"""Visualization dumps of the train and eval loops.

Counterpart of ``yanerf_tpu/runners/vis.py``: every ``rendered_*`` (and
``image_rgb_*``) prediction is written as PNGs under
``{output_dir}/visualization/{split}/{type}/[{epoch}/]{index:05d}.png``,
depth and alpha maps max-normalized per item. The PNGs come from the
port's own encoder (``utils/images.py``). ``AsyncVisWriter`` moves the
device-to-host copy and the encoding of eval frames to a thread, so that
they overlap the next frame's render.
"""

from __future__ import annotations

import queue
import threading
from enum import Enum
from functools import lru_cache
from pathlib import Path
from typing import Dict, Union

import numpy as np
import torch

from ..utils.images import png_bytes, to_img

RENDER_PREFIXES = ("rendered_", "image_rgb_")
MAX_PENDING = 4  # eval frames the vis writer's queue holds


class RunType(Enum):
    TRAIN = "train"
    VAL = "val"
    TEST = "test"


@lru_cache(maxsize=None)
def _vis_dir(output_dir: str, run_type_value: str, rendered_type: str, prefix) -> Path:
    vis_dir = Path(output_dir) / "visualization" / run_type_value / rendered_type
    if prefix is not None:
        vis_dir = vis_dir / prefix
    vis_dir.mkdir(exist_ok=True, parents=True)
    return vis_dir


def _to_numpy(value) -> np.ndarray:
    if isinstance(value, torch.Tensor):
        return value.detach().float().cpu().numpy()
    return np.asarray(value)


def vis_batch_img(
    preds: Dict,
    run_type: RunType,
    output_dir: Union[str, Path],
    output_start_idx: int,
    output_end_idx: int,
    file_name_prefix: str = "",
) -> None:
    """Write items ``output_start_idx ..`` of every rendered prediction of the batch.

    A ``file_name_prefix`` ending in ``/`` is a subdirectory (the eval
    loops' ``{epoch:05d}/``), otherwise it prefixes the file names.
    """
    if file_name_prefix.endswith("/"):
        prefix, file_name_prefix = file_name_prefix, ""
    else:
        prefix = None
    template = file_name_prefix + "{:05d}.png"

    for rendered_type, renders in preds.items():
        if not rendered_type.startswith(RENDER_PREFIXES):
            continue
        renders = _to_numpy(renders)
        if "depths" in rendered_type or "alpha_masks" in rendered_type:
            flat_max = renders.reshape(renders.shape[0], -1).max(axis=1)
            flat_max = np.where(flat_max <= 0, 1.0, flat_max)
            renders = renders / flat_max.reshape(-1, *([1] * (renders.ndim - 1)))

        end_idx = output_start_idx + min(output_end_idx - output_start_idx, len(renders))
        vis_dir = _vis_dir(str(output_dir), run_type.value, rendered_type, prefix)
        for batch_idx, file_idx in enumerate(range(output_start_idx, end_idx)):
            (vis_dir / template.format(file_idx)).write_bytes(png_bytes(to_img(renders[batch_idx])))


class AsyncVisWriter:
    """``vis_batch_img`` on a background thread: ``submit`` queues a frame, ``close`` drains and re-raises.

    ``submit`` keeps only the rendered entries of the predictions, so the
    queue holds no more of a frame than it writes; at most ``MAX_PENDING``
    frames wait.
    """

    _SENTINEL = object()

    def __init__(self) -> None:
        self._queue: "queue.Queue" = queue.Queue(maxsize=MAX_PENDING)
        self._error = None
        self._thread = threading.Thread(target=self._run, daemon=True, name="vis-writer")
        self._thread.start()

    def _run(self) -> None:
        while True:
            item = self._queue.get()
            if item is self._SENTINEL:
                return
            try:
                vis_batch_img(*item)
            except Exception as e:  # raised by close()
                if self._error is None:
                    self._error = e

    def submit(self, preds: Dict, *args) -> None:
        self._queue.put(({k: v for k, v in preds.items() if k.startswith(RENDER_PREFIXES)}, *args))

    def close(self) -> None:
        self._queue.put(self._SENTINEL)
        self._thread.join()
        if self._error is not None:
            raise self._error
