"""Checkpoint save and restore with the JAX package's contract.

Counterpart of ``yanerf_tpu/runners/checkpoints.py``: the payload is the
parameters, the optimizer state, the step and the epoch; the file is
``{output_dir}/ckpts/ckpts_{epoch:04d}``, the best model ``ckpts_-001``;
resuming restores all of it and continues at ``epoch + 1``. Storage is
``torch.save`` of plain tensors on the CPU. The parameters are keyed by the
JAX param tree's dotted paths, so ``checkpoint_params_tree`` gives back a
tree that the JAX package's pipeline takes as its params.

``PreemptionGuard`` (the JAX package's) turns SIGTERM / SIGINT into a
request the train loops poll between steps (or fused dispatches); the CLI
then writes the emergency checkpoint ``ckpts_preempt`` and
``find_latest_checkpoint`` finds it for ``--auto_resume``.
"""

from __future__ import annotations

import os
import signal
import threading
from pathlib import Path
from typing import Any, Dict, Optional, Tuple, Union

import torch

from ..convert import unflatten_tree
from .optim import TrainState


def ckpt_name(epoch: int) -> str:
    return f"ckpts_{epoch:04d}"


def save_checkpoint(output_dir: Union[str, Path], state: TrainState, epoch: int, name: Optional[str] = None) -> Path:
    """Write params, optimizer state, step and epoch to ``{output_dir}/ckpts/ckpts_{epoch:04d}`` (or ``name``)."""
    path = Path(output_dir).resolve() / "ckpts" / (name or ckpt_name(epoch))
    path.parent.mkdir(parents=True, exist_ok=True)
    payload = {
        "params": {k: p.detach().cpu() for k, p in state.pipeline.named_parameters()},
        "opt_state": state.optimizer.state_dict(),
        "step": int(state.step),
        "epoch": int(epoch),
    }
    tmp = path.with_name(path.name + ".tmp")
    torch.save(payload, tmp)
    os.replace(tmp, path)  # a reader never sees a half-written file
    return path


def load_checkpoint(path: Union[str, Path], state: TrainState) -> Dict[str, Any]:
    """Restore params, optimizer state and step into ``state``; returns ``{"state", "epoch"}``.

    The parameters are written in place; each group's learning-rate tensor
    keeps its identity and device and its ``capturable`` flag (the saved
    run may have trained on another device).
    """
    payload = torch.load(Path(path), map_location="cpu", weights_only=True)
    params = dict(state.pipeline.named_parameters())
    if set(params) != set(payload["params"]):
        raise KeyError(f"checkpoint {path} does not match the pipeline's parameters")
    with torch.no_grad():
        for key, p in params.items():
            p.copy_(payload["params"][key])
    kept = [(group["lr"], group["capturable"]) for group in state.optimizer.param_groups]
    state.optimizer.load_state_dict(payload["opt_state"])
    for group, (lr, capturable) in zip(state.optimizer.param_groups, kept):
        lr.copy_(torch.as_tensor(group["lr"], dtype=lr.dtype))
        group["lr"], group["capturable"] = lr, capturable
        for p in group["params"] if capturable else ():
            if "step" in state.optimizer.state.get(p, {}):
                state.optimizer.state[p]["step"] = state.optimizer.state[p]["step"].to(p.device, torch.float32)
    state.step = int(payload["step"])
    return {"state": state, "epoch": int(payload["epoch"])}


def checkpoint_params_tree(path: Union[str, Path]) -> Dict[str, Any]:
    """A checkpoint's parameters as the JAX package's nested param tree of numpy arrays."""
    payload = torch.load(Path(path), map_location="cpu", weights_only=True)
    tree = unflatten_tree({k: v.numpy() for k, v in payload["params"].items()})
    tree.setdefault("feature_extractors", [])
    return tree


def find_best_checkpoint(output_dir: Union[str, Path]) -> Optional[Path]:
    best = Path(output_dir) / "ckpts" / ckpt_name(-1)
    return best if best.exists() else None


def find_latest_checkpoint(output_dir: Union[str, Path]) -> Optional[Tuple[Path, Path]]:
    """``(version_dir, checkpoint)`` of the newest resumable checkpoint under ``output_dir``, for ``--auto_resume``.

    Scans ``version_*`` (or ``output_dir`` itself when it holds ``ckpts/``)
    and takes the newest ``ckpts_*`` by modification time, so an emergency
    ``ckpts_preempt`` wins right after a preemption; the best model
    ``ckpts_-001`` and half-written ``.tmp`` files are skipped.
    """
    root = Path(output_dir)
    version_dirs = sorted(root.glob("version_*"))
    if not version_dirs and (root / "ckpts").exists():
        version_dirs = [root]
    candidates = [
        (c.stat().st_mtime, str(c), vd, c)
        for vd in version_dirs
        for c in (vd / "ckpts").glob("ckpts_*")
        if c.name != ckpt_name(-1) and not c.name.endswith(".tmp")
    ]
    if not candidates:
        return None
    _, _, version_dir, path = max(candidates)
    return version_dir, path


class PreemptionGuard:
    """SIGTERM / SIGINT request a stop instead of killing the process.

    The handler only sets a flag; the train loops poll :attr:`preempted`
    between steps (or fused dispatches) and return, and the CLI writes a
    resumable emergency checkpoint. :meth:`uninstall` restores the previous
    handlers. Handlers can be installed from the main thread only; elsewhere
    the guard stays inert.
    """

    SIGNALS = (signal.SIGTERM, signal.SIGINT)

    def __init__(self) -> None:
        self._event = threading.Event()
        self._previous: Dict[int, Any] = {}

    def install(self) -> "PreemptionGuard":
        if threading.current_thread() is threading.main_thread():
            for sig in self.SIGNALS:
                self._previous[sig] = signal.signal(sig, self._handle)
        return self

    def uninstall(self) -> None:
        for sig, previous in self._previous.items():
            signal.signal(sig, previous)
        self._previous.clear()

    def _handle(self, signum, frame) -> None:
        self._event.set()

    @property
    def preempted(self) -> bool:
        return self._event.is_set()
