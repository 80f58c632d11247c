"""Checkpoint save and restore with the JAX package's contract.

Counterpart of ``yanerf_tpu/runners/checkpoints.py``: the payload is the
parameters, the optimizer state, the step and the epoch; the file is
``{output_dir}/ckpts/ckpts_{epoch:04d}``, the best model ``ckpts_-001``;
resuming restores all of it and continues at ``epoch + 1``. Storage is
``torch.save`` of plain tensors on the CPU. The parameters are keyed by the
JAX param tree's dotted paths, so ``checkpoint_params_tree`` gives back a
tree that the JAX package's pipeline takes as its params.

``save_checkpoint(..., async_save=True)`` (the JAX package's async orbax
save) copies the state to the host before it returns and leaves only the
write to a writer thread; ``wait_for_async_saves`` waits for the writes.

``PreemptionGuard`` (the JAX package's) turns SIGTERM / SIGINT into a
request the train loops poll between steps (or fused dispatches); the CLI
then writes the emergency checkpoint ``ckpts_preempt`` and
``find_latest_checkpoint`` finds it for ``--auto_resume``.

``import_torch_checkpoint`` / ``export_torch_checkpoint`` read and write
the reference's own ``.pth`` layout (``{"model": state_dict, "optimizer":
{}, "epoch": e}``, torch ``(out, in)`` Linear weights, the
``PartialFunctionWrapper``'s ``._fn.`` and the ``Sequential`` indices of
its modules), the JAX package's importer and its inverse, through the
weight bridge (``convert.py``).
"""

from __future__ import annotations

import os
import re
import signal
import threading
from concurrent.futures import Future, ThreadPoolExecutor
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from ..convert import export_jax_params, flatten_tree, load_jax_params, unflatten_tree
from .optim import TrainState

# one writer thread: async saves are written in the order they were made, one at a time
_WRITER = ThreadPoolExecutor(max_workers=1, thread_name_prefix="checkpoint-writer")
_PENDING: List[Future] = []


def ckpt_name(epoch: int) -> str:
    return f"ckpts_{epoch:04d}"


def _host_copy(tree: Any) -> Any:
    """``tree`` with every tensor copied to new host memory (a CPU tensor too): a snapshot no later step reaches."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: _host_copy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_host_copy(v) for v in tree)
    return tree


def _write(payload: Dict[str, Any], path: Path) -> Path:
    tmp = path.with_name(path.name + ".tmp")
    torch.save(payload, tmp)
    os.replace(tmp, path)  # a reader never sees a half-written file
    return path


def wait_for_async_saves() -> None:
    """Block until every async save has been written; re-raises a failed write.

    Call it before reading a checkpoint that may still be written (the
    best-model reload) and before the process ends.
    """
    while _PENDING:
        _PENDING.pop(0).result()


def save_checkpoint(
    output_dir: Union[str, Path],
    state: TrainState,
    epoch: int,
    name: Optional[str] = None,
    async_save: bool = False,
) -> Path:
    """Write params, optimizer state, step and epoch to ``{output_dir}/ckpts/ckpts_{epoch:04d}`` (or ``name``).

    Every parameter and optimizer tensor is copied to the host before this
    returns (the fused dispatch's CUDA graph writes both in place at its
    next replay); with ``async_save`` the writer thread then does the
    ``torch.save`` and the rename. A synchronous save first waits for the
    async ones, so two writes never meet at one path.
    """
    path = Path(output_dir).resolve() / "ckpts" / (name or ckpt_name(epoch))
    path.parent.mkdir(parents=True, exist_ok=True)
    if not async_save:
        wait_for_async_saves()
    payload = {
        "params": _host_copy(dict(state.pipeline.named_parameters())),
        "opt_state": _host_copy(state.optimizer.state_dict()),
        "step": int(state.step),
        "epoch": int(epoch),
    }
    if async_save:
        _PENDING.append(_WRITER.submit(_write, payload, path))
        return path
    return _write(payload, path)


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


# -- the reference's .pth ---------------------------------------------------------------


def _reference_key(name: str) -> Tuple[str, bool]:
    """A reference module name -> ``(the JAX param tree's dotted key, whether it is a Linear weight)``.

    ``implicit_functions.0._fn.xyz_encoder.mlp.3.0.weight`` ->
    ``implicit_functions.0.xyz_encoder.mlp.3.w``; the color head's
    ``Sequential`` holds the Linear layers at its even slots.
    """
    path = name.replace("._fn.", ".")
    path = re.sub(r"\.mlp\.(\d+)\.0\.(weight|bias)", r".mlp.\1.\2", path)
    match = re.search(r"color_layer\.(\d+)\.(weight|bias)$", path)
    if match:
        path = re.sub(r"color_layer\.\d+\.", f"color_layer.{int(match.group(1)) // 2}.", path)
    if path.endswith(".weight"):
        return path[: -len(".weight")] + ".w", True
    if path.endswith(".bias"):
        return path[: -len(".bias")] + ".b", False
    return path, False


def import_torch_checkpoint(pth_path: Union[str, Path], pipeline: torch.nn.Module) -> int:
    """Load a reference-layout ``.pth`` into ``pipeline``'s parameters; returns the tensors that found no slot.

    The JAX package's ``import_torch_checkpoint``: torch's ``(out, in)``
    Linear weights become the ``(in, out)`` layout, a tensor whose key the
    pipeline lacks is counted, a shape mismatch raises ``ValueError``, and
    the parameters the file does not hold keep their values.
    """
    blob = torch.load(Path(pth_path), map_location="cpu", weights_only=True)
    state_dict = blob["model"] if isinstance(blob, dict) and "model" in blob else blob
    flat = flatten_tree(export_jax_params(pipeline))
    n_missing = 0
    for name, tensor in state_dict.items():
        value = tensor.detach().cpu().numpy().astype(np.float32)
        key, is_weight = _reference_key(name)
        if is_weight and value.ndim == 2:
            value = value.T  # (out, in) -> (in, out)
        if key not in flat:
            n_missing += 1
            continue
        if flat[key].shape != value.shape:
            raise ValueError(f"shape mismatch at {key}: {flat[key].shape} vs {value.shape}")
        flat[key] = value
    load_jax_params(pipeline, flat)
    return n_missing


def export_torch_checkpoint(pipeline: torch.nn.Module, pth_path: Union[str, Path], epoch: int = -1) -> int:
    """Write ``pipeline``'s NeRFMLPs as a reference-layout ``.pth``; returns the tensors written.

    The JAX package's ``export_torch_checkpoint`` (the inverse of the
    importer): ``torch.save({"model": state_dict, "optimizer": {}, "epoch":
    e})`` with the reference's module names, weights back in torch's
    ``(out, in)``. Only the NeRFMLP family has a reference counterpart;
    another model raises ``ValueError``.
    """
    params = export_jax_params(pipeline)
    sd: Dict[str, torch.Tensor] = {}

    def put(name: str, arr: np.ndarray) -> None:
        arr = np.asarray(arr, dtype=np.float32)
        if arr.ndim == 2:
            arr = arr.T  # (in, out) -> torch Linear's (out, in)
        sd[name] = torch.from_numpy(np.ascontiguousarray(arr))

    for i, fn_params in enumerate(params["implicit_functions"]):
        prefix = f"implicit_functions.{i}._fn."
        if not (isinstance(fn_params, dict) and "xyz_encoder" in fn_params):
            raise ValueError(
                f"implicit function {i} is not a NeRFMLP param tree; only the "
                "reference-analog family can be exported to .pth"
            )
        for li, layer in enumerate(fn_params["xyz_encoder"]["mlp"]):
            put(f"{prefix}xyz_encoder.mlp.{li}.0.weight", layer["w"])
            put(f"{prefix}xyz_encoder.mlp.{li}.0.bias", layer["b"])
        for flat in ("intermediate_linear", "density_layer"):
            put(f"{prefix}{flat}.weight", fn_params[flat]["w"])
            put(f"{prefix}{flat}.bias", fn_params[flat]["b"])
        for j, layer in enumerate(fn_params["color_layer"]):  # Linear layers at the Sequential's even slots
            put(f"{prefix}color_layer.{2 * j}.weight", layer["w"])
            put(f"{prefix}color_layer.{2 * j}.bias", layer["b"])

    torch.save({"model": sd, "optimizer": {}, "epoch": int(epoch)}, str(pth_path))
    return len(sd)


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
