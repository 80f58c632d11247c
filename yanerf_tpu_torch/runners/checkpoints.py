"""Checkpoint save and restore with the JAX package's contract.

Counterpart of ``yanerf_tpu/runners/checkpoints.py``: the payload is the
parameters, the optimizer state, the step and the epoch; the file is
``{output_dir}/ckpts/ckpts_{epoch:04d}``, the best model ``ckpts_-001``;
resuming restores all of it and continues at ``epoch + 1``. Storage is
``torch.save`` of plain tensors on the CPU. The parameters are keyed by the
JAX param tree's dotted paths, so ``checkpoint_params_tree`` gives back a
tree that the JAX package's pipeline takes as its params.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Any, Dict, Optional, Union

import torch

from ..convert import unflatten_tree
from .optim import TrainState


def ckpt_name(epoch: int) -> str:
    return f"ckpts_{epoch:04d}"


def save_checkpoint(output_dir: Union[str, Path], state: TrainState, epoch: int) -> Path:
    """Write params, optimizer state, step and epoch to ``{output_dir}/ckpts/ckpts_{epoch:04d}``."""
    path = Path(output_dir).resolve() / "ckpts" / ckpt_name(epoch)
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
    """Restore params, optimizer state and step into ``state``; returns ``{"state", "epoch"}``."""
    payload = torch.load(Path(path), map_location="cpu", weights_only=True)
    params = dict(state.pipeline.named_parameters())
    if set(params) != set(payload["params"]):
        raise KeyError(f"checkpoint {path} does not match the pipeline's parameters")
    with torch.no_grad():
        for key, p in params.items():
            p.copy_(payload["params"][key])
    state.optimizer.load_state_dict(payload["opt_state"])
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
