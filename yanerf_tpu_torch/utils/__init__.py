"""Config, registry and device helpers of the port (no JAX, no ``yanerf_tpu``)."""

from __future__ import annotations

from typing import Any, Callable, Dict, Hashable, Union

import torch

from .config import Config, ConfigDict, DictAction
from .registry import Registry, build_from_cfg

__all__ = ["Config", "ConfigDict", "DictAction", "Registry", "build_from_cfg", "device_constant", "resolve_device"]

_CONSTANTS: Dict[tuple, torch.Tensor] = {}


def resolve_device(device: Union[str, torch.device] = "cuda") -> torch.device:
    """The device an entry point was asked for; ``cuda`` without a card raises.

    The port never carries on on the CPU when it was asked for the GPU: a
    caller that wants the CPU (the tests) says ``device="cpu"``.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {str(device)!r} was requested but torch.cuda.is_available() is False")
    return dev


def device_constant(key: Hashable, make: Callable[[], Any], dtype: torch.dtype, device) -> torch.Tensor:
    """``torch.as_tensor(make(), dtype, device)``, made once per ``key``, dtype and device and then reused.

    A train step captured as a CUDA graph cannot copy from the host: the
    step's constants (frequencies, pixel grids, depth bounds, colors) reach
    the card in the eager step before the capture, and the capture reuses
    them. Callers must not write to the tensor. It is never an inference
    tensor, so an eval pass may make it and a train step save it for
    backward.
    """
    full_key = (key, dtype, torch.device(device))
    tensor = _CONSTANTS.get(full_key)
    if tensor is None:
        with torch.inference_mode(False):
            tensor = _CONSTANTS.setdefault(full_key, torch.as_tensor(make(), dtype=dtype, device=device))
    return tensor
