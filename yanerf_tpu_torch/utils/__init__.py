"""Config, registry and device helpers of the port (no JAX, no ``yanerf_tpu``)."""

from __future__ import annotations

from typing import Union

import torch

from .config import Config, ConfigDict, DictAction
from .registry import Registry, build_from_cfg

__all__ = ["Config", "ConfigDict", "DictAction", "Registry", "build_from_cfg", "resolve_device"]


def resolve_device(device: Union[str, torch.device] = "cuda") -> torch.device:
    """The device an entry point was asked for; ``cuda`` without a card raises.

    The port never carries on on the CPU when it was asked for the GPU: a
    caller that wants the CPU (the tests) says ``device="cpu"``.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {str(device)!r} was requested but torch.cuda.is_available() is False")
    return dev
