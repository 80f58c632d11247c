"""Config, registry, logging, timing, file and device helpers of the port (no JAX, no ``yanerf_tpu``).

The names of ``yanerf_tpu/utils/__init__.py``, and ``device_constant`` /
``resolve_device``; ``fileio`` is a subpackage.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Hashable, Union

import torch

from .config import Config, ConfigDict, DictAction
from .logging import get_logger, print_log
from .misc import (
    concat_list,
    import_modules_from_strings,
    is_list_of,
    is_seq_of,
    is_str,
    is_tuple_of,
    iter_cast,
    list_cast,
    slice_list,
    to_1tuple,
    to_2tuple,
    to_3tuple,
    to_4tuple,
    to_ntuple,
    tuple_cast,
)
from .path import check_file_exist, find_vcs_root, fopen, is_filepath, mkdir_or_exist, scandir, symlink
from .profiling import StepTimer, annotate, trace
from .registry import Registry, build_from_cfg
from .timer import Timer, TimerError, check_time

__all__ = [
    "StepTimer",
    "annotate",
    "trace",
    "Config",
    "ConfigDict",
    "DictAction",
    "get_logger",
    "print_log",
    "Registry",
    "build_from_cfg",
    "Timer",
    "TimerError",
    "check_time",
    "is_str",
    "is_seq_of",
    "is_list_of",
    "is_tuple_of",
    "iter_cast",
    "list_cast",
    "tuple_cast",
    "slice_list",
    "concat_list",
    "import_modules_from_strings",
    "to_1tuple",
    "to_2tuple",
    "to_3tuple",
    "to_4tuple",
    "to_ntuple",
    "check_file_exist",
    "find_vcs_root",
    "fopen",
    "is_filepath",
    "mkdir_or_exist",
    "scandir",
    "symlink",
    "device_constant",
    "resolve_device",
]

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
    backward. While ``torch.export`` traces, a constant not made yet is
    made for the trace and not kept.
    """
    full_key = (key, dtype, torch.device(device))
    tensor = _CONSTANTS.get(full_key)
    if tensor is None and torch.compiler.is_exporting():  # a traced tensor must not stay in the cache
        return torch.as_tensor(make(), dtype=dtype, device=device)
    if tensor is None:
        with torch.inference_mode(False):
            tensor = _CONSTANTS.setdefault(full_key, torch.as_tensor(make(), dtype=dtype, device=device))
    return tensor
