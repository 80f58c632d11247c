"""The multiresolution hash encoding on the card: K4 (forward), K5 (the tables' gradient) and their autograd Function.

Counterpart of the encoding of ``models/hash_grid.py`` (``HashGridNeRF.encode``
and ``table_lookup``), which the JAX package runs as XLA gathers and
scatter-adds: no Pallas kernel stands behind these two.
``csrc/hash_encode.cu`` says what bounds them and what the design does
about it.

* ``hash_encode_fwd_op`` is the operator
  ``torch.ops.yanerf_tpu_torch.hash_encode_fwd`` (``torch.library.custom_op``,
  with a fake implementation for tracing): on CUDA tensors it launches K4,
  ``(n, 3)`` float32 points and the L tables ``(rows_l, 2)`` -> the
  ``(n, 2 L)`` float32 features.
* ``hash_encode_bwd_op`` is ``torch.ops.yanerf_tpu_torch.hash_encode_bwd``:
  K5, the features' cotangents ``(n, 2 L)`` -> every table's gradient, one
  ``(sum of rows_l, 2)`` float32 buffer, level after level. It is
  deterministic: two launches on the same inputs give the same bits.
* ``HashEncode`` joins them; ``hash_encode`` is its entry. The points
  take no gradient on this path: asking for one raises.
``HashGridNeRF`` encodes every CUDA point here. ``takes_widths`` says
which hash grids the kernels take; a launch on other widths raises.
Neither operator has a CPU kernel: on the CPU the model runs its plain
path. On a CUDA tensor they launch their kernel or raise (no fallback). Both are
capturable into a CUDA graph: no host synchronisation, and no allocation
whose size depends on the data.

``launches`` counts K4's launches and ``bwd_launches`` K5's (one per
backward, whatever kernels it runs), each launch of a replayed CUDA graph
too (``launch_count.py``).
"""

from __future__ import annotations

import ctypes
import functools
import sys
from typing import List, Tuple

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from . import launch_count
from ._build import CudaLibrary

# kernel launches since import (or since a caller reset them): K4, K5
launches = 0
bwd_launches = 0

MAX_LEVELS = 16  # csrc/hash_encode.cu: a block is 32 points x L levels
N_FEATURES = 2  # features per level the kernels are compiled for


def _bind(lib: ctypes.CDLL) -> None:
    c_int, c_float, c_void_p = ctypes.c_int, ctypes.c_float, ctypes.c_void_p
    lib.hash_encode_fwd.argtypes = [c_void_p] * 5 + [c_int, c_int, c_float, c_float, c_void_p]
    lib.hash_encode_fwd.restype = c_int
    lib.hash_encode_bwd.argtypes = [c_void_p] * 6 + [c_int, c_int, c_float, c_float, c_void_p]
    lib.hash_encode_bwd.restype = c_int


LIBRARY = CudaLibrary("hash_encode.cu", _bind)
build, build_report, load = LIBRARY.build, LIBRARY.build_report, LIBRARY.load


@functools.lru_cache(maxsize=64)
def _host_ints(values: Tuple[int, ...]):
    return (ctypes.c_int * len(values))(*values)


@functools.lru_cache(maxsize=64)
def _host_pointers(values: Tuple[int, ...]):
    return (ctypes.c_void_p * len(values))(*values)


def inv_extent(scene_bound: float) -> float:
    """``1 / (2 * scene_bound)`` in float32: the plain path's division of a CUDA tensor by that scalar is this
    product."""
    return float(np.float32(1.0) / np.float32(2.0 * scene_bound))


def takes_widths(resolutions: List[int], sizes: List[int], n_features: int = N_FEATURES) -> bool:
    """Whether K4 / K5 take a hash grid of these widths: 1 to ``MAX_LEVELS`` levels of ``N_FEATURES`` features,
    each level's resolution and table at least 1, each hashed level's table a power of two."""
    return (n_features == N_FEATURES and 1 <= len(sizes) <= MAX_LEVELS and len(resolutions) == len(sizes)
            and all(res >= 1 and size >= 1 and ((res + 1) ** 3 <= size or not size & (size - 1))
                    for res, size in zip(resolutions, sizes)))


def _check(points: torch.Tensor, sizes: List[int], resolutions: List[int], n_features: int = N_FEATURES) -> None:
    if points.device.type != "cuda":
        raise ValueError(f"the hash encoding's kernels take CUDA tensors, got {points.device}; "
                         "on the CPU the model runs its plain path")
    if points.dtype != torch.float32 or points.dim() != 2 or points.shape[1] != 3 or not points.is_contiguous():
        raise ValueError(f"points must be a contiguous float32 (n, 3) tensor, got {tuple(points.shape)} {points.dtype}")
    if not takes_widths(resolutions, sizes, n_features):
        raise NotImplementedError(f"the kernels take 1 to {MAX_LEVELS} levels of {N_FEATURES} features, resolution "
                                  f"and table at least 1, a hashed level's table a power of two; got {n_features} "
                                  f"features, resolutions {list(resolutions)} and tables of {list(sizes)} rows")


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


@torch.library.custom_op("yanerf_tpu_torch::hash_encode_fwd", mutates_args=())
def hash_encode_fwd_op(points: torch.Tensor, tables: List[torch.Tensor], resolutions: List[int],
                       scene_bound: float) -> torch.Tensor:
    """K4 as a PyTorch operator, ``torch.ops.yanerf_tpu_torch.hash_encode_fwd``: ``(n, 3)`` points, the
    levels' tables ``(rows_l, 2)`` and resolutions -> ``(n, 2 L)`` float32 features. CUDA tensors only."""
    raise ValueError(f"the hash encoding's kernels take CUDA tensors, got {points.device}")


@hash_encode_fwd_op.register_fake
def _(points, tables, resolutions, scene_bound):
    return points.new_empty((points.shape[0], N_FEATURES * len(tables)), dtype=torch.float32)


def _fwd_cuda(points, tables, resolutions, scene_bound):
    lib = LIBRARY.library()  # raises where the kernel cannot be built
    _check(points, [t.shape[0] for t in tables], resolutions, tables[0].shape[-1] if tables else N_FEATURES)
    for t in tables:
        if (t.dtype != torch.float32 or t.dim() != 2 or t.shape[1] != N_FEATURES or not t.is_contiguous()
                or t.device != points.device):
            raise ValueError(f"every table must be a contiguous float32 (rows, {N_FEATURES}) tensor on "
                             f"{points.device}, got {tuple(t.shape)} {t.dtype} on {t.device}")
    n = points.shape[0]
    out = torch.empty((n, N_FEATURES * len(tables)), dtype=torch.float32, device=points.device)
    with torch.cuda.device(points.device):
        rc = lib.hash_encode_fwd(
            points.data_ptr(), out.data_ptr(), _host_pointers(tuple(t.data_ptr() for t in tables)),
            _host_ints(tuple(resolutions)), _host_ints(tuple(t.shape[0] for t in tables)), len(tables), n,
            float(scene_bound), inv_extent(scene_bound), _stream(points.device),
        )
    if rc != 0:
        raise RuntimeError(f"hash_encode_fwd kernel launch failed with CUDA error {rc}")
    launch_count.count(sys.modules[__name__], "launches")
    return out


hash_encode_fwd_op.register_kernel("cuda")(_fwd_cuda)


@torch.library.custom_op("yanerf_tpu_torch::hash_encode_bwd", mutates_args=())
def hash_encode_bwd_op(points: torch.Tensor, grad: torch.Tensor, resolutions: List[int], sizes: List[int],
                       scene_bound: float) -> torch.Tensor:
    """K5 as a PyTorch operator, ``torch.ops.yanerf_tpu_torch.hash_encode_bwd``: the features' cotangents
    ``(n, 2 L)`` -> the tables' gradient, ``(sum of sizes, 2)`` float32, level after level. CUDA tensors only."""
    raise ValueError(f"the hash encoding's kernels take CUDA tensors, got {points.device}")


@hash_encode_bwd_op.register_fake
def _(points, grad, resolutions, sizes, scene_bound):
    return points.new_empty((sum(sizes), N_FEATURES), dtype=torch.float32)


def _bwd_cuda(points, grad, resolutions, sizes, scene_bound):
    lib = LIBRARY.library()
    _check(points, sizes, resolutions)
    n = points.shape[0]
    if (grad.dtype != torch.float32 or tuple(grad.shape) != (n, N_FEATURES * len(sizes)) or not grad.is_contiguous()
            or grad.device != points.device):
        raise ValueError(f"the cotangents must be a contiguous float32 ({n}, {N_FEATURES * len(sizes)}) tensor on "
                         f"{points.device}, got {tuple(grad.shape)} {grad.dtype} on {grad.device}")
    rows = sum(sizes)
    scratch = torch.empty(N_FEATURES * rows + 1, dtype=torch.int64, device=points.device)
    out = torch.empty((rows, N_FEATURES), dtype=torch.float32, device=points.device)
    with torch.cuda.device(points.device):
        rc = lib.hash_encode_bwd(
            points.data_ptr(), grad.data_ptr(), scratch.data_ptr(), out.data_ptr(), _host_ints(tuple(resolutions)),
            _host_ints(tuple(sizes)), len(sizes), n, float(scene_bound), inv_extent(scene_bound),
            _stream(points.device),
        )
    if rc != 0:
        raise RuntimeError(f"hash_encode_bwd kernel launch failed with CUDA error {rc}")
    launch_count.count(sys.modules[__name__], "bwd_launches")
    return out


hash_encode_bwd_op.register_kernel("cuda")(_bwd_cuda)


class HashEncode(torch.autograd.Function):
    """K4 forward, K5 backward; the tables' gradients are views of K5's one buffer."""

    @staticmethod
    def forward(ctx, points, resolutions, scene_bound, *tables):
        ctx.save_for_backward(points)
        ctx.resolutions, ctx.scene_bound, ctx.sizes = resolutions, scene_bound, [t.shape[0] for t in tables]
        return hash_encode_fwd_op(points, list(tables), resolutions, scene_bound)

    @staticmethod
    @once_differentiable
    def backward(ctx, grad):
        (points,) = ctx.saved_tensors
        flat = hash_encode_bwd_op(points, grad.to(torch.float32).contiguous(), ctx.resolutions, ctx.sizes,
                                  ctx.scene_bound)
        return (None, None, None, *torch.split(flat, ctx.sizes))


def hash_encode(points: torch.Tensor, tables: List[torch.Tensor], resolutions: List[int],
                scene_bound: float) -> torch.Tensor:
    """``(n, 3)`` world points -> ``(n, 2 L)`` float32 features on K4, differentiable in the tables (K5)."""
    if points.requires_grad:
        raise ValueError("the hash encoding's kernels give no gradient for the points; they must not require grad")
    return HashEncode.apply(points, list(resolutions), float(scene_bound), *tables)
