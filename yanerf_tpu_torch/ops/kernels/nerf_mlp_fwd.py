"""Fused NeRF-MLP forward: the CUDA kernel's wrapper, its plain version and the weight packing.

Replaces ``yanerf_tpu/ops/pallas/nerf_mlp_kernel.py::_nerf_mlp_kernel``
(reached through ``nerf_mlp_forward_pallas``). The kernel is
``csrc/nerf_mlp_fwd.cu``; its header says what bounds it on the card
(operations) and what the design does about it.

* ``pack_weights`` pads the model's weights in kernel order, with K padded
  to multiples of 16 (63 -> 64 for the xyz embedding, 27 -> 32 for the
  direction embedding, the skip layer's embedding rows likewise), and keeps
  them in one flat buffer of the compute dtype. The biases stay float32.
* ``nerf_mlp_fwd_plain`` is the plain PyTorch version of the same function.
  It mirrors the Pallas kernel, not the eager model: float32 bias adds after
  float32 accumulation of bf16 products, and ``cos(t)`` as
  ``sin(t + pi/2)``. It runs with TF32 off.
* ``nerf_mlp_fwd`` launches the kernel for CUDA tensors and takes the plain
  version only for CPU tensors. It never falls back on the card.
* ``launches`` counts the kernel's launches.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import hashlib
import math
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import List, Tuple

import torch
import torch.nn.functional as F

from ..harmonics import harmonic_frequencies

# kernel launches since import (or since a caller reset it)
launches = 0

KERNEL_HIDDEN = 256  # xyz hidden width the CUDA kernel is compiled for
KERNEL_HIDDEN_DIR = 128  # color hidden width the CUDA kernel is compiled for
KERNEL_MAX_K_XYZ = 64
KERNEL_MAX_K_DIR = 32
_ALIGN = 64  # every packed tensor starts on a 64-element (128-byte) boundary

_PACKAGE_DIR = Path(__file__).resolve().parents[2]
SOURCE = _PACKAGE_DIR / "csrc" / "nerf_mlp_fwd.cu"
BUILD_DIR = _PACKAGE_DIR / "_build"
# no --use_fast_math: the embedding's phases reach |x| * 2^9 rad, where the
# fast sine is wrong. -Xptxas -v reports registers, shared memory, spills.
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]

_lib = None
_lib_lock = threading.Lock()


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class PackedNerfMlp:
    """A NeRFMLP's weights in kernel order, padded, with its architecture."""

    flat: torch.Tensor  # all weights, compute dtype, one buffer
    biases_flat: torch.Tensor  # all biases, float32, one buffer
    weights: Tuple[torch.Tensor, ...]  # views into ``flat``, (K_padded, N) each
    biases: Tuple[torch.Tensor, ...]  # views into ``biases_flat``
    w_offsets: Tuple[int, ...]
    b_offsets: Tuple[int, ...]
    n_layers: int
    input_skips: Tuple[int, ...]
    n_freq_xyz: int
    append_xyz: bool
    n_freq_dir: int
    append_dir: bool
    n_extra_color: int
    hidden: int
    hidden_dir: int
    color_dim: int
    compute_dtype: torch.dtype

    @property
    def k_xyz(self) -> int:
        return _round_up(3 * (2 * self.n_freq_xyz + int(self.append_xyz)), 16)

    @property
    def k_dir(self) -> int:
        return _round_up(3 * (2 * self.n_freq_dir + int(self.append_dir)), 16)


def _pad_rows(w: torch.Tensor, rows: int) -> torch.Tensor:
    return w if w.shape[0] == rows else F.pad(w, (0, 0, 0, rows - w.shape[0]))


def pack_weights(model) -> PackedNerfMlp:
    """Pad and flatten a ``NeRFMLP``'s weights in kernel order.

    Order: xyz layers, intermediate, density, color layers (as
    ``padded_weights`` of the Pallas kernel). Layer 0 and the skip layers
    get their embedding rows padded to ``k_xyz``; the first color layer its
    direction-embedding rows to ``k_dir``.
    """
    if model.latent_dim != 0 or not model.input_xyz or not model.input_dir:
        raise NotImplementedError("the fused kernel covers the standard xyz+dir NeRFMLP")
    h = model.n_hidden_neurons_xyz
    k_xyz = _round_up(model.embedding_dim_xyz, 16)
    k_dir = _round_up(model.embedding_dim_dir, 16)
    weights: List[torch.Tensor] = []
    biases: List[torch.Tensor] = []
    with torch.no_grad():
        for li, layer in enumerate(model.xyz_encoder.mlp):
            w = layer.w
            if li == 0:
                w = _pad_rows(w, k_xyz)
            elif li in model.input_skips:
                w = torch.cat([w[:h], _pad_rows(w[h:], k_xyz)], dim=0)
            weights.append(w)
            biases.append(layer.b)
        for layer in (model.intermediate_linear, model.density_layer):
            weights.append(layer.w)
            biases.append(layer.b)
        for ci, layer in enumerate(model.color_layer):
            w = layer.w
            if ci == 0:
                w = torch.cat([w[:h], _pad_rows(w[h:], k_dir)], dim=0)
            weights.append(w)
            biases.append(layer.b)

        w_offsets, b_offsets, w_total, b_total = [], [], 0, 0
        for w, b in zip(weights, biases):
            w_offsets.append(w_total)
            b_offsets.append(b_total)
            w_total += _round_up(w.numel(), _ALIGN)
            b_total += _round_up(b.numel(), _ALIGN)
        device = weights[0].device
        flat = torch.zeros(w_total, dtype=model.compute_dtype, device=device)
        biases_flat = torch.zeros(b_total, dtype=torch.float32, device=device)
        w_views, b_views = [], []
        for w, b, wo, bo in zip(weights, biases, w_offsets, b_offsets):
            wv = flat[wo : wo + w.numel()].view(w.shape)
            wv.copy_(w)
            bv = biases_flat[bo : bo + b.numel()]
            bv.copy_(b)
            w_views.append(wv)
            b_views.append(bv)

    return PackedNerfMlp(
        flat=flat,
        biases_flat=biases_flat,
        weights=tuple(w_views),
        biases=tuple(b_views),
        w_offsets=tuple(w_offsets),
        b_offsets=tuple(b_offsets),
        n_layers=model.n_layers,
        input_skips=tuple(model.input_skips),
        n_freq_xyz=model.n_harmonic_functions_xyz,
        append_xyz=bool(model.harmonic_functions_xyz_append_intput),
        n_freq_dir=model.n_harmonic_functions_dir,
        append_dir=bool(model.harmonic_functions_dir_append_intput),
        n_extra_color=model.n_extra_color_layers,
        hidden=h,
        hidden_dir=model.n_hidden_neurons_dir,
        color_dim=model.color_dim,
        compute_dtype=model.compute_dtype,
    )


@contextlib.contextmanager
def no_tf32():
    """Full float32 matrix products on the card for the duration of the block."""
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def embed_padded(x: torch.Tensor, n_freq: int, append_input: bool, k_pad: int) -> torch.Tensor:
    """The kernel's embedding of ``x (N, 3)``: ``sin | sin(. + pi/2) | x | 0-pad``, float32."""
    freqs = torch.as_tensor(harmonic_frequencies(n_freq), dtype=torch.float32, device=x.device)
    t = (x[..., None] * freqs).reshape(x.shape[0], -1)
    half_pi = torch.tensor(math.pi / 2.0, dtype=torch.float32, device=x.device)
    parts = [torch.sin(t), torch.sin(t + half_pi)] + ([x] if append_input else [])
    emb = torch.cat(parts, dim=-1)
    return F.pad(emb, (0, k_pad - emb.shape[-1]))


def nerf_mlp_fwd_plain(packed: PackedNerfMlp, points: torch.Tensor, dirs: torch.Tensor, pts_per_ray: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel.

    Args:
        points: ``(N, 3)`` float32 ray points, ``pts_per_ray`` consecutive
            points per ray.
        dirs: ``(N / pts_per_ray, 3)`` float32 unnormalized ray directions.

    Returns:
        ``(N, 1 + color_dim)`` float32: density | rgb.
    """
    cd = packed.compute_dtype
    h = packed.hidden
    w, b = packed.weights, packed.biases

    def mm(a, wt):
        return a.float() @ wt.float()

    with no_tf32():
        emb = embed_padded(points, packed.n_freq_xyz, packed.append_xyz, packed.k_xyz).to(cd)
        d = dirs.repeat_interleave(pts_per_ray, dim=0)
        norm = torch.sqrt(torch.clamp(torch.sum(d * d, dim=-1, keepdim=True), min=1e-24))
        demb = embed_padded(d / norm, packed.n_freq_dir, packed.append_dir, packed.k_dir).to(cd)

        y = emb
        for li in range(packed.n_layers):
            if li in packed.input_skips and li > 0:
                acc = mm(y, w[li][:h]) + mm(emb, w[li][h:])
            else:
                acc = mm(y, w[li])
            y = F.relu(acc + b[li]).to(cd)

        l_int, l_den, l_c0 = packed.n_layers, packed.n_layers + 1, packed.n_layers + 2
        density = mm(y, w[l_den]) + b[l_den]
        inter = (mm(y, w[l_int]) + b[l_int]).to(cd)
        color = F.relu(mm(inter, w[l_c0][:h]) + mm(demb, w[l_c0][h:]) + b[l_c0]).to(cd)
        for e in range(packed.n_extra_color):
            color = F.relu(mm(color, w[l_c0 + 1 + e]) + b[l_c0 + 1 + e]).to(cd)
        l_last = l_c0 + 1 + packed.n_extra_color
        color = torch.sigmoid(mm(color, w[l_last]) + b[l_last])
        return torch.cat([density, color], dim=-1)


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc was not found: the fused NeRF-MLP kernel cannot be built")
    return nvcc


def _library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libnerf_mlp_fwd_{digest}.so"


def build() -> Path:
    """Compile ``csrc/nerf_mlp_fwd.cu`` into a shared library, cached by content.

    The compiler's report is kept beside the library (``.log``).
    """
    out = _library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, str(SOURCE)], capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}")
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)
    return out


def build_report() -> str:
    """The ptxas lines of the last build: registers, spills, shared memory."""
    log = _library_path().with_suffix(".log")
    lines = log.read_text().splitlines() if log.exists() else []
    return "; ".join(line.split(":", 1)[-1].strip() for line in lines if "registers" in line or "spill" in line)


def _library():
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            fn = lib.nerf_mlp_fwd_bf16
            fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 11 + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def load() -> float:
    """Build (if needed) and load the kernel library; returns the seconds it took."""
    t0 = time.perf_counter()
    _library()
    return time.perf_counter() - t0


def _check_cuda_inputs(packed: PackedNerfMlp, points: torch.Tensor, dirs: torch.Tensor, pts_per_ray: int) -> None:
    if packed.compute_dtype != torch.bfloat16:
        raise NotImplementedError("the CUDA kernel computes in bfloat16 only; float32 runs on the plain version")
    if (packed.hidden, packed.hidden_dir) != (KERNEL_HIDDEN, KERNEL_HIDDEN_DIR):
        raise NotImplementedError(
            f"the CUDA kernel is compiled for hidden widths {KERNEL_HIDDEN}/{KERNEL_HIDDEN_DIR}, "
            f"got {packed.hidden}/{packed.hidden_dir}"
        )
    if packed.k_xyz > KERNEL_MAX_K_XYZ or packed.k_dir > KERNEL_MAX_K_DIR:
        raise NotImplementedError(
            f"the CUDA kernel takes embeddings up to {KERNEL_MAX_K_XYZ}/{KERNEL_MAX_K_DIR} wide, "
            f"got {packed.k_xyz}/{packed.k_dir}"
        )
    for name, t in (("points", points), ("dirs", dirs)):
        if t.dtype != torch.float32 or t.dim() != 2 or t.shape[1] != 3 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 (n, 3) tensor, got {tuple(t.shape)} {t.dtype}")
        if t.device != points.device:
            raise ValueError(f"{name} is on {t.device}, points on {points.device}")
    if packed.flat.device != points.device:
        raise ValueError(f"the packed weights are on {packed.flat.device}, the points on {points.device}")
    if pts_per_ray < 1 or points.shape[0] != dirs.shape[0] * pts_per_ray:
        raise ValueError(f"{points.shape[0]} points do not make {dirs.shape[0]} rays of {pts_per_ray}")


def nerf_mlp_fwd(packed: PackedNerfMlp, points: torch.Tensor, dirs: torch.Tensor, pts_per_ray: int) -> torch.Tensor:
    """Fused forward: ``(N, 3)`` points and ``(N / pts_per_ray, 3)`` dirs -> ``(N, 1 + C)``.

    CPU tensors go through :func:`nerf_mlp_fwd_plain`; CUDA tensors launch
    the kernel or raise.
    """
    global launches
    if points.device.type == "cpu":
        return nerf_mlp_fwd_plain(packed, points, dirs, pts_per_ray)
    if points.device.type != "cuda":
        raise ValueError(f"unsupported device {points.device}")
    _check_cuda_inputs(packed, points, dirs, pts_per_ray)
    n = points.shape[0]
    out = torch.empty((n, 1 + packed.color_dim), dtype=torch.float32, device=points.device)
    w_off = (ctypes.c_longlong * len(packed.w_offsets))(*packed.w_offsets)
    b_off = (ctypes.c_longlong * len(packed.b_offsets))(*packed.b_offsets)
    skip_mask = sum(1 << s for s in packed.input_skips if 0 < s < packed.n_layers)
    with torch.cuda.device(points.device):
        stream = torch.cuda.current_stream(points.device).cuda_stream
        rc = _library().nerf_mlp_fwd_bf16(
            points.data_ptr(), dirs.data_ptr(), out.data_ptr(),
            packed.flat.data_ptr(), packed.biases_flat.data_ptr(),
            ctypes.addressof(w_off), ctypes.addressof(b_off), len(packed.w_offsets),
            n, pts_per_ray, packed.n_layers, skip_mask,
            packed.n_freq_xyz, int(packed.append_xyz), packed.n_freq_dir, int(packed.append_dir),
            packed.n_extra_color, packed.color_dim, stream,
        )
    if rc != 0:
        raise RuntimeError(f"nerf_mlp_fwd kernel launch failed with CUDA error {rc}")
    launches += 1
    return out


def flops_per_point(packed: PackedNerfMlp) -> int:
    """Operations (2 per multiply-add) per point, as the Pallas cost estimate counts them.

    Counts the model's own widths (63/27 embedding rows), the work the
    function needs, not the kernel's padding.
    """
    h, hd = packed.hidden, packed.hidden_dir
    kx = 3 * (2 * packed.n_freq_xyz + int(packed.append_xyz))
    kd = 3 * (2 * packed.n_freq_dir + int(packed.append_dir))
    n_skips = len([s for s in packed.input_skips if 0 < s < packed.n_layers])
    macs = (
        kx * h
        + (packed.n_layers - 1) * h * h
        + n_skips * kx * h
        + h * (h + 1)
        + (h + kd) * hd
        + packed.n_extra_color * hd * hd
        + hd * packed.color_dim
    )
    return 2 * macs


def weight_bytes(packed: PackedNerfMlp) -> int:
    """Bytes of the packed weights and biases (read once per launch at the least)."""
    return packed.flat.numel() * packed.flat.element_size() + packed.biases_flat.numel() * 4
