"""Fused NeRF-MLP forward: the CUDA kernels' wrapper, their plain version and the weight packing.

Two kernels of one function, as in the JAX package:
  * K1 replaces ``yanerf_tpu/ops/pallas/nerf_mlp_kernel.py::_nerf_mlp_kernel``
    (``nerf_mlp_forward_pallas``): ``csrc/nerf_mlp_fwd.cu``;
  * K2 replaces its pipelined twin ``_nerf_mlp_kernel_pipelined``
    (``nerf_mlp_forward_pallas(..., pipelined=True)``):
    ``csrc/nerf_mlp_fwd_pipelined.cu``, whose idle producer warps embed the
    next tile while the consumer warp groups run the layer chain of the
    current one.
Both run the forward tile engine of ``csrc/nerf_mlp_tile.cuh`` (a persistent
CTA per SM, a TMA weight ring, wgmma products with register epilogues),
which K3's tile pass runs too, and give the same bits. The sources' headers
say what bounds them on the card (operations) and what the design does
about it. As in the JAX package, no config key or model flag reaches K2:
it is chosen at this entry only.

* ``pack_weights`` pads the model's weights in kernel order, with K padded
  to multiples of 16 (63 -> 64 for the xyz embedding, 27 -> 32 for the
  direction embedding, the skip layer's embedding rows likewise), and keeps
  them in one flat buffer of the compute dtype. The biases stay float32.
* ``weight_rows`` is the plan the kernels' tensor maps read: the first row
  of each packed matrix in the (rows, 256) or (rows, 128) view of the flat
  buffer.
* ``nerf_mlp_fwd_plain`` is the plain PyTorch version of the same function.
  It mirrors the Pallas kernel, not the eager model: float32 bias adds after
  float32 accumulation of bf16 products, and ``cos(t)`` as
  ``sin(t + pi/2)``. It runs with TF32 off.
* ``nerf_mlp_fwd_op`` is the operator ``torch.ops.yanerf_tpu_torch.nerf_mlp_fwd``
  (``torch.library.custom_op``, with a fake implementation for tracing):
  its CUDA kernel launches K1 (or K2 with ``pipelined=True``), its CPU
  kernel is the plain version, chosen by the tensors' device. It never
  falls back on the card. Every K1 / K2 launch of the port goes through it,
  so a traced graph (``export.py``) records it by name.
* ``nerf_mlp_fwd`` calls the operator on a ``PackedNerfMlp``.
* ``repack_weights_`` writes the model's current weights into an earlier
  pack's buffers, at the same addresses (the kernels' tensor maps are
  cached by address, and a captured CUDA graph reads the buffers it saw).
* ``launches`` counts K1's launches, ``pipelined_launches`` K2's, each
  launch of a replayed CUDA graph too (``launch_count.py``).
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import functools
import math
import sys
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F

from ..harmonics import harmonic_frequencies
from . import launch_count
from ._build import CudaLibrary

# kernel launches since import (or since a caller reset them): K1, K2
launches = 0
pipelined_launches = 0

KERNEL_HIDDEN = 256  # xyz hidden width the CUDA kernel is compiled for
KERNEL_HIDDEN_DIR = 128  # color hidden width the CUDA kernel is compiled for
KERNEL_MAX_K_XYZ = 64
KERNEL_MAX_K_DIR = 32
KERNEL_MAX_LAYERS = 8  # the maxima of csrc/nerf_mlp_tile.cuh, shared by K1, K2 and K3
KERNEL_MAX_EXTRA_COLOR = 2
KERNEL_MAX_COLOR = 4
_ALIGN = 64  # every packed tensor starts on a 64-element (128-byte) boundary


def _binder(entry: str):
    def bind(lib: ctypes.CDLL) -> None:
        fn = getattr(lib, entry)
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 11 + [ctypes.c_longlong, ctypes.c_void_p]
        fn.restype = ctypes.c_int

    return bind


LIBRARY = CudaLibrary("nerf_mlp_fwd.cu", _binder("nerf_mlp_fwd_bf16"))
PIPELINED_LIBRARY = CudaLibrary("nerf_mlp_fwd_pipelined.cu", _binder("nerf_mlp_fwd_pipelined_bf16"))
build, build_report, load = LIBRARY.build, LIBRARY.build_report, LIBRARY.load


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

    @functools.cached_property
    def op_layout(self) -> tuple:
        """The operator's arguments after the two buffers: offsets, shapes and architecture, ints and int lists."""
        return (
            list(self.w_offsets), list(self.b_offsets), [d for w in self.weights for d in w.shape], self.n_layers,
            list(self.input_skips), self.n_freq_xyz, self.append_xyz, self.n_freq_dir, self.append_dir,
            self.n_extra_color, self.color_dim,
        )

    @property
    def launch_tables(self):
        """``(w_off, b_off, w_rows)`` as the host int64 arrays the kernels' entry points take, made once."""
        return _host_tables(self.w_offsets, self.b_offsets, weight_rows(self))


def kernel_layers(model) -> List:
    """The NeRFMLP's linear layers in kernel order: xyz layers, intermediate, density, color layers."""
    return list(model.xyz_encoder.mlp) + [model.intermediate_linear, model.density_layer] + list(model.color_layer)


def _embedding_rows(model, i: int) -> Optional[Tuple[int, int, int]]:
    """``(first row, rows, padded rows)`` of the embedding block of weight ``i`` in kernel order, if it has one.

    Layer 0 and the skip layers take the xyz embedding (padded to
    ``k_xyz``), the first color layer the direction embedding after its
    hidden rows (padded to ``k_dir``).
    """
    h = model.n_hidden_neurons_xyz
    if i == 0:
        return 0, model.embedding_dim_xyz, _round_up(model.embedding_dim_xyz, 16)
    if i < model.n_layers and i in model.input_skips:
        return h, model.embedding_dim_xyz, _round_up(model.embedding_dim_xyz, 16)
    if i == model.n_layers + 2:
        return h, model.embedding_dim_dir, _round_up(model.embedding_dim_dir, 16)
    return None


def weight_rows(packed: PackedNerfMlp) -> Tuple[int, ...]:
    """First row of each packed tensor (kernel order) in the view of ``packed.flat`` its tensor map reads.

    The kernels read the xyz layers and the intermediate as row slabs of the
    ``(rows, 256)`` view and the color layers of the ``(rows, 128)`` view of
    the buffer's whole rows: tensor ``i`` of width ``w`` is rows
    ``row .. row + K`` of ``packed.flat[: numel // w * w].view(-1, w)``. The
    two heads (density, color), read by the threads, get -1.
    """
    widths = tuple(w.shape[1] for w in packed.weights)
    return _weight_rows(packed.w_offsets, widths, packed.n_layers, packed.n_extra_color)


@functools.lru_cache(maxsize=64)
def _weight_rows(w_offsets: Tuple[int, ...], widths: Tuple[int, ...], n_layers: int, n_extra_color: int):
    rows = []
    for i, (width, off) in enumerate(zip(widths, w_offsets)):
        if i in (n_layers + 1, n_layers + 3 + n_extra_color):
            rows.append(-1)
            continue
        if off % width:
            raise ValueError(f"packed tensor {i} starts at {off}, not on a row of the ({width}-wide) view")
        rows.append(off // width)
    return tuple(rows)


def unpad_weight(model, i: int, w: torch.Tensor) -> torch.Tensor:
    """Undo ``pack_weights``' padding of weight ``i`` (kernel order): a tensor of the parameter's shape."""
    rows = _embedding_rows(model, i)
    if rows is None:
        return w
    first, n, _ = rows
    return w[: first + n] if first == 0 else torch.cat([w[:first], w[first : first + n]])


def pack_weights(model) -> PackedNerfMlp:
    """Pad and flatten a ``NeRFMLP``'s weights in kernel order.

    Order: xyz layers, intermediate, density, color layers (as
    ``padded_weights`` of the Pallas kernel). Layer 0 and the skip layers
    get their embedding rows padded to ``k_xyz``; the first color layer its
    direction-embedding rows to ``k_dir``.
    """
    if model.latent_dim != 0 or not model.input_xyz or not model.input_dir:
        raise NotImplementedError("the fused kernel covers the standard xyz+dir NeRFMLP")
    for switch in ("skip_affine_trans", "no_last_relu"):
        if getattr(model.xyz_encoder, switch):
            raise NotImplementedError(f"the fused kernel covers the concatenating ReLU trunk, not {switch}")
    h = model.n_hidden_neurons_xyz
    weights: List[torch.Tensor] = []
    biases: List[torch.Tensor] = []
    with torch.no_grad():
        for i, layer in enumerate(kernel_layers(model)):
            w, rows = layer.w, _embedding_rows(model, i)
            if rows is not None:
                first, _, padded = rows
                w = torch.cat([w[:first], F.pad(w[first:], (0, 0, 0, first + padded - w.shape[0]))], dim=0)
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


def repack_weights_(packed: PackedNerfMlp, model) -> PackedNerfMlp:
    """Write ``model``'s weights into ``packed``'s buffers in place: the bits of a fresh ``pack_weights``.

    Only the parameters' own rows are written: the padding rows and the
    alignment gaps keep the zeros of the first pack.
    """
    with torch.no_grad():
        for layer, wv, bv in zip(kernel_layers(model), packed.weights, packed.biases):
            wv[: layer.w.shape[0]].copy_(layer.w)
            bv.copy_(layer.b)
    return packed


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
    if (
        not 1 <= packed.n_layers <= KERNEL_MAX_LAYERS
        or packed.n_extra_color > KERNEL_MAX_EXTRA_COLOR
        or not 1 <= packed.color_dim <= KERNEL_MAX_COLOR
    ):
        raise NotImplementedError(
            f"the CUDA kernels take up to {KERNEL_MAX_LAYERS} xyz layers, {KERNEL_MAX_EXTRA_COLOR} extra color "
            f"layers and {KERNEL_MAX_COLOR} color channels, got {packed.n_layers}, {packed.n_extra_color} and "
            f"{packed.color_dim}"
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


def _op_args(packed: PackedNerfMlp) -> tuple:
    """The op's arguments after ``points, dirs`` that describe ``packed``: its buffers, tables and architecture."""
    return (packed.flat, packed.biases_flat, *packed.op_layout)


def _packed_from_args(
    flat: torch.Tensor, biases_flat: torch.Tensor, w_offsets: List[int], b_offsets: List[int], w_shapes: List[int],
    n_layers: int, input_skips: List[int], n_freq_xyz: int, append_xyz: bool, n_freq_dir: int, append_dir: bool,
    n_extra_color: int, color_dim: int, views: bool = True,
) -> PackedNerfMlp:
    """The ``PackedNerfMlp`` the op's arguments describe; with ``views`` its weight and bias views into the two
    buffers (a launch reads the buffers' addresses and the tables only)."""
    shapes = [tuple(w_shapes[i : i + 2]) for i in range(0, len(w_shapes), 2)]
    weights = tuple(flat[o : o + k * n].view(k, n) for o, (k, n) in zip(w_offsets, shapes)) if views else ()
    biases = tuple(biases_flat[o : o + n] for o, (_, n) in zip(b_offsets, shapes)) if views else ()
    return PackedNerfMlp(
        flat=flat, biases_flat=biases_flat, weights=weights, biases=biases, w_offsets=tuple(w_offsets),
        b_offsets=tuple(b_offsets), n_layers=n_layers, input_skips=tuple(input_skips), n_freq_xyz=n_freq_xyz,
        append_xyz=append_xyz, n_freq_dir=n_freq_dir, append_dir=append_dir, n_extra_color=n_extra_color,
        hidden=shapes[0][1], hidden_dir=shapes[n_layers + 2][1], color_dim=color_dim, compute_dtype=flat.dtype,
    )


@functools.lru_cache(maxsize=64)
def _host_tables(w_offsets: Tuple[int, ...], b_offsets: Tuple[int, ...], w_rows: Tuple[int, ...]):
    """``(w_off, b_off, w_rows)`` as the host int64 arrays the entry points read at each launch, made once."""
    return tuple((ctypes.c_longlong * len(t))(*t) for t in (w_offsets, b_offsets, w_rows))


@torch.library.custom_op("yanerf_tpu_torch::nerf_mlp_fwd", mutates_args=())
def nerf_mlp_fwd_op(
    points: torch.Tensor, dirs: torch.Tensor, flat: torch.Tensor, biases_flat: torch.Tensor, w_offsets: List[int],
    b_offsets: List[int], w_shapes: List[int], n_layers: int, input_skips: List[int], n_freq_xyz: int,
    append_xyz: bool, n_freq_dir: int, append_dir: bool, n_extra_color: int, color_dim: int, pts_per_ray: int,
    pipelined: bool,
) -> torch.Tensor:
    """The fused forward as a PyTorch operator, ``torch.ops.yanerf_tpu_torch.nerf_mlp_fwd``.

    Its arguments are tensors, ints and int lists only (``_op_args``), so
    that a graph can record it: ``torch.export`` writes it into a
    program by name, and the program's consumer imports this module to run
    it. The kernel of the tensors' device runs: K1 (K2 with ``pipelined``)
    on CUDA tensors, the plain version on CPU tensors.
    """
    raise ValueError(f"unsupported device {points.device}")


@nerf_mlp_fwd_op.register_fake
def _(points, dirs, flat, biases_flat, w_offsets, b_offsets, w_shapes, n_layers, input_skips, n_freq_xyz, append_xyz,
      n_freq_dir, append_dir, n_extra_color, color_dim, pts_per_ray, pipelined):
    return points.new_empty((points.shape[0], 1 + color_dim), dtype=torch.float32)


@nerf_mlp_fwd_op.register_kernel("cpu")
def _(points, dirs, flat, biases_flat, w_offsets, b_offsets, w_shapes, n_layers, input_skips, n_freq_xyz, append_xyz,
      n_freq_dir, append_dir, n_extra_color, color_dim, pts_per_ray, pipelined):
    packed = _packed_from_args(flat, biases_flat, w_offsets, b_offsets, w_shapes, n_layers, input_skips, n_freq_xyz,
                               append_xyz, n_freq_dir, append_dir, n_extra_color, color_dim)
    return nerf_mlp_fwd_plain(packed, points, dirs, pts_per_ray)


@nerf_mlp_fwd_op.register_kernel("cuda")
def _(points, dirs, flat, biases_flat, w_offsets, b_offsets, w_shapes, n_layers, input_skips, n_freq_xyz, append_xyz,
      n_freq_dir, append_dir, n_extra_color, color_dim, pts_per_ray, pipelined):
    packed = _packed_from_args(flat, biases_flat, w_offsets, b_offsets, w_shapes, n_layers, input_skips, n_freq_xyz,
                               append_xyz, n_freq_dir, append_dir, n_extra_color, color_dim, views=False)
    _check_cuda_inputs(packed, points, dirs, pts_per_ray)
    n = points.shape[0]
    out = torch.empty((n, 1 + packed.color_dim), dtype=torch.float32, device=points.device)
    rows = _weight_rows(packed.w_offsets, tuple(w_shapes[1::2]), packed.n_layers, packed.n_extra_color)
    w_off, b_off, w_rows = _host_tables(packed.w_offsets, packed.b_offsets, rows)
    skip_mask = sum(1 << s for s in packed.input_skips if 0 < s < packed.n_layers)
    entry = (
        PIPELINED_LIBRARY.library().nerf_mlp_fwd_pipelined_bf16 if pipelined else LIBRARY.library().nerf_mlp_fwd_bf16
    )
    with torch.cuda.device(points.device):
        stream = torch.cuda.current_stream(points.device).cuda_stream
        rc = entry(
            points.data_ptr(), dirs.data_ptr(), out.data_ptr(),
            packed.flat.data_ptr(), packed.biases_flat.data_ptr(),
            ctypes.addressof(w_off), ctypes.addressof(b_off), ctypes.addressof(w_rows), len(packed.w_offsets),
            n, pts_per_ray, packed.n_layers, skip_mask,
            packed.n_freq_xyz, int(packed.append_xyz), packed.n_freq_dir, int(packed.append_dir),
            packed.n_extra_color, packed.color_dim, packed.flat.numel(), stream,
        )
    if rc != 0:
        name = "nerf_mlp_fwd_pipelined" if pipelined else "nerf_mlp_fwd"
        raise RuntimeError(f"{name} kernel launch failed with CUDA error {rc}")
    launch_count.count(sys.modules[__name__], "pipelined_launches" if pipelined else "launches")
    return out


def nerf_mlp_fwd(
    packed: PackedNerfMlp, points: torch.Tensor, dirs: torch.Tensor, pts_per_ray: int, pipelined: bool = False
) -> torch.Tensor:
    """Fused forward: ``(N, 3)`` points and ``(N / pts_per_ray, 3)`` dirs -> ``(N, 1 + C)``.

    Calls the operator :func:`nerf_mlp_fwd_op`: CPU tensors go through
    :func:`nerf_mlp_fwd_plain` (K1 and K2 compute one function); CUDA
    tensors launch K1, or K2 with ``pipelined``, or raise.
    """
    if points.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {points.device}")
    return nerf_mlp_fwd_op(points, dirs, *_op_args(packed), pts_per_ray, pipelined)


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
