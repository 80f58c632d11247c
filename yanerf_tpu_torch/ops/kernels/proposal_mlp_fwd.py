"""The ProposalMLP forward on the card: K7, the operator ``yanerf_tpu_torch::proposal_mlp_fwd``.

Counterpart of ``yanerf_tpu/models/proposal_mlp.py::ProposalMLP.apply``,
which the JAX package leaves to XLA: no Pallas kernel stands behind it.
``csrc/proposal_mlp_fwd.cu`` says what bounds it and what the design does
about it.

* ``takes_widths`` is the one predicate of the widths K7 takes: 128-wide
  layers, 1 to ``KERNEL_MAX_LAYERS`` of them (their weights held in a
  block's shared memory), a harmonic embedding of at most
  ``KERNEL_EMBEDDING`` columns. ``check_widths`` raises, naming them, for
  any other.
* ``pack_weights`` lays a ``ProposalMLP``'s weights out as K7 reads them:
  one bf16 buffer of 128-wide rows (W0's embedding rows padded to 64, each
  later layer's 128 rows, the density head's weights as one row, then a
  latent model's code rows of W0) and one float32 buffer of the biases
  (layer l's at 128 l, the head's at 128 ``n_layers``). The buffers are
  never inference tensors, so a pack first made while serving is rewritten
  in place (``repack_weights_``) after a train step.
* ``first_layer_bias`` is layer 0's bias as rows: one row, or, for a latent
  model, one per batch element with the codes' product with W0's code rows
  folded in (bf16 codes and weights, float32 sum).
* ``proposal_mlp_fwd_plain`` is the plain version. It mirrors K7, not the
  eager model: float32 bias adds after float32 accumulation of bf16
  products, bf16 rounding at each layer's output, ``cos(t)`` as
  ``sin(t + pi/2)``, the head summed in float32 from the last layer's bf16
  output, no rounding of the density. It runs with TF32 off.
* ``proposal_mlp_fwd_op`` is ``torch.ops.yanerf_tpu_torch.proposal_mlp_fwd``
  (``torch.library.custom_op``, with a fake implementation for tracing):
  ``(n, 3)`` float32 points -> ``(n, 1)`` float32 raw density. Its CPU
  kernel is the plain version; on CUDA tensors it launches K7 or raises (no
  fallback). It allocates only its output and never synchronises, so a
  CUDA graph captures it.
* ``launches`` counts K7's launches, each launch of a replayed CUDA graph
  too (``launch_count.py``).
"""

from __future__ import annotations

import ctypes
import dataclasses
import sys
from typing import Optional

import torch
import torch.nn.functional as F

from ..harmonics import harmonic_embedding_dim
from . import launch_count
from ._build import CudaLibrary
from .nerf_mlp_fwd import embed_padded, no_tf32

launches = 0  # kernel launches since import (or since a caller reset them)

KERNEL_HIDDEN = 128  # the layers' width K7 is compiled for
KERNEL_MAX_LAYERS = 6  # csrc/proposal_mlp_fwd.cu: six layers' weights fill a block's shared memory
KERNEL_EMBEDDING = 64  # the embedding's padded width: 10 frequencies and x, 63 -> 64


def _bind(lib: ctypes.CDLL) -> None:
    c_int, c_ll, c_void_p = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p
    lib.proposal_mlp_fwd_bf16.argtypes = [c_void_p, c_void_p, c_void_p, c_ll, c_void_p, c_void_p, c_int, c_ll, c_int,
                                          c_int, c_int, c_int, c_void_p]
    lib.proposal_mlp_fwd_bf16.restype = c_int


LIBRARY = CudaLibrary("proposal_mlp_fwd.cu", _bind)
build, build_report, load = LIBRARY.build, LIBRARY.build_report, LIBRARY.load


def takes_widths(hidden_dim: int, n_layers: int, n_freq: int, append: bool) -> bool:
    """Whether K7 takes a ProposalMLP of these widths."""
    return (hidden_dim == KERNEL_HIDDEN and 1 <= n_layers <= KERNEL_MAX_LAYERS and n_freq >= 0
            and harmonic_embedding_dim(3, n_freq, append) <= KERNEL_EMBEDDING)


def check_widths(hidden_dim: int, n_layers: int, n_freq: int, append: bool) -> None:
    if not takes_widths(hidden_dim, n_layers, n_freq, append):
        columns = harmonic_embedding_dim(3, n_freq, append)
        raise NotImplementedError(
            f"K7 takes {KERNEL_HIDDEN}-wide layers, 1 to {KERNEL_MAX_LAYERS} of them (their weights held in a "
            f"block's shared memory), and a harmonic embedding of at most {KERNEL_EMBEDDING} columns; got "
            f"hidden_dim {hidden_dim}, {n_layers} layers and {columns} embedding columns")


def _layer_rows(layer: int) -> slice:
    """Layer ``layer``'s rows of the packed weights: W0's 64 (the embedding's, padded), 128 for each later one."""
    return slice(0, 64) if layer == 0 else slice(64 * (2 * layer - 1), 64 * (2 * layer + 1))


def _head_row(n_layers: int) -> int:
    return 64 * (2 * n_layers - 1)


@dataclasses.dataclass(frozen=True)
class PackedProposalMlp:
    """A ProposalMLP's weights as K7 reads them, with its architecture."""

    flat: torch.Tensor  # bf16, 128-wide rows: the layers, the head's row, the latent code rows of W0
    biases_flat: torch.Tensor  # float32: layer l's bias at 128 l, the head's at 128 n_layers
    n_layers: int
    n_freq: int
    append: bool
    latent_dim: int

    @property
    def layout(self) -> tuple:
        """The operator's arguments after the first bias's: ints only."""
        return self.n_layers, self.n_freq, self.append

    def latent_rows(self) -> torch.Tensor:
        """W0's rows of the latent codes, ``(latent_dim, 128)``."""
        first = _head_row(self.n_layers) + 1
        return self.flat.view(-1, KERNEL_HIDDEN)[first : first + self.latent_dim]


def pack_weights(model) -> PackedProposalMlp:
    """K7's buffers for a ``ProposalMLP`` (of widths ``takes_widths`` takes), filled by :func:`repack_weights_`."""
    n_freq, append = model.n_harmonic_functions_xyz, bool(model.harmonic_functions_xyz_append_intput)
    check_widths(model.hidden_dim, model.n_layers, n_freq, append)
    device = model.density_layer.w.device
    rows = _head_row(model.n_layers) + 1 + model.latent_dim
    with torch.inference_mode(False):
        flat = torch.zeros(rows * KERNEL_HIDDEN, dtype=torch.bfloat16, device=device)
        biases_flat = torch.zeros(model.n_layers * KERNEL_HIDDEN + 1, dtype=torch.float32, device=device)
    packed = PackedProposalMlp(flat, biases_flat, model.n_layers, n_freq, append, model.latent_dim)
    return repack_weights_(packed, model)


def repack_weights_(packed: PackedProposalMlp, model) -> PackedProposalMlp:
    """Write ``model``'s weights into ``packed``'s buffers in place: the bits of a fresh ``pack_weights``.

    Only the parameters' own entries are written: W0's padding rows keep
    the zeros of the first pack.
    """
    emb = harmonic_embedding_dim(3, packed.n_freq, packed.append)
    w = packed.flat.view(-1, KERNEL_HIDDEN)
    with torch.inference_mode(False), torch.no_grad():
        for layer, linear in enumerate(model.mlp):
            if layer == 0:
                w[:emb].copy_(linear.w[:emb])  # the code rows of a latent model go below the head's row
            else:
                w[_layer_rows(layer)].copy_(linear.w)
            packed.biases_flat[KERNEL_HIDDEN * layer : KERNEL_HIDDEN * (layer + 1)].copy_(linear.b)
        w[_head_row(packed.n_layers)].copy_(model.density_layer.w[:, 0])
        packed.biases_flat[-1:].copy_(model.density_layer.b)
        packed.latent_rows().copy_(model.mlp[0].w[emb:])
    return packed


def first_layer_bias(packed: PackedProposalMlp, codes: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Layer 0's bias as ``(rows, 128)`` float32: the bias itself, or with ``codes`` ``(B, latent_dim)`` one row
    per batch element, ``b0 + bf16(codes) @ W0's code rows`` summed in float32."""
    b0 = packed.biases_flat[:KERNEL_HIDDEN]
    if codes is None:
        return b0.view(1, KERNEL_HIDDEN)
    codes = codes.reshape(codes.shape[0], -1)
    if codes.shape[-1] != packed.latent_dim:
        raise ValueError(f"global_codes dim {codes.shape[-1]} is incompatible with latent_dim {packed.latent_dim}")
    with no_tf32():
        return b0 + codes.to(torch.bfloat16).float() @ packed.latent_rows().float()


def proposal_mlp_fwd_plain(points: torch.Tensor, flat: torch.Tensor, biases_flat: torch.Tensor,
                           first_bias: torch.Tensor, points_per_bias_row: int, n_layers: int, n_freq: int,
                           append: bool) -> torch.Tensor:
    """The plain version: ``(n, 3)`` float32 points -> ``(n, 1)`` float32 raw density, K7's arithmetic.

    Point ``g`` takes row ``g // points_per_bias_row`` of ``first_bias``
    (the last row past the end), as K7 does.
    """
    w = flat.view(-1, KERNEL_HIDDEN)
    with no_tf32():
        y = embed_padded(points, n_freq, append, KERNEL_EMBEDDING).to(torch.bfloat16)
        b0 = first_bias
        if first_bias.shape[0] > 1:
            rows = torch.arange(points.shape[0], device=points.device) // points_per_bias_row
            b0 = first_bias[rows.clamp(max=first_bias.shape[0] - 1)]
        for layer in range(n_layers):
            b = b0 if layer == 0 else biases_flat[KERNEL_HIDDEN * layer : KERNEL_HIDDEN * (layer + 1)]
            y = F.relu(y.float() @ w[_layer_rows(layer)].float() + b).to(torch.bfloat16)
        return y.float() @ w[_head_row(n_layers)].float()[:, None] + biases_flat[KERNEL_HIDDEN * n_layers]


@torch.library.custom_op("yanerf_tpu_torch::proposal_mlp_fwd", mutates_args=())
def proposal_mlp_fwd_op(points: torch.Tensor, flat: torch.Tensor, biases_flat: torch.Tensor,
                        first_bias: torch.Tensor, points_per_bias_row: int, n_layers: int, n_freq: int,
                        append: bool) -> torch.Tensor:
    """K7 as a PyTorch operator, ``torch.ops.yanerf_tpu_torch.proposal_mlp_fwd``: ``(n, 3)`` points, the packed
    buffers and layer 0's bias rows -> ``(n, 1)`` raw density. The plain version on CPU tensors, K7 on CUDA."""
    raise ValueError(f"unsupported device {points.device}")


@proposal_mlp_fwd_op.register_fake
def _(points, flat, biases_flat, first_bias, points_per_bias_row, n_layers, n_freq, append):
    return points.new_empty((points.shape[0], 1), dtype=torch.float32)


proposal_mlp_fwd_op.register_kernel("cpu")(proposal_mlp_fwd_plain)


def _check_cuda_inputs(points, flat, biases_flat, first_bias, points_per_bias_row, n_layers, n_freq, append):
    check_widths(KERNEL_HIDDEN, n_layers, n_freq, append)
    if points.dtype != torch.float32 or points.dim() != 2 or points.shape[1] != 3 or not points.is_contiguous():
        raise ValueError(f"points must be a contiguous float32 (n, 3) tensor, got {tuple(points.shape)} {points.dtype}")
    if points.shape[0] >= 2**31:
        raise ValueError(f"K7 indexes points with 32-bit ints, got {points.shape[0]}")
    rows = _head_row(n_layers) + 1
    if flat.dtype != torch.bfloat16 or not flat.is_contiguous() or flat.numel() % KERNEL_HIDDEN or \
            flat.numel() < rows * KERNEL_HIDDEN:
        raise ValueError(f"the packed weights must be a contiguous bf16 buffer of at least {rows} rows of "
                         f"{KERNEL_HIDDEN}, got {tuple(flat.shape)} {flat.dtype}")
    if biases_flat.dtype != torch.float32 or not biases_flat.is_contiguous() or \
            biases_flat.numel() < KERNEL_HIDDEN * n_layers + 1:
        raise ValueError(f"the packed biases must be a contiguous float32 buffer of {KERNEL_HIDDEN * n_layers + 1}, "
                         f"got {tuple(biases_flat.shape)} {biases_flat.dtype}")
    if first_bias.dtype != torch.float32 or first_bias.dim() != 2 or first_bias.shape[1] != KERNEL_HIDDEN or \
            first_bias.shape[0] < 1 or not first_bias.is_contiguous():
        raise ValueError(f"layer 0's bias must be contiguous float32 rows of {KERNEL_HIDDEN}, got "
                         f"{tuple(first_bias.shape)} {first_bias.dtype}")
    if points_per_bias_row < 1:
        raise ValueError(f"points_per_bias_row must be at least 1, got {points_per_bias_row}")
    if not (points.device == flat.device == biases_flat.device == first_bias.device):
        raise ValueError(f"K7's inputs must share a device, got {points.device}, {flat.device}, "
                         f"{biases_flat.device}, {first_bias.device}")


def _proposal_mlp_fwd_cuda(points, flat, biases_flat, first_bias, points_per_bias_row, n_layers, n_freq, append):
    _check_cuda_inputs(points, flat, biases_flat, first_bias, points_per_bias_row, n_layers, n_freq, append)
    lib = LIBRARY.library()  # raises where the kernel cannot be built
    out = torch.empty((points.shape[0], 1), dtype=torch.float32, device=points.device)
    with torch.cuda.device(points.device):
        rc = lib.proposal_mlp_fwd_bf16(points.data_ptr(), out.data_ptr(), flat.data_ptr(), flat.numel(),
                                       biases_flat.data_ptr(), first_bias.data_ptr(), first_bias.shape[0],
                                       points_per_bias_row, points.shape[0], n_layers, n_freq, int(append),
                                       torch.cuda.current_stream(points.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"proposal_mlp_fwd kernel launch failed with CUDA error {rc}")
    launch_count.count(sys.modules[__name__], "launches")
    return out


proposal_mlp_fwd_op.register_kernel("cuda")(_proposal_mlp_fwd_cuda)


def proposal_mlp_fwd(packed: PackedProposalMlp, points: torch.Tensor,
                     codes: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``(n, 3)`` float32 points -> ``(n, 1)`` raw density through the operator, with ``codes`` ``(B, latent_dim)``
    for a latent model (the points then ``B`` equal runs, one per batch element)."""
    if points.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {points.device}")
    if (codes is None) != (packed.latent_dim == 0):
        raise ValueError(f"latent_dim {packed.latent_dim} with global_codes {None if codes is None else 'given'}")
    first = first_layer_bias(packed, codes)
    n = points.shape[0]
    if n % first.shape[0]:
        raise ValueError(f"{n} points do not split into {first.shape[0]} batch elements")
    return proposal_mlp_fwd_op(points, packed.flat, packed.biases_flat, first, max(n // first.shape[0], 1),
                               *packed.layout)


def flops_per_point(packed: PackedProposalMlp) -> int:
    """Operations (2 per multiply-add) a point: the model's own widths (63 embedding columns), not the padding."""
    h = KERNEL_HIDDEN
    return 2 * (harmonic_embedding_dim(3, packed.n_freq, packed.append) * h + (packed.n_layers - 1) * h * h + h)
