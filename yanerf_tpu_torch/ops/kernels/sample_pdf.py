"""Inverse-CDF sampling on the card: K6, the operator ``yanerf_tpu_torch::sample_pdf``.

Counterpart of the sampling step of ``yanerf_tpu/ops/sample_pdf.py``, which
the JAX package runs as XLA over a ``(rays, samples, bins)`` mask: no Pallas
kernel stands behind it. ``csrc/sample_pdf.cu`` says what bounds it and
what the design does about it.

``sample_pdf_op`` is ``torch.ops.yanerf_tpu_torch.sample_pdf``
(``torch.library.custom_op``, with a fake implementation for tracing):
``(..., n_bins + 1)`` edges, ``(..., n_bins)`` weights and ``(..., n_samples)``
uniform draws -> ``(..., n_samples)`` samples. On CPU tensors it runs
:func:`sample_pdf_plain`; on CUDA tensors it launches K6 or raises (no
fallback). K6 takes float32 rows whose last axis is contiguous, the draws
also as one row for every ray (a stride of 0, as ``linspace01`` expanded),
and at most ``MAX_BINS`` bins. It is deterministic and capturable into a
CUDA graph: no host synchronisation, no allocation but its output.

``launches`` counts K6's launches, each launch of a replayed CUDA graph too
(``launch_count.py``).
"""

from __future__ import annotations

import ctypes
import sys

import torch

from . import launch_count
from ._build import CudaLibrary

launches = 0  # kernel launches since import (or since a caller reset them)

MAX_BINS = 1535  # csrc/sample_pdf.cu: a block's 4 rays' CDFs and edges within 48 KB of shared memory


def _bind(lib: ctypes.CDLL) -> None:
    c_int, c_ll, c_void_p = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p
    lib.sample_pdf_fwd.argtypes = [c_void_p, c_ll, c_void_p, c_ll, c_void_p, c_ll, c_void_p, c_int, c_int, c_int,
                                   c_int, ctypes.c_float, c_void_p]
    lib.sample_pdf_fwd.restype = c_int


LIBRARY = CudaLibrary("sample_pdf.cu", _bind)
build, build_report, load = LIBRARY.build, LIBRARY.build_report, LIBRARY.load


def sample_pdf_plain(bins: torch.Tensor, weights: torch.Tensor, u: torch.Tensor, stratified: bool,
                     eps: float) -> torch.Tensor:
    """The plain version: the pdf ``(clamp(w, min=0) + eps) / sum``, its CDF with 0 in front, then
    :func:`inverse_cdf`."""
    weights = torch.clamp(weights, min=0.0) + eps
    pdf = weights / torch.sum(weights, dim=-1, keepdim=True)
    cdf = torch.cumsum(pdf, dim=-1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], dim=-1)
    return inverse_cdf(bins, cdf, u, stratified, eps)


def inverse_cdf(bins: torch.Tensor, cdf: torch.Tensor, u: torch.Tensor, stratified: bool,
                eps: float) -> torch.Tensor:
    """The gather-free inverse of ``cdf`` ``(..., n_bins + 1)`` over the edges ``bins`` at ``u``: each u matched
    to its bin by a disjoint interval mask over the ``(n_samples x n_bins)`` tile, the last bin half-open, a u at
    or above the CDF top pinned to the top edge."""
    n_samples = u.shape[-1]
    if stratified:
        u = (torch.arange(n_samples, dtype=u.dtype, device=u.device) + u) / n_samples

    cdf_lo = cdf[..., :-1]
    cdf_hi = cdf[..., 1:]
    bins_lo = bins[..., :-1]
    bins_hi = bins[..., 1:]

    n_bins = cdf_lo.shape[-1]
    is_last = torch.arange(n_bins, device=bins.device) == n_bins - 1

    u_e = u[..., :, None]
    lo = cdf_lo[..., None, :]
    hi = cdf_hi[..., None, :]
    in_bin = (lo <= u_e) & ((u_e < hi) | is_last)

    denom = cdf_hi - cdf_lo
    denom = torch.where(denom < eps, torch.ones_like(denom), denom)
    t = (u_e - lo) / denom[..., None, :]
    val = bins_lo[..., None, :] + t * (bins_hi - bins_lo)[..., None, :]
    top = torch.clamp(hi, max=1.0)
    val = torch.where(is_last & (u_e >= top), bins_hi[..., None, :], val)
    return torch.sum(torch.where(in_bin, val, torch.zeros_like(val)), dim=-1)


def k6_cdf(weights: torch.Tensor, eps: float) -> torch.Tensor:
    """K6's CDF ``(..., n_bins + 1)`` in plain ops: the normaliser summed in float64 and rounded to float32, the
    running sum accumulated in float64 and rounded at every prefix (the CPU's ``torch.cumsum`` of a float32 row,
    which is why it runs there). Only these roundings part it from the plain version's CDF."""
    masses = torch.clamp(weights, min=0.0) + eps
    pdf = masses / masses.double().sum(dim=-1, keepdim=True).float()
    cdf = torch.cumsum(pdf.cpu(), dim=-1).to(pdf.device)
    return torch.cat([torch.zeros_like(cdf[..., :1]), cdf], dim=-1)


def k6_arithmetic(bins: torch.Tensor, weights: torch.Tensor, u: torch.Tensor, stratified: bool,
                  eps: float) -> torch.Tensor:
    """K6's function in plain ops, :func:`inverse_cdf` of :func:`k6_cdf`: on CPU tensors K6's samples bit for bit
    (on CUDA tensors the plain ops stratify by a product with 1 / n where K6 divides)."""
    return inverse_cdf(bins, k6_cdf(weights, eps), u, stratified, eps)


@torch.library.custom_op("yanerf_tpu_torch::sample_pdf", mutates_args=())
def sample_pdf_op(bins: torch.Tensor, weights: torch.Tensor, u: torch.Tensor, stratified: bool,
                  eps: float) -> torch.Tensor:
    """K6 as a PyTorch operator, ``torch.ops.yanerf_tpu_torch.sample_pdf``: edges ``(..., B + 1)``, weights
    ``(..., B)`` and draws ``(..., S)`` -> samples ``(..., S)``. The plain version on CPU tensors, K6 on CUDA."""
    raise ValueError(f"unsupported device {u.device}")


@sample_pdf_op.register_fake
def _(bins, weights, u, stratified, eps):
    return u.new_empty(u.shape, dtype=torch.promote_types(torch.promote_types(bins.dtype, weights.dtype), u.dtype))


sample_pdf_op.register_kernel("cpu")(sample_pdf_plain)


def _rows(x: torch.Tensor, name: str, n: int, width: int):
    """``x`` as ``(n, width)`` rows with a contiguous last axis: the view and its row stride (0: one shared row)."""
    if x.dtype != torch.float32:
        raise ValueError(f"K6 takes float32 {name}, got {x.dtype}")
    if x.shape[-1] != width:
        raise ValueError(f"K6's {name} must have {width} entries a ray, got {tuple(x.shape)}")
    if x.stride(-1) != 1:
        x = x.contiguous()
    lead = x.shape[:-1]
    if all(s == 0 for s, size in zip(x.stride()[:-1], lead) if size > 1):
        return x, 0
    rows = x.reshape(n, width)
    return rows, (rows.stride(0) if n > 1 else width)


def _sample_pdf_cuda(bins, weights, u, stratified, eps):
    lib = LIBRARY.library()  # raises where the kernel cannot be built
    if not (bins.device == weights.device == u.device):
        raise ValueError(f"K6's inputs must share a device, got {bins.device}, {weights.device}, {u.device}")
    n_bins, n_samples = weights.shape[-1], u.shape[-1]
    if n_bins > MAX_BINS:
        raise NotImplementedError(f"K6 holds a ray's CDF in shared memory: at most {MAX_BINS} bins, got {n_bins}")
    lead = u.shape[:-1]
    if bins.shape[:-1] != lead or weights.shape[:-1] != lead:
        raise ValueError(f"K6 takes edges, weights and draws over the same rays, got {tuple(bins.shape)}, "
                         f"{tuple(weights.shape)}, {tuple(u.shape)}")
    n = lead.numel()
    bins, bins_row = _rows(bins, "edges", n, n_bins + 1)
    weights, weights_row = _rows(weights, "weights", n, n_bins)
    u, u_row = _rows(u, "draws", n, n_samples)
    out = torch.empty((*lead, n_samples), dtype=torch.float32, device=u.device)
    with torch.cuda.device(u.device):
        rc = lib.sample_pdf_fwd(bins.data_ptr(), bins_row, weights.data_ptr(), weights_row, u.data_ptr(), u_row,
                                out.data_ptr(), n, n_bins, n_samples, int(stratified), float(eps),
                                torch.cuda.current_stream(u.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"sample_pdf kernel launch failed with CUDA error {rc}")
    launch_count.count(sys.modules[__name__], "launches")
    return out


sample_pdf_op.register_kernel("cuda")(_sample_pdf_cuda)
