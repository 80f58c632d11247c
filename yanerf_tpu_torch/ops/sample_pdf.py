"""Hierarchical importance sampling: inverse-CDF ``sample_pdf``.

Counterpart of ``yanerf_tpu/ops/sample_pdf.py``, with the same gather-free
formulation: each u is matched to its bin by a disjoint interval mask over
the ``(n_samples x n_bins)`` tile, the last bin is half-open, and u at or
above the CDF top is pinned to the top edge.
"""

from __future__ import annotations

from typing import Optional

import torch

from .rays import linspace01


def sample_pdf(
    bins: torch.Tensor,
    weights: torch.Tensor,
    n_samples: int,
    generator: Optional[torch.Generator] = None,
    det: bool = False,
    eps: float = 1e-5,
    stratified: bool = False,
    u: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Draw samples from the piecewise-constant pdf defined by bins/weights.

    Args:
        bins: ``(..., n_bins + 1)`` bin edges.
        weights: ``(..., n_bins)`` non-negative per-bin masses.
        n_samples: number of samples per distribution.
        generator: source of the uniform draws when ``det=False`` and no
            ``u`` is given; with neither the call raises.
        det: deterministic (uniformly spaced u) vs random sampling.
        stratified: with ``det=False``, stratify the draws,
            ``u_i = (i + xi_i) / n``.
        u: optional ``(..., n_samples)`` uniform draws on [0, 1) used in
            place of the generator's (the tests feed the reference's draws);
            stratification is applied to them as to drawn ones.

    Returns:
        ``(..., n_samples)`` samples.
    """
    dtype = bins.dtype
    weights = torch.clamp(weights, min=0.0) + eps
    pdf = weights / torch.sum(weights, dim=-1, keepdim=True)
    cdf = torch.cumsum(pdf, dim=-1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], dim=-1)

    if det:
        u = linspace01(n_samples, dtype=dtype, device=bins.device).expand(*cdf.shape[:-1], n_samples)
    else:
        if u is None:
            if generator is None:
                raise ValueError("random sample_pdf requires a generator or fed-in pdf_u")
            u = torch.rand(
                (*cdf.shape[:-1], n_samples), generator=generator, dtype=dtype, device=bins.device
            )
        if stratified:
            u = (torch.arange(n_samples, dtype=dtype, device=bins.device) + u) / n_samples

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
