"""Hierarchical importance sampling: inverse-CDF ``sample_pdf``.

Counterpart of ``yanerf_tpu/ops/sample_pdf.py``. The draws are made here as
there (the linspace of ``det``, the generator's or the fed ``u``); the
sampling itself is the operator ``yanerf_tpu_torch::sample_pdf``
(``ops/kernels/sample_pdf.py``): on CPU tensors the JAX package's
gather-free formulation (each u matched to its bin by a disjoint interval
mask over the ``(n_samples x n_bins)`` tile, the last bin half-open, u at or
above the CDF top pinned to the top edge), on CUDA tensors the kernel K6,
which computes the same function a ray at a time.
"""

from __future__ import annotations

from typing import Optional

import torch

from .kernels.sample_pdf import sample_pdf_op
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
        ``(..., n_samples)`` samples, detached.
    """
    dtype = bins.dtype
    lead = weights.shape[:-1]
    if det:
        u = linspace01(n_samples, dtype=dtype, device=bins.device).expand(*lead, n_samples)
    elif u is None:
        if generator is None:
            raise ValueError("random sample_pdf requires a generator or fed-in pdf_u")
        u = torch.rand((*lead, n_samples), generator=generator, dtype=dtype, device=bins.device)
    # no gradient flows through the samples (their one caller detaches them)
    return sample_pdf_op(bins.detach(), weights.detach(), u.detach(), stratified and not det, eps)
