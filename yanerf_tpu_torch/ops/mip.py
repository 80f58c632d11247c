"""Cone marching math for the mip-NeRF model family: the integrated positional encoding (IPE).

Counterpart of ``yanerf_tpu/ops/mip.py`` (mip-NeRF, Barron et al. 2021,
eqs. 7/8/14): each ray sample stands for the conical frustum the pixel's
cone sweeps over the sample's depth interval, moment-matched to a Gaussian
with a diagonal covariance, and the positional encoding is the expectation
of sin/cos under that Gaussian, so frequencies finer than the footprint
fade to zero. The intervals come from the shared ``lengths`` tensor, so
every sampler and renderer stays as it is. The guards are the JAX
package's: the first interval edge is kept above 0 (``finfo.tiny``), the
moment formulas' denominators are floored at 1e-12, and duplicate depths
keep ``t1 >= t0``.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..utils import device_constant
from .harmonics import harmonic_frequencies


def intervals_from_midpoints(lengths: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-sample depth intervals ``(t0, t1)``, each ``(..., P)``, centred on the sorted ``lengths`` (``P >= 2``).

    Interior edges are the midpoints of consecutive samples; the first and
    last extend by half their neighbouring gap, the first kept above 0 (a
    near plane closer than half the first gap would cross the cone's apex).
    """
    mids = 0.5 * (lengths[..., 1:] + lengths[..., :-1])
    first = torch.clamp(lengths[..., :1] - (mids[..., :1] - lengths[..., :1]), min=torch.finfo(lengths.dtype).tiny)
    last = lengths[..., -1:] + (lengths[..., -1:] - mids[..., -1:])
    return torch.cat([first, mids], dim=-1), torch.cat([mids, last], dim=-1)


def intervals_from_boundaries(lengths: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-sample intervals with the samples as their boundaries: sample ``i`` spans ``[lengths[i], lengths[i+1]]``.

    The interval the raymarcher composites density ``i`` over; the last
    sample's interval repeats the previous gap. Duplicate depths keep
    ``t1 >= t0`` (a zero-width interval is the point encoding).
    """
    t0 = lengths
    last_gap = torch.clamp(lengths[..., -1:] - lengths[..., -2:-1], min=torch.finfo(lengths.dtype).tiny)
    t1 = torch.cat([lengths[..., 1:], lengths[..., -1:] + last_gap], dim=-1)
    return t0, torch.maximum(t1, t0)


def conical_frustum_to_gaussian(
    origins: torch.Tensor,
    directions: torch.Tensor,
    t0: torch.Tensor,
    t1: torch.Tensor,
    base_radius: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean ``(..., P, 3)`` and diagonal covariance ``(..., P, 3)`` of the frustum over ``[t0, t1]``.

    The cone's radius is ``base_radius * t``; ``origins`` / ``directions``
    are ``(..., 3)``, the directions unnormalized as the ray sampler casts
    them. The stable ``t_mu`` / ``t_delta`` form of the paper (eq. 7).
    """
    t_mu = 0.5 * (t0 + t1)
    t_delta = 0.5 * (t1 - t0)
    mu_sq, d_sq = t_mu * t_mu, t_delta * t_delta
    denom = torch.clamp(3.0 * mu_sq + d_sq, min=1e-12)
    t_mean = t_mu + 2.0 * t_mu * d_sq / denom
    t_var = d_sq / 3.0 - (4.0 / 15.0) * (d_sq * d_sq * (12.0 * mu_sq - d_sq)) / (denom * denom)
    r_var = (base_radius * base_radius) * (mu_sq / 4.0 + (5.0 / 12.0) * d_sq - (4.0 / 15.0) * (d_sq * d_sq) / denom)

    mean = origins[..., None, :] + t_mean[..., None] * directions[..., None, :]
    d_outer = directions * directions
    d_mag_sq = torch.clamp(torch.sum(d_outer, dim=-1, keepdim=True), min=1e-12)
    null_outer = 1.0 - d_outer / d_mag_sq
    var = t_var[..., None] * d_outer[..., None, :] + r_var[..., None] * null_outer[..., None, :]
    return mean, var


def integrated_harmonic_embedding(
    mean: torch.Tensor,
    var: torch.Tensor,
    n_harmonic_functions: int = 6,
    omega_0: float = 1.0,
    logspace: bool = True,
    append_input: bool = True,
) -> torch.Tensor:
    """The expected harmonic embedding of ``N(mean, diag(var))`` (IPE, eq. 14).

    ``harmonic_embedding``'s layout (frequency-major, ``sin | cos | mean``)
    with each component damped by ``exp(-f^2 var / 2)``: with ``var == 0``
    it is the point embedding of ``mean`` bit for bit.
    """
    freqs = device_constant(("harmonics", n_harmonic_functions, omega_0, logspace),
                            lambda: harmonic_frequencies(n_harmonic_functions, omega_0, logspace), mean.dtype, mean.device)
    angle = (mean[..., None] * freqs).reshape(*mean.shape[:-1], -1)
    damp = torch.exp(-0.5 * (var[..., None] * (freqs * freqs)).reshape(*var.shape[:-1], -1))
    parts = (torch.sin(angle) * damp, torch.cos(angle) * damp)
    return torch.cat((*parts, mean) if append_input else parts, dim=-1)
