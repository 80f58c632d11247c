"""Proposal-sampler losses: the interlevel histogram loss and distortion.

Counterpart of ``yanerf_tpu/ops/proposal.py``. The reference pins both
contractions to full float32 (``Precision.HIGHEST``). Here they are written
as broadcast multiply-sums instead of ``einsum``: elementwise float32
arithmetic never takes the TF32 path on the card, so no global precision
switch is needed.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["distortion_loss", "interlevel_loss"]


def _intervals(lengths: torch.Tensor, weights: torch.Tensor):
    """Drop the sentinel interval: the last weight belongs to ``[t_{P-1}, inf)``."""
    return lengths[..., :-1], lengths[..., 1:], weights[..., :-1]


def interlevel_loss(
    final_lengths: torch.Tensor,
    final_weights: torch.Tensor,
    prop_lengths: torch.Tensor,
    prop_weights: torch.Tensor,
    eps: float = 1e-7,
) -> torch.Tensor:
    """Per-ray proposal consistency loss, ``(...,)``."""
    t_lo, t_hi, w = _intervals(final_lengths.detach(), final_weights.detach())
    that_lo, that_hi, what = _intervals(prop_lengths.detach(), prop_weights)

    overlap = (
        (that_lo[..., None, :] <= t_hi[..., :, None]) & (that_hi[..., None, :] >= t_lo[..., :, None])
    ).to(torch.float32)
    w_outer = torch.sum(what.to(torch.float32)[..., None, :] * overlap, dim=-1)

    w = w.to(torch.float32)
    excess = F.relu(w - w_outer)
    return torch.sum(excess * excess / (w + eps), dim=-1)


def distortion_loss(
    lengths: torch.Tensor,
    weights: torch.Tensor,
    in_disparity: bool = False,
    near: torch.Tensor = None,
    far: torch.Tensor = None,
) -> torch.Tensor:
    """Per-ray distortion regularizer (mip-NeRF 360 eq. 15), ``(...,)``."""
    t_lo, t_hi, w = _intervals(lengths.detach(), weights)
    if in_disparity:
        g = lambda t: -1.0 / torch.clamp(t, min=1e-9)  # noqa: E731
        t_lo, t_hi = g(t_lo), g(t_hi)
    else:
        g = lambda t: t  # noqa: E731
    g_near = t_lo[..., :1] if near is None else g(near.detach())
    g_far = t_hi[..., -1:] if far is None else g(far.detach())
    span = torch.clamp(g_far - g_near, min=1e-9)
    mids = (0.5 * (t_lo + t_hi) - g_near) / span
    deltas = (t_hi - t_lo) / span

    w = w.to(torch.float32)
    mids = mids.to(torch.float32)
    cross = torch.abs(mids[..., :, None] - mids[..., None, :])
    inter = torch.sum(w[..., :, None] * w[..., None, :] * cross, dim=(-2, -1))
    intra = torch.sum(w * w * deltas.to(torch.float32), dim=-1) / 3.0
    return inter + intra
