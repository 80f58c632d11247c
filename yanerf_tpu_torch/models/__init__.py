"""Implicit-function models of the port (``nn.Module``s)."""

from __future__ import annotations

from ..utils.registry import register_not_ported
from .builder import MODELS
from .nerf_mlp import NeRFMLP
from .proposal_mlp import ProposalMLP

register_not_ported(MODELS, ("MipNeRFMLP", "HashGridNeRF", "ZeroOutputer"))

__all__ = ["MODELS", "NeRFMLP", "ProposalMLP"]
