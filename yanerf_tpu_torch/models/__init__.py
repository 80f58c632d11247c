"""Implicit-function models of the port (``nn.Module``s): every model of the JAX package's registry."""

from __future__ import annotations

from .builder import MODELS
from .hash_grid import HashGridNeRF
from .mip_nerf import MipNeRFMLP
from .nerf_mlp import NeRFMLP, ZeroOutputer
from .proposal_mlp import ProposalMLP

__all__ = ["MODELS", "HashGridNeRF", "MipNeRFMLP", "NeRFMLP", "ProposalMLP", "ZeroOutputer"]
