"""MipNeRFMLP: NeRFMLP on the integrated positional encoding of cone segments (mip-NeRF).

Counterpart of ``yanerf_tpu/models/mip_nerf.py``. The trunk, the heads and
the parameters are NeRFMLP's (a NeRFMLP's weights load into it through
``convert.py``); only the embedding changes: each sample's depth interval
(``interval_mode``: centred on the samples, or the samples as boundaries)
becomes the Gaussian of its conical frustum, and the IPE of that Gaussian
replaces the harmonic embedding of the point (``ops/mip.py``).

It has no fused kernel, as in the JAX package: it refuses ``use_pallas`` /
``use_pallas_train``, and NeRFMLP's kernel machinery (the packed weights)
raises if reached.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from ..ops.mip import (
    conical_frustum_to_gaussian,
    integrated_harmonic_embedding,
    intervals_from_boundaries,
    intervals_from_midpoints,
)
from .builder import MODELS
from .nerf_mlp import NeRFMLP


@MODELS.register_module()
class MipNeRFMLP(NeRFMLP):
    """:class:`NeRFMLP` with the integrated positional encoding over cone segments.

    Args (beyond NeRFMLP's):
        base_radius: the pixel cone's radius per unit depth, ``(2 /
            sqrt(12)) / focal_px`` for a pinhole camera; must be positive.
        interval_mode: ``midpoint`` (intervals centred on the samples, the
            default) or ``boundary`` (sample ``i`` spans ``[lengths[i],
            lengths[i+1]]``, the interval the raymarcher composites over).
    """

    # intervals need two samples per ray, also for point queries
    min_samples_per_ray = 2

    def __init__(self, base_radius: float, interval_mode: str = "midpoint", **kwargs) -> None:
        if base_radius <= 0.0:
            raise ValueError(f"base_radius must be > 0, got {base_radius}")
        if interval_mode not in ("midpoint", "boundary"):
            raise ValueError(f"interval_mode must be 'midpoint' or 'boundary', got {interval_mode!r}")
        if kwargs.get("contract_coords"):
            raise ValueError("MipNeRFMLP does not support contract_coords: the contraction would have to be "
                             "linearized onto the Gaussian; use NeRFMLP with contract_coords for unbounded scenes")
        if kwargs.get("use_pallas") or kwargs.get("use_pallas_train"):
            raise ValueError("MipNeRFMLP has no fused kernel; leave use_pallas and use_pallas_train off")
        if not kwargs.get("input_xyz", True):
            raise ValueError("MipNeRFMLP requires input_xyz=True (the IPE is the model)")
        super().__init__(**kwargs)
        self.base_radius = float(base_radius)
        self.interval_mode = interval_mode

    def packed_weights(self, refresh: bool = False):
        raise RuntimeError("MipNeRFMLP has no fused kernel, so no packed weights")

    def _embed_points(self, origins: torch.Tensor, directions: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
        derive = intervals_from_boundaries if self.interval_mode == "boundary" else intervals_from_midpoints
        t0, t1 = derive(lengths)
        mean, var = conical_frustum_to_gaussian(origins, directions, t0, t1, self.base_radius)
        return integrated_harmonic_embedding(
            mean, var, self.n_harmonic_functions_xyz, append_input=self.harmonic_functions_xyz_append_intput
        )

    def forward(
        self,
        origins: torch.Tensor,
        directions: torch.Tensor,
        lengths: torch.Tensor,
        global_codes: Optional[torch.Tensor] = None,
        use_pallas: Optional[bool] = None,
        **kwargs,
    ) -> Dict[str, Any]:
        """NeRFMLP's outputs at the IPE of each sample's frustum; ``use_pallas`` may only be off."""
        if use_pallas:
            raise ValueError("MipNeRFMLP has no fused kernel; use_pallas must be off")
        if global_codes is not None:
            raise ValueError(f"global_codes given but latent_dim is {self.latent_dim}")
        if lengths.shape[-1] < self.min_samples_per_ray:
            raise ValueError("MipNeRFMLP needs >= 2 samples per ray to form intervals")
        return self._from_embedding(self._embed_points(origins, directions, lengths), directions)
