"""Density-only proposal MLP, the sampler model of the proposal estimator.

Counterpart of ``yanerf_tpu/models/proposal_mlp.py::ProposalMLP``:
harmonic embedding -> ``n_layers`` x ``hidden_dim`` Linear+ReLU -> raw
density. ``rays_features`` is a zero placeholder. With ``contract_coords``
the points are contracted (``ops/rays.py::contract_points``) before the
embedding. With ``latent_dim > 0`` the per-batch ``global_codes`` are
concatenated onto the embedding (``layers.concat_global_codes``) before the
cast to ``compute_dtype``, in the JAX package's order: in a multi-scene
setting the proposal density is scene-dependent too.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.harmonics import harmonic_embedding, harmonic_embedding_dim
from ..ops.rays import contract_points, ray_bundle_to_ray_points
from .builder import MODELS
from .layers import Linear, concat_global_codes, init_linear_xavier, linear
from .nerf_mlp import as_torch_dtype


@MODELS.register_module()
class ProposalMLP(nn.Module):
    def __init__(
        self,
        n_layers: int = 4,
        hidden_dim: int = 128,
        n_harmonic_functions_xyz: int = 10,
        harmonic_functions_xyz_append_intput: bool = True,
        color_dim: int = 3,
        compute_dtype: str = "float32",
        contract_coords: bool = False,
        latent_dim: int = 0,
        generator: Optional[torch.Generator] = None,
    ) -> None:
        super().__init__()
        self.n_layers = n_layers
        self.hidden_dim = hidden_dim
        self.n_harmonic_functions_xyz = n_harmonic_functions_xyz
        self.harmonic_functions_xyz_append_intput = harmonic_functions_xyz_append_intput
        self.color_dim = color_dim
        self.contract_coords = contract_coords
        self.compute_dtype = as_torch_dtype(compute_dtype)
        self.latent_dim = int(latent_dim)
        self.input_dim = (
            harmonic_embedding_dim(3, n_harmonic_functions_xyz, harmonic_functions_xyz_append_intput) + self.latent_dim
        )
        layers = []
        dim = self.input_dim
        for _ in range(n_layers):
            layers.append(init_linear_xavier(Linear(dim, hidden_dim), generator))
            dim = hidden_dim
        self.mlp = nn.ModuleList(layers)
        self.density_layer = init_linear_xavier(Linear(dim, 1), generator, zero_bias=True)

    def forward(
        self,
        origins: torch.Tensor,
        directions: torch.Tensor,
        lengths: torch.Tensor,
        global_codes: Optional[torch.Tensor] = None,
        **kwargs,
    ) -> Dict[str, Any]:
        points = ray_bundle_to_ray_points(origins, directions, lengths)
        if self.contract_coords:
            points = contract_points(points)
        x = harmonic_embedding(
            points, self.n_harmonic_functions_xyz, append_input=self.harmonic_functions_xyz_append_intput
        )
        x = concat_global_codes(x, global_codes, self.latent_dim).to(self.compute_dtype)
        for layer in self.mlp:
            x = F.relu(linear(layer, x, self.compute_dtype))
        raw_density = linear(self.density_layer, x, self.compute_dtype).to(torch.float32)
        features = torch.zeros((*raw_density.shape[:-1], self.color_dim), dtype=torch.float32, device=raw_density.device)
        return dict(rays_densities=raw_density, rays_features=features, aux={})
