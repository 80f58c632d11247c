"""Density-only proposal MLP, the sampler model of the proposal estimator.

Counterpart of ``yanerf_tpu/models/proposal_mlp.py::ProposalMLP``:
harmonic embedding -> ``n_layers`` x ``hidden_dim`` Linear+ReLU -> raw
density. ``rays_features`` is a zero placeholder. With ``contract_coords``
the points are contracted (``ops/rays.py::contract_points``) before the
embedding. With ``latent_dim > 0`` the per-batch ``global_codes`` are
concatenated onto the embedding (``layers.concat_global_codes``) before the
cast to ``compute_dtype``, in the JAX package's order: in a multi-scene
setting the proposal density is scene-dependent too.

The device picks how the forward runs, and no option does. On CUDA points
with no gradient to carry (serving, eval frames, the tools), a bfloat16
model runs K7, the hand-written kernel of the whole forward
(``ops/kernels/proposal_mlp_fwd.py``), on weights packed once and rewritten
in place after they change; widths K7 does not take
(``proposal_mlp_fwd.takes_widths``) raise. The model's own layers run on
CPU points, under autograd (training keeps its activations for the
backward) and for a float32 model (K7 computes in bf16). K7 rounds where
the kernels round (float32 bias adds, an unrounded density), not where the
eager bf16 layers do. ``bake_packed_weights`` freezes the packed weights
as buffers for a traced program (``export.py``).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.harmonics import harmonic_embedding, harmonic_embedding_dim
from ..ops.kernels import proposal_mlp_fwd as K7
from ..ops.rays import contract_points, ray_bundle_to_ray_points
from .builder import MODELS
from .layers import Linear, PackedWeights, concat_global_codes, init_linear_xavier, linear
from .nerf_mlp import as_torch_dtype


@MODELS.register_module()
class ProposalMLP(PackedWeights, nn.Module):
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

    # -- K7's weights (``PackedWeights``) -------------------------------------------
    def _pack(self) -> K7.PackedProposalMlp:
        return K7.pack_weights(self)

    def _repack(self, packed: K7.PackedProposalMlp) -> K7.PackedProposalMlp:
        return K7.repack_weights_(packed, self)

    def bake_packed_weights(self) -> None:
        """Hold K7's packed weights as the buffers ``packed_flat`` / ``packed_biases``, in place of the
        parameters, which are dropped: the module then computes with K7 alone (a traced program's state)."""
        if not (self.compute_dtype == torch.bfloat16 and self.density_layer.w.is_cuda):
            raise ValueError("only a bfloat16 ProposalMLP on the card runs K7 and can bake its weights")
        self._bake([*self.mlp, self.density_layer])

    def on_kernel(self, points: torch.Tensor, global_codes: Optional[torch.Tensor] = None) -> bool:
        """Whether a forward on ``points`` runs K7: a baked model always; else bfloat16 CUDA points with no
        gradient to carry."""
        if self._baked is not None:
            return True
        if not points.is_cuda or self.compute_dtype != torch.bfloat16:
            return False
        if not torch.is_grad_enabled():
            return True
        tensors = [points, *self.parameters()] + ([] if global_codes is None else [global_codes])
        return not any(t.requires_grad for t in tensors)

    def _points(self, origins: torch.Tensor, directions: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
        """The ray points ``(B, *spatial, P, 3)``, contracted with ``contract_coords``."""
        points = ray_bundle_to_ray_points(origins, directions, lengths)
        return contract_points(points) if self.contract_coords else points

    def forward(
        self,
        origins: torch.Tensor,
        directions: torch.Tensor,
        lengths: torch.Tensor,
        global_codes: Optional[torch.Tensor] = None,
        **kwargs,
    ) -> Dict[str, Any]:
        points = self._points(origins, directions, lengths)
        if self.on_kernel(points, global_codes):
            raw_density = K7.proposal_mlp_fwd(self.packed_weights(), points.reshape(-1, 3).contiguous(),
                                              global_codes).reshape(*points.shape[:-1], 1)
        else:
            x = harmonic_embedding(
                points, self.n_harmonic_functions_xyz, append_input=self.harmonic_functions_xyz_append_intput
            )
            x = concat_global_codes(x, global_codes, self.latent_dim).to(self.compute_dtype)
            for layer in self.mlp:
                x = F.relu(linear(layer, x, self.compute_dtype))
            raw_density = linear(self.density_layer, x, self.compute_dtype).to(torch.float32)
        features = torch.zeros((*raw_density.shape[:-1], self.color_dim), dtype=torch.float32, device=raw_density.device)
        return dict(rays_densities=raw_density, rays_features=features, aux={})
