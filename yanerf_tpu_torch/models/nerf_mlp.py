"""The NeRF implicit function.

Counterpart of ``yanerf_tpu/models/nerf_mlp.py::NeRFMLP``: a harmonic
embedding of the points (10 frequencies) and normalized directions (4), an
``n_layers`` MLP with input skips, a density head and a color head
(intermediate linear -> linear-with-repeat over the direction embedding ->
ReLU -> [extra layers] -> linear -> sigmoid).

Two paths, chosen by ``use_pallas`` (the config keys are the JAX package's,
so both packages read the same configs; in TRAINING the pipeline passes
``use_pallas_train`` in its place):
  * the eager path, the model's own, with the JAX package's bf16 policy;
  * the fused kernels (``ops/kernels/fused_mlp.py``): forward K1
    (``nerf_mlp_fwd``) and, under autograd, backward K3 (``nerf_mlp_bwd``),
    the CUDA kernels on the card, their plain versions on the CPU.
The eager path is the point embedding (``_embed_points``) and the rest
(``_from_embedding``), so that ``MipNeRFMLP`` replaces only the embedding.
Without a gradient to carry (serving, eval) the kernel path calls the
forward operator directly, the same call the autograd Function makes;
``bake_packed_weights`` freezes the packed weights as buffers for a traced
program (``export.py``).
``ZeroOutputer`` is the reference's analytic test model.

With ``contract_coords`` (unbounded scenes) the ray points go through the
mip-NeRF 360 contraction (``ops/rays.py::contract_points``) before either
path: the eager embedding and the kernels both see the contracted points,
as ``make_fused_mlp`` gets them in the JAX package.

With ``latent_dim > 0`` the per-batch ``global_codes`` (a feature
extractor's, ``pipelines/feature_extractors.py``) are broadcast onto the
point embedding (``layers.concat_global_codes``), and ``input_xyz=False``
leaves the codes as the trunk's only input. The kernels compute neither:
the kernel switch is taken only with ``input_xyz`` and ``latent_dim == 0``,
the JAX package's rule, so a latent NeRFMLP runs its eager path whatever
the switch says.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.harmonics import harmonic_embedding, harmonic_embedding_dim
from ..ops.kernels import nerf_mlp_fwd as fused
from ..ops.kernels.fused_mlp import fused_nerf_mlp
from ..ops.rays import contract_points, ray_bundle_to_ray_points
from .builder import MODELS
from .layers import Linear, concat_global_codes, init_linear_default, init_linear_xavier, linear, linear_with_repeat
from .mlp import MLPWithInputSkips


def as_torch_dtype(name) -> torch.dtype:
    """``"bfloat16"`` / ``"float32"`` (the configs' spelling) -> torch dtype."""
    return name if isinstance(name, torch.dtype) else getattr(torch, str(name))


@MODELS.register_module()
class NeRFMLP(nn.Module):
    kernel_arm = "k1k3"  # the training path's halves under use_pallas_train (fused_mlp.ARMS)

    def __init__(
        self,
        n_layers: int = 8,
        input_skips: Sequence[int] = (5,),
        n_harmonic_functions_xyz: int = 10,
        harmonic_functions_xyz_append_intput: bool = True,
        n_hidden_neurons_xyz: int = 256,
        n_harmonic_functions_dir: int = 4,
        harmonic_functions_dir_append_intput: bool = True,
        n_hidden_neurons_dir: int = 128,
        latent_dim: int = 0,
        input_xyz: bool = True,
        input_dir: bool = True,
        color_dim: int = 3,
        nerf_paper_v1: bool = False,
        compute_dtype: str = "float32",
        use_pallas: bool = False,
        use_pallas_train: bool = False,
        contract_coords: bool = False,
        generator: Optional[torch.Generator] = None,
    ) -> None:
        super().__init__()
        if not input_xyz and latent_dim <= 0:
            raise ValueError("The latent dimension has to be > 0 if xyz is not input!")
        self.n_layers = n_layers
        self.input_skips = tuple(input_skips)
        self.n_harmonic_functions_xyz = n_harmonic_functions_xyz
        self.harmonic_functions_xyz_append_intput = harmonic_functions_xyz_append_intput
        self.n_hidden_neurons_xyz = n_hidden_neurons_xyz
        self.n_harmonic_functions_dir = n_harmonic_functions_dir
        self.harmonic_functions_dir_append_intput = harmonic_functions_dir_append_intput
        self.n_hidden_neurons_dir = n_hidden_neurons_dir
        self.latent_dim = latent_dim
        self.input_xyz = input_xyz
        self.input_dir = input_dir
        self.color_dim = color_dim
        self.compute_dtype = as_torch_dtype(compute_dtype)
        self.use_pallas = use_pallas
        self.use_pallas_train = use_pallas_train
        self.contract_coords = contract_coords

        self.embedding_dim_xyz = harmonic_embedding_dim(3, n_harmonic_functions_xyz, harmonic_functions_xyz_append_intput)
        self.embedding_dim_dir = harmonic_embedding_dim(3, n_harmonic_functions_dir, harmonic_functions_dir_append_intput)
        self.input_dim = self.embedding_dim_xyz * int(input_xyz) + latent_dim
        self.n_extra_color_layers = (n_layers // 4) if nerf_paper_v1 else 0

        # parameters are created in the JAX package's init order
        self.xyz_encoder = MLPWithInputSkips(
            n_layers=n_layers,
            input_dim=self.input_dim,
            output_dim=n_hidden_neurons_xyz,
            skip_dim=self.input_dim,
            hidden_dim=n_hidden_neurons_xyz,
            input_skips=self.input_skips,
            compute_dtype=self.compute_dtype,
            generator=generator,
        )
        h = n_hidden_neurons_xyz
        self.intermediate_linear = init_linear_xavier(Linear(h, h), generator)
        self.density_layer = init_linear_xavier(Linear(h, 1), generator, zero_bias=True)
        color_in = h + (self.embedding_dim_dir if input_dir else 0)
        color_layers = [init_linear_default(Linear(color_in, n_hidden_neurons_dir), generator)]
        for _ in range(self.n_extra_color_layers):
            color_layers.append(init_linear_default(Linear(n_hidden_neurons_dir, n_hidden_neurons_dir), generator))
        color_layers.append(init_linear_default(Linear(n_hidden_neurons_dir, color_dim), generator))
        self.color_layer = nn.ModuleList(color_layers)
        self._packed = None  # (key, PackedNerfMlp) of the kernel's weights
        self._baked: Optional[fused.PackedNerfMlp] = None  # the pack whose buffers replaced the parameters

    # -- the fused kernel's weights -------------------------------------------
    def packed_weights(self, refresh: bool = False) -> fused.PackedNerfMlp:
        """The kernel-order, padded weights: packed once, then rewritten in place.

        The buffers keep their addresses for the module's life on one
        device: the kernels cache their tensor maps by address, and a
        captured CUDA graph reads the buffers it was captured with. They are
        rewritten (``repack_weights_``) when ``refresh`` is set (the
        training forward, which repacks unconditionally, also inside a
        captured step where no Python runs) or when a parameter was
        replaced or written to in place since (``_version``), or after
        :meth:`params_changed`. A move to another device packs anew.
        """
        if self._baked is not None:
            return dataclasses.replace(self._baked, flat=self.packed_flat, biases_flat=self.packed_biases)
        key = tuple((p.data_ptr(), p._version) for p in self.parameters())
        if self._packed is None or self._packed[1].flat.device != self.density_layer.w.device:
            self._packed = (key, fused.pack_weights(self))
        elif refresh or self._packed[0] != key:
            self._packed = (key, fused.repack_weights_(self._packed[1], self))
        return self._packed[1]

    def bake_packed_weights(self) -> None:
        """Hold the kernel's packed weights as the buffers ``packed_flat`` / ``packed_biases``, in place of the
        parameters, which are dropped: the module then computes its frame with the kernel alone.

        For a traced program (``export.py``): the buffers are read where the
        operator is called, so the program takes them as its own state; a
        repack in place cannot be traced, and nothing trains a baked model.
        """
        if not (self.use_pallas and self.input_xyz and self.latent_dim == 0):
            raise ValueError("only a NeRFMLP on the fused kernel (use_pallas, no latent) can bake its weights")
        packed = self.packed_weights()
        self.register_buffer("packed_flat", packed.flat)
        self.register_buffer("packed_biases", packed.biases_flat)
        for layer in fused.kernel_layers(self):
            layer._parameters.clear()
        self._baked, self._packed = packed, None
        self._baked_layout = packed.op_layout  # ints and int lists: all a traced launch reads besides the buffers

    def params_changed(self) -> None:
        """The parameters changed where ``_version`` cannot see it (a graph replay): repack at the next use."""
        if self._packed is not None:
            self._packed = (None, self._packed[1])

    # -- forward ----------------------------------------------------------------
    def _get_colors(self, features: torch.Tensor, rays_directions: torch.Tensor) -> torch.Tensor:
        cd = self.compute_dtype
        inter = linear(self.intermediate_linear, features, cd)
        if self.input_dir:
            dir_norm = rays_directions / torch.clamp(
                torch.linalg.vector_norm(rays_directions, dim=-1, keepdim=True), min=1e-12
            )
            rays_embedding = harmonic_embedding(
                dir_norm, self.n_harmonic_functions_dir, append_input=self.harmonic_functions_dir_append_intput
            )
            color = linear_with_repeat(self.color_layer[0], inter, rays_embedding, cd)
        else:
            color = linear(self.color_layer[0], inter, cd)
        color = F.relu(color)
        for layer in self.color_layer[1:-1]:
            color = F.relu(linear(layer, color, cd))
        return torch.sigmoid(linear(self.color_layer[-1], color, cd).to(torch.float32))

    def _points(self, origins: torch.Tensor, directions: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
        """The ray points ``(B, *spatial, P, 3)``, contracted with ``contract_coords``."""
        points = ray_bundle_to_ray_points(origins, directions, lengths)
        return contract_points(points) if self.contract_coords else points

    def _embed_points(self, origins: torch.Tensor, directions: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
        """The harmonic embedding of the ray points ``(B, *spatial, P, embedding_dim_xyz)``; subclasses replace it."""
        points = self._points(origins, directions, lengths)
        return harmonic_embedding(
            points, self.n_harmonic_functions_xyz, append_input=self.harmonic_functions_xyz_append_intput
        )

    def _from_embedding(self, embeds: torch.Tensor, directions: torch.Tensor) -> Dict[str, Any]:
        """The eager path after the embedding: ``xyz_encoder``, the density head and the color head."""
        features = self.xyz_encoder(embeds)
        raw_densities = linear(self.density_layer, features, self.compute_dtype).to(torch.float32)
        rays_colors = self._get_colors(features, directions)
        return dict(rays_densities=raw_densities, rays_features=rays_colors, aux={})

    def eager_flat(self, points: torch.Tensor, dirs: torch.Tensor, pts_per_ray: int) -> torch.Tensor:
        """The eager model on the kernel's inputs: ``(N, 3)`` ray points (contracted where the model contracts)
        and ``(N / pts_per_ray, 3)`` dirs -> ``(N, 1 + C)`` float32, density | rgb."""
        embeds = harmonic_embedding(
            points.reshape(-1, pts_per_ray, 3), self.n_harmonic_functions_xyz,
            append_input=self.harmonic_functions_xyz_append_intput,
        )
        out = self._from_embedding(embeds, dirs)
        return torch.cat([out["rays_densities"], out["rays_features"]], dim=-1).reshape(points.shape[0], -1)

    def forward(
        self,
        origins: torch.Tensor,
        directions: torch.Tensor,
        lengths: torch.Tensor,
        global_codes: Optional[torch.Tensor] = None,
        use_pallas: Optional[bool] = None,
        **kwargs,
    ) -> Dict[str, Any]:
        """Densities ``(B, *spatial, P, 1)`` and colors ``(B, *spatial, P, C)`` at all ray points.

        ``global_codes``: ``(B, latent_dim)`` (or ``(B, N, D)`` with ``N * D
        == latent_dim``), required exactly when ``latent_dim > 0``.
        """
        use_pallas = self.use_pallas if use_pallas is None else use_pallas
        use_pallas = use_pallas and self.input_xyz and self.latent_dim == 0
        if self._baked is not None and not use_pallas:
            raise ValueError("a NeRFMLP with baked weights computes on the fused kernel only")
        if use_pallas:
            if global_codes is not None:  # latent_dim is 0 here
                raise ValueError(f"global_codes dim {global_codes.reshape(global_codes.shape[0], -1).shape[-1]} "
                                 f"is incompatible with latent_dim {self.latent_dim}")
            points = self._points(origins, directions, lengths)
            *lead, n_pts, _ = points.shape
            points, dirs = points.reshape(-1, 3).contiguous(), directions.reshape(-1, 3).contiguous()
            if self._baked is not None:
                # the two buffers and the layout: a traced program's body reads no other tensor of the pack
                out = fused.nerf_mlp_fwd_op(points, dirs, self.packed_flat, self.packed_biases, *self._baked_layout,
                                            n_pts, False)
            elif not torch.is_grad_enabled():
                # no gradient to carry: the operator alone, as the Function's forward calls it
                out = fused.nerf_mlp_fwd(self.packed_weights(), points, dirs, n_pts)
            else:
                out = fused_nerf_mlp(self, points, dirs, n_pts, self.kernel_arm)
            return dict(
                rays_densities=out[:, :1].reshape(*lead, n_pts, 1),
                rays_features=out[:, 1:].reshape(*lead, n_pts, self.color_dim),
                aux={},
            )
        if self.input_xyz:
            embeds = self._embed_points(origins, directions, lengths)
        else:
            embeds = origins.new_zeros((*lengths.shape, 0))
        return self._from_embedding(concat_global_codes(embeds, global_codes, self.latent_dim), directions)


@MODELS.register_module()
class ZeroOutputer(nn.Module):
    """Zero densities and colors at every ray point, for analytic tests (``yanerf_tpu``'s ``ZeroOutputer``).

    Its one parameter, ``dummy``, keeps the optimizer and the weight bridge
    uniform; the outputs depend on it only through ``dummy * 0``.
    """

    def __init__(self, generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        self.dummy = nn.Parameter(torch.zeros(1))

    def forward(self, origins: torch.Tensor, directions: torch.Tensor, lengths: torch.Tensor,
                global_codes: Optional[torch.Tensor] = None, **kwargs) -> Dict[str, Any]:
        batch, *spatial, _ = origins.shape
        n_pts = lengths.shape[-1]
        zero = self.dummy[0] * 0.0
        densities = torch.zeros((batch, *spatial, n_pts, 1), dtype=origins.dtype, device=origins.device) + zero
        colors = torch.zeros((batch, *spatial, n_pts, 3), dtype=origins.dtype, device=origins.device) + zero
        return dict(rays_densities=densities, rays_features=colors, aux={})
