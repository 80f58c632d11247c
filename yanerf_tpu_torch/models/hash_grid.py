"""HashGridNeRF: an Instant-NGP-style multiresolution hash encoding and two tiny MLPs.

Counterpart of ``yanerf_tpu/models/hash_grid.py`` (Müller et al. 2022).
Per level ``l`` of ``L``:
  * the resolution ``N_l = floor(N_min * b**l)``, ``b = exp((ln N_max -
    ln N_min) / (L - 1))``, computed in float64 by numpy as the JAX package
    does, so the integer resolutions are the same;
  * levels with ``(N_l + 1)**3`` rows at most the table size index a dense
    grid; finer ones hash the corner, ``x0 XOR x1 * 2654435761 XOR x2 *
    805459861 mod T`` in uint32 arithmetic with wraparound. PyTorch has no
    uint32 multiply on CUDA, so the corners and products are int64 and each
    product is masked to its low 32 bits before the XOR: the same rows;
  * the trilinear interpolation of the 8 corner rows, the levels'
    features concatenated to ``(..., L * F)``.
Then a density MLP (``encoding -> hidden -> 1 + geo_feature_dim``, the
first output the raw density) and a color MLP over the geometry features
and the direction embedding. The tables are float32; the MLPs follow
``compute_dtype`` with the JAX package's bf16 policy. The parameter names
(``tables.3``, ``density_mlp.0.w``, ``color_mlp.2.b``) are the JAX param
tree's dotted paths, so ``convert.py`` loads it as it is.

Two paths for the encoding, and the device picks between them: CUDA
points go through the hash-encoding kernels, K4 forward and K5 the tables'
gradient (``ops/kernels/hash_encode.py``), which raise for widths they do
not take (``hash_encode.takes_widths``; every shipped config's they do);
CPU points run the plain path below, the reference the tests hold the
kernels to. No option chooses. The encoding is the span
``model.hash_encode`` of a trace.

``encode_chunk`` is taken for the configs' sake and changes nothing: in the
JAX package it bounded the size of one XLA scatter's lowering. The port
encodes every point in one pass. With ``contract_coords`` the points are
contracted into the radius-2 ball (``ops/rays.py::contract_points``) before
the encoding, which needs ``scene_bound >= 2``.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.harmonics import harmonic_embedding, harmonic_embedding_dim
from ..ops.kernels import hash_encode
from ..ops.rays import contract_points, ray_bundle_to_ray_points
from ..utils import device_constant
from ..utils.profiling import annotate
from .builder import MODELS
from .layers import Linear, _uniform, init_linear_default, linear
from .nerf_mlp import as_torch_dtype

_PRIMES = (1, 2654435761, 805459861)
_LOW_32_BITS = 0xFFFFFFFF
# the 8 corners of a cell, as (i, j, k) bits with k fastest: the JAX package's order
_CORNERS = [[i, j, k] for i in (0, 1) for j in (0, 1) for k in (0, 1)]


class _TableLookup(torch.autograd.Function):
    """Rows ``idx`` of ``table``; the table's gradient is one scatter-add of the rows' cotangents."""

    @staticmethod
    def forward(ctx, table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(idx)
        ctx.n_rows = table.shape[0]
        return table.index_select(0, idx)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        (idx,) = ctx.saved_tensors
        out = torch.zeros((ctx.n_rows, grad.shape[-1]), dtype=torch.float32, device=grad.device)
        out.index_put_((idx,), grad.to(torch.float32), accumulate=True)
        return out, None


def table_lookup(table: torch.Tensor, flat_idx: torch.Tensor) -> torch.Tensor:
    """``table[flat_idx]``, ``(n, F)``, with a deterministic table gradient.

    The forward is a row gather (``index_select``). The backward is one
    row scatter-add, ``index_put_(accumulate=True)``: on CUDA PyTorch runs
    it as a sort of the indices followed by a sum over each run of equal
    rows in a fixed order, so two runs of a step give the same bits (the
    gradient of ``index_select`` itself is ``index_add_``, which adds
    atomically on CUDA and so in an order that changes from run to run).
    ``chip_smoke.py``'s "family" phase runs a step twice on the card and
    prints whether the two tables' gradients are bit-equal.
    """
    return _TableLookup.apply(table, flat_idx)


def _level_resolutions(n_levels: int, base_resolution: int, max_resolution: int) -> List[int]:
    if n_levels == 1:
        return [base_resolution]
    growth = float(np.exp((np.log(max_resolution) - np.log(base_resolution)) / (n_levels - 1)))
    return [int(np.floor(base_resolution * growth**level)) for level in range(n_levels)]


@MODELS.register_module()
class HashGridNeRF(nn.Module):
    """Multiresolution hash encoding + tiny density / color MLPs."""

    def __init__(
        self,
        n_levels: int = 16,
        table_size_log2: int = 19,
        n_features_per_level: int = 2,
        base_resolution: int = 16,
        max_resolution: int = 2048,
        hidden_dim: int = 64,
        geo_feature_dim: int = 15,
        n_color_layers: int = 2,
        n_harmonic_functions_dir: int = 4,
        harmonic_functions_dir_append_intput: bool = True,
        color_dim: int = 3,
        scene_bound: float = 1.5,
        input_dir: bool = True,
        compute_dtype: str = "float32",
        contract_coords: bool = False,
        encode_chunk: int = 1 << 17,
        use_pallas: bool = False,
        use_pallas_train: bool = False,
        generator: Optional[torch.Generator] = None,
    ) -> None:
        super().__init__()
        # use_pallas / use_pallas_train are accepted for the configs that still set them and select nothing
        # the contraction's codomain is |x| < 2: a smaller box would clip the whole background onto its faces
        if contract_coords and float(scene_bound) < 2.0:
            raise ValueError(f"contract_coords=True requires scene_bound >= 2.0 (the contraction's codomain is "
                             f"|x| < 2), got {float(scene_bound)}")
        self.contract_coords = contract_coords
        self.n_levels = n_levels
        self.table_size = 1 << table_size_log2
        self.n_features_per_level = n_features_per_level
        self.resolutions = _level_resolutions(n_levels, base_resolution, max_resolution)
        # dense (collision-free) while the grid fits the table, hashed above
        self.level_table_sizes = [min((res + 1) ** 3, self.table_size) for res in self.resolutions]
        self.hidden_dim = hidden_dim
        self.geo_feature_dim = geo_feature_dim
        self.n_color_layers = n_color_layers
        self.n_harmonic_functions_dir = n_harmonic_functions_dir
        self.harmonic_functions_dir_append_intput = harmonic_functions_dir_append_intput
        self.color_dim = color_dim
        self.scene_bound = float(scene_bound)
        self.input_dir = input_dir
        self.compute_dtype = as_torch_dtype(compute_dtype)
        self.encoding_dim = n_levels * n_features_per_level
        self.embedding_dim_dir = (
            harmonic_embedding_dim(3, n_harmonic_functions_dir, harmonic_functions_dir_append_intput) if input_dir else 0
        )

        # parameters in the JAX package's init order; tables U(-1e-4, 1e-4) as in iNGP
        self.tables = nn.ParameterList(
            nn.Parameter(_uniform((size, n_features_per_level), 1e-4, generator)) for size in self.level_table_sizes
        )
        self.density_mlp = nn.ModuleList([
            init_linear_default(Linear(self.encoding_dim, hidden_dim), generator),
            init_linear_default(Linear(hidden_dim, 1 + geo_feature_dim), generator),
        ])
        dims = [geo_feature_dim + self.embedding_dim_dir] + [hidden_dim] * n_color_layers + [color_dim]
        self.color_mlp = nn.ModuleList(
            init_linear_default(Linear(d_in, d_out), generator) for d_in, d_out in zip(dims[:-1], dims[1:])
        )

    # -- encoding ---------------------------------------------------------------
    def _is_dense(self, level: int) -> bool:
        return self.level_table_sizes[level] == (self.resolutions[level] + 1) ** 3

    def _corner_indices(self, cells: torch.Tensor, level: int) -> torch.Tensor:
        """Integer cells ``(N, 3)`` -> the table rows ``(N, 8)`` of their corners (clipped to the grid)."""
        res = self.resolutions[level]
        offsets = device_constant("hash_grid_corners", lambda: _CORNERS, torch.int64, cells.device)
        corners = torch.clamp(cells.to(torch.int64)[:, None, :] + offsets, 0, res)
        if self._is_dense(level):
            stride = res + 1
            return (corners[..., 0] * stride + corners[..., 1]) * stride + corners[..., 2]
        h = (corners[..., 0] * _PRIMES[0]) & _LOW_32_BITS
        h = h ^ ((corners[..., 1] * _PRIMES[1]) & _LOW_32_BITS)
        h = h ^ ((corners[..., 2] * _PRIMES[2]) & _LOW_32_BITS)
        return h % self.level_table_sizes[level]

    def encode(self, tables: List[torch.Tensor], points: torch.Tensor) -> torch.Tensor:
        """World points ``(..., 3)`` -> the interpolated features ``(..., L * F)``."""
        flat = points.reshape(-1, 3)
        # the points into [0, 1]^3 over the scene's box
        x01 = torch.clamp((flat + self.scene_bound) / (2.0 * self.scene_bound), 0.0, 1.0)
        upper = device_constant("hash_grid_corners", lambda: _CORNERS, torch.bool, flat.device)
        feats = []
        for level, res in enumerate(self.resolutions):
            scaled = x01 * res
            cell = torch.floor(scaled)
            frac = scaled - cell
            idx = self._corner_indices(cell, level)
            rows = table_lookup(tables[level], idx.reshape(-1)).reshape(*idx.shape, self.n_features_per_level)
            # trilinear weights: per corner, the product over the axes of frac or 1 - frac
            w = torch.where(upper, frac[:, None, :], 1.0 - frac[:, None, :])
            w = w[..., 0] * w[..., 1] * w[..., 2]
            feats.append(torch.sum(rows * w[..., None], dim=1))
        return torch.cat(feats, dim=-1).reshape(*points.shape[:-1], self.encoding_dim)

    # -- forward ----------------------------------------------------------------
    def forward(
        self,
        origins: torch.Tensor,
        directions: torch.Tensor,
        lengths: torch.Tensor,
        global_codes: Optional[torch.Tensor] = None,
        **kwargs,
    ) -> Dict[str, Any]:
        """Raw densities ``(B, *spatial, P, 1)`` and colors ``(B, *spatial, P, C)``."""
        if global_codes is not None:
            raise ValueError("HashGridNeRF does not support latent conditioning")
        cd = self.compute_dtype
        points = ray_bundle_to_ray_points(origins, directions, lengths)
        if self.contract_coords:
            points = contract_points(points)
        with annotate("model.hash_encode"):
            if points.is_cuda:
                enc = hash_encode.hash_encode(points.reshape(-1, 3).contiguous(), list(self.tables), self.resolutions,
                                              self.scene_bound).reshape(*points.shape[:-1], self.encoding_dim)
            else:
                enc = self.encode(list(self.tables), points)
        enc = enc.to(cd)
        h = F.relu(linear(self.density_mlp[0], enc, cd))
        geo = linear(self.density_mlp[1], h, cd).to(torch.float32)
        raw_density = geo[..., :1]  # the raymarcher applies the activation and the bias
        x = geo[..., 1:].to(cd)
        if self.input_dir:
            dir_norm = directions / torch.clamp(torch.linalg.vector_norm(directions, dim=-1, keepdim=True), min=1e-12)
            dir_emb = harmonic_embedding(
                dir_norm, self.n_harmonic_functions_dir, append_input=self.harmonic_functions_dir_append_intput
            ).to(cd)
            x = torch.cat([x, dir_emb[..., None, :].expand(*points.shape[:-1], dir_emb.shape[-1])], dim=-1)
        for layer in self.color_mlp[:-1]:
            x = F.relu(linear(layer, x, cd))
        color = torch.sigmoid(linear(self.color_mlp[-1], x, cd).to(torch.float32))
        return dict(rays_densities=raw_density, rays_features=color, aux={})
