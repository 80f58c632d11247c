"""The NeRF backbone MLP with input-skip connections.

Counterpart of ``yanerf_tpu/models/mlp.py``: ``n_layers`` Linear+ReLU
blocks, the skip layers re-concatenating ``[y, z]`` (y first), or with
``skip_affine_trans`` modulating the activations by an affine transform
predicted from ``z``: ``y = (y - mu) * softplus(log_std)``, ``[mu, log_std]
= l2(relu(l1(z)))``, held in ``skip_affines.<i>.l1`` / ``.l2`` (the JAX
tree's ``skip_affines`` list, so ``convert.py`` carries them key for key).
``no_last_relu`` makes the final layer linear.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import Linear, init_linear_xavier, linear


class MLPWithInputSkips(nn.Module):
    def __init__(
        self,
        n_layers: int = 8,
        input_dim: int = 39,
        output_dim: int = 256,
        skip_dim: int = 39,
        hidden_dim: int = 256,
        input_skips: Sequence[int] = (5,),
        skip_affine_trans: bool = False,
        no_last_relu: bool = False,
        compute_dtype: torch.dtype = torch.float32,
        generator: Optional[torch.Generator] = None,
    ) -> None:
        super().__init__()
        self.n_layers = n_layers
        self.input_skips = tuple(input_skips)
        self.skip_affine_trans = skip_affine_trans
        self.no_last_relu = no_last_relu
        self.compute_dtype = compute_dtype
        layers, affines = [], []
        for li in range(n_layers):
            dim_in = hidden_dim if li > 0 else input_dim
            dim_out = hidden_dim if li + 1 < n_layers else output_dim
            if li > 0 and li in self.input_skips:
                if skip_affine_trans:
                    affines.append(nn.ModuleDict({
                        "l1": init_linear_xavier(Linear(skip_dim, hidden_dim * 2), generator),
                        "l2": init_linear_xavier(Linear(hidden_dim * 2, hidden_dim * 2), generator),
                    }))
                else:
                    dim_in = hidden_dim + skip_dim
            layers.append(init_linear_xavier(Linear(dim_in, dim_out), generator))
        self.mlp = nn.ModuleList(layers)
        if skip_affine_trans:
            self.skip_affines = nn.ModuleList(affines)

    def _apply_affine(self, affine: nn.ModuleDict, x: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
        hidden = F.relu(linear(affine["l1"], z, self.compute_dtype))
        mu, log_std = torch.chunk(linear(affine["l2"], hidden, self.compute_dtype), 2, dim=-1)
        return (x - mu) * F.softplus(log_std)

    def forward(self, x: torch.Tensor, z: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Run the stack; ``z`` defaults to ``x`` (the usual NeRF skip)."""
        y = x
        z = x if z is None else z
        low_precision = self.compute_dtype != torch.float32
        if low_precision:
            z = z.to(self.compute_dtype)
        skip_idx, n = 0, len(self.mlp)
        for li, layer in enumerate(self.mlp):
            if li in self.input_skips and li > 0:
                if self.skip_affine_trans:
                    y = self._apply_affine(self.skip_affines[skip_idx], y, z)
                else:
                    y = torch.cat([y, z], dim=-1)
                skip_idx += 1
            y = linear(layer, y, self.compute_dtype)
            if not (self.no_last_relu and li + 1 == n):
                y = F.relu(y)
            if low_precision:
                y = y.to(self.compute_dtype)
        return y
