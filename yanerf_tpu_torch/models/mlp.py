"""The NeRF backbone MLP with input-skip connections.

Counterpart of ``yanerf_tpu/models/mlp.py``: ``n_layers`` Linear+ReLU
blocks, the skip layers re-concatenating ``[y, z]`` (y first). The affine
skip (``skip_affine_trans``) and ``no_last_relu`` are not ported yet.
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
        if skip_affine_trans or no_last_relu:
            raise NotImplementedError("skip_affine_trans and no_last_relu are not ported yet")
        self.n_layers = n_layers
        self.input_skips = tuple(input_skips)
        self.compute_dtype = compute_dtype
        layers = []
        for li in range(n_layers):
            dim_in = hidden_dim if li > 0 else input_dim
            dim_out = hidden_dim if li + 1 < n_layers else output_dim
            if li > 0 and li in self.input_skips:
                dim_in = hidden_dim + skip_dim
            layers.append(init_linear_xavier(Linear(dim_in, dim_out), generator))
        self.mlp = nn.ModuleList(layers)

    def forward(self, x: torch.Tensor, z: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Run the stack; ``z`` defaults to ``x`` (the usual NeRF skip)."""
        y = x
        z = x if z is None else z
        low_precision = self.compute_dtype != torch.float32
        if low_precision:
            z = z.to(self.compute_dtype)
        for li, layer in enumerate(self.mlp):
            if li in self.input_skips and li > 0:
                y = torch.cat([y, z], dim=-1)
            y = F.relu(linear(layer, y, self.compute_dtype))
            if low_precision:
                y = y.to(self.compute_dtype)
        return y
