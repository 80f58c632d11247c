"""Linear layers with weights in the JAX package's ``(in, out)`` layout.

Counterpart of ``yanerf_tpu/models/layers.py``. ``Linear`` holds ``w`` as
``(in_features, out_features)`` and ``b`` as ``(out_features,)``, so the
forward is ``x @ w + b`` and a JAX param tree maps onto the state dict key
for key with no transpose (``convert.py``).

The bf16 policy is the JAX package's: under a low-precision compute dtype
the inputs, weights and bias are cast to it and the bias is added in it.
``concat_global_codes`` is the latent conditioning every model family
shares: per-batch codes broadcast onto the point embedding.
``PackedWeights`` keeps the weights a hand-written kernel reads (NeRFMLP's
K1 / K3, ProposalMLP's K7).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Iterable, Optional

import torch
import torch.nn as nn


class Linear(nn.Module):
    """``x @ w + b`` with ``w`` stored ``(in, out)``; initialised by the caller."""

    def __init__(self, in_features: int, out_features: int) -> None:
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self.w = nn.Parameter(torch.empty(in_features, out_features))
        self.b = nn.Parameter(torch.empty(out_features))


def _uniform(shape, bound: float, generator: Optional[torch.Generator]) -> torch.Tensor:
    return (torch.rand(shape, generator=generator, dtype=torch.float32) * 2.0 - 1.0) * bound


@torch.no_grad()
def init_linear_xavier(layer: Linear, generator: Optional[torch.Generator] = None, zero_bias: bool = False) -> Linear:
    """Xavier-uniform weight; torch-default uniform bias (or zeros)."""
    fan_in, fan_out = layer.in_features, layer.out_features
    layer.w.copy_(_uniform((fan_in, fan_out), math.sqrt(6.0 / (fan_in + fan_out)), generator))
    if zero_bias:
        layer.b.zero_()
    else:
        layer.b.copy_(_uniform((fan_out,), 1.0 / math.sqrt(fan_in) if fan_in > 0 else 0.0, generator))
    return layer


@torch.no_grad()
def init_linear_default(layer: Linear, generator: Optional[torch.Generator] = None) -> Linear:
    """torch.nn.Linear default init: U(+-1/sqrt(fan_in)) for weight and bias."""
    bound = 1.0 / math.sqrt(layer.in_features) if layer.in_features > 0 else 0.0
    layer.w.copy_(_uniform((layer.in_features, layer.out_features), bound, generator))
    layer.b.copy_(_uniform((layer.out_features,), bound, generator))
    return layer


def linear(layer: Linear, x: torch.Tensor, compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``x @ w + b``; under a low-precision compute dtype everything stays in it."""
    if compute_dtype != torch.float32:
        return x.to(compute_dtype) @ layer.w.to(compute_dtype) + layer.b.to(compute_dtype)
    return x @ layer.w + layer.b


def linear_with_repeat(
    layer: Linear, x: torch.Tensor, y: torch.Tensor, compute_dtype: torch.dtype = torch.float32
) -> torch.Tensor:
    """Linear over per-point ``x (..., P, n1)`` and per-ray ``y (..., n2)`` without the concat."""
    n1 = x.shape[-1]
    w1, w2 = layer.w[:n1], layer.w[n1:]
    if compute_dtype != torch.float32:
        out1 = x.to(compute_dtype) @ w1.to(compute_dtype)
        out2 = y.to(compute_dtype) @ w2.to(compute_dtype)
        return out1 + layer.b.to(compute_dtype) + out2[..., None, :]
    return x @ w1 + layer.b + (y @ w2)[..., None, :]


def concat_global_codes(embeds: torch.Tensor, global_codes: Optional[torch.Tensor], latent_dim: int) -> torch.Tensor:
    """Broadcast per-batch latent codes onto a point embedding and concatenate them on the feature axis.

    Codes are ``(B, latent_dim)`` (extra dims flattened, ``(B, N, D)`` with
    ``N * D == latent_dim``), broadcast over every spatial and point axis of
    ``embeds`` and cast to its dtype. Without codes ``latent_dim`` must be 0.
    """
    if global_codes is None:
        if latent_dim != 0:
            raise ValueError("latent_dim > 0 requires global_codes")
        return embeds
    global_codes = global_codes.reshape(global_codes.shape[0], -1)
    if global_codes.shape[-1] != latent_dim:
        raise ValueError(
            f"global_codes dim {global_codes.shape[-1]} is incompatible with latent_dim {latent_dim}"
        )
    broadcast_shape = (embeds.shape[0],) + (1,) * (embeds.ndim - 2) + (latent_dim,)
    codes = global_codes.reshape(broadcast_shape).expand(*embeds.shape[:-1], latent_dim).to(embeds.dtype)
    return torch.cat([embeds, codes], dim=-1)


class PackedWeights:
    """Mixed into a model whose kernel reads its weights from a pack: packed once, then rewritten in place.

    The model defines ``_pack()``, a fresh pack of its current weights (a
    dataclass with the buffers ``flat`` and ``biases_flat``), and
    ``_repack(packed)``, its current weights written into ``packed``'s
    buffers. The buffers keep their addresses for the module's life on one
    device: the kernels cache their tensor maps by address, and a captured
    CUDA graph reads the buffers it was captured with. They are rewritten
    when ``refresh`` is set (the training forward, which repacks
    unconditionally, also inside a captured step where no Python runs) or
    when a parameter was replaced or written to in place since
    (``_version``), or after :meth:`params_changed`. A move to another device
    packs anew. ``_bake`` holds the pack as the buffers ``packed_flat`` /
    ``packed_biases`` in place of the parameters, for a traced program.
    """

    _packed = None  # (key, pack) of the kernel's weights
    _baked = None  # the pack whose buffers replaced the parameters

    def packed_weights(self, refresh: bool = False):
        """The kernel's packed weights, brought up to date."""
        if self._baked is not None:
            return dataclasses.replace(self._baked, flat=self.packed_flat, biases_flat=self.packed_biases)
        params = list(self.parameters())
        key = tuple((p.data_ptr(), p._version) for p in params)
        if self._packed is None or self._packed[1].flat.device != params[0].device:
            self._packed = (key, self._pack())
        elif refresh or self._packed[0] != key:
            self._packed = (key, self._repack(self._packed[1]))
        return self._packed[1]

    def _bake(self, layers: Iterable[nn.Module]):
        """Register the pack's buffers and drop ``layers``' parameters; returns the pack."""
        packed = self.packed_weights()
        self.register_buffer("packed_flat", packed.flat)
        self.register_buffer("packed_biases", packed.biases_flat)
        for layer in layers:
            layer._parameters.clear()
        self._baked, self._packed = packed, None
        return packed

    def params_changed(self) -> None:
        """The parameters changed where ``_version`` cannot see it (a graph replay): repack at the next use."""
        if self._packed is not None:
            self._packed = (None, self._packed[1])

    def current_packed_weights(self):
        """The packed weights brought up to date (:meth:`packed_weights`) if this module has packed them, else
        None: a captured graph that reads them runs this host check before its replays."""
        if self._packed is None and self._baked is None:
            return None
        return self.packed_weights()
