"""The fused NeRF-MLP as a ``torch.autograd.Function``: forward K1, backward K3.

Counterpart of ``yanerf_tpu/ops/pallas/nerf_mlp_bwd.py::make_fused_mlp``,
the ``jax.custom_vjp`` that joins the Pallas forward and backward. The
Function takes the NeRFMLP's own parameter tensors as inputs, so that
autograd delivers their gradients; it packs them through the model's
``packed_weights()``, repacked in place at every call that needs
gradients (a train step, captured or not) and only after a change
otherwise, and slices the packed gradients back to each parameter's shape.

As in the JAX package, the gradients for the points and directions are
not computed: ray geometry never depends on the parameters where the
kernel is eligible (``latent_dim == 0``). Asking for them raises.
Which versions run is the device's choice, not an option's: on CUDA
tensors K1 and K3, on CPU tensors their plain versions.
"""

from __future__ import annotations

from typing import List

import torch
from torch.autograd.function import once_differentiable

from . import nerf_mlp_bwd, nerf_mlp_fwd


def kernel_order_params(model) -> List[torch.nn.Parameter]:
    """``[w, b]`` of every layer in the kernel's order: xyz layers, intermediate, density, color layers."""
    return [t for layer in nerf_mlp_fwd.kernel_layers(model) for t in (layer.w, layer.b)]


class FusedNerfMlp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, model, points, dirs, pts_per_ray, *params):
        packed = model.packed_weights(refresh=any(ctx.needs_input_grad[4:]))
        ctx.save_for_backward(points, dirs)
        ctx.model, ctx.packed, ctx.pts_per_ray = model, packed, pts_per_ray
        return nerf_mlp_fwd.nerf_mlp_fwd(packed, points, dirs, pts_per_ray)

    @staticmethod
    @once_differentiable
    def backward(ctx, g_out):
        points, dirs = ctx.saved_tensors
        grad_flat, grad_biases = nerf_mlp_bwd.nerf_mlp_bwd(
            ctx.packed, points, dirs, ctx.pts_per_ray, g_out.to(torch.float32).contiguous()
        )
        ws, bs = nerf_mlp_bwd.grad_views(ctx.packed, grad_flat, grad_biases)
        grads = []
        for i, (gw, gb) in enumerate(zip(ws, bs)):
            grads += [nerf_mlp_fwd.unpad_weight(ctx.model, i, gw), gb]
        return (None, None, None, None, *grads)


def fused_nerf_mlp(model, points: torch.Tensor, dirs: torch.Tensor, pts_per_ray: int) -> torch.Tensor:
    """``(N, 3)`` points and ``(N / pts_per_ray, 3)`` dirs -> ``(N, 1 + C)``, differentiable in the parameters."""
    if points.requires_grad or dirs.requires_grad:
        raise ValueError(
            "the fused NeRF-MLP gives no gradient for the ray geometry (as make_fused_mlp); "
            "points and directions must not require grad"
        )
    return FusedNerfMlp.apply(model, points, dirs, pts_per_ray, *kernel_order_params(model))
