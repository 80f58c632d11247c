"""Emission-absorption alpha compositing along rays.

Counterpart of ``yanerf_tpu/ops/raymarch.py``, with the same contract:
  * the last delta is the ``background_opacity`` (1e10) sentinel;
  * deltas are scaled by ``||direction||``;
  * transmittance is ``cap(cumsum(delta * sigma))`` rolled by
    ``surface_thickness`` with ones at the front;
  * background blending is soft or hard;
  * density noise (training only) is ``N(0, 1) * std`` added to the raw
    densities before the activation, the draws taken from ``generator`` or
    fed in as ``noise`` (the densities' shape, without the channel).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..utils import device_constant


def _capping_function(name: str):
    if name == "exponential":
        return lambda x: 1.0 - torch.exp(-x)
    if name == "cap1":
        return lambda x: torch.clamp(x, max=1.0)
    raise ValueError(f"Unknown capping_function: {name}")


def _weight_function(name: str):
    if name == "product":
        return lambda curr, acc: curr * acc
    if name == "minimum":
        return torch.minimum
    raise ValueError(f"Unknown weight_function: {name}")


def _density_activation(name: Optional[str], density_relu: bool):
    if name is None:
        name = "relu" if density_relu else "none"
    if name == "relu":
        return F.relu
    if name == "softplus":
        return F.softplus
    if name == "none":
        return None
    raise ValueError(f"Unknown density_activation: {name}")


def emission_absorption_weights(
    rays_densities: torch.Tensor,
    ray_lengths: torch.Tensor,
    ray_directions: torch.Tensor,
    *,
    density_noise_std: float = 0.0,
    generator: Optional[torch.Generator] = None,
    noise: Optional[torch.Tensor] = None,
    capping_function: str = "exponential",
    weight_function: str = "product",
    background_opacity: float = 1e10,
    density_relu: bool = True,
    density_activation: Optional[str] = None,
    density_pre_activation_bias: float = 0.0,
    background_density_bias: float = 0.0,
    surface_thickness: int = 1,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-point weights ``(..., P)`` and per-ray opacities ``(..., 1)``.

    With ``density_noise_std > 0`` the ``(..., P)`` standard normal draws
    come from ``noise`` if given, else from ``generator``; with neither the
    call raises, as the JAX package does without an rng key.
    """
    cap = _capping_function(capping_function)
    weight_fn = _weight_function(weight_function)

    deltas = torch.cat(
        [
            ray_lengths[..., 1:] - ray_lengths[..., :-1],
            torch.full_like(ray_lengths[..., :1], background_opacity),
        ],
        dim=-1,
    )
    dir_norm = torch.linalg.vector_norm(ray_directions, dim=-1)
    deltas = deltas * dir_norm[..., None]

    densities = rays_densities[..., 0]
    if density_noise_std > 0.0:
        if noise is None:
            if generator is None:
                raise ValueError("density_noise_std > 0 requires a generator or fed-in noise")
            noise = torch.randn(densities.shape, generator=generator, dtype=densities.dtype, device=densities.device)
        densities = densities + noise * density_noise_std
    act = _density_activation(density_activation, density_relu)
    if act is not None:
        densities = act(densities + density_pre_activation_bias) + background_density_bias

    weighted_densities = deltas * densities
    capped_densities = cap(weighted_densities)

    rays_opacities = cap(torch.cumsum(weighted_densities, dim=-1))
    opacities = rays_opacities[..., -1:]
    absorption_shifted = torch.roll(1.0 - rays_opacities, surface_thickness, dims=-1)
    ones_head = torch.ones_like(absorption_shifted[..., :surface_thickness])
    absorption_shifted = torch.cat([ones_head, absorption_shifted[..., surface_thickness:]], dim=-1)

    weights = weight_fn(capped_densities, absorption_shifted)
    return weights, opacities


def emission_absorption(
    rays_densities: torch.Tensor,
    rays_features: torch.Tensor,
    ray_lengths: torch.Tensor,
    ray_directions: torch.Tensor,
    *,
    density_noise_std: float = 0.0,
    generator: Optional[torch.Generator] = None,
    noise: Optional[torch.Tensor] = None,
    bg_color: Optional[torch.Tensor] = None,
    default_bg_color: Tuple[float, ...] = (0.0,),
    capping_function: str = "exponential",
    weight_function: str = "product",
    background_opacity: float = 1e10,
    density_relu: bool = True,
    density_activation: Optional[str] = None,
    density_pre_activation_bias: float = 0.0,
    blend_output: bool = False,
    background_density_bias: float = 0.0,
    hard_background: bool = False,
    surface_thickness: int = 1,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Composite ``(..., P, 1)`` densities and ``(..., P, C)`` features.

    Returns:
        ``(features (..., C), depths (..., 1), opacities (..., 1),
        weights (..., P))``.
    """
    weights, opacities = emission_absorption_weights(
        rays_densities,
        ray_lengths,
        ray_directions,
        density_noise_std=density_noise_std,
        generator=generator,
        noise=noise,
        capping_function=capping_function,
        weight_function=weight_function,
        background_opacity=background_opacity,
        density_relu=density_relu,
        density_activation=density_activation,
        density_pre_activation_bias=density_pre_activation_bias,
        background_density_bias=background_density_bias,
        surface_thickness=surface_thickness,
    )
    dtype = rays_densities.dtype
    depths = torch.sum(weights * ray_lengths, dim=-1, keepdim=True)

    n_channels = rays_features.shape[-1]
    if bg_color is None:
        bg = device_constant(("bg_color", tuple(default_bg_color)), lambda: default_bg_color, dtype,
                             rays_features.device)
        bg_color = bg.expand(*rays_features.shape[:-2], bg.shape[-1])
    if bg_color.shape[-1] not in (1, n_channels):
        raise ValueError(f"Background color has {bg_color.shape[-1]} channels, features have {n_channels}.")

    if not hard_background:
        features = torch.sum(weights[..., None] * rays_features, dim=-2)
        alpha = opacities if blend_output else 1.0
        features = alpha * features + (1.0 - opacities) * bg_color
    else:
        bg_row = bg_color[..., None, :].expand(*bg_color.shape[:-1], 1, n_channels)
        rays_features = torch.cat([rays_features[..., :-1, :], bg_row], dim=-2)
        features = torch.sum(weights[..., None] * rays_features, dim=-2)

    return features, depths, opacities, weights
