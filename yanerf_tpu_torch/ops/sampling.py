"""Pixel selection and image gathers for Monte-Carlo ray sampling.

Counterpart of ``yanerf_tpu/ops/sampling.py`` for what the lego configs'
training needs: uniform pixel indices drawn with replacement (a bare
``randint``), weighted sampling with replacement by the inverse CDF (the
masked ``pixel_replacement`` case), weighted sampling without replacement
by the Gumbel top-k (with or without a mask), and ``sample_grid`` and its
inverse, ``scatter_rays_to_image`` (the training vis's Monte-Carlo
rasterization). Where the JAX package takes the approximate top-k
(``lax.approx_max_k``), the port takes the exact one.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def weighted_sample_without_replacement(
    weights: torch.Tensor,
    num_samples: int,
    generator: Optional[torch.Generator] = None,
    gumbel: Optional[torch.Tensor] = None,
    approx: bool = False,
) -> torch.Tensor:
    """``(B, num_samples)`` indices per row of ``(B, N)`` non-negative weights, without replacement.

    The Gumbel top-k: ``keys = where(w > 0, log(max(w, tiny)) + g, -inf)``
    with standard Gumbel draws ``g``, then the exact ``topk``. The draws are
    ``gumbel`` (``weights``' shape) if given, else drawn from ``generator``;
    with neither the call raises.
    As in the JAX package, a row with fewer positive weights than samples
    pads with zero-weight indices. ``approx=True`` (``ray_sampler.approx_top_k``)
    takes the exact ``topk`` too: ``lax.approx_max_k(keys, k,
    recall_target=0.95)`` promises at least 95% of the true top k, and the
    exact top k keeps that promise. On the JAX CPU backend it returns
    ``lax.top_k``'s indices in the same order, so the two packages draw the
    same pixels from the same Gumbel draws; the approximation that drops
    some of them is the TPU's own (its aggregation-based top-k).
    """
    tiny = torch.finfo(weights.dtype).tiny
    if gumbel is None:
        if generator is None:
            raise ValueError("pixels without replacement require a generator or fed-in pixel draws")
        gumbel = gumbel_from_uniform(
            torch.rand(weights.shape, generator=generator, dtype=weights.dtype, device=weights.device)
        )
    keys = torch.where(weights > 0, torch.log(torch.clamp(weights, min=tiny)) + gumbel, float("-inf"))
    return torch.topk(keys, num_samples, dim=-1).indices


def gumbel_from_uniform(u: torch.Tensor) -> torch.Tensor:
    """Standard Gumbel draws from uniform ones: ``-log(-log(max(u, tiny)))``."""
    return -torch.log(-torch.log(torch.clamp(u, min=torch.finfo(u.dtype).tiny)))


def weighted_sample_with_replacement(
    weights: torch.Tensor,
    num_samples: int,
    generator: Optional[torch.Generator] = None,
    u: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """``(B, num_samples)`` indices per row of ``(B, N)`` non-negative weights, WITH replacement.

    The inverse CDF: per row the first index whose cumulative weight
    exceeds ``u * total`` (``searchsorted`` on the right side, so a draw of
    exactly 0 never picks a zero-weight pixel), clipped to ``N - 1``. The
    uniform draws are ``u`` ``(B, num_samples)`` if given, else drawn from
    ``generator``; with neither the call raises.
    """
    cdf = torch.cumsum(weights, dim=-1)
    total = cdf[..., -1:]
    if u is None:
        if generator is None:
            raise ValueError("weighted pixels with replacement require a generator or fed-in pixel draws")
        u = torch.rand((*weights.shape[:-1], num_samples), generator=generator, dtype=weights.dtype,
                       device=weights.device)
    idx = torch.searchsorted(cdf.contiguous(), (u * total).contiguous(), right=True)
    return torch.clamp(idx, 0, weights.shape[-1] - 1)


def uniform_sample_with_replacement(
    batch_size: int,
    n: int,
    num_samples: int,
    generator: Optional[torch.Generator] = None,
    device: Union[str, torch.device] = "cuda",
) -> torch.Tensor:
    """``(batch_size, num_samples)`` indices in ``[0, n)``, uniform with replacement, from ``generator``."""
    if generator is None:
        raise ValueError("pixels with replacement require a generator or fed-in pixel_idx")
    return torch.randint(0, n, (batch_size, num_samples), generator=generator, device=device)


def sample_grid(tensor: torch.Tensor, image_sampling_grid: torch.Tensor) -> torch.Tensor:
    """Gather ``(B, H, W, C)`` image values at ``(B, *spatial, 2)`` pixel coordinates (x, y)."""
    batch_size, height, width, channels = tensor.shape[0], tensor.shape[1], tensor.shape[2], tensor.shape[-1]
    grid_spatial = image_sampling_grid.shape[1:-1]
    flat_tensor = tensor.reshape(batch_size, height * width, channels)
    flat_grid = image_sampling_grid.reshape(batch_size, -1, 2)
    flat_idx = (flat_grid[..., 0] + width * flat_grid[..., 1]).to(torch.int64)
    gathered = torch.gather(flat_tensor, 1, flat_idx[..., None].expand(-1, -1, channels))
    return gathered.reshape(batch_size, *grid_spatial, channels)


def scatter_rays_to_image(
    tensor: torch.Tensor,
    image_sampling_grid: torch.Tensor,
    image_height: int,
    image_width: int,
    bg_color: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Splat ``(B, *spatial, C)`` per-ray values back onto a ``(B, image_height, image_width, C)`` image.

    The inverse of :func:`sample_grid` at ``(B, *spatial, 2)`` pixel
    coordinates (x, y); pixels no ray hit hold ``bg_color`` (broadcast to
    the image, when it has ``C`` channels) or zero. Where two rays hit one
    pixel, which value lands is unspecified (as in the JAX package). The
    result carries no gradient.
    """
    batch_size, channels = tensor.shape[0], tensor.shape[-1]
    flat_tensor = tensor.detach().reshape(batch_size, -1, channels)
    flat_grid = image_sampling_grid.reshape(batch_size, -1, 2)
    flat_idx = (flat_grid[..., 0] + image_width * flat_grid[..., 1]).to(torch.int64)
    output = torch.zeros((batch_size, image_height, image_width, channels), dtype=tensor.dtype, device=tensor.device)
    if bg_color is not None and bg_color.shape[-1] == channels:
        output = output + bg_color
    output = output.reshape(batch_size, image_height * image_width, channels)
    batch_idx = torch.arange(batch_size, device=tensor.device)[:, None].expand_as(flat_idx)
    output = output.index_put((batch_idx, flat_idx), flat_tensor)
    return output.reshape(batch_size, image_height, image_width, channels)
