"""Pixel selection and image gathers for Monte-Carlo ray sampling.

Counterpart of ``yanerf_tpu/ops/sampling.py`` for what the lego configs'
training needs: uniform pixel indices drawn with replacement (a bare
``randint``), weighted sampling without replacement by the Gumbel top-k,
and ``sample_grid`` and its inverse, ``scatter_rays_to_image`` (the training
vis's Monte-Carlo rasterization). The approximate top-k
(``lax.approx_max_k``) has no PyTorch counterpart and raises; weighted
sampling with replacement is not ported yet.
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
    pads with zero-weight indices. ``approx=True`` where the JAX package
    would take ``lax.approx_max_k`` (``ray_sampler.approx_top_k``, when
    ``4 * num_samples <= N``) raises: it is not ported.
    """
    if approx and num_samples * 4 <= weights.shape[-1]:
        raise NotImplementedError(
            "the approximate top-k (ray_sampler.approx_top_k) has no PyTorch counterpart: set it to False"
        )
    tiny = torch.finfo(weights.dtype).tiny
    if gumbel is None:
        if generator is None:
            raise ValueError("pixels without replacement require a generator or fed-in pixel draws")
        u = torch.rand(weights.shape, generator=generator, dtype=weights.dtype, device=weights.device)
        gumbel = -torch.log(-torch.log(torch.clamp(u, min=tiny)))
    keys = torch.where(weights > 0, torch.log(torch.clamp(weights, min=tiny)) + gumbel, float("-inf"))
    return torch.topk(keys, num_samples, dim=-1).indices


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
