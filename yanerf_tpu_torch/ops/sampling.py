"""Pixel selection and image gathers for Monte-Carlo ray sampling.

Counterpart of ``yanerf_tpu/ops/sampling.py`` for what the lego configs'
training needs: uniform pixel indices drawn with replacement (a bare
``randint``), weighted sampling without replacement by the Gumbel top-k,
and ``sample_grid``. The approximate top-k (``lax.approx_max_k``) has no
PyTorch counterpart and raises; weighted sampling with replacement and
``scatter_rays_to_image`` are not ported yet.
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
    ``gumbel`` (``weights``' shape) if given, else drawn from ``generator``.
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
    """``(batch_size, num_samples)`` indices in ``[0, n)``, uniform with replacement."""
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
