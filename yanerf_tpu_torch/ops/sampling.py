"""Pixel selection and image gathers for Monte-Carlo ray sampling.

Counterpart of ``yanerf_tpu/ops/sampling.py`` for what the flagship's
training needs: uniform pixel indices drawn with replacement (a bare
``randint``) and ``sample_grid``. Weighted sampling (with or without
replacement) and ``scatter_rays_to_image`` are not ported yet.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


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
