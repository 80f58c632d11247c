"""Per-sample view metrics.

Counterpart of ``yanerf_tpu/ops/metrics.py`` for what serving needs: with
no ground truth (``image_rgb=None``, ``depth_map=None``) ``view_metrics``
returns no losses. The ground-truth metrics (RGB, SSIM, depth) raise
``NotImplementedError`` until the training slice brings a dataset.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch


def sample_grid(tensor: torch.Tensor, image_sampling_grid: torch.Tensor) -> torch.Tensor:
    """Gather ``(B, H, W, C)`` image values at ``(B, *spatial, 2)`` pixel coordinates."""
    batch_size, height, width, channels = tensor.shape[0], tensor.shape[1], tensor.shape[2], tensor.shape[-1]
    grid_spatial = image_sampling_grid.shape[1:-1]
    flat_tensor = tensor.reshape(batch_size, height * width, channels)
    flat_grid = image_sampling_grid.reshape(batch_size, -1, 2)
    flat_idx = (flat_grid[..., 0] + width * flat_grid[..., 1]).to(torch.int64)
    gathered = torch.gather(flat_tensor, 1, flat_idx[..., None].expand(-1, -1, channels))
    return gathered.reshape(batch_size, *grid_spatial, channels)


def view_metrics(
    image_sampling_grid: torch.Tensor,
    images: Optional[torch.Tensor] = None,
    images_pred: Optional[torch.Tensor] = None,
    depths: Optional[torch.Tensor] = None,
    depths_pred: Optional[torch.Tensor] = None,
    keys_prefix: str = "loss_",
) -> Dict[str, torch.Tensor]:
    """Per-sample losses against ground truth; none without it (the serving case)."""
    if images is not None or depths is not None:
        raise NotImplementedError("ground-truth view metrics are not ported yet (ROADMAP.md Queue 1 item 2)")
    return {}
