"""Camera-to-ray geometry.

Counterpart of ``yanerf_tpu/ops/rays.py`` for the parts the serving and
training paths run: the pixel grid, metric-depth ray bundles with optional
stratified jitter, and ray points. NDC rays, ``scene_aabb`` tightening,
occupancy bounds and disparity spacing raise ``NotImplementedError`` until
a later slice ports them.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Optional, Union

import numpy as np
import torch

from .structures import RayBundle


@lru_cache(maxsize=32)
def _xy_grid_np(image_height: int, image_width: int) -> np.ndarray:
    ys, xs = np.meshgrid(
        np.arange(image_height, dtype=np.float32),
        np.arange(image_width, dtype=np.float32),
        indexing="ij",
    )
    return np.stack([xs, ys], axis=-1)


def get_xy_grid(image_height: int, image_width: int, device: Union[str, torch.device] = "cuda") -> torch.Tensor:
    """Pixel-coordinate grid of shape ``(H, W, 2)``; ``[..., 0]`` is x (column)."""
    return torch.as_tensor(_xy_grid_np(image_height, image_width), device=device)


def linspace01(n: int, dtype: torch.dtype = torch.float32, device: Union[str, torch.device] = "cuda") -> torch.Tensor:
    """``n`` evenly spaced values on [0, 1], rounded as ``jnp.linspace`` rounds them.

    ``jnp.linspace`` computes ``iota * (1 / (n - 1))`` and appends the exact
    endpoint; ``torch.linspace`` differs from it by one ulp in places, which
    would move the deterministic ``sample_pdf`` u's off the reference.
    """
    if n == 1:
        return torch.zeros(1, dtype=dtype, device=device)
    step = torch.arange(n - 1, dtype=dtype, device=device) * torch.tensor(1.0 / (n - 1), dtype=dtype)
    return torch.cat([step, torch.ones(1, dtype=dtype, device=device)])


def jiggle_within_stratas(
    bin_centers: torch.Tensor, generator: Optional[torch.Generator] = None, u: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Stratified resampling: one uniform draw per bin around each center.

    Each value ``z`` becomes a draw on ``[z - d-, z + d+]``, the deltas the
    half-distances to the neighbouring centers (zero at the ends). ``u``
    (the shape of ``bin_centers``, on [0, 1)) replaces the generator's draws.
    """
    mids = 0.5 * (bin_centers[..., 1:] + bin_centers[..., :-1])
    upper = torch.cat([mids, bin_centers[..., -1:]], dim=-1)
    lower = torch.cat([bin_centers[..., :1], mids], dim=-1)
    if u is None:
        u = torch.rand(lower.shape, generator=generator, dtype=lower.dtype, device=lower.device)
    return lower + (upper - lower) * u


def xy_to_ray_bundle(
    poses: torch.Tensor,
    image_width: int,
    image_height: int,
    focal_lengths: torch.Tensor,
    xy_grid: torch.Tensor,
    min_depth: Union[float, torch.Tensor],
    max_depth: Union[float, torch.Tensor],
    n_pts_per_ray: int,
    stratified_sampling: bool = False,
    generator: Optional[torch.Generator] = None,
    sample_in_disparity: bool = False,
    scene_aabb=None,
    occupancy=None,
    strata_u: Optional[torch.Tensor] = None,
) -> RayBundle:
    """Unproject pixel coordinates into world-space rays with metric depth samples.

    Args:
        poses: ``(B, 3, 4)`` camera-to-world matrices (rotation | translation).
        image_width/image_height: the sampler's intrinsic size, used for the
            principal point even when ``xy_grid`` covers another resolution.
        focal_lengths: ``(B,)`` or ``(B, 1)`` focal lengths in pixels.
        xy_grid: ``(B, *spatial, 2)`` pixel coordinates to unproject.
        min_depth/max_depth: scalars bounding the depth range.
        n_pts_per_ray: number of depth samples per ray (0 for none).
        stratified_sampling: jiggle the depths within their strata, with
            ``strata_u`` (``(B, *spatial, n_pts_per_ray)``) or the
            generator's draws.

    Returns:
        A :class:`RayBundle`; directions are NOT normalized (their norm
        carries the depth->distance scale used by the raymarcher).
    """
    if sample_in_disparity or scene_aabb is not None or occupancy is not None:
        raise NotImplementedError(
            "disparity spacing, scene_aabb and occupancy bounds are not ported yet (ROADMAP Queue 1 item 11)"
        )
    batch_size = xy_grid.shape[0]
    spatial_size = xy_grid.shape[1:-1]
    dtype, device = xy_grid.dtype, xy_grid.device

    poses = poses[:, :3, :4]
    expand = (batch_size,) + (1,) * len(spatial_size)
    origins = poses[:, :3, 3].reshape(*expand, 3).expand(batch_size, *spatial_size, 3)

    focal = torch.as_tensor(focal_lengths, dtype=dtype, device=device).reshape(expand)
    dirs_cam = torch.stack(
        [
            (xy_grid[..., 0] - image_width * 0.5) / focal,
            (xy_grid[..., 1] - image_height * 0.5) / focal,
            torch.ones((batch_size, *spatial_size), dtype=dtype, device=device),
        ],
        dim=-1,
    )
    rot = poses[:, :3, :3].reshape(*expand, 3, 3)
    directions = torch.sum(rot * dirs_cam[..., None, :], dim=-1)

    if n_pts_per_ray > 0:
        lo = torch.mean(torch.as_tensor(min_depth, dtype=dtype, device=device))
        hi = torch.mean(torch.as_tensor(max_depth, dtype=dtype, device=device))
        t = linspace01(n_pts_per_ray, dtype=dtype, device=device)
        depths = t * (hi - lo) + lo
        rays_zs = depths.expand(batch_size, *spatial_size, n_pts_per_ray)
        if stratified_sampling:
            rays_zs = jiggle_within_stratas(rays_zs, generator, strata_u)
    else:
        rays_zs = torch.zeros((batch_size, *spatial_size, 0), dtype=dtype, device=device)

    return RayBundle(origins=origins, directions=directions, lengths=rays_zs, xys=xy_grid)


def ray_bundle_to_ray_points(
    rays_origins: torch.Tensor,
    rays_directions: torch.Tensor,
    rays_lengths: torch.Tensor,
) -> torch.Tensor:
    """``points[..., p, :] = origin + length[..., p] * direction`` — ``(..., P, 3)``."""
    return rays_origins[..., None, :] + rays_lengths[..., :, None] * rays_directions[..., None, :]
