"""Camera-to-ray geometry.

Counterpart of ``yanerf_tpu/ops/rays.py``: the pixel grid, ray bundles with
depths spaced linearly in depth or in disparity (``sample_in_disparity``)
and optional stratified jitter, per-ray bounds from a content box
(``ray_aabb_bounds``), the forward-facing NDC warp (``ndc_ray_bundle``),
the mip-NeRF 360 scene contraction (``contract_points``), scene-extent
bounds (``get_min_max_depth_bounds``) and ray points. Every function is a
plain tensor function with no host sync and no Python branch on a device
value, so a train step that calls them can be captured as a CUDA graph.
Occupancy-grid bounds (``ops/occupancy.py``, a grid that ``fit_occupancy.py``
fits) tighten the ray bundle's range after the slab test.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Optional, Tuple, Union

import numpy as np
import torch

from ..utils import device_constant
from .occupancy import occupancy_bounds
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
    return device_constant(("xy_grid", image_height, image_width), lambda: _xy_grid_np(image_height, image_width),
                           torch.float32, device)


def _bound(value, dtype: torch.dtype, device) -> torch.Tensor:
    """A depth bound as a tensor on ``device``: a batch's tensor as it is, a number as a cached constant."""
    if isinstance(value, torch.Tensor):
        return value.to(dtype=dtype, device=device)
    return device_constant(("depth_bound", float(value)), lambda: value, dtype, device)


def linspace01(n: int, dtype: torch.dtype = torch.float32, device: Union[str, torch.device] = "cuda") -> torch.Tensor:
    """``n`` evenly spaced values on [0, 1], rounded as ``jnp.linspace`` rounds them.

    ``jnp.linspace`` computes ``iota * (1 / (n - 1))`` and appends the exact
    endpoint; ``torch.linspace`` differs from it by one ulp in places, which
    would move the deterministic ``sample_pdf`` u's off the reference.
    Made once per ``n`` (``device_constant``), so a traced body holds no
    tensor constant of its own.
    """
    if n == 1:
        return torch.zeros(1, dtype=dtype, device=device)

    def make() -> torch.Tensor:
        step = torch.arange(n - 1, dtype=dtype) * torch.tensor(1.0 / (n - 1), dtype=dtype)
        return torch.cat([step, torch.ones(1, dtype=dtype)])

    return device_constant(("linspace01", n), make, dtype, device)


def jiggle_within_stratas(
    bin_centers: torch.Tensor, generator: Optional[torch.Generator] = None, u: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Stratified resampling: one uniform draw per bin around each center.

    Each value ``z`` becomes a draw on ``[z - d-, z + d+]``, the deltas the
    half-distances to the neighbouring centers (zero at the ends). ``u``
    (the shape of ``bin_centers``, on [0, 1)) replaces the generator's draws;
    with neither the call raises.
    """
    mids = 0.5 * (bin_centers[..., 1:] + bin_centers[..., :-1])
    upper = torch.cat([mids, bin_centers[..., -1:]], dim=-1)
    lower = torch.cat([bin_centers[..., :1], mids], dim=-1)
    if u is None:
        if generator is None:
            raise ValueError("stratified depths require a generator or fed-in strata_u")
        u = torch.rand(lower.shape, generator=generator, dtype=lower.dtype, device=lower.device)
    return lower + (upper - lower) * u


def ray_aabb_bounds(
    origins: torch.Tensor,
    directions: torch.Tensor,
    aabb,
    min_depth: Union[float, torch.Tensor],
    max_depth: Union[float, torch.Tensor],
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-ray depth bounds tightened to an axis-aligned box (the slab test).

    ``origin + t * direction`` against ``aabb`` (six numbers, ``[[x0, y0,
    z0], [x1, y1, z1]]``; a constant on the device, made once) in the parameter the bundle's lengths use
    (directions unnormalized). Where a direction component is 0 the slab
    degenerates to an inside-the-slab test; the quotient with the dummy
    divisor is discarded. The interval is clamped inside ``[min_depth,
    max_depth]``, and a ray that misses the box gets ``[max_depth,
    max_depth]``. Returns ``(t_near, t_far)``, each ``origins.shape[:-1]``.
    """
    dtype, device = origins.dtype, origins.device
    values = tuple(float(v) for v in np.asarray(aabb, np.float64).reshape(-1))
    aabb = device_constant(("aabb", values), lambda: np.asarray(values).reshape(2, 3), dtype, device)
    d = directions
    parallel = d == 0
    safe_d = torch.where(parallel, torch.ones_like(d), d)
    t_a = (aabb[0] - origins) / safe_d
    t_b = (aabb[1] - origins) / safe_d
    big = torch.full_like(t_a, torch.finfo(dtype).max)
    inside_slab = (origins >= aabb[0]) & (origins <= aabb[1])
    enter_ax = torch.where(parallel, torch.where(inside_slab, -big, big), torch.minimum(t_a, t_b))
    exit_ax = torch.where(parallel, torch.where(inside_slab, big, -big), torch.maximum(t_a, t_b))
    t_near = torch.amax(enter_ax, dim=-1)
    t_far = torch.amin(exit_ax, dim=-1)
    min_d = _bound(min_depth, dtype, device)
    max_d = _bound(max_depth, dtype, device)
    t_near = torch.minimum(torch.maximum(t_near, min_d), max_d)
    t_far = torch.minimum(torch.maximum(t_far, min_d), max_d)
    miss = t_far <= t_near
    t_near = torch.where(miss, max_d, t_near)
    t_far = torch.where(miss, max_d, t_far)
    return t_near, t_far


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
    occupancy_n_probe: int = 128,
    strata_u: Optional[torch.Tensor] = None,
) -> RayBundle:
    """Unproject pixel coordinates into world-space rays with depth samples.

    Args:
        poses: ``(B, 3, 4)`` camera-to-world matrices (rotation | translation).
        image_width/image_height: the sampler's intrinsic size, used for the
            principal point even when ``xy_grid`` covers another resolution.
        focal_lengths: ``(B,)`` or ``(B, 1)`` focal lengths in pixels.
        xy_grid: ``(B, *spatial, 2)`` pixel coordinates to unproject.
        min_depth/max_depth: numbers or tensors (a batch's per-image
            ``(B, 1)`` bounds); their means bound the depth range.
        n_pts_per_ray: number of depth samples per ray (0 for none).
        stratified_sampling: jiggle the depths within their strata, with
            ``strata_u`` (``(B, *spatial, n_pts_per_ray)``) or the
            generator's draws.
        sample_in_disparity: space the depths linearly in inverse depth,
            the bounds clamped to ``lo >= 1e-6`` and ``hi >= lo * (1 +
            1e-6)`` first.
        scene_aabb: a ``(2, 3)`` content box: each ray's range is tightened
            to its slab intersection with the box (``ray_aabb_bounds``).
        occupancy: an ``ops.occupancy.OccupancyGrid`` (the exact march,
            ``occupancy_n_probe`` probes per ray) or ``OccupancyBoundsSpec``
            (coarse-to-fine, image-decimated): each ray's range is further
            tightened to the occupied span along it
            (``ops.occupancy.occupancy_bounds``), inside the ``scene_aabb``
            bounds when both are set, before the depths are drawn.

    Returns:
        A :class:`RayBundle`; directions are NOT normalized (their norm
        carries the depth->distance scale used by the raymarcher).
    """
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
        lo = torch.mean(_bound(min_depth, dtype, device))
        hi = torch.mean(_bound(max_depth, dtype, device))
        if scene_aabb is not None:  # per-ray bounds (B, *spatial)
            lo, hi = ray_aabb_bounds(origins, directions, scene_aabb, lo, hi)
        if occupancy is not None:
            lo, hi = occupancy_bounds(origins, directions, occupancy, lo, hi, n_probe=occupancy_n_probe)
        t = linspace01(n_pts_per_ray, dtype=dtype, device=device)
        if sample_in_disparity:
            # a non-positive near plane would give inf / NaN depths
            lo = torch.clamp(lo, min=1e-6)
            hi = torch.maximum(hi, lo * (1.0 + 1e-6))
            depths = 1.0 / (t * (1.0 / hi - 1.0 / lo)[..., None] + (1.0 / lo)[..., None])
        else:
            depths = t * (hi - lo)[..., None] + lo[..., None]
        rays_zs = depths.expand(batch_size, *spatial_size, n_pts_per_ray)
        if stratified_sampling:
            rays_zs = jiggle_within_stratas(rays_zs, generator, strata_u)
    else:
        rays_zs = torch.zeros((batch_size, *spatial_size, 0), dtype=dtype, device=device)

    return RayBundle(origins=origins, directions=directions, lengths=rays_zs, xys=xy_grid)


def ndc_ray_bundle(
    bundle: RayBundle,
    image_width: int,
    image_height: int,
    focal_lengths: torch.Tensor,
    near: float = 1.0,
) -> RayBundle:
    """Re-parametrize world-space rays into normalized device coordinates (forward-facing scenes).

    The NeRF NDC warp (Mildenhall et al. 2020, appendix C) for +z-forward
    cameras: the rays are advanced to the ``z = near`` plane, then

        o' = (f_x * ox/oz, f_y * oy/oz, 1 - 2*near/oz)
        d' = (f_x * (dx/dz - ox/oz), f_y * (dy/dz - oy/oz), 2*near/oz)

    with ``f_x = 2*focal/W``, ``f_y = 2*focal/H``, so that the parameter
    ``t' in [0, 1]`` sweeps the frustum from the near plane to infinity,
    uniformly in disparity. The facing axis is z flipped to the sign of the
    sum of every ray's ``dz`` in this call (a recentered LLFF capture faces
    -z), ``+1`` where that sum is exactly 0: a device ``where``, no host
    branch. ``lengths`` (expected in [0, 1]) and ``xys`` pass through.
    """
    origins, directions = bundle.origins, bundle.directions
    expand = (origins.shape[0],) + (1,) * (origins.ndim - 2)
    focal = torch.as_tensor(focal_lengths, device=origins.device).reshape(expand).to(origins.dtype)

    s = torch.sign(torch.sum(directions[..., 2]))
    s = torch.where(s == 0, torch.ones_like(s), s)

    t_near = (near - s * origins[..., 2]) / (s * directions[..., 2])
    origins = origins + t_near[..., None] * directions

    ox, oy = origins[..., 0], origins[..., 1]
    dx, dy = directions[..., 0], directions[..., 1]
    oz = s * origins[..., 2]
    dz = s * directions[..., 2]
    fx = 2.0 * focal / float(image_width)
    fy = 2.0 * focal / float(image_height)

    o_ndc = torch.stack([fx * ox / oz, fy * oy / oz, 1.0 - 2.0 * near / oz], dim=-1)
    d_ndc = torch.stack([fx * (dx / dz - ox / oz), fy * (dy / dz - oy / oz), 2.0 * near / oz], dim=-1)
    return RayBundle(origins=o_ndc, directions=d_ndc, lengths=bundle.lengths, xys=bundle.xys)


def ray_bundle_to_ray_points(
    rays_origins: torch.Tensor,
    rays_directions: torch.Tensor,
    rays_lengths: torch.Tensor,
) -> torch.Tensor:
    """``points[..., p, :] = origin + length[..., p] * direction`` — ``(..., P, 3)``."""
    return rays_origins[..., None, :] + rays_lengths[..., :, None] * rays_directions[..., None, :]


def contract_points(points: torch.Tensor, eps: float = 1e-9) -> torch.Tensor:
    """The mip-NeRF 360 scene contraction: ``x`` inside the unit ball, ``(2 - 1/|x|) x/|x|`` outside.

    All of R^3 lands in the radius-2 ball. A double ``where`` keeps the
    branch not taken from producing NaN cotangents (the norm's gradient at
    the origin, ``1/|x|`` near it): the gradient is finite at 0 and on the
    unit sphere.
    """
    norm_sq = torch.sum(points * points, dim=-1, keepdim=True)
    inside = norm_sq <= 1.0
    norm = torch.sqrt(torch.clamp(norm_sq, min=eps * eps))
    safe = torch.where(inside, torch.ones_like(norm), norm)
    contracted = (2.0 - 1.0 / safe) * (points / safe)
    return torch.where(inside, points, contracted)


def get_min_max_depth_bounds(
    poses: torch.Tensor, scene_center: torch.Tensor, scene_extent: float
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Near and far planes from the cameras' distance to the scene center, +- the extent (batch means).

    Takes ``(B, 3, 4)`` or ``(B, 4, 4)`` camera-to-world poses.
    """
    cam_center = poses[:, :3, -1]
    projected_center = torch.einsum("bij,j->bi", poses[:, :3, :3], scene_center)
    center_dist = torch.sqrt(torch.clamp(torch.sum((cam_center - projected_center) ** 2, dim=-1), min=0.001))
    center_dist = torch.clamp(center_dist, min=scene_extent + 1e-3)
    return torch.mean(center_dist - scene_extent), torch.mean(center_dist + scene_extent)
