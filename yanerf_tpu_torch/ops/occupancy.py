"""Occupancy-grid empty-space skipping for evaluation rendering.

Counterpart of ``yanerf_tpu/ops/occupancy.py``. A binary voxel grid fitted
to a trained model (``fit_occupancy.py``) tightens each ray's depth
interval to the first and last occupied voxel along it, so the same fixed
sample budget lands where the content is; every shape stays static.

The grid is built, pooled, saved and loaded in numpy (the same ``.npz``
keys as the JAX package, so either package reads the other's grids): the
threshold and dilation (``build_occupancy_grid``) and the conservative
coarse grid (``coarsen_occupancy``). The bounds are tensor functions with
no host sync: the probe march (``occupancy_ray_bounds``), the two-stage
coarse-then-fine march and the decimated image path
(``OccupancyBoundsSpec``, ``occupancy_bounds``). They take the grids as
numpy arrays (copied to the device at each call) or as tensors already on
the device (``occupancy_on_device``, which the ray sampler calls once per
device).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from ..utils import device_constant


class OccupancyGrid(NamedTuple):
    """A binary occupancy lattice over a world-space box.

    Attributes:
        grid: ``(Rx, Ry, Rz) uint8``, nonzero where the (dilated) density
            exceeded the build threshold; index order [ix, iy, iz], lattice
            points spanning ``aabb`` inclusively.
        aabb: ``(2, 3) float32`` world-space box the grid spans.
    """

    grid: Union[np.ndarray, torch.Tensor]
    aabb: Union[np.ndarray, torch.Tensor]


class OccupancyBoundsSpec(NamedTuple):
    """How to turn an occupancy grid into per-ray depth bounds cheaply.

    - ``coarse``: march ``n_probe_coarse`` probes against a conservative
      coarse grid first, then ``n_probe`` fine probes across the coarse span;
    - ``block``: on full-image eval grids, march every ``block``-th ray per
      image axis, take the 3x3 neighbourhood union of the decimated maps and
      upsample by repetition.

    ``coarse=None`` and ``block=1`` is the exact path.
    """

    grid: OccupancyGrid
    coarse: Optional[OccupancyGrid] = None
    n_probe: int = 64
    n_probe_coarse: int = 32
    block: int = 2


# --- building, pooling and storing the grid (numpy, on the host) -------------------


def _dilate_binary(occ: np.ndarray, radius: int) -> np.ndarray:
    """Binary max-pool (radius voxels, 6-neighborhood per step) of a 3D mask."""
    occ = occ.astype(bool)
    for _ in range(int(radius)):
        grown = occ.copy()
        for ax in range(3):
            grown[tuple(slice(None, -1) if i == ax else slice(None) for i in range(3))] |= occ[
                tuple(slice(1, None) if i == ax else slice(None) for i in range(3))
            ]
            grown[tuple(slice(1, None) if i == ax else slice(None) for i in range(3))] |= occ[
                tuple(slice(None, -1) if i == ax else slice(None) for i in range(3))
            ]
        occ = grown
    return occ


def build_occupancy_grid(density_grid: np.ndarray, bounds: Tuple[float, float], threshold: float,
                         dilate: int = 1) -> OccupancyGrid:
    """Threshold and dilate an evaluated density lattice (``mesh.evaluate_density_grid``) into a binary grid.

    ``bounds`` is the ``(lo, hi)`` cube the lattice points span; one voxel
    of dilation covers density that peaks between lattice points and keeps
    the probe-spacing error of :func:`occupancy_ray_bounds` conservative.
    """
    occ = _dilate_binary(density_grid > float(threshold), int(dilate))
    lo, hi = float(bounds[0]), float(bounds[1])
    aabb = np.asarray([[lo, lo, lo], [hi, hi, hi]], np.float32)
    return OccupancyGrid(grid=occ.astype(np.uint8), aabb=aabb)


def occupancy_fraction(occ: OccupancyGrid) -> float:
    """Fraction of voxels occupied: the headroom for skipping."""
    return float(np.asarray(occ.grid, np.float32).mean())


def _conservative_axis_pool(g: np.ndarray, axis: int, rc: int) -> np.ndarray:
    """OR each fine slab along ``axis`` into every coarse index a point inside it can round to.

    Fine voxel ``i`` owns unit coordinates ``[(i-0.5)/(rf-1),
    (i+0.5)/(rf-1)]``; a point there coarse-queries ``round(u*(rc-1))``,
    which ranges over ``[ceil(u_lo*(rc-1)-0.5), floor(u_hi*(rc-1)+0.5)]``
    (a superset of either round-half convention): coarse-empty implies
    fine-empty by construction.
    """
    rf = g.shape[axis]
    out_shape = list(g.shape)
    out_shape[axis] = rc
    out = np.zeros(out_shape, bool)
    gm = np.moveaxis(g, axis, 0)
    om = np.moveaxis(out, axis, 0)
    if rf == 1 or rc == 1:
        np.logical_or.at(om, np.zeros(rf, int), gm)
        return out
    i = np.arange(rf, dtype=np.float64)
    u_lo = np.clip((i - 0.5) / (rf - 1), 0.0, 1.0)
    u_hi = np.clip((i + 0.5) / (rf - 1), 0.0, 1.0)
    j_lo = np.clip(np.ceil(u_lo * (rc - 1) - 0.5).astype(int), 0, rc - 1)
    j_hi = np.clip(np.floor(u_hi * (rc - 1) + 0.5).astype(int), 0, rc - 1)
    for off in range(int((j_hi - j_lo).max()) + 1):
        np.logical_or.at(om, np.minimum(j_lo + off, j_hi), gm)
    return out


def coarsen_occupancy(occ: OccupancyGrid, factor: int) -> OccupancyGrid:
    """Pool the binary grid by ``factor`` per axis into a strictly conservative coarse grid.

    Both grids are lattices spanning the same box, so every fine voxel is
    ORed into exactly the coarse cells its points can round to
    (:func:`_conservative_axis_pool`), at ``ceil(res / factor)`` per axis.
    """
    factor = int(factor)
    if factor <= 1:
        return occ
    g = np.asarray(occ.grid) > 0
    for axis in range(3):
        rc = max(1, -(-g.shape[axis] // factor))
        g = _conservative_axis_pool(g, axis, rc)
    return OccupancyGrid(grid=g.astype(np.uint8), aabb=np.asarray(occ.aabb, np.float32))


def save_occupancy(path: str, occ: OccupancyGrid, threshold: float) -> None:
    np.savez_compressed(
        path,
        occupancy=np.asarray(occ.grid, np.uint8),
        aabb=np.asarray(occ.aabb, np.float32),
        threshold=np.float32(threshold),
    )


def load_occupancy(path: str) -> OccupancyGrid:
    with np.load(path) as z:
        return OccupancyGrid(grid=z["occupancy"].astype(np.uint8), aabb=z["aabb"].astype(np.float32))


# --- the bounds (tensors, on the device) ----------------------------------------------


def occupancy_on_device(occ: Union[OccupancyGrid, OccupancyBoundsSpec], device):
    """``occ`` (a grid or a spec) with its grids as tensors on ``device``: uint8 grids, float32 boxes.

    Not inference tensors, so that a train step may use grids an eval pass
    moved.
    """
    with torch.inference_mode(False):
        if isinstance(occ, OccupancyBoundsSpec):
            return occ._replace(grid=occupancy_on_device(occ.grid, device),
                                coarse=None if occ.coarse is None else occupancy_on_device(occ.coarse, device))
        return OccupancyGrid(grid=torch.as_tensor(occ.grid, dtype=torch.uint8, device=device),
                             aabb=torch.as_tensor(occ.aabb, dtype=torch.float32, device=device).reshape(2, 3))


def _bound(value, shape, dtype: torch.dtype, device) -> torch.Tensor:
    """A depth bound broadcast to ``shape``: a tensor as it is, a number as a cached constant."""
    if not isinstance(value, torch.Tensor):
        value = device_constant(("depth_bound", float(value)), lambda: value, dtype, device)
    return value.to(dtype=dtype, device=device).expand(shape)


def _lookup(grid: torch.Tensor, aabb: torch.Tensor, coords) -> torch.Tensor:
    """Nearest-lattice lookup of points given per axis (``coords[k]`` the k-th coordinate); outside is empty.

    Per axis, so that a march never holds the ``(..., 3)`` probe points
    whole: ``unit = (x - lo) / (hi - lo)``, the index ``round(unit * (R -
    1))`` (half to even, as ``jnp.round``), clamped into the grid.
    """
    res = grid.shape
    flat, inside = None, None
    for k in range(3):
        unit = (coords[k] - aabb[0, k]) / (aabb[1, k] - aabb[0, k])
        idx = torch.clamp(torch.round(unit * float(res[k] - 1)), 0, res[k] - 1).to(torch.int64)
        within = (unit >= 0.0) & (unit <= 1.0)
        flat = idx if flat is None else flat * res[k] + idx
        inside = within if inside is None else inside & within
    return (torch.take(grid, flat) > 0) & inside


def query_occupancy(occ_grid, aabb, points: torch.Tensor) -> torch.Tensor:
    """Nearest-voxel occupancy of ``points (..., 3)``; points outside the box are empty. Returns ``(...,)`` bool."""
    grid, box = occupancy_on_device(OccupancyGrid(occ_grid, aabb), points.device)
    return _lookup(grid, box.to(points.dtype), [points[..., k] for k in range(3)])


def occupancy_ray_bounds(
    origins: torch.Tensor,
    directions: torch.Tensor,
    occ: OccupancyGrid,
    t_lo,
    t_hi,
    n_probe: int = 128,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Tighten per-ray depth bounds to the occupied span along each ray.

    ``n_probe`` cell-centred probe depths across ``[t_lo, t_hi]`` per ray
    (the parameter of the bundle's lengths: directions unnormalized), each
    looked up in the grid; the interval from the first to the last occupied
    probe, widened by one probe spacing on each side and clamped into the
    outer bounds. A ray with no occupied probe collapses to ``[t_hi,
    t_hi]`` (background, as a slab-test miss). ``t_lo`` / ``t_hi``: numbers
    or tensors broadcastable to ``origins.shape[:-1]``. Returns ``(t_near,
    t_far)``, each ``origins.shape[:-1]``.
    """
    dtype, device = origins.dtype, origins.device
    grid, aabb = occupancy_on_device(occ, device)
    aabb = aabb.to(dtype)
    lo = _bound(t_lo, origins.shape[:-1], dtype, device)
    hi = _bound(t_hi, origins.shape[:-1], dtype, device)
    span = hi - lo
    step = span / float(n_probe)
    k = (torch.arange(n_probe, dtype=dtype, device=device) + 0.5) / float(n_probe)  # cell centres
    t = lo[..., None] + span[..., None] * k  # (..., n_probe)
    hit = _lookup(grid, aabb, [origins[..., None, a] + t * directions[..., None, a] for a in range(3)])

    big = torch.finfo(dtype).max
    t_first = torch.amin(torch.where(hit, t, big), dim=-1)
    t_last = torch.amax(torch.where(hit, t, -big), dim=-1)
    t_near = torch.minimum(torch.maximum(t_first - step, lo), hi)
    t_far = torch.minimum(torch.maximum(t_last + step, lo), hi)
    miss = ~torch.any(hit, dim=-1)
    return torch.where(miss, hi, t_near), torch.where(miss, hi, t_far)


def occupancy_bounds(
    origins: torch.Tensor,
    directions: torch.Tensor,
    spec: Union[OccupancyGrid, OccupancyBoundsSpec],
    t_lo,
    t_hi,
    n_probe: int = 128,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-ray occupancy bounds for a plain grid (the exact march, ``n_probe`` probes) or a spec.

    A spec carries its own probe counts; its decimated image path engages
    only when the rays form an image grid, ``origins.shape == (B, H, W,
    3)`` with H and W larger than ``block``.
    """
    if isinstance(spec, OccupancyGrid):
        return occupancy_ray_bounds(origins, directions, spec, t_lo, t_hi, n_probe=n_probe)
    block = int(spec.block)
    spatial = origins.shape[1:-1]
    if block > 1 and len(spatial) == 2 and min(spatial) > block:
        return _occupancy_image_bounds(origins, directions, spec, t_lo, t_hi)
    return _two_stage_bounds(origins, directions, spec, t_lo, t_hi)


def _two_stage_bounds(origins, directions, spec: OccupancyBoundsSpec, t_lo, t_hi):
    """Coarse-grid march to find the rough span, fine-grid march inside it."""
    lo, hi = t_lo, t_hi
    if spec.coarse is not None:
        lo, hi = occupancy_ray_bounds(origins, directions, spec.coarse, lo, hi, n_probe=int(spec.n_probe_coarse))
    return occupancy_ray_bounds(origins, directions, spec.grid, lo, hi, n_probe=int(spec.n_probe))


def _occupancy_image_bounds(origins, directions, spec: OccupancyBoundsSpec, t_lo, t_hi):
    """Bounds on every ``block``-th ray of a ``(B, H, W, 3)`` image grid, then a conservative 3x3 union.

    The decimated near / far maps are min / max pooled over a 3x3 stride-1
    window, a missed ray counting as an empty interval (the pool's
    identity, not its ``[hi, hi]`` encoding), upsampled by repetition to
    (H, W) and clamped into each ray's own outer interval; a ray whose whole
    neighbourhood missed keeps the far-plane miss.
    """
    dtype, device = origins.dtype, origins.device
    b = int(spec.block)
    bsz, h, w = origins.shape[:3]
    lo = _bound(t_lo, (bsz, h, w), dtype, device)
    hi = _bound(t_hi, (bsz, h, w), dtype, device)
    t0_d, t1_d = _two_stage_bounds(origins[:, ::b, ::b], directions[:, ::b, ::b], spec, lo[:, ::b, ::b],
                                   hi[:, ::b, ::b])
    big = torch.finfo(dtype).max
    miss_d = t1_d <= t0_d
    t0_p = -F.max_pool2d(torch.where(miss_d, -big, -t0_d), kernel_size=3, stride=1, padding=1)
    t1_p = F.max_pool2d(torch.where(miss_d, -big, t1_d), kernel_size=3, stride=1, padding=1)
    t0 = t0_p.repeat_interleave(b, dim=1).repeat_interleave(b, dim=2)[:, :h, :w]
    t1 = t1_p.repeat_interleave(b, dim=1).repeat_interleave(b, dim=2)[:, :h, :w]
    all_miss = t1 <= -big * 0.5
    t0 = torch.minimum(torch.maximum(torch.where(all_miss, hi, t0), lo), hi)
    t1 = torch.minimum(torch.maximum(torch.where(all_miss, hi, t1), lo), hi)
    return torch.minimum(t0, t1), t1
