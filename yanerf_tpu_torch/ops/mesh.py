"""Density-field tools: the model's density on a lattice, iso-surfaces, boxes, vertex colors.

Counterpart of ``yanerf_tpu/ops/mesh.py``. ``evaluate_density_grid`` and
``evaluate_vertex_colors`` query a model through its ray contract
(``model(origins, directions, lengths)``, a zero-length sample so that the
point is the origin, ``_point_query``) in chunks of one fixed size under
``torch.no_grad()``: the last chunk is zero-padded, the results stay on the
device and reach the host once. A NeRFMLP with its kernel switch on
(``use_pallas``) runs one K1 launch per chunk, on ``(1, chunk, 3)`` points
with direction ``(0, 0, 1)``. The irregular part is numpy on the host, as in
the JAX package: naive surface nets (``surface_nets``, one vertex per
sign-crossing cell, one quad per sign-crossing lattice edge),
``fit_scene_aabb``, ``vertex_normals``, ``save_obj`` and ``triangulate``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def _point_query(model: Any, origins: torch.Tensor, directions: torch.Tensor) -> Dict[str, Any]:
    """Query ``model`` at the points ``origins`` through the ray contract; read sample 0 of the output.

    Standard models take one zero-length sample (the point is the origin).
    Interval models (``min_samples_per_ray == 2``, MipNeRFMLP) take two
    samples ``[0, 1e-3]``: interval 0 is then centred at ``t == 0`` with a
    vanishing footprint, and the IPE becomes the plain encoding of the point.
    """
    n_min = int(getattr(model, "min_samples_per_ray", 1))
    zero = torch.zeros(origins.shape[:-1] + (1,), dtype=origins.dtype, device=origins.device)
    lengths = zero if n_min <= 1 else torch.cat([zero, torch.full_like(zero, 1e-3)], dim=-1)
    return model(origins, directions, lengths)


def _device(model: Any) -> torch.device:
    return next(iter(model.parameters())).device


@torch.no_grad()
def evaluate_density_grid(
    model: Any,
    resolution: int = 128,
    bounds: Tuple[float, float] = (-1.5, 1.5),
    chunk: int = 65536,
    density_activation: Optional[Callable] = None,
) -> np.ndarray:
    """Evaluate ``model``'s density on a ``resolution^3`` lattice spanning the ``bounds`` cube.

    Args:
        model: a model of the registry (NeRFMLP, MipNeRFMLP, ProposalMLP,
            HashGridNeRF): ``model(origins, directions, lengths)`` returns
            ``rays_densities``; its parameters' device is where it runs.
        resolution: lattice points per axis.
        bounds: ``(lo, hi)`` of the cube in model coordinates.
        chunk: lattice points per model call (every call the same shape).
        density_activation: raw density -> sigma; ``relu`` by default (the
            emission-absorption raymarcher's activation).

    Returns:
        ``(resolution,) * 3`` float32 numpy array, index order [ix, iy, iz].
    """
    device = _device(model)
    lo, hi = float(bounds[0]), float(bounds[1])
    axis = np.linspace(lo, hi, resolution, dtype=np.float32)
    pts = np.stack(np.meshgrid(axis, axis, axis, indexing="ij"), axis=-1).reshape(-1, 3)
    n = pts.shape[0]
    chunk = int(min(chunk, n))
    n_chunks = (n + chunk - 1) // chunk
    pad = n_chunks * chunk - n
    if pad:
        pts = np.concatenate([pts, np.zeros((pad, 3), np.float32)], axis=0)
    points = torch.as_tensor(pts, device=device).reshape(n_chunks, 1, chunk, 3)
    directions = torch.tensor([0.0, 0.0, 1.0], device=device).expand(1, chunk, 3)
    grid = torch.empty((n_chunks, chunk), dtype=torch.float32, device=device)
    for i in range(n_chunks):
        out = _point_query(model, points[i], directions)
        grid[i] = out["rays_densities"][0, :, 0, 0].to(torch.float32)
    grid = (F.relu if density_activation is None else density_activation)(grid)
    return grid.cpu().numpy().reshape(-1)[:n].reshape(resolution, resolution, resolution)


@torch.no_grad()
def evaluate_vertex_colors(model: Any, verts: np.ndarray, normals: np.ndarray, chunk: int = 65536) -> np.ndarray:
    """The model's color head at surface points, each seen along ``-normal`` (a camera outside the surface).

    Returns ``(V, 3) float32`` colors in [0, 1] (the head's sigmoid).
    """
    n = len(verts)
    if n == 0:
        return np.zeros((0, 3), np.float32)
    device = _device(model)
    chunk = int(min(chunk, n))
    n_chunks = (n + chunk - 1) // chunk
    pad = n_chunks * chunk - n
    pts = np.asarray(verts, np.float32)
    dirs = -np.asarray(normals, np.float32)
    if pad:
        pts = np.concatenate([pts, np.zeros((pad, 3), np.float32)], axis=0)
        dirs = np.concatenate([dirs, np.tile(np.array([[0, 0, 1]], np.float32), (pad, 1))], axis=0)
    points = torch.as_tensor(pts, device=device).reshape(n_chunks, 1, chunk, 3)
    directions = torch.as_tensor(dirs, device=device).reshape(n_chunks, 1, chunk, 3)
    colors = torch.empty((n_chunks, chunk, 3), dtype=torch.float32, device=device)
    for i in range(n_chunks):
        colors[i] = _point_query(model, points[i], directions[i])["rays_features"][0, :, 0, :3].to(torch.float32)
    return colors.cpu().numpy().reshape(-1, 3)[:n]


def surface_nets(
    grid: np.ndarray,
    iso: float,
    origin: Tuple[float, float, float] = (0.0, 0.0, 0.0),
    spacing: Tuple[float, float, float] = (1.0, 1.0, 1.0),
) -> Tuple[np.ndarray, np.ndarray]:
    """Extract the ``density == iso`` surface as a quad mesh.

    Vectorized naive surface nets: each lattice cell crossed by the surface
    gets ONE vertex at the mean of its (linearly interpolated) edge
    crossings; each sign-crossing lattice edge interior to the grid emits
    one quad over the 4 cells sharing it, wound so face normals point
    toward decreasing density (outward for a solid object).

    Args:
        grid: ``(Nx, Ny, Nz)`` scalar field, indexed [ix, iy, iz].
        iso: iso-value of the extracted level set.
        origin: world position of grid index (0, 0, 0).
        spacing: world step per index along each axis.

    Returns:
        ``verts (V, 3) float32`` world-space positions and
        ``faces (F, 4) int32`` quads (indices into verts). Both empty when
        the surface does not intersect the grid.
    """
    if grid.ndim != 3:
        raise ValueError(f"grid must be 3-D, got {grid.shape}")
    d = grid.astype(np.float64) - float(iso)
    inside = d > 0
    nx, ny, nz = grid.shape
    if min(nx, ny, nz) < 2:
        raise ValueError(f"grid must be >= 2 per axis, got {grid.shape}")
    cells = (nx - 1, ny - 1, nz - 1)

    vert_sum = np.zeros(cells + (3,), np.float64)
    vert_cnt = np.zeros(cells, np.int32)

    # one pass per edge family (edges along axis `ax`); crossing fraction t
    # by linear interpolation, crossing position accumulated into the <=4
    # cells sharing the edge via shifted-slice adds (no scatter needed)
    crossings = {}
    for ax in range(3):
        lo = [slice(None)] * 3
        hi = [slice(None)] * 3
        lo[ax] = slice(None, -1)
        hi[ax] = slice(1, None)
        d0, d1 = d[tuple(lo)], d[tuple(hi)]
        cross = inside[tuple(lo)] != inside[tuple(hi)]
        with np.errstate(divide="ignore", invalid="ignore"):
            t = np.where(cross, d0 / (d0 - d1), 0.0)
        # edge (i,j,k) of family `ax` starts at lattice point (i,j,k);
        # crossing position in index space:
        idx = np.indices(cross.shape).astype(np.float64)
        pos = np.moveaxis(idx, 0, -1)
        pos[..., ax] += t
        crossings[ax] = cross
        w = cross.astype(np.float64)
        pos_w = pos * w[..., None]
        # cells sharing this edge: offsets over the two non-edge axes
        ax_a, ax_b = [a for a in range(3) if a != ax]
        for da in (0, 1):
            for db in (0, 1):
                sl = [slice(None)] * 3
                # cell index = edge index - offset along the transverse axes;
                # valid cells are a (cells) shaped window of the edge array
                sl[ax_a] = slice(da, da + cells[ax_a])
                sl[ax_b] = slice(db, db + cells[ax_b])
                sl[ax] = slice(0, cells[ax])
                vert_sum += pos_w[tuple(sl)]
                vert_cnt += w[tuple(sl)].astype(np.int32)

    active = vert_cnt > 0
    n_verts = int(active.sum())
    if n_verts == 0:
        return np.zeros((0, 3), np.float32), np.zeros((0, 4), np.int32)

    cell_to_vert = np.full(cells, -1, np.int64)
    cell_to_vert[active] = np.arange(n_verts)
    verts_idx_space = vert_sum[active] / vert_cnt[active][:, None]
    verts = (np.asarray(origin, np.float64) + verts_idx_space * np.asarray(spacing, np.float64)).astype(
        np.float32
    )

    # faces: every crossing edge whose 4 surrounding cells all exist (i.e.
    # the edge is interior along both transverse axes) emits one quad
    faces = []
    for ax in range(3):
        cross = crossings[ax]
        ax_a, ax_b = [a for a in range(3) if a != ax]
        sl = [slice(None)] * 3
        sl[ax] = slice(0, cells[ax])
        sl[ax_a] = slice(1, cells[ax_a])
        sl[ax_b] = slice(1, cells[ax_b])
        interior = cross[tuple(sl)]
        if not interior.any():
            continue
        # orientation: edge start inside -> surface crossed going +ax ->
        # outward normal along +ax
        lo = [slice(None)] * 3
        lo[ax] = slice(None, -1)
        start_inside = inside[tuple(lo)][tuple(sl)]
        # argwhere indices are in the sliced array's axis order == the
        # original (ax0, ax1, ax2); the transverse slices started at 1
        e = np.argwhere(interior)
        full = e.astype(np.int64)
        full[:, ax_a] += 1
        full[:, ax_b] += 1

        def vid(offset_a, offset_b):
            idx = full.copy()
            idx[:, ax_a] -= offset_a
            idx[:, ax_b] -= offset_b
            return cell_to_vert[idx[:, 0], idx[:, 1], idx[:, 2]]

        # quad around the edge in the (ax_a, ax_b) plane; that traversal is
        # counter-clockwise seen from +ax only when (ax, ax_a, ax_b) is an
        # even permutation of (0, 1, 2) — for ax == 1 it is odd, so swap
        v00, v10, v11, v01 = vid(1, 1), vid(0, 1), vid(0, 0), vid(1, 0)
        quad_ccw = np.stack([v00, v10, v11, v01], axis=1)
        quad_cw = quad_ccw[:, ::-1]
        if ax == 1:
            quad_ccw, quad_cw = quad_cw, quad_ccw
        flip = start_inside[e[:, 0], e[:, 1], e[:, 2]]
        faces.append(np.where(flip[:, None], quad_ccw, quad_cw))

    faces = np.concatenate(faces, axis=0).astype(np.int32) if faces else np.zeros((0, 4), np.int32)
    return verts, faces


def fit_scene_aabb(
    grid: np.ndarray,
    bounds: Tuple[float, float],
    threshold: float,
    margin: float = 0.05,
) -> np.ndarray:
    """Tight world-space AABB of the density field's occupied region.

    Used to feed ``RaySampler.scene_aabb`` (per-ray depth tightening,
    ops/rays.py::ray_aabb_bounds): lattice points whose activated density
    exceeds ``threshold`` define the content; the box is their index-space
    extent mapped to world coordinates, padded by ``margin`` of the extent
    plus one lattice spacing (so interpolated density between lattice
    points stays inside).

    Args:
        grid: ``(R, R, R)`` activated densities from
            ``evaluate_density_grid`` (index order [ix, iy, iz], world
            axis-aligned).
        bounds: the ``(lo, hi)`` cube the grid was evaluated on.
        threshold: occupancy density cutoff (sigma units). A sample at
            density s contributes alpha 1-exp(-s*delta); with typical
            deltas of ~1e-2 scene units, s below ~1 is visually empty.
        margin: relative padding per axis.

    Returns:
        ``(2, 3) float32`` — ``[[x0, y0, z0], [x1, y1, z1]]``.
    """
    occupied = np.argwhere(grid > threshold)
    if occupied.size == 0:
        raise ValueError(f"no density above threshold {threshold} (grid max {grid.max():.3f})")
    lo, hi = float(bounds[0]), float(bounds[1])
    spacing = (hi - lo) / (np.asarray(grid.shape, np.float64) - 1)
    mins = lo + occupied.min(0) * spacing
    maxs = lo + occupied.max(0) * spacing
    pad = margin * (maxs - mins) + spacing
    return np.stack([mins - pad, maxs + pad]).astype(np.float32)


def vertex_normals(verts: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """Area-weighted per-vertex normals of a quad mesh.

    Each quad contributes its (unnormalized, hence area-weighted) normal —
    the cross-product sum of its two 0-2-diagonal triangles — to all four
    corner vertices. ``surface_nets`` winds faces outward, so these normals
    point out of the solid.

    Returns:
        ``(V, 3) float32`` unit normals; vertices with a degenerate normal
        sum (cancelling adjacent faces) fall back to ``+z``.
    """
    vn = np.zeros((len(verts), 3), np.float64)
    if faces.size:
        a, b, c, d = (verts[faces[:, i]].astype(np.float64) for i in range(4))
        n = np.cross(b - a, c - a) + np.cross(c - a, d - a)
        for i in range(4):
            np.add.at(vn, faces[:, i], n)
    norm = np.linalg.norm(vn, axis=1, keepdims=True)
    vn = np.where(norm > 1e-12, vn / np.maximum(norm, 1e-12), np.array([0.0, 0.0, 1.0]))
    return vn.astype(np.float32)


def save_obj(
    path: str, verts: np.ndarray, faces: np.ndarray, colors: Optional[np.ndarray] = None
) -> None:
    """Write a (quad) mesh as Wavefront OBJ (1-indexed faces).

    ``colors`` (V, 3) in [0, 1], if given, are written via the widely
    supported vertex-color OBJ extension (``v x y z r g b`` — read by
    MeshLab, Blender, trimesh, …).
    """
    if colors is not None and len(colors) != len(verts):
        raise ValueError(f"{len(colors)} colors for {len(verts)} verts")
    with open(path, "w") as f:
        f.write(f"# yanerf_tpu surface-nets mesh: {len(verts)} verts, {len(faces)} quads\n")
        if colors is None:
            for v in verts:
                f.write(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
        else:
            for v, c in zip(verts, np.clip(colors, 0.0, 1.0)):
                f.write(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f} {c[0]:.4f} {c[1]:.4f} {c[2]:.4f}\n")
        for q in faces:
            f.write(f"f {q[0] + 1} {q[1] + 1} {q[2] + 1} {q[3] + 1}\n")


def triangulate(faces: np.ndarray) -> np.ndarray:
    """Split quads (F, 4) into triangles (2F, 3) along the 0-2 diagonal."""
    if faces.size == 0:
        return np.zeros((0, 3), faces.dtype if faces.size else np.int32)
    return np.concatenate([faces[:, [0, 1, 2]], faces[:, [0, 2, 3]]], axis=0)
