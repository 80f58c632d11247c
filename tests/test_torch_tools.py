"""The density-field tools and eval-time occupancy bounds of yanerf_tpu_torch against yanerf_tpu, on the CPU.

  * ``ops/occupancy.py``: every case of tests/test_occupancy.py on the
    port, each against the JAX function on the same inputs: the lookup,
    the exact march, a full grid as the identity, build / dilate / the
    ``.npz`` (read across packages both ways), the conservative coarsening
    at every lattice point, the two-stage march, the decimated image bounds
    covering the exact ones, the sampler's eval-only bounds, a full grid a
    bit-exact no-op in the sampler, the NDC refusal. The sampler's bounds
    against the JAX sampler under ``jit`` (grid and box constants: XLA may
    turn ``x / c`` into ``x * (1 / c)``, one ulp off), with the rays whose
    bounds differ counted and each difference at most one probe spacing;
    the decimated path engages on an image grid only, training rays take
    the two-stage path, and a frame's bounds are computed once, before the
    chunks;
  * ``ops/mesh.py``: every case of tests/test_mesh.py; surface nets,
    vertex normals, the fitted box and the OBJ bytes equal to JAX's on the
    same grid; ``evaluate_density_grid`` of NeRFMLP through the kernel's
    plain version (one call per chunk, the last zero-padded) and of
    MipNeRFMLP at 1e-5 against the JAX function;
  * the tools: ``print_config`` prints what scripts/print_config.py prints
    for every configs/nerf/*.yml; ``fit_occupancy``, ``fit_aabb``,
    ``extract_mesh`` and ``render`` run their ``main`` with ``--device cpu``
    on a tiny checkpoint.
"""

import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import yanerf_tpu.ops.mesh as jmesh
import yanerf_tpu.ops.occupancy as jocc
from yanerf_tpu.models import MODELS as JAX_MODELS
from yanerf_tpu.ops.structures import EvaluationMode as JaxEvaluationMode
from yanerf_tpu.pipelines import RAY_SAMPLERS as JAX_RAY_SAMPLERS
from yanerf_tpu_torch import extract_mesh, fit_aabb, fit_occupancy, print_config, render
from yanerf_tpu_torch import run as port_run
from yanerf_tpu_torch.convert import load_jax_params
from yanerf_tpu_torch.models import MODELS
from yanerf_tpu_torch.ops import mesh as tmesh
from yanerf_tpu_torch.ops import occupancy as tocc
from yanerf_tpu_torch.ops.kernels import nerf_mlp_fwd as K1
from yanerf_tpu_torch.ops.structures import EvaluationMode
from yanerf_tpu_torch.pipelines import PIPELINES, RAY_SAMPLERS
from yanerf_tpu_torch.synth_scene import write_scene
from yanerf_tpu_torch.utils import Config

REPO = Path(__file__).resolve().parent.parent
SAMPLER = dict(type="RaySampler", image_width=10, image_height=6, min_depth=1.0, max_depth=3.0,
               n_pts_per_ray_training=5, n_pts_per_ray_evaluation=5, n_rays_per_image_sampled_from_mask=4,
               stratified_point_sampling_training=True, stratified_point_sampling_evaluation=False)
BOX = np.asarray([[-1.0] * 3, [1.0] * 3], np.float32)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Every test here runs torch ops on tensors of a few thousand elements: one thread each, so that the
    suite's parallel workers do not oversubscribe the cores (the intra-op pool's barriers then dominate)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _pair(port, ref, **tol):
    for a, b in zip(port, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **(tol or dict(rtol=1e-6, atol=1e-6)))


# --- the lookup and the march --------------------------------------------------------------


def test_query_occupancy_inside_outside_matches_jax():
    grid = np.zeros((8, 8, 8), np.uint8)
    grid[4, 4, 4] = 1
    c = 2.0 * 4.0 / 7.0 - 1.0  # lattice point (4, 4, 4)
    pts = np.asarray([[c, c, c], [0.9, 0.9, 0.9], [1.5, 0.0, 0.0]], np.float32)
    got = tocc.query_occupancy(grid, BOX, _t(pts))
    assert got.tolist() == [True, False, False]
    rng = np.random.RandomState(0)
    rand_grid = (rng.rand(7, 9, 5) < 0.3).astype(np.uint8)
    aabb = np.asarray([[-2.0, -1.0, 0.5], [1.0, 2.0, 3.0]], np.float32)
    pts = rng.uniform(-2.5, 3.5, (4096, 3)).astype(np.float32)
    ref = jocc.query_occupancy(jnp.asarray(rand_grid), jnp.asarray(aabb), jnp.asarray(pts))
    np.testing.assert_array_equal(tocc.query_occupancy(rand_grid, aabb, _t(pts)).numpy(), np.asarray(ref))
    # a grid already on the device as a tensor gives the same
    np.testing.assert_array_equal(tocc.query_occupancy(_t(rand_grid), _t(aabb), _t(pts)).numpy(), np.asarray(ref))


def test_query_occupancy_at_halves_equals_jax_eagerly_and_differs_under_jit_only_there():
    """Points whose lattice coordinate ``unit * (R - 1)`` is a half: ``torch.round`` and ``jnp.round`` both round
    half to even, so the port equals the JAX function as written, bit for bit. Under jit with the grid and box as
    constants (the sampler's case) XLA divides by multiplying with the inverse, one ulp off, and a point on a half
    may round to the neighbouring voxel: those points are counted, and points off the halves all agree."""
    rng = np.random.RandomState(0)
    res = 16
    grid = (rng.rand(res, res, res) < 0.5).astype(np.uint8)
    aabb = np.asarray([[-1.5, -1.0, 0.5], [1.5, 1.0, 3.5]], np.float32)
    unit = (rng.randint(0, res - 1, (20000, 3)) + 0.5) / (res - 1)
    halves = (aabb[0] + unit * (aabb[1] - aabb[0])).astype(np.float32)
    off = (aabb[0] + rng.uniform(-0.1, 1.1, (20000, 3)) * (aabb[1] - aabb[0])).astype(np.float32)
    jitted = jax.jit(lambda p: jocc.query_occupancy(jnp.asarray(grid), jnp.asarray(aabb), p))
    for pts in (halves, off):
        got = tocc.query_occupancy(grid, aabb, _t(pts)).numpy()
        np.testing.assert_array_equal(got, np.asarray(jocc.query_occupancy(jnp.asarray(grid), jnp.asarray(aabb),
                                                                           jnp.asarray(pts))))
        differ = int((got != np.asarray(jitted(jnp.asarray(pts)))).sum())
        print(f"{'halves' if pts is halves else 'off the halves'}: {differ} of {len(pts)} lookups differ from the "
              f"jitted JAX function's")
        assert differ == 0 if pts is off else differ < 0.25 * len(pts)


def _slab_occ(res=32, cls=tocc.OccupancyGrid):
    zz = np.broadcast_to(np.linspace(-1.0, 1.0, res), (res, res, res))
    return cls(grid=((zz >= 0.2) & (zz <= 0.5)).astype(np.uint8), aabb=BOX)


def test_occupancy_ray_bounds_bracket_content_as_jax():
    res, n_probe = 32, 128
    origins = np.asarray([[0.0, 0.0, -3.0], [5.0, 5.0, -3.0]], np.float32)
    dirs = np.asarray([[0.0, 0.0, 1.0], [0.0, 0.0, 1.0]], np.float32)
    t0, t1 = tocc.occupancy_ray_bounds(_t(origins), _t(dirs), _slab_occ(res), 0.1, 10.0, n_probe=n_probe)
    ref = jocc.occupancy_ray_bounds(jnp.asarray(origins), jnp.asarray(dirs), _slab_occ(res, jocc.OccupancyGrid),
                                    0.1, 10.0, n_probe=n_probe)
    _pair((t0, t1), ref)
    t0, t1 = t0.numpy(), t1.numpy()
    step, vox = (10.0 - 0.1) / n_probe, 2.0 / (res - 1)
    assert t0[0] <= 3.2 + 1e-5 and t1[0] >= 3.5 - 1e-5
    assert t0[0] >= 3.2 - step - vox - 1e-5 and t1[0] <= 3.5 + step + vox + 1e-5
    assert t0[1] == pytest.approx(10.0) and t1[1] == pytest.approx(10.0)


def test_full_occupancy_is_identity_bounds():
    occ = tocc.OccupancyGrid(grid=np.ones((16, 16, 16), np.uint8), aabb=np.asarray([[-100.0] * 3, [100.0] * 3],
                                                                                     np.float32))
    t0, t1 = tocc.occupancy_ray_bounds(torch.tensor([[0.3, -0.2, 0.0]]), torch.tensor([[0.1, 0.2, 1.0]]), occ, 0.5,
                                       7.5, n_probe=32)
    assert float(t0[0]) == pytest.approx(0.5, abs=1e-6) and float(t1[0]) == pytest.approx(7.5, abs=1e-6)


def test_build_dilate_and_the_npz_cross_both_packages(tmp_path):
    density = np.zeros((16, 16, 16), np.float32)
    density[8, 8, 8] = 10.0
    occ0 = tocc.build_occupancy_grid(density, (-1.0, 1.0), threshold=5.0, dilate=0)
    occ1 = tocc.build_occupancy_grid(density, (-1.0, 1.0), threshold=5.0, dilate=1)
    assert occ0.grid.sum() == 1 and occ1.grid.sum() == 7  # center + 6 face neighbours
    assert occ1.grid[8, 8, 8] == 1 and occ1.grid[7, 8, 8] == 1 and occ1.grid[8, 8, 9] == 1
    rng = np.random.RandomState(1)
    blob = rng.rand(12, 12, 12).astype(np.float32) * 10.0
    for dilate in (0, 1, 2):
        ref = jocc.build_occupancy_grid(blob, (-2.0, 2.0), 8.0, dilate=dilate)
        got = tocc.build_occupancy_grid(blob, (-2.0, 2.0), 8.0, dilate=dilate)
        np.testing.assert_array_equal(got.grid, ref.grid)
        np.testing.assert_array_equal(got.aabb, ref.aabb)
        assert tocc.occupancy_fraction(got) == jocc.occupancy_fraction(ref)
    # the port reads the JAX package's file and the JAX package the port's, byte for byte the same keys
    jocc.save_occupancy(str(tmp_path / "jax.npz"), ref, threshold=8.0)
    tocc.save_occupancy(str(tmp_path / "port.npz"), got, threshold=8.0)
    for path in ("jax.npz", "port.npz"):
        with np.load(tmp_path / path) as z:
            assert sorted(z.files) == ["aabb", "occupancy", "threshold"] and float(z["threshold"]) == 8.0
        for load in (tocc.load_occupancy, jocc.load_occupancy):
            loaded = load(str(tmp_path / path))
            np.testing.assert_array_equal(loaded.grid, got.grid)
            np.testing.assert_array_equal(loaded.aabb, got.aabb)


def test_coarsen_occupancy_is_conservative_and_equals_jax():
    rng = np.random.default_rng(0)
    res = 33  # not a multiple of the factor
    aabb = np.asarray([[-2.0, -1.0, 0.0], [1.0, 2.0, 3.0]], np.float32)
    fine = tocc.OccupancyGrid(grid=(rng.random((res, res, res)) < 0.03).astype(np.uint8), aabb=aabb)
    coarse = tocc.coarsen_occupancy(fine, 4)
    np.testing.assert_array_equal(coarse.grid, jocc.coarsen_occupancy(jocc.OccupancyGrid(*fine), 4).grid)
    assert max(coarse.grid.shape) <= (res + 3) // 4 and coarse.grid.mean() < 1.0
    pts = _t(rng.uniform(-2.5, 3.5, size=(4096, 3)).astype(np.float32))
    hit_f = tocc.query_occupancy(fine.grid, fine.aabb, pts)
    hit_c = tocc.query_occupancy(coarse.grid, coarse.aabb, pts)
    assert not (hit_f & ~hit_c).any()
    assert tocc.coarsen_occupancy(fine, 1) is fine


def test_coarsen_occupancy_diagonal_corner_voxel():
    """The fine voxel (3, 3, 0) at res 33, factor 4 rounds to the coarse cell (1, 1, 0), a diagonal neighbour
    of its pooling group: it must be marked, and every point of the voxel must be coarse-occupied."""
    res = 33
    grid = np.zeros((res, res, res), np.uint8)
    grid[3, 3, 0] = 1
    fine = tocc.OccupancyGrid(grid=grid, aabb=BOX)
    coarse = tocc.coarsen_occupancy(fine, 4)
    assert coarse.grid[1, 1, 0] == 1 and coarse.grid.sum() <= 8
    c = 2.0 * np.asarray([3, 3, 0]) / (res - 1) - 1.0
    ax = np.linspace(-1.0, 1.0, 9) / (res - 1)
    off = np.stack(np.meshgrid(ax, ax, ax, indexing="ij"), axis=-1).reshape(-1, 3)
    pts = _t(np.clip(c + off * 0.999, -1.0, 1.0).astype(np.float32))
    hit_f = tocc.query_occupancy(fine.grid, fine.aabb, pts)
    hit_c = tocc.query_occupancy(coarse.grid, coarse.aabb, pts)
    assert hit_f.all() and hit_c[hit_f].all()


@pytest.mark.parametrize("voxel", [(0, 0, 0), (3, 3, 0), (3, 3, 3), (20, 17, 19), (10, 3, 7)])
def test_coarsen_occupancy_conservative_at_every_lattice_point(voxel):
    rng = np.random.default_rng(3)
    res, factor = 21, 4
    grid = np.zeros((res, res, res), np.uint8)
    grid[voxel] = 1
    fine = tocc.OccupancyGrid(grid=grid, aabb=np.asarray([[-2.0, 0.0, -1.0], [2.0, 4.0, 3.0]], np.float32))
    coarse = tocc.coarsen_occupancy(fine, factor)
    np.testing.assert_array_equal(coarse.grid, jocc.coarsen_occupancy(jocc.OccupancyGrid(*fine), factor).grid)
    lo, hi = fine.aabb[0], fine.aabb[1]
    c = lo + (hi - lo) * np.asarray(voxel) / (res - 1)
    half = (hi - lo) / (res - 1) / 2.0
    pts = _t(np.clip(c + rng.uniform(-1, 1, size=(512, 3)) * half * 0.999, lo, hi).astype(np.float32))
    hit_f = tocc.query_occupancy(fine.grid, fine.aabb, pts)
    hit_c = tocc.query_occupancy(coarse.grid, coarse.aabb, pts)
    assert hit_f.any() and not (hit_f & ~hit_c).any()


def _spec(occ, coarse_factor=4, cls=tocc, **kw):
    return cls.OccupancyBoundsSpec(grid=occ, coarse=cls.coarsen_occupancy(occ, coarse_factor), **kw)


def test_two_stage_bounds_bracket_content_as_jax():
    origins = np.asarray([[0.0, 0.0, -3.0], [5.0, 5.0, -3.0]], np.float32)
    dirs = np.asarray([[0.0, 0.0, 1.0], [0.0, 0.0, 1.0]], np.float32)
    kw = dict(n_probe=64, n_probe_coarse=32, block=1)
    t0, t1 = tocc.occupancy_bounds(_t(origins), _t(dirs), _spec(_slab_occ(), **kw), 0.1, 10.0)
    ref = jocc.occupancy_bounds(jnp.asarray(origins), jnp.asarray(dirs),
                                _spec(_slab_occ(cls=jocc.OccupancyGrid), cls=jocc, **kw), 0.1, 10.0)
    _pair((t0, t1), ref)
    t0, t1 = t0.numpy(), t1.numpy()
    assert t0[0] <= 3.2 + 1e-5 and t1[0] >= 3.5 - 1e-5 and t0[0] >= 2.0 and t1[0] <= 4.7
    assert t0[1] == pytest.approx(10.0) and t1[1] == pytest.approx(10.0)


def _blob_occ(res=48, seed=1):
    rng = np.random.default_rng(seed)
    density = np.zeros((res, res, res), np.float32)
    for _ in range(6):
        m, r = res // 6, res // 12  # 8 and 4 at tests/test_occupancy.py's 48
        c = rng.integers(m, res - m, size=3)
        density[c[0] - r : c[0] + r, c[1] - r : c[1] + r, c[2] - r : c[2] + r] = 10.0
    return tocc.build_occupancy_grid(density, (-1.0, 1.0), threshold=5.0, dilate=1)


def _image_rays(h=21, w=21):
    ii, jj = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    dirs = np.stack([(jj - w / 2) / (w / 2) * 0.6, (ii - h / 2) / (h / 2) * 0.6, np.ones_like(ii, np.float32)],
                    axis=-1).astype(np.float32)[None]
    origins = np.broadcast_to(np.asarray([0.0, 0.0, -3.0], np.float32), dirs.shape).copy()
    return origins, dirs


def test_image_decimated_bounds_cover_the_exact_bounds_and_equal_jax():
    occ = _blob_occ()
    kw = dict(n_probe=64, n_probe_coarse=24, block=2)
    origins, dirs = _image_rays()  # odd size: the upsample's crop
    t_lo, t_hi = 0.5, 6.0
    t0_f, t1_f = tocc.occupancy_bounds(_t(origins), _t(dirs), _spec(occ, **kw), t_lo, t_hi)
    ref = jocc.occupancy_bounds(jnp.asarray(origins), jnp.asarray(dirs),
                                _spec(jocc.OccupancyGrid(*occ), cls=jocc, **kw), t_lo, t_hi)
    _pair((t0_f, t1_f), ref, rtol=1e-6, atol=1e-5)
    t0_e, t1_e = tocc.occupancy_ray_bounds(_t(origins), _t(dirs), occ, t_lo, t_hi, n_probe=256)
    t0_f, t1_f, t0_e, t1_e = (t.numpy() for t in (t0_f, t1_f, t0_e, t1_e))
    hit = t1_e > t0_e + 1e-6
    slack = (t_hi - t_lo) / 64 + 1e-4
    assert hit.any() and (~hit).any()
    assert (t0_f[hit] <= t0_e[hit] + slack).all() and (t1_f[hit] >= t1_e[hit] - slack).all()
    assert t0_f.shape == (1, 21, 21) and t1_f.shape == (1, 21, 21)


def test_spec_full_grid_identity():
    occ = tocc.OccupancyGrid(grid=np.ones((8, 8, 8), np.uint8), aabb=np.asarray([[-50.0] * 3, [50.0] * 3],
                                                                                  np.float32))
    origins = torch.zeros(1, 6, 6, 3) + torch.tensor([0.0, 0.0, -3.0])
    dirs = torch.cat([torch.zeros(1, 6, 6, 2), torch.ones(1, 6, 6, 1)], dim=-1)
    t0, t1 = tocc.occupancy_bounds(origins, dirs, _spec(occ, block=2), 0.5, 7.5)
    np.testing.assert_allclose(t0.numpy(), 0.5, atol=1e-6)
    np.testing.assert_allclose(t1.numpy(), 7.5, atol=1e-6)


def test_the_decimated_path_engages_on_image_grids_only(monkeypatch):
    """(B, H, W, 3) with H, W > block takes the decimated path; training rays (B, n, 1, 3) and small images the
    two-stage path, as ops/occupancy.py:304-308."""
    taken = []
    for name in ("_occupancy_image_bounds", "_two_stage_bounds"):
        fn = getattr(tocc, name)
        monkeypatch.setattr(tocc, name, lambda *a, _fn=fn, _name=name: taken.append(_name) or _fn(*a))
    spec = _spec(_blob_occ(res=16), block=2)
    origins, dirs = _image_rays(5, 7)
    for shape, path in (((1, 5, 7, 3), "_occupancy_image_bounds"), ((1, 35, 1, 3), "_two_stage_bounds"),
                        ((1, 2, 7, 3), "_two_stage_bounds")):
        taken.clear()
        o, d = _t(origins.reshape(-1, 3)[: np.prod(shape[:-1])].reshape(shape)), _t(
            dirs.reshape(-1, 3)[: np.prod(shape[:-1])].reshape(shape))
        t0, t1 = tocc.occupancy_bounds(o, d, spec, 0.5, 6.0)
        assert taken[0] == path and tuple(t0.shape) == shape[:-1]


# --- the sampler ---------------------------------------------------------------------------


def _cams(batch=2):
    return torch.eye(4).expand(batch, 4, 4)[:, :3], torch.full((batch, 1), 5.0)


def _content_grid(path, res=32):
    density = np.zeros((res, res, res), np.float32)
    density[14:18, 14:18, 26:29] = 10.0  # world z in [2.71, 3.23] on [-4, 4]
    occ = tocc.build_occupancy_grid(density, (-4.0, 4.0), threshold=5.0, dilate=1)
    tocc.save_occupancy(str(path), occ, threshold=5.0)
    return str(path)


def test_sampler_occupancy_tightens_eval_lengths_only(tmp_path):
    path = _content_grid(tmp_path / "occ.npz")
    sampler = RAY_SAMPLERS.build(dict(SAMPLER, occupancy_grid=path, n_pts_per_ray_evaluation=16,
                                      n_pts_per_ray_training=16))
    poses, focals = _cams()
    lengths = sampler(poses, focals, EvaluationMode.EVALUATION, min_depth=0.1, max_depth=10.0).lengths.numpy()
    hit = lengths[..., -1] < 9.0
    assert hit.any() and lengths[hit].min() >= 2.0 and lengths[hit].max() <= 4.0
    assert np.allclose(lengths[~hit], 10.0)
    # the grids reached the device once: every later frame reuses them
    evaluation = sampler.sampler(EvaluationMode.EVALUATION)
    on_cpu = evaluation.occupancy_on(torch.device("cpu"))
    assert isinstance(on_cpu.grid.grid, torch.Tensor) and isinstance(on_cpu.coarse.grid, torch.Tensor)
    sampler(poses, focals, EvaluationMode.EVALUATION, min_depth=0.1, max_depth=10.0)
    assert evaluation.occupancy_on(torch.device("cpu")) is on_cpu
    train = sampler(poses, focals, EvaluationMode.TRAINING, min_depth=0.1, max_depth=10.0,
                    generator=torch.Generator().manual_seed(0)).lengths.numpy()
    assert train.min() < 1.0 and train.max() > 9.0  # occupancy_eval_only (the default): the full chord
    both = RAY_SAMPLERS.build(dict(SAMPLER, occupancy_grid=path, occupancy_eval_only=False,
                                   n_pts_per_ray_training=16))
    train = both(poses, focals, EvaluationMode.TRAINING, min_depth=0.1, max_depth=10.0,
                 generator=torch.Generator().manual_seed(0)).lengths.numpy()
    assert train.max() <= 10.0 and (train[..., 0] >= 2.0).any()


def test_sampler_occupancy_full_grid_is_a_bit_exact_noop(tmp_path):
    occ = tocc.OccupancyGrid(grid=np.ones((8, 8, 8), np.uint8), aabb=np.asarray([[-50.0] * 3, [50.0] * 3],
                                                                                  np.float32))
    tocc.save_occupancy(str(tmp_path / "full.npz"), occ, threshold=1.0)
    poses, focals = _cams()
    base = RAY_SAMPLERS.build(dict(SAMPLER))(poses, focals, EvaluationMode.EVALUATION)
    for options in ({}, dict(occupancy_coarse_factor=1, occupancy_block=1)):
        with_occ = RAY_SAMPLERS.build(dict(SAMPLER, occupancy_grid=str(tmp_path / "full.npz"), **options))
        assert torch.equal(with_occ(poses, focals, EvaluationMode.EVALUATION).lengths, base.lengths)


def test_sampler_refuses_occupancy_with_ndc_as_jax(tmp_path):
    occ = tocc.OccupancyGrid(grid=np.ones((4, 4, 4), np.uint8), aabb=BOX)
    tocc.save_occupancy(str(tmp_path / "occ.npz"), occ, threshold=1.0)
    cfg = dict(SAMPLER, occupancy_grid=str(tmp_path / "occ.npz"), use_ndc=True)
    with pytest.raises(ValueError) as jax_err:
        JAX_RAY_SAMPLERS.build(dict(cfg))
    with pytest.raises(ValueError, match="NDC") as port_err:
        RAY_SAMPLERS.build(dict(cfg))
    assert str(port_err.value) == str(jax_err.value)


@pytest.mark.parametrize("mode", ["decimated", "exact", "two_stage"])
def test_sampler_bounds_match_the_jax_sampler_under_jit(tmp_path, mode):
    """The JAX sampler under jit captures the grid and box as constants, and XLA may rewrite a division by a
    constant as a multiplication by its inverse (ROADMAP.md "Notes"): a probe that lands on a half between two
    lattice points can round to the other voxel. The rays whose bounds differ are counted (printed), and each
    differs by at most one probe spacing; the probes here do land on halves (a 16-voxel grid over a box whose
    lattice the camera's rays cross everywhere)."""
    occ = _blob_occ(res=16, seed=2)
    occ = tocc.OccupancyGrid(grid=occ.grid, aabb=np.asarray([[-1.5, -1.0, 0.5], [1.5, 1.0, 3.5]], np.float32))
    tocc.save_occupancy(str(tmp_path / "occ.npz"), occ, threshold=5.0)
    options = {"decimated": {}, "exact": dict(occupancy_coarse_factor=1, occupancy_block=1, occupancy_n_probe=48),
               "two_stage": dict(occupancy_block=1)}[mode]
    cfg = dict(SAMPLER, image_width=24, image_height=20, occupancy_grid=str(tmp_path / "occ.npz"),
               n_pts_per_ray_evaluation=8, **options)
    poses = np.eye(4, dtype=np.float32)[None, :3].repeat(2, axis=0)
    poses[1, :, 3] = (0.1, -0.05, 0.2)
    focals = np.full((2, 1), 12.0, np.float32)
    jax_sampler = JAX_RAY_SAMPLERS.build(dict(cfg))
    ref = jax.jit(lambda p, f: jax_sampler(None, p, f, JaxEvaluationMode.EVALUATION, min_depth=0.5,
                                           max_depth=4.0).lengths)(jnp.asarray(poses), jnp.asarray(focals))
    got = RAY_SAMPLERS.build(dict(cfg))(_t(poses), _t(focals), EvaluationMode.EVALUATION, min_depth=0.5,
                                        max_depth=4.0).lengths.numpy()
    ref = np.asarray(ref)
    n_probe = {"decimated": 64, "exact": 48, "two_stage": 64}[mode]
    # a bound moves by one probe spacing of its march; the depths interpolate between the bounds
    spacing = (4.0 - 0.5) / min(n_probe, 32 if mode != "exact" else n_probe)
    differ = np.abs(got - ref).max(axis=-1) > 1e-5
    print(f"{mode}: {int(differ.sum())} of {differ.size} rays' bounds differ from the jitted JAX sampler's, "
          f"by at most {float(np.abs(got - ref).max()):.3g}")
    assert np.abs(got - ref).max() <= spacing + 1e-5
    assert differ.sum() <= 0.05 * differ.size
    hit = got[..., -1] < 4.0 - 1e-5
    assert hit.any() and (~hit).any()


def test_a_frames_bounds_are_computed_once_before_the_chunks(tmp_path, monkeypatch):
    path = _content_grid(tmp_path / "occ.npz", res=16)
    cfg = dict(
        type="NeRFPipeline", chunk_size_grid=64, num_passes=1, output_rasterized_mc=False,
        loss_weights={"loss_rgb_mse": 1.0},
        model=dict(type="NeRFMLP", n_layers=2, input_skips=[1], n_harmonic_functions_xyz=2,
                   n_harmonic_functions_dir=1, n_hidden_neurons_xyz=16, n_hidden_neurons_dir=8),
        ray_sampler=dict(SAMPLER, occupancy_grid=path, min_depth=0.1, max_depth=10.0),
        renderer=dict(type="MultipassEmissionAbsorpsionRenderer", append_coarse_samples_to_fine=True,
                      bg_color=[0.0, 0.0, 0.0], density_noise_std_train=0.0, n_pts_per_ray_fine_training=0,
                      n_pts_per_ray_fine_evaluation=0, background_density_bias=1e-6),
        feature_extractor=[],
    )
    pipeline = PIPELINES.build(cfg, device="cpu")
    from yanerf_tpu_torch.ops import rays as trays

    bounds_calls, chunks = [], []
    bounds = trays.occupancy_bounds
    monkeypatch.setattr(trays, "occupancy_bounds",
                        lambda o, *a, **kw: bounds_calls.append(tuple(o.shape)) or bounds(o, *a, **kw))
    render_call = type(pipeline.renderer).__call__
    monkeypatch.setattr(type(pipeline.renderer), "__call__",
                        lambda self, *a, **kw: chunks.append(1) or render_call(self, *a, **kw))
    poses, focals = _cams(1)
    with torch.no_grad():
        out = pipeline(poses=poses, focal_lengths=focals, evaluation_mode=EvaluationMode.EVALUATION)
    assert bounds_calls == [(1, 6, 10, 3)] and len(chunks) == 5  # 60 rays x 5 points / 64
    assert tuple(out["rendered_images"].shape) == (1, 6, 10, 3)


# --- mesh --------------------------------------------------------------------------------


def _sphere_grid(n=33, r=0.6, lo=-1.0, hi=1.0):
    axis = np.linspace(lo, hi, n)
    x, y, z = np.meshgrid(axis, axis, axis, indexing="ij")
    spacing = (hi - lo) / (n - 1)
    return r - np.sqrt(x * x + y * y + z * z), (lo, lo, lo), (spacing,) * 3


def test_surface_nets_sphere_geometry_and_equal_to_jax():
    r = 0.6
    grid, origin, spacing = _sphere_grid(n=33, r=r)
    verts, faces = tmesh.surface_nets(grid, iso=0.0, origin=origin, spacing=spacing)
    ref_v, ref_f = jmesh.surface_nets(grid, iso=0.0, origin=origin, spacing=spacing)
    np.testing.assert_array_equal(verts, ref_v)
    np.testing.assert_array_equal(faces, ref_f)
    assert len(verts) > 100 and faces.min() >= 0 and faces.max() < len(verts)
    assert np.abs(np.linalg.norm(verts, axis=1) - r).max() < spacing[0]
    edges = np.sort(np.concatenate([np.stack([faces[:, i], faces[:, (i + 1) % 4]], 1) for i in range(4)]), axis=1)
    _, counts = np.unique(edges, axis=0, return_counts=True)
    assert (counts == 2).all() and len(np.unique(faces)) == len(verts)  # watertight, every vertex used
    a, b, c = verts[faces[:, 0]], verts[faces[:, 1]], verts[faces[:, 2]]
    assert ((np.cross(b - a, c - a) * verts[faces].mean(axis=1)).sum(1) > 0).all()  # outward
    tri = tmesh.triangulate(faces)
    np.testing.assert_array_equal(tri, jmesh.triangulate(faces))
    ta, tb, tc = verts[tri[:, 0]], verts[tri[:, 1]], verts[tri[:, 2]]
    np.testing.assert_allclose(0.5 * np.linalg.norm(np.cross(tb - ta, tc - ta), axis=1).sum(), 4 * np.pi * r * r,
                               rtol=0.05)
    vn = tmesh.vertex_normals(verts, faces)
    np.testing.assert_array_equal(vn, jmesh.vertex_normals(verts, faces))
    assert ((vn * verts / np.linalg.norm(verts, axis=1, keepdims=True)).sum(1)).min() > 0.9
    np.testing.assert_allclose(tmesh.vertex_normals(np.zeros((2, 3), np.float32), np.zeros((0, 4), np.int32)),
                               [[0, 0, 1], [0, 0, 1]])
    assert tmesh.triangulate(np.zeros((0, 4), np.int32)).shape == (0, 3)


def test_surface_nets_empty_translation_and_bad_grids():
    grid, origin, spacing = _sphere_grid(n=17, r=0.5)
    verts, faces = tmesh.surface_nets(grid, iso=10.0)
    assert verts.shape == (0, 3) and faces.shape == (0, 4)
    v1, _ = tmesh.surface_nets(grid, iso=0.0, origin=origin, spacing=spacing)
    v2, _ = tmesh.surface_nets(grid, iso=0.0, origin=(5.0, 5.0, 5.0), spacing=(2.0, 2.0, 2.0))
    np.testing.assert_allclose((v1 - np.asarray(origin)) / spacing[0] * 2.0 + 5.0, v2, atol=1e-5)
    for bad in (np.zeros((4, 4)), np.zeros((1, 4, 4))):
        with pytest.raises(ValueError):
            tmesh.surface_nets(bad, iso=0.0)


def test_fit_scene_aabb_equals_jax():
    rng = np.random.RandomState(4)
    grid = np.zeros((20, 20, 20), np.float32)
    grid[4:9, 7:15, 3:18] = rng.uniform(6.0, 9.0, (5, 8, 15))
    for margin in (0.0, 0.05):
        np.testing.assert_array_equal(tmesh.fit_scene_aabb(grid, (-2.0, 2.0), 5.0, margin),
                                      jmesh.fit_scene_aabb(grid, (-2.0, 2.0), 5.0, margin))
    with pytest.raises(ValueError, match="no density above threshold"):
        tmesh.fit_scene_aabb(grid, (-2.0, 2.0), 50.0)


@pytest.mark.parametrize("with_colors", [False, True])
def test_save_obj_writes_the_bytes_of_jax(tmp_path, with_colors):
    grid, origin, spacing = _sphere_grid(n=17, r=0.5)
    verts, faces = tmesh.surface_nets(grid, iso=0.0, origin=origin, spacing=spacing)
    colors = np.random.RandomState(0).uniform(-0.1, 1.1, (len(verts), 3)).astype(np.float32) if with_colors else None
    tmesh.save_obj(str(tmp_path / "port.obj"), verts, faces, colors=colors)
    jmesh.save_obj(str(tmp_path / "jax.obj"), verts, faces, colors=colors)
    assert (tmp_path / "port.obj").read_bytes() == (tmp_path / "jax.obj").read_bytes()
    lines = (tmp_path / "port.obj").read_text().splitlines()
    assert len([ln for ln in lines if ln.startswith("v ")]) == len(verts)
    assert len([ln for ln in lines if ln.startswith("f ")]) == len(faces)
    if with_colors:
        with pytest.raises(ValueError):
            tmesh.save_obj(str(tmp_path / "bad.obj"), verts, faces, colors=colors[:-1])


SMALL_NERF = dict(type="NeRFMLP", n_layers=2, input_skips=[1], n_harmonic_functions_xyz=2, n_harmonic_functions_dir=1,
                  n_hidden_neurons_xyz=16, n_hidden_neurons_dir=8, latent_dim=0, color_dim=3)


def _model_pair(cfg, seed=0):
    jax_model = JAX_MODELS.build(dict(cfg))
    params = jax_model.init(jax.random.PRNGKey(seed))
    model = load_jax_params(MODELS.build(dict(cfg)), jax.tree_util.tree_map(np.asarray, params))
    return jax_model, params, model


def test_density_grid_of_nerf_mlp_through_the_kernel_matches_jax(monkeypatch):
    """With use_pallas every chunk is one K1 call (its plain version on the CPU) on (1, chunk, 3) points and the
    direction (0, 0, 1); 9^3 = 729 points in 12 chunks of 64, the last zero-padded."""
    jax_model, params, model = _model_pair(SMALL_NERF)
    model.use_pallas = True
    calls, k1 = [], K1.nerf_mlp_fwd

    def counted(packed, points, dirs, pts_per_ray, **kw):
        calls.append((tuple(points.shape), tuple(dirs.shape), pts_per_ray, dirs[0].tolist()))
        return k1(packed, points, dirs, pts_per_ray, **kw)

    monkeypatch.setattr(K1, "nerf_mlp_fwd", counted)
    grid = tmesh.evaluate_density_grid(model, resolution=9, bounds=(-1.0, 1.0), chunk=64)
    ref = jmesh.evaluate_density_grid(jax_model, params, resolution=9, bounds=(-1.0, 1.0), chunk=64)
    assert grid.shape == (9, 9, 9) and grid.dtype == np.float32 and (grid >= 0).all()
    np.testing.assert_allclose(grid, ref, rtol=1e-5, atol=1e-5)
    assert calls == [((64, 3), (64, 3), 1, [0.0, 0.0, 1.0])] * 12
    # the vertex colors, seen along -normal
    sphere, origin, spacing = _sphere_grid(n=17, r=0.5)
    verts, faces = tmesh.surface_nets(sphere, iso=0.0, origin=origin, spacing=spacing)
    normals = tmesh.vertex_normals(verts, faces)
    colors = tmesh.evaluate_vertex_colors(model, verts, normals, chunk=64)
    np.testing.assert_allclose(colors, jmesh.evaluate_vertex_colors(jax_model, params, verts, normals, chunk=64),
                               rtol=1e-5, atol=1e-5)
    assert colors.shape == (len(verts), 3) and (colors >= 0).all() and (colors <= 1).all()
    assert len(calls) == 12 + -(-len(verts) // 64)
    assert tmesh.evaluate_vertex_colors(model, np.zeros((0, 3)), np.zeros((0, 3))).shape == (0, 3)


def test_density_grid_of_mip_nerf_mlp_matches_jax():
    """The interval model gets two samples [0, 1e-3] per point: a vanishing footprint at the point."""
    jax_model, params, model = _model_pair(dict(SMALL_NERF, type="MipNeRFMLP", base_radius=5.196e-4))
    grid = tmesh.evaluate_density_grid(model, resolution=5, bounds=(-1.0, 1.0), chunk=32)
    np.testing.assert_allclose(grid, jmesh.evaluate_density_grid(jax_model, params, resolution=5, bounds=(-1.0, 1.0),
                                                                 chunk=32), rtol=1e-5, atol=1e-5)
    verts, normals = np.array([[0.1, 0.2, 0.3]], np.float32), np.array([[0.0, 0.0, 1.0]], np.float32)
    np.testing.assert_allclose(tmesh.evaluate_vertex_colors(model, verts, normals),
                               jmesh.evaluate_vertex_colors(jax_model, params, verts, normals), rtol=1e-5, atol=1e-5)


# --- the tools ---------------------------------------------------------------------------


@pytest.mark.parametrize("config", sorted(p.name for p in (REPO / "configs" / "nerf").glob("*.yml")))
def test_print_config_prints_what_the_script_prints(config, capsys, monkeypatch, tmp_path):
    sys.path.insert(0, str(REPO / "scripts"))
    try:
        import print_config as jax_print_config
    finally:
        sys.path.remove(str(REPO / "scripts"))
    path = str(REPO / "configs" / "nerf" / config)
    options = ["--cfg_options", "runner.seed=3", "pipeline.chunk_size_grid=1024"]
    monkeypatch.setattr(sys, "argv", ["print_config.py", path, "--save_path", str(tmp_path / "jax.yml"), *options])
    jax_print_config.main()
    ref = capsys.readouterr().out
    print_config.main([path, "--save_path", str(tmp_path / "port.yml"), *options])
    got = capsys.readouterr().out
    assert got.replace("port.yml", "jax.yml") == ref
    assert (tmp_path / "port.yml").read_text() == (tmp_path / "jax.yml").read_text()


@pytest.fixture(scope="module")
def tiny_run(tmp_path_factory):
    """A two-step CPU run of lego_proposal.yml's structure at tiny widths on a 16x16 scene; its config and final
    checkpoint, every density bias raised so that the field has content."""
    tmp = tmp_path_factory.mktemp("tools")
    scene = write_scene(tmp / "scene", hw=16, n_train=2, n_val=1, n_test=2, n_spheres=3, seed=1)
    cfg = Config.fromfile(str(REPO / "configs" / "nerf" / "lego_proposal.yml"))
    opts = {"pipeline.ray_sampler.image_height": 16, "pipeline.ray_sampler.image_width": 16,
            "pipeline.ray_sampler.n_rays_per_image_sampled_from_mask": 16, "pipeline.chunk_size_grid": 4096,
            "runner.num_iters": 2, "runner.output_dir": str(tmp / "results"), "runner.val_per_iter": 2,
            "runner.save_per_iter": 2, "runner.num_workers_list": [0, 0, 0], "runner.steps_per_call": 1,
            **{f"datasets.{i}.base_dir": str(scene) for i in range(3)}, "datasets.2.test_skip": 1,
            "pipeline.model.2.n_layers": 3, "pipeline.model.2.input_skips": [2],
            "pipeline.model.2.n_hidden_neurons_xyz": 32, "pipeline.model.2.n_hidden_neurons_dir": 16,
            "pipeline.model.2.use_pallas": True, "pipeline.model.2.use_pallas_train": True,
            **{f"pipeline.model.{i}.{k}": v for i in (0, 1) for k, v in (("n_layers", 2), ("hidden_dim", 16))}}
    cfg.merge_from_dict(opts)
    cfg.dump(str(tmp / "tiny.yml"))
    result = port_run.main(["--config", str(tmp / "tiny.yml"), "--device", "cpu"])
    state = result["state"]
    with torch.no_grad():
        state.pipeline.implicit_functions[2].density_layer.b.add_(8.0)
    from yanerf_tpu_torch.runners import save_checkpoint

    checkpoint = save_checkpoint(tmp, state, epoch=0, name="ckpts_content")
    return dict(tmp=tmp, config=str(tmp / "tiny.yml"), checkpoint=str(checkpoint), pipeline=state.pipeline)


def test_fit_occupancy_and_fit_aabb_run_on_a_checkpoint(tiny_run, capsys, monkeypatch):
    calls, k1 = [], K1.nerf_mlp_fwd
    monkeypatch.setattr(K1, "nerf_mlp_fwd", lambda *a, **kw: calls.append(1) or k1(*a, **kw))
    out = tiny_run["tmp"] / "occ.npz"
    args = ["--config", tiny_run["config"], "--checkpoint", tiny_run["checkpoint"], "--resolution", "20",
            "--chunk", "2048", "--threshold", "7.5", "--device", "cpu"]
    fitted = fit_occupancy.main([*args, "--out", str(out)])
    assert "occupied (dilated) voxel fraction" in capsys.readouterr().out
    assert len(calls) == -(-20**3 // 2048) == 4  # one K1 per chunk (the plain version on the CPU)
    occ = tocc.load_occupancy(str(out))
    assert occ.grid.shape == (20, 20, 20) and 0.0 < tocc.occupancy_fraction(occ) == fitted["fraction"] < 1.0
    np.testing.assert_array_equal(occ.grid, jocc.build_occupancy_grid(fitted["grid"], (-2.0, 2.0), 7.5).grid)
    np.testing.assert_array_equal(jocc.load_occupancy(str(out)).grid, occ.grid)  # the JAX package reads it
    # the grid is the final model's density on the lattice
    np.testing.assert_allclose(fitted["grid"], tmesh.evaluate_density_grid(
        tiny_run["pipeline"].implicit_functions[2], resolution=20, bounds=(-2.0, 2.0)), rtol=1e-6, atol=1e-6)
    # and the flagship frame serves with it
    cfg = Config.fromfile(tiny_run["config"])
    cfg.merge_from_dict({"pipeline.ray_sampler.occupancy_grid": str(out)})
    from yanerf_tpu_torch.serve import CAM_CALIBRATION, orbit_pose, service_from_config

    service = service_from_config(cfg, checkpoint=tiny_run["checkpoint"], device="cpu")
    rgb, depth = service.render((orbit_pose(30.0, -30.0, 4.0) @ CAM_CALIBRATION)[:3, :4].astype(np.float32),
                                service.default_focal)
    assert np.isfinite(rgb).all() and rgb.shape == (16, 16, 3)

    boxed = fit_aabb.main(args)
    printed = capsys.readouterr().out
    np.testing.assert_array_equal(boxed["aabb"], jmesh.fit_scene_aabb(fitted["grid"], (-2.0, 2.0), 7.5, 0.05))
    line = next(ln for ln in printed.splitlines() if ln.startswith("aabb: "))
    assert json.loads(line[len("aabb: "):line.index("]") + 1]) == [round(float(v), 4) for v in boxed["aabb"].ravel()]


def test_extract_mesh_writes_a_colored_obj(tiny_run, capsys):
    out = tiny_run["tmp"] / "mesh.obj"
    mesh = extract_mesh.main(["--config", tiny_run["config"], "--checkpoint", tiny_run["checkpoint"], "--out",
                              str(out), "--resolution", "24", "--iso", "7.5", "--vertex_colors", "--device", "cpu"])
    assert f"wrote {out}: {len(mesh['verts'])} colored vertices, {len(mesh['faces'])} quads" in capsys.readouterr().out
    assert len(mesh["verts"]) > 0 and mesh["colors"].shape == (len(mesh["verts"]), 3)
    lines = out.read_text().splitlines()
    assert sum(ln.startswith("v ") for ln in lines) == len(mesh["verts"])
    assert all(len(ln.split()) == 7 for ln in lines if ln.startswith("v "))


def test_render_writes_the_trajectory(tiny_run, capsys):
    out = tiny_run["tmp"] / "renders"
    done = render.main(["--config", tiny_run["config"], "--checkpoint", tiny_run["checkpoint"], "--output_dir",
                        str(out), "--device", "cpu", "--gif"])
    printed = capsys.readouterr().out
    assert "has no render_poses" in printed and "fps after the first frame" in printed  # Blender: the test cameras
    assert done["frames"] == 2 and done["fps"] > 0
    from yanerf_tpu_torch.utils.images import decode_png

    for i in range(2):
        assert decode_png((out / "rgb" / f"{i:05d}.png").read_bytes()).shape == (16, 16, 3)
        assert decode_png((out / "depth" / f"{i:05d}.png").read_bytes()).shape[:2] == (16, 16)
    assert (out / "rgb.gif").read_bytes().startswith(b"GIF89a")
    one = render.main(["--config", tiny_run["config"], "--checkpoint", tiny_run["checkpoint"], "--output_dir",
                       str(tiny_run["tmp"] / "one"), "--device", "cpu", "--trajectory", "test", "--n_frames", "1"])
    assert one["frames"] == 1
    # a reference-layout .pth of the final NeRFMLP: the proposal MLPs keep the seed's weights
    from yanerf_tpu_torch.runners import export_torch_checkpoint
    from yanerf_tpu_torch.serve import load_pipeline

    stub = torch.nn.Module()
    stub.implicit_functions = torch.nn.ModuleList([tiny_run["pipeline"].implicit_functions[2]])
    pth = tiny_run["tmp"] / "weights.pth"
    export_torch_checkpoint(stub, pth)
    blob = torch.load(pth, weights_only=True)
    blob["model"] = {k.replace("implicit_functions.0.", "implicit_functions.2.", 1): v for k, v in blob["model"].items()}
    torch.save(blob, pth)
    from_pth = render.main(["--config", tiny_run["config"], "--checkpoint", str(pth), "--output_dir",
                            str(tiny_run["tmp"] / "pth"), "--device", "cpu", "--trajectory", "test", "--n_frames", "1"])
    assert from_pth["frames"] == 1
    loaded = load_pipeline(Config.fromfile(tiny_run["config"]), str(pth), "cpu").implicit_functions[2]
    for (key, p), q in zip(loaded.named_parameters(), tiny_run["pipeline"].implicit_functions[2].parameters()):
        assert torch.equal(p, q.detach()), key


def test_chip_smoke_slice_phases_run_on_the_cpu(tiny_run, tmp_path, monkeypatch):
    """chip_smoke.py's multi-scene, tools and occupancy-frame phases at tiny widths: two 16x16 scenes of 6 train
    views (three steps of batch 4 per epoch, two epochs at steps_per_call 2), the tools on a tiny flagship
    checkpoint at a 16^3 lattice in chunks of 1024, and the occupancy frame at 16x16 with a 16^3 ball."""
    import chip_smoke
    from yanerf_tpu_torch.ops.kernels import nerf_mlp_bwd as K3
    from test_torch_latent import _tiny_multiscene_config

    for module, name in ((K1, "nerf_mlp_fwd"), (K3, "nerf_mlp_bwd")):

        def counting(*args, _module=module, _plain=getattr(module, name), **kwargs):
            _module.launches += 1
            return _plain(*args, **kwargs)

        monkeypatch.setattr(module, name, counting)
    for name, value in (("DEVICE", "cpu"), ("MULTISCENE", dict(n_scenes=2, hw=16, n_train=6, n_val=1, n_test=2)),
                        ("MULTISCENE_STEPS", 6), ("MULTISCENE_STEPS_PER_CALL", 2), ("FAMILY_EVAL_RAYS", 40),
                        ("FAMILY_TRAIN_RAYS", 64), ("TOOL_RESOLUTION", 16), ("LATTICE_CHUNK", 1024),
                        ("OCCUPANCY_BALL", (16, 1.5, 1.0)), ("CONFIG", Path(tiny_run["config"]))):
        monkeypatch.setattr(chip_smoke, name, value)
    for attr, config in (("MULTISCENE_LATENT_CONFIG", "synth_multiscene_latent.yml"),
                         ("MULTISCENE_CONTROL_CONFIG", "synth_multiscene_unconditioned.yml")):
        path = _tiny_multiscene_config(config, tmp_path / f"{attr}.yml", tmp_path / "unused", tmp_path / "results")
        monkeypatch.setattr(chip_smoke, attr, path)
    paths = chip_smoke.multiscene_phases(torch, K1, K3, "cpu", tmp_path)
    assert paths["multiscene_latent_train_fused"] == chip_smoke.NO_LAUNCHES  # the JAX rule: no kernel on latents
    assert paths["multiscene_control_train_fused"] == {"nerf_mlp_fwd": 6, "nerf_mlp_fwd_pipelined": 0,
                                                       "nerf_mlp_bwd": 6}
    scene = Path(Config.fromfile(tiny_run["config"]).datasets[0].base_dir)
    (tmp_path / "tools").mkdir()
    tools = chip_smoke.tools_phases(torch, K1, K3, "cpu", tmp_path / "tools", tiny_run["checkpoint"], scene)
    assert tools["fit_occupancy"]["nerf_mlp_fwd"] == tools["fit_aabb"]["nerf_mlp_fwd"] == 4  # 16^3 / 1024
    chunks = chip_smoke.frame_chunks(Config.fromfile(tiny_run["config"]))
    assert chunks == 4  # 16 * 16 * 64 / 4096
    assert tools["extract_mesh"]["nerf_mlp_fwd"] >= 5 and tools["render"]["nerf_mlp_fwd"] == 2 * chunks
    frames = chip_smoke.occupancy_phase(torch, K1, "cpu", tmp_path)
    assert frames == {"occupancy_frame": {"nerf_mlp_fwd": chunks}, "occupancy_frame_exact": {"nerf_mlp_fwd": chunks}}
