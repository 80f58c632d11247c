"""yanerf_tpu_torch ops against their yanerf_tpu counterparts, in float32 on the CPU.

Inputs are made with numpy from a seed and handed to both. Unless a test
says otherwise the tolerance is rtol/atol 1e-6: both sides run the same
float32 formula, and only the order of a few additions (reductions over 3
coordinates or P samples) may differ, which moves a result by an ulp or two.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yanerf_tpu.ops import harmonics as jh
from yanerf_tpu.ops import metrics as jm
from yanerf_tpu.ops import proposal as jp
from yanerf_tpu.ops import raymarch as jr
from yanerf_tpu.ops import rays as jrays
from yanerf_tpu.ops.sample_pdf import sample_pdf as j_sample_pdf
from yanerf_tpu_torch.ops import harmonics as th
from yanerf_tpu_torch.ops import metrics as tm
from yanerf_tpu_torch.ops import proposal as tp
from yanerf_tpu_torch.ops import raymarch as tr
from yanerf_tpu_torch.ops import rays as trays
from yanerf_tpu_torch.ops.sample_pdf import sample_pdf as t_sample_pdf

TOL = dict(rtol=1e-6, atol=1e-6)


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(a, b, **tol):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), **(tol or TOL))


@pytest.mark.parametrize("n_freq,append", [(10, True), (4, True), (3, False)])
def test_harmonic_embedding(n_freq, append):
    x = np.random.RandomState(0).uniform(-3, 3, (5, 7, 3)).astype(np.float32)
    ref = jh.harmonic_embedding(jnp.asarray(x), n_freq, append_input=append)
    got = th.harmonic_embedding(_t(x), n_freq, append_input=append)
    assert got.shape == ref.shape
    # sin/cos of phases up to 3 * 2^9 rad: the two libraries' float32 sin
    # differ by a few ulp of the phase there
    _close(got, ref, rtol=1e-5, atol=1e-5)
    assert th.harmonic_embedding_dim(3, n_freq, append) == jh.harmonic_embedding_dim(3, n_freq, append)


def test_xy_grid_and_ray_bundle():
    rng = np.random.RandomState(1)
    _close(trays.get_xy_grid(5, 7, device="cpu"), jrays.get_xy_grid(5, 7))
    poses = rng.randn(2, 3, 4).astype(np.float32)
    focal = np.array([9.0, 11.0], np.float32)
    grid = np.broadcast_to(jrays.get_xy_grid(6, 4), (2, 6, 4, 2))
    ref = jrays.xy_to_ray_bundle(jnp.asarray(poses), 4, 6, jnp.asarray(focal), jnp.asarray(grid), 2.0, 6.0, 64)
    got = trays.xy_to_ray_bundle(_t(poses), 4, 6, _t(focal), _t(np.array(grid)), 2.0, 6.0, 64)
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        _close(g, r)
    pts_ref = jrays.ray_bundle_to_ray_points(ref.origins, ref.directions, ref.lengths)
    pts = trays.ray_bundle_to_ray_points(got.origins, got.directions, got.lengths)
    _close(pts, pts_ref, rtol=1e-6, atol=2e-6)


@pytest.mark.parametrize("n", [1, 3, 32, 48, 64, 128])
def test_linspace_matches_jnp(n):
    np.testing.assert_array_equal(trays.linspace01(n, device="cpu").numpy(), np.asarray(jnp.linspace(0.0, 1.0, n)))


def test_ray_bundle_unported_options_raise():
    """Every option of ``xy_to_ray_bundle`` is ported and matches JAX: disparity spacing, ``scene_aabb`` and the
    occupancy bounds (a grid: the exact march; a spec: coarse-to-fine, on the image grid's decimated path),
    applied after the slab test and before the depths are drawn."""
    from yanerf_tpu.ops import occupancy as jocc
    from yanerf_tpu_torch.ops import occupancy as tocc

    pose = np.eye(4, dtype=np.float32)[None, :3]
    pose[0, :, 3] = (0.1, -0.2, -2.0)
    xy = np.broadcast_to(trays._xy_grid_np(6, 8), (1, 6, 8, 2)).copy()
    density = np.zeros((12, 12, 12), np.float32)
    density[3:8, 4:9, 5:9] = 10.0
    grids = {pkg: pkg.build_occupancy_grid(density, (-0.6, 0.6), 5.0) for pkg in (jocc, tocc)}
    box = [-0.5, -0.5, -0.5, 0.5, 0.5, 0.5]
    for options in (dict(sample_in_disparity=True), dict(scene_aabb=box), dict(occupancy="grid"),
                    dict(occupancy="spec", scene_aabb=box), dict(occupancy="grid", occupancy_n_probe=16,
                                                                 sample_in_disparity=True)):
        def resolve(pkg, v):
            if v == "grid":
                return grids[pkg]
            return pkg.OccupancyBoundsSpec(grids[pkg], pkg.coarsen_occupancy(grids[pkg], 4), block=2)

        ref = jrays.xy_to_ray_bundle(jnp.asarray(pose), 8, 6, jnp.asarray([[3.0]]), jnp.asarray(xy), 0.5, 4.0, 5,
                                     **{k: jnp.asarray(v) if k == "scene_aabb" else resolve(jocc, v) if k == "occupancy"
                                        else v for k, v in options.items()})
        got = trays.xy_to_ray_bundle(torch.from_numpy(pose), 8, 6, torch.tensor([[3.0]]), torch.from_numpy(xy), 0.5,
                                     4.0, 5, **{k: resolve(tocc, v) if k == "occupancy" else v
                                                for k, v in options.items()})
        _close(got.lengths, ref.lengths)
        if "occupancy" in options:  # tightened: some rays hit the content, some collapse to the far plane
            lengths = got.lengths.numpy()
            assert (lengths[..., -1] < 4.0).any() and (lengths[..., 0] == 4.0).any()


def _ray_inputs(seed=2, n_rays=6, n_pts=9, channels=3):
    rng = np.random.RandomState(seed)
    dens = rng.randn(n_rays, n_pts, 1).astype(np.float32) * 3
    feats = rng.rand(n_rays, n_pts, channels).astype(np.float32)
    lengths = np.sort(rng.uniform(1, 5, (n_rays, n_pts)), axis=-1).astype(np.float32)
    dirs = rng.randn(n_rays, 3).astype(np.float32)
    return dens, feats, lengths, dirs


@pytest.mark.parametrize(
    "kwargs",
    [
        {},
        {"background_density_bias": 1e-6},
        {"capping_function": "cap1", "weight_function": "minimum"},
        {"density_activation": "softplus", "density_pre_activation_bias": -1.0, "surface_thickness": 2},
        {"blend_output": True},
        {"hard_background": True, "default_bg_color": (0.5,)},
    ],
)
def test_emission_absorption(kwargs):
    dens, feats, lengths, dirs = _ray_inputs()
    ref = jr.emission_absorption(jnp.asarray(dens), jnp.asarray(feats), jnp.asarray(lengths), jnp.asarray(dirs), **kwargs)
    got = tr.emission_absorption(_t(dens), _t(feats), _t(lengths), _t(dirs), **kwargs)
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        _close(g, r, rtol=1e-5, atol=1e-6)
    wkw = {k: v for k, v in kwargs.items() if k not in ("blend_output", "hard_background", "default_bg_color")}
    w_ref, o_ref = jr.emission_absorption_weights(jnp.asarray(dens), jnp.asarray(lengths), jnp.asarray(dirs), **wkw)
    w_got, o_got = tr.emission_absorption_weights(_t(dens), _t(lengths), _t(dirs), **wkw)
    _close(w_got, w_ref, rtol=1e-5, atol=1e-6)
    _close(o_got, o_ref, rtol=1e-5, atol=1e-6)


def test_emission_absorption_density_noise_with_fed_draws_matches_jax():
    """Training density noise: N(0, 1) * std on the raw densities, the JAX package's draws fed in."""
    dens, feats, lengths, dirs = _ray_inputs()
    key = jax.random.PRNGKey(7)
    noise = np.asarray(jax.random.normal(key, dens.shape[:-1], dtype=jnp.float32))
    w_ref, o_ref = jr.emission_absorption_weights(
        jnp.asarray(dens), jnp.asarray(lengths), jnp.asarray(dirs), density_noise_std=0.2, rng=key,
        background_density_bias=1e-6,
    )
    w_got, o_got = tr.emission_absorption_weights(
        _t(dens), _t(lengths), _t(dirs), density_noise_std=0.2, noise=_t(noise), background_density_bias=1e-6
    )
    _close(w_got, w_ref, rtol=1e-5, atol=1e-6)
    _close(o_got, o_ref, rtol=1e-5, atol=1e-6)
    ref = jr.emission_absorption(jnp.asarray(dens), jnp.asarray(feats), jnp.asarray(lengths), jnp.asarray(dirs),
                                 density_noise_std=0.2, rng=key)
    got = tr.emission_absorption(_t(dens), _t(feats), _t(lengths), _t(dirs), density_noise_std=0.2, noise=_t(noise))
    for g, r in zip(got, ref):
        _close(g, r, rtol=1e-5, atol=1e-6)
    clean, _ = tr.emission_absorption_weights(_t(dens), _t(lengths), _t(dirs))
    assert float((w_got - clean).abs().max()) > 1e-3, "the noise moves the weights"
    # drawn from a generator: reproducible; with neither draws nor a generator: refused, as without an rng key
    a, _ = tr.emission_absorption_weights(_t(dens), _t(lengths), _t(dirs), density_noise_std=0.2,
                                          generator=torch.Generator().manual_seed(0))
    b, _ = tr.emission_absorption_weights(_t(dens), _t(lengths), _t(dirs), density_noise_std=0.2,
                                          generator=torch.Generator().manual_seed(0))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    with pytest.raises(ValueError, match="generator"):
        tr.emission_absorption_weights(_t(dens), _t(lengths), _t(dirs), density_noise_std=0.2)


def _pdf_inputs(seed=3, n_rays=8, n_bins=15):
    rng = np.random.RandomState(seed)
    bins = np.sort(rng.uniform(2, 6, (n_rays, n_bins + 1)), axis=-1).astype(np.float32)
    weights = rng.rand(n_rays, n_bins).astype(np.float32)
    weights[0] = 0.0  # all-empty ray: the eps floor makes it uniform
    weights[1, -3:] = 0.0  # empty last bins: the top-edge pin
    weights[2, :4] = 0.0
    return bins, weights


@pytest.mark.parametrize("n_samples", [1, 7, 16, 64])
def test_sample_pdf_det(n_samples):
    bins, weights = _pdf_inputs()
    ref = j_sample_pdf(jnp.asarray(bins), jnp.asarray(weights), n_samples, det=True)
    got = t_sample_pdf(_t(bins), _t(weights), n_samples, det=True)
    # the inverse CDF divides by the bin's CDF step: 1e-5 relative at depths ~6
    _close(got, ref, rtol=1e-5, atol=2e-5)


@pytest.mark.parametrize("stratified", [True, False])
def test_sample_pdf_fed_u_matches_jax_draws(stratified):
    bins, weights = _pdf_inputs(seed=4)
    key = jax.random.PRNGKey(5)
    ref = j_sample_pdf(jnp.asarray(bins), jnp.asarray(weights), 12, rng=key, det=False, stratified=stratified)
    u = np.asarray(jax.random.uniform(key, (bins.shape[0], 12), dtype=jnp.float32))
    got = t_sample_pdf(_t(bins), _t(weights), 12, det=False, stratified=stratified, u=_t(u))
    _close(got, ref, rtol=1e-5, atol=2e-5)


def test_sample_pdf_generator_draws_are_reproducible():
    bins, weights = _pdf_inputs()
    a = t_sample_pdf(_t(bins), _t(weights), 9, generator=torch.Generator().manual_seed(0), stratified=True)
    b = t_sample_pdf(_t(bins), _t(weights), 9, generator=torch.Generator().manual_seed(0), stratified=True)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert bool((a[:, 1:] >= a[:, :-1]).all()), "stratified samples are sorted by construction"


def _histograms(seed=6, n_rays=5, p_final=9, p_prop=13):
    rng = np.random.RandomState(seed)
    fl = np.sort(rng.uniform(2, 6, (n_rays, p_final)), axis=-1).astype(np.float32)
    fw = rng.dirichlet(np.ones(p_final), n_rays).astype(np.float32)
    pl = np.sort(rng.uniform(2, 6, (n_rays, p_prop)), axis=-1).astype(np.float32)
    pw = rng.dirichlet(np.ones(p_prop), n_rays).astype(np.float32)
    return fl, fw, pl, pw


def test_interlevel_loss():
    fl, fw, pl, pw = _histograms()
    ref = jp.interlevel_loss(*map(jnp.asarray, (fl, fw, pl, pw)))
    got = tp.interlevel_loss(*map(_t, (fl, fw, pl, pw)))
    assert got.shape == ref.shape
    _close(got, ref, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("in_disparity,bounds", [(False, False), (False, True), (True, True)])
def test_distortion_loss(in_disparity, bounds):
    fl, fw, _, _ = _histograms(seed=7)
    near, far = (fl[:, :1] - 0.5, fl[:, -1:] + 0.5) if bounds else (None, None)
    ref = jp.distortion_loss(
        jnp.asarray(fl), jnp.asarray(fw), in_disparity=in_disparity,
        near=None if near is None else jnp.asarray(near), far=None if far is None else jnp.asarray(far),
    )
    got = tp.distortion_loss(
        _t(fl), _t(fw), in_disparity=in_disparity,
        near=None if near is None else _t(near), far=None if far is None else _t(far),
    )
    _close(got, ref, rtol=1e-5, atol=1e-7)


def test_view_metrics_serving_case():
    rng = np.random.RandomState(8)
    grid = np.broadcast_to(jrays.get_xy_grid(4, 5), (2, 4, 5, 2))
    pred = rng.rand(2, 4, 5, 3).astype(np.float32)
    assert tm.view_metrics(_t(grid), images=None, images_pred=_t(pred)) == {}
    assert jm.view_metrics(jnp.asarray(grid), images=None, images_pred=jnp.asarray(pred)) == {}
    assert set(tm.view_metrics(_t(grid), images=_t(pred), images_pred=_t(pred))) == {"loss_rgb_mse", "loss_rgb_huber"}
    with pytest.raises(NotImplementedError):
        tm.view_metrics(_t(grid), depths=_t(pred[..., :1]), depths_pred=_t(pred[..., :1]))


def test_sample_grid_gathers_pixels():
    rng = np.random.RandomState(9)
    img = rng.rand(2, 4, 5, 3).astype(np.float32)
    grid = np.stack([rng.randint(0, 5, (2, 6)), rng.randint(0, 4, (2, 6))], axis=-1).astype(np.float32)
    ref = jm.sample_grid(jnp.asarray(img), jnp.asarray(grid))
    np.testing.assert_array_equal(tm.sample_grid(_t(img), _t(grid)).numpy(), np.asarray(ref))
