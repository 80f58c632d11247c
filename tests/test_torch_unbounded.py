"""Unbounded scenes in yanerf_tpu_torch against yanerf_tpu, on the CPU.

configs/nerf/synth_llff_360_unbounded.yml's path and the per-ray box of
synth800_proposal.yml, held to the JAX package on the same inputs (numpy
seeds) and the same draws:
  * the ops: ``ray_aabb_bounds`` (parallel axes inside and outside their
    slab, misses collapsed to ``[max, max]``), disparity spacing with both
    clamps (``lo >= 1e-6``, ``hi >= lo * (1 + 1e-6)``), per-ray box bounds
    under disparity spacing, ``contract_points`` (its gradient finite at 0
    and on the unit sphere) and ``get_min_max_depth_bounds``, at rtol/atol
    1e-6 (elementwise float32 arithmetic in the same order; the
    reciprocals of the disparity spacing are the same IEEE divisions);
  * ``RaySampler`` with ``sample_in_disparity``, ``scene_aabb`` (in both
    modes and eval-only) and ``scene_extent``, the JAX draws fed in, and
    its ``ValueError``s (occupancy grids: tests/test_torch_tools.py);
  * each model with ``contract_coords`` at f32 1e-5 (ProposalMLP, NeRFMLP
    eager and through the fused function's plain versions against
    ``make_fused_mlp`` in interpret mode, HashGridNeRF and its
    ``scene_bound >= 2`` refusal); every weight tree round-trips
    ``convert.py``;
  * one eval chunk and one train step of the unbounded config's structure
    (two contracted ProposalMLPs and a contracted NeRFMLP on the fused
    function, disparity spacing, per-image bounds, distortion in
    disparity): outputs at 1e-4, objective 1e-5, gradients rtol 2e-4 /
    atol 2e-5;
  * ``synth_llff.py --mode orbit --distant_spheres`` writes the scene of
    ``scripts/make_synth_llff.py``.
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import yanerf_tpu.ops.rays as jrays
from test_torch_classic import F32_GRAD_TOL, RUNNER
from test_torch_train import _capture_draws
from yanerf_tpu.models import MODELS as JAX_MODELS
from yanerf_tpu.ops.structures import EvaluationMode as JaxEvaluationMode
from yanerf_tpu.pipelines import PIPELINES as JAX_PIPELINES
from yanerf_tpu.pipelines import RAY_SAMPLERS as JAX_RAY_SAMPLERS
from yanerf_tpu.runners import apis as jax_apis
from yanerf_tpu.runners import optim as jax_optim
from yanerf_tpu_torch.convert import export_jax_params, flatten_tree, load_jax_params
from yanerf_tpu_torch.models import MODELS
from yanerf_tpu_torch.ops import rays as trays
from yanerf_tpu_torch.ops.kernels.fused_mlp import fused_nerf_mlp
from yanerf_tpu_torch.ops.structures import EvaluationMode
from yanerf_tpu_torch.pipelines import PIPELINES, RAY_SAMPLERS
from yanerf_tpu_torch.runners import TrainState, create_optimizer, make_train_step
from yanerf_tpu_torch.serve import CAM_CALIBRATION, orbit_pose
from yanerf_tpu_torch.synth_llff import write_llff_scene
from yanerf_tpu_torch.utils.images import load_image_u8

REPO = Path(__file__).resolve().parent.parent
TOL = dict(rtol=1e-6, atol=1e-6)
F32 = dict(rtol=1e-5, atol=1e-5)
HW = 8
AABB = [-0.6, -0.5, -0.4, 0.5, 0.7, 0.6]


def _rays(seed=0, n_rays=40):
    rng = np.random.RandomState(seed)
    origins = (rng.randn(1, n_rays, 1, 3) * 1.2).astype(np.float32)
    directions = rng.randn(1, n_rays, 1, 3).astype(np.float32)
    # parallel axes: inside their slab (x, z), outside it (y), and a ray on no axis at all
    directions[0, 0, 0, 0] = 0.0
    origins[0, 0, 0, 0] = 0.1
    directions[0, 1, 0, 1] = 0.0
    origins[0, 1, 0, 1] = 2.0
    directions[0, 2, 0, :2] = 0.0
    origins[0, 2, 0, :2] = (0.0, 0.3)
    directions[0, 3, 0, :] = 0.0
    return origins, directions


def _close(got, ref, **tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), **(tol or TOL))


# --- the ops ------------------------------------------------------------------


@pytest.mark.parametrize("bounds", [(0.5, 4.0), (2.5, 3.0), (0.0, 10.0)], ids=["wide", "narrow", "from_zero"])
def test_ray_aabb_bounds_match_jax(bounds):
    o, d = _rays()
    aabb = np.asarray(AABB, np.float32).reshape(2, 3)
    ref = jrays.ray_aabb_bounds(jnp.asarray(o), jnp.asarray(d), jnp.asarray(aabb), *bounds)
    got = trays.ray_aabb_bounds(torch.from_numpy(o), torch.from_numpy(d), aabb, *bounds)
    for g, r in zip(got, ref):
        assert tuple(g.shape) == (1, 40, 1)
        _close(g, r)
    near, far = (g.numpy() for g in got)
    miss = near == far
    np.testing.assert_array_equal(near[miss], bounds[1])  # a miss collapses to [max, max]
    assert miss[0, 1, 0], "parallel to y outside its slab"
    if bounds[0] < 1.0:  # the narrow range [2.5, 3] lies behind the box for every ray
        assert (~miss).any() and miss.sum() > 1, "both hits and misses"
        assert not miss[0, 2, 0], "parallel to x and y inside both slabs"


@pytest.mark.parametrize(
    "lo,hi,aabb",
    [(0.5, 6.0, None), (0.0, 6.0, None), (-1.0, 3.0, None), (2.0, 2.0, None), (0.5, 6.0, AABB)],
    ids=["plain", "near_zero", "near_negative", "empty_range", "per_ray_box"],
)
@pytest.mark.parametrize("stratified", [False, True])
def test_disparity_spacing_and_its_clamps_match_jax(lo, hi, aabb, stratified):
    pose = (orbit_pose(30.0, -30.0, 2.0) @ CAM_CALIBRATION).astype(np.float32)[None, :3]
    grid = np.broadcast_to(trays._xy_grid_np(4, 5), (1, 4, 5, 2)).copy()
    rng = jax.random.PRNGKey(3)
    ref = jrays.xy_to_ray_bundle(jnp.asarray(pose), 5, 4, jnp.asarray([[6.0]]), jnp.asarray(grid), lo, hi, 7,
                                 stratified, rng=rng, sample_in_disparity=True,
                                 scene_aabb=None if aabb is None else jnp.asarray(aabb))
    u = torch.from_numpy(np.array(jax.random.uniform(rng, (1, 4, 5, 7), dtype=jnp.float32))) if stratified else None
    got = trays.xy_to_ray_bundle(torch.from_numpy(pose), 5, 4, torch.tensor([[6.0]]), torch.from_numpy(grid), lo, hi,
                                 7, stratified, sample_in_disparity=True, scene_aabb=aabb, strata_u=u)
    for name in ("origins", "directions", "lengths", "xys"):
        _close(getattr(got, name), getattr(ref, name))
    lengths = got.lengths.numpy()
    assert np.isfinite(lengths).all() and np.all(lengths >= 1e-6 * (1 - 1e-6))
    assert np.all(np.diff(lengths, axis=-1) >= 0)


def test_per_image_bounds_and_the_box_reach_the_depths_as_tensors():
    """A batch's (B, 1) bound tensors (the LLFF fields) are averaged on the device, as JAX's jnp.mean."""
    pose = (orbit_pose(10.0, -20.0, 2.5) @ CAM_CALIBRATION).astype(np.float32)[None, :3]
    grid = np.broadcast_to(trays._xy_grid_np(3, 3), (1, 3, 3, 2)).copy()
    lo, hi = np.array([[0.7]], np.float32), np.array([[4.3]], np.float32)
    for aabb, disparity in ((None, False), (AABB, False), (AABB, True)):
        ref = jrays.xy_to_ray_bundle(jnp.asarray(pose), 3, 3, jnp.asarray([[4.0]]), jnp.asarray(grid),
                                     jnp.asarray(lo), jnp.asarray(hi), 5, sample_in_disparity=disparity,
                                     scene_aabb=None if aabb is None else jnp.asarray(aabb))
        got = trays.xy_to_ray_bundle(torch.from_numpy(pose), 3, 3, torch.tensor([[4.0]]), torch.from_numpy(grid),
                                     torch.from_numpy(lo), torch.from_numpy(hi), 5, sample_in_disparity=disparity,
                                     scene_aabb=aabb)
        _close(got.lengths, ref.lengths)


def test_contract_points_matches_jax_and_its_gradient_is_finite_at_zero_and_on_the_sphere():
    rng = np.random.RandomState(5)
    pts = (rng.randn(64, 3) * np.array([[0.3], [3.0]]).repeat(32, 0)).astype(np.float32)
    pts[0] = 0.0
    pts[1] = (1.0, 0.0, 0.0)
    pts[2] = np.array([0.6, 0.0, 0.8], np.float32)  # |x| = 1 to float32 rounding
    pts[3] = (1e-20, 0.0, 0.0)
    pts[4] = (1e6, -2e6, 3e6)
    ref = jrays.contract_points(jnp.asarray(pts))
    x = torch.from_numpy(pts).requires_grad_(True)
    got = trays.contract_points(x)
    _close(got, ref)
    assert float(got.detach().norm(dim=-1).max()) < 2.0
    np.testing.assert_array_equal(got.detach().numpy()[:4], pts[:4])  # identity inside the unit ball
    weights = rng.randn(64, 3).astype(np.float32)
    ref_grad = jax.grad(lambda p: jnp.sum(jrays.contract_points(p) * weights))(jnp.asarray(pts))
    (got * torch.from_numpy(weights)).sum().backward()
    assert torch.isfinite(x.grad).all()
    _close(x.grad, ref_grad, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(x.grad.numpy()[:4], weights[:4])  # the identity's gradient at 0 and |x| = 1


def test_get_min_max_depth_bounds_matches_jax():
    rng = np.random.RandomState(6)
    poses = np.stack([orbit_pose(40.0 * i, -20.0 - 5 * i, 3.0 + 0.3 * i) @ CAM_CALIBRATION for i in range(3)])
    poses = poses.astype(np.float32)
    center = rng.randn(3).astype(np.float32) * 0.2
    for poses_in in (poses, poses[:, :3]):
        for extent in (0.5, 1.7, 50.0):
            ref = jrays.get_min_max_depth_bounds(jnp.asarray(poses_in), jnp.asarray(center), extent)
            got = trays.get_min_max_depth_bounds(torch.from_numpy(poses_in), torch.from_numpy(center), extent)
            for g, r in zip(got, ref):
                _close(g, r)


# --- the ray sampler ------------------------------------------------------------


def _sampler_cfg(**options):
    return dict(dict(type="RaySampler", image_height=HW, image_width=HW, min_depth=0.5, max_depth=6.0,
                     n_pts_per_ray_training=5, n_pts_per_ray_evaluation=6, n_rays_per_image_sampled_from_mask=12,
                     pixel_replacement=True), **options)


def _pose_batch():
    pose = (orbit_pose(30.0, -30.0, 2.0) @ CAM_CALIBRATION).astype(np.float32)[None]
    return pose, np.asarray([[10.0]], np.float32)


@pytest.mark.parametrize(
    "options,bounds",
    [(dict(sample_in_disparity=True), None), (dict(sample_in_disparity=True), (0.3, 9.0)),
     (dict(scene_aabb=AABB), None), (dict(scene_aabb=AABB, sample_in_disparity=True), (0.4, 5.0)),
     (dict(scene_aabb=AABB, scene_aabb_eval_only=True), None), (dict(scene_extent=1.2), None),
     (dict(scene_extent=1.2, scene_center=(0.1, -0.2, 0.3)), None), (dict(scene_extent=1.2), (0.6, 4.0))],
    ids=["disparity", "disparity_batch_bounds", "aabb", "aabb_disparity_batch_bounds", "aabb_eval_only", "extent",
         "extent_center", "extent_yields_to_batch_bounds"],
)
@pytest.mark.parametrize("mode", ["training", "evaluation"])
def test_ray_sampler_modes_match_jax(monkeypatch, options, bounds, mode):
    cfg = _sampler_cfg(**options)
    pose, focal = _pose_batch()
    kw = {} if bounds is None else dict(min_depth=np.array([[bounds[0]]], np.float32),
                                        max_depth=np.array([[bounds[1]]], np.float32))
    draws = _capture_draws(monkeypatch)
    jax_mode, port_mode = (JaxEvaluationMode.TRAINING, EvaluationMode.TRAINING) if mode == "training" else (
        JaxEvaluationMode.EVALUATION, EvaluationMode.EVALUATION)
    ref = JAX_RAY_SAMPLERS.build(dict(cfg))(jax.random.PRNGKey(7), jnp.asarray(pose[:, :3]), jnp.asarray(focal),
                                            jax_mode, **{k: jnp.asarray(v) for k, v in kw.items()})
    got = RAY_SAMPLERS.build(dict(cfg))(torch.from_numpy(pose), torch.from_numpy(focal), port_mode,
                                        pixel_idx=draws.get("pixel_idx"), strata_u=draws.get("strata_u"),
                                        **{k: torch.from_numpy(v) for k, v in kw.items()})
    for name in ("origins", "directions", "lengths", "xys"):
        _close(getattr(got, name), getattr(ref, name), rtol=1e-5, atol=1e-6)
    if options.get("scene_aabb_eval_only") and mode == "training":
        assert float(got.lengths.min()) >= 0.5 and float(got.lengths.max()) <= 6.0


def test_ray_sampler_refuses_what_the_jax_sampler_refuses():
    for options in (dict(scene_aabb=AABB, use_ndc=True), dict(scene_aabb=[0, 0, 0, 1, 0, 1])):
        with pytest.raises(ValueError) as jax_err:
            JAX_RAY_SAMPLERS.build(_sampler_cfg(**options))
        with pytest.raises(type(jax_err.value), match="scene_aabb"):
            RAY_SAMPLERS.build(_sampler_cfg(**options))
    # occupancy grids are ported (tests/test_torch_tools.py): refused with NDC as in JAX, a missing file raises
    for options in (dict(occupancy_grid="grid.npz", use_ndc=True), dict(occupancy_grid="missing.npz")):
        with pytest.raises((ValueError, FileNotFoundError)) as jax_err:
            JAX_RAY_SAMPLERS.build(_sampler_cfg(**options))
        with pytest.raises(type(jax_err.value)) as port_err:
            RAY_SAMPLERS.build(_sampler_cfg(**options))
        assert str(port_err.value) == str(jax_err.value)


# --- the models -------------------------------------------------------------------


NERF = dict(type="NeRFMLP", n_layers=3, input_skips=[2], n_harmonic_functions_xyz=3, n_harmonic_functions_dir=2,
            n_hidden_neurons_xyz=32, n_hidden_neurons_dir=16, contract_coords=True)
PROPOSAL = dict(type="ProposalMLP", n_layers=2, hidden_dim=16, n_harmonic_functions_xyz=4, contract_coords=True)
HASH = dict(type="HashGridNeRF", n_levels=4, table_size_log2=10, n_features_per_level=2, base_resolution=4,
            max_resolution=32, hidden_dim=16, geo_feature_dim=7, n_color_layers=2, n_harmonic_functions_dir=2,
            scene_bound=2.0, contract_coords=True)


def _unbounded_inputs(seed=0, n_rays=6, n_pts=7):
    """Rays whose points lie inside the unit ball and far outside it."""
    rng = np.random.RandomState(seed)
    origins = (rng.randn(1, n_rays, 1, 3) * 0.3).astype(np.float32)
    directions = rng.randn(1, n_rays, 1, 3).astype(np.float32)
    lengths = np.sort(1.0 / rng.uniform(0.02, 4.0, (1, n_rays, 1, n_pts)), axis=-1).astype(np.float32)
    return origins, directions, lengths


def _model_pair(cfg, seed=0):
    jax_model = JAX_MODELS.build(dict(cfg))
    params = jax_model.init(jax.random.PRNGKey(seed))
    model = load_jax_params(MODELS.build(dict(cfg)), jax.tree_util.tree_map(np.asarray, params))
    return jax_model, params, model


@pytest.mark.parametrize("cfg", [PROPOSAL, NERF, HASH], ids=["proposal_mlp", "nerf_mlp", "hash_grid"])
def test_models_with_contract_coords_match_apply(cfg):
    jax_model, params, model = _model_pair(cfg)
    assert model.contract_coords
    o, d, l = _unbounded_inputs()
    pts = np.asarray(jrays.ray_bundle_to_ray_points(jnp.asarray(o), jnp.asarray(d), jnp.asarray(l)))
    assert np.linalg.norm(pts, axis=-1).max() > 5.0 and np.linalg.norm(pts, axis=-1).min() < 1.0
    ref = jax_model.apply(params, jnp.asarray(o), jnp.asarray(d), jnp.asarray(l))
    with torch.no_grad():
        got = model(*map(torch.from_numpy, (o, d, l)))
    for key in ("rays_densities", "rays_features"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(ref[key]), err_msg=key, **F32)
    # contraction adds no parameter: the tree round-trips the bridge
    back = export_jax_params(model)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(a, np.asarray(b))
    # and without the contraction the outputs differ (the far points reach the embedding as they are)
    plain = load_jax_params(MODELS.build(dict(cfg, contract_coords=False)), jax.tree_util.tree_map(np.asarray, params))
    with torch.no_grad():
        assert not torch.allclose(plain(*map(torch.from_numpy, (o, d, l)))["rays_densities"], got["rays_densities"])


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_contracted_nerf_mlp_on_the_fused_function_matches_make_fused_mlp(compute_dtype):
    """The contracted points reach the kernels' plain versions as make_fused_mlp gets them in JAX (interpret
    mode): the forward, and every parameter gradient through K3's plain version."""
    cfg = dict(NERF, compute_dtype=compute_dtype)
    jax_model, params, model = _model_pair(cfg, seed=2)
    o, d, l = _unbounded_inputs(seed=3)
    rng = np.random.RandomState(4)
    gd, gc = rng.randn(1, 6, 1, 7, 1).astype(np.float32), rng.randn(1, 6, 1, 7, 3).astype(np.float32)

    def loss(p):
        out = jax_model.apply(p, jnp.asarray(o), jnp.asarray(d), jnp.asarray(l), use_pallas=True)
        return jnp.sum(out["rays_densities"] * gd) + jnp.sum(out["rays_features"] * gc), out

    (_, ref), ref_grads = jax.value_and_grad(loss, has_aux=True)(params)
    ref_grads = flatten_tree(jax.tree_util.tree_map(np.asarray, ref_grads))
    got = model(*map(torch.from_numpy, (o, d, l)), use_pallas=True)
    tol = F32 if compute_dtype == "float32" else dict(rtol=0.0, atol=4e-3)
    for key in ("rays_densities", "rays_features"):
        np.testing.assert_allclose(got[key].detach().numpy(), np.asarray(ref[key]), err_msg=key, **tol)
    loss = (got["rays_densities"] * torch.from_numpy(gd)).sum() + (got["rays_features"] * torch.from_numpy(gc)).sum()
    loss.backward()
    for key, p in model.named_parameters():
        if compute_dtype == "float32":
            np.testing.assert_allclose(p.grad.numpy(), ref_grads[key], err_msg=key, **F32_GRAD_TOL)
        else:
            cos = float(np.sum(p.grad.numpy() * ref_grads[key]) /
                        max(np.linalg.norm(p.grad.numpy()) * np.linalg.norm(ref_grads[key]), 1e-30))
            assert cos >= 0.9999, (key, cos)
    # the kernel path sees exactly the points the eager path embeds
    pts = trays.ray_bundle_to_ray_points(*map(torch.from_numpy, (o, d, l)))
    assert torch.equal(model._points(*map(torch.from_numpy, (o, d, l))), trays.contract_points(pts))
    direct = fused_nerf_mlp(model, trays.contract_points(pts).reshape(-1, 3), torch.from_numpy(d).reshape(-1, 3), 7)
    assert torch.equal(direct[:, :1].reshape(got["rays_densities"].shape), got["rays_densities"].detach())


def test_hash_grid_contraction_needs_scene_bound_two_and_mip_refuses_it():
    for cfg in (dict(HASH, scene_bound=1.5), dict(HASH, scene_bound=1.99)):
        with pytest.raises(ValueError) as jax_err:
            JAX_MODELS.build(dict(cfg))
        with pytest.raises(type(jax_err.value), match="scene_bound >= 2.0"):
            MODELS.build(dict(cfg))
    assert MODELS.build(dict(HASH, scene_bound=3.0)).contract_coords
    with pytest.raises(ValueError, match="contract_coords"):
        MODELS.build(dict(NERF, type="MipNeRFMLP", base_radius=1e-3))


# --- the unbounded config's structure: an eval chunk and a train step ------------------


def unbounded_cfg(compute_dtype="float32", hw=HW, chunk_size_grid=96):
    """synth_llff_360_unbounded.yml at tiny widths: contraction on all three models, disparity spacing from
    per-image bounds, the NeRF-MLP on the fused function, the distortion loss measured in disparity."""
    return dict(
        type="NeRFPipeline", chunk_size_grid=chunk_size_grid, num_passes=3, output_rasterized_mc=False,
        loss_weights={"loss_rgb_mse": 1.0, "loss_proposal": 1.0, "loss_distortion": 0.01},
        model=[
            dict(PROPOSAL, compute_dtype=compute_dtype),
            dict(PROPOSAL, compute_dtype=compute_dtype),
            dict(NERF, compute_dtype=compute_dtype, use_pallas_train=True),
        ],
        ray_sampler=dict(_sampler_cfg(sample_in_disparity=True, min_depth=0.1, max_depth=6.0),
                         image_height=hw, image_width=hw),
        renderer=dict(
            type="ProposalEmissionAbsorpsionRenderer", n_pts_per_ray_final_training=4,
            n_pts_per_ray_final_evaluation=5, n_pts_per_ray_intermediate_training=[6],
            n_pts_per_ray_intermediate_evaluation=[6], bg_color=[0.0, 0.0, 0.0], density_noise_std_train=0.0,
            background_density_bias=1e-6, distortion_in_disparity=True, stratified_sampling_training=True,
        ),
        feature_extractor=[],
    )


def _unbounded_batch(seed=0, hw=HW):
    rng = np.random.RandomState(seed)
    pose = (orbit_pose(30.0, -30.0, 1.2) @ CAM_CALIBRATION).astype(np.float32)
    return dict(poses=pose[None], focal_lengths=np.asarray([[6.0]], np.float32),
                image_rgb=rng.rand(1, hw, hw, 3).astype(np.float32),
                min_depth=np.asarray([[0.2]], np.float32), max_depth=np.asarray([[30.0]], np.float32))


def _jax_params(jax_pipeline, seed):
    params = jax_pipeline.init(jax.random.PRNGKey(seed))
    # every ray carries mass: on an empty ray the refined depths differ by ~1e-3 between the packages (1 - exp(-x)
    # cancels there; ROADMAP.md Queue 3, "Noted, not faults"); the background rays of an unbounded scene are such rays
    for fn in params["implicit_functions"]:
        fn["density_layer"]["b"] = fn["density_layer"]["b"] + 1.0
    return params


def test_unbounded_eval_chunk_matches_jax():
    cfg = unbounded_cfg()
    batch = _unbounded_batch()
    jax_pipeline = JAX_PIPELINES.build(dict(cfg))
    params = _jax_params(jax_pipeline, 0)
    ref = jax_pipeline.forward(params, jax.random.PRNGKey(1), evaluation_mode=JaxEvaluationMode.EVALUATION,
                               **{k: jnp.asarray(v) for k, v in batch.items()})
    pipeline = PIPELINES.build(dict(cfg), device="cpu")
    load_jax_params(pipeline, jax.tree_util.tree_map(np.asarray, params))
    with torch.no_grad():
        got = pipeline(evaluation_mode=EvaluationMode.EVALUATION, **{k: torch.from_numpy(v) for k, v in batch.items()})
    assert got["rendered_images"].shape == (1, HW, HW, 3)
    for key in ("rendered_images", "rendered_depths", "rendered_alpha_masks", "objective"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(ref[key]), rtol=1e-4, atol=1e-4, err_msg=key)


def test_unbounded_train_step_matches_jax_make_train_step(monkeypatch):
    cfg = unbounded_cfg()
    batch = _unbounded_batch(seed=1)
    jax_pipeline = JAX_PIPELINES.build(dict(cfg))
    params = _jax_params(jax_pipeline, 2)  # from this init every model gets a gradient above the tolerance
    tx = jax_optim.create_optimizer(RUNNER, params)
    rng = jax.random.PRNGKey(11)
    jax_batch = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss_fn(p):
        preds = jax_pipeline.forward(p, jax.random.fold_in(rng, 0), evaluation_mode=JaxEvaluationMode.TRAINING,
                                     output_rasterized_mc=False, **jax_batch)
        return jnp.mean(preds["objective"])

    with monkeypatch.context() as m:
        draws = _capture_draws(m)
        ref_grads = flatten_tree(jax.tree_util.tree_map(np.asarray, jax.grad(loss_fn)(params)))
    _, ref_preds = jax_apis.make_train_step(jax_pipeline, tx, donate=False)(
        jax_optim.create_train_state(params, tx), jax_batch, rng)
    for i in range(3):
        largest = max(np.abs(v).max() for k, v in ref_grads.items() if k.startswith(f"implicit_functions.{i}."))
        assert largest > 10 * F32_GRAD_TOL["atol"], (i, largest)

    pipeline = PIPELINES.build(dict(cfg), device="cpu")
    load_jax_params(pipeline, jax.tree_util.tree_map(np.asarray, params))
    state = TrainState(pipeline=pipeline, optimizer=create_optimizer(RUNNER, pipeline), step=0)
    preds = make_train_step(pipeline, RUNNER, seed=0)(state, {k: torch.from_numpy(v) for k, v in batch.items()},
                                                      draws=draws)
    np.testing.assert_allclose(preds["objective"].numpy(), np.asarray(ref_preds["objective"]), rtol=1e-5, atol=1e-5)
    for key in ("loss_rgb_mse", "loss_proposal", "loss_distortion"):
        np.testing.assert_allclose(preds[key].numpy(), np.asarray(ref_preds[key]), rtol=1e-5, atol=1e-6, err_msg=key)
    for key, p in pipeline.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), ref_grads[key], err_msg=key, **F32_GRAD_TOL)


# --- the orbit scene with distant spheres -------------------------------------------


def test_synth_llff_orbit_writes_the_scene_of_make_synth_llff(tmp_path, monkeypatch):
    sys.path.insert(0, str(REPO / "scripts"))
    try:
        import make_synth_llff
    finally:
        sys.path.remove(str(REPO / "scripts"))
    from PIL import Image

    args = ["--height", "12", "--width", "16", "--n_images", "5", "--mode", "orbit", "--distant_spheres", "3",
            "--distant_min", "20", "--distant_max", "30", "--seed", "4"]
    monkeypatch.setattr(sys, "argv", ["make_synth_llff.py", "--out_dir", str(tmp_path / "ref"), *args])
    make_synth_llff.main()
    write_llff_scene(tmp_path / "port", 12, 16, 5, mode="orbit", distant_spheres=3, distant_min=20.0,
                     distant_max=30.0, seed=4)
    np.testing.assert_array_equal(np.load(tmp_path / "port" / "poses_bounds.npy"),
                                  np.load(tmp_path / "ref" / "poses_bounds.npy"))
    for i in range(5):
        with Image.open(tmp_path / "ref" / "images" / f"image{i:03d}.png") as im:
            ref = np.array(im.convert("RGB"))
        np.testing.assert_array_equal(load_image_u8(tmp_path / "port" / "images" / f"image{i:03d}.png"), ref)
