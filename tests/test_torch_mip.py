"""The mip-NeRF family (configs/nerf/synth800_mip.yml) of yanerf_tpu_torch against yanerf_tpu, on the CPU.

  * the cone-marching ops (``ops/mip.py``) at rtol/atol 1e-6, as
    tests/test_torch_ops.py: a near plane closer than half the first gap,
    duplicate depths, and ``var == 0`` equal to the point embedding by
    ``torch.equal``;
  * ``MipNeRFMLP`` against ``MipNeRFMLP.apply`` in both ``interval_mode``s
    at the ``TOLS`` of tests/test_torch_models.py (f32 1e-5, bf16 one bf16
    ulp); a NeRFMLP's tree loads into it; every refusal raises the JAX
    class's error type; it runs under the proposal renderer;
  * one train step of synth800_mip.yml's structure (the multipass renderer,
    softplus with bias -1, density noise 0.2, pixels without replacement)
    at a tiny width against ``make_train_step``, the JAX draws fed in:
    objective 1e-5, every gradient rtol 2e-4 / atol 2e-5;
  * three fused steps (``steps_per_call: 3``) against
    ``make_train_step_fused`` with the JAX draws fed in, and the fused epoch
    equal to the per-step epoch bit for bit;
  * the weight bridge round-trips its tree exactly.
"""

from collections import namedtuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_classic import F32_GRAD_TOL, HW, RENDERER, RUNNER, _batch, _capture_draws
from test_torch_fused_step import _assert_states_equal, _train_loader
from test_torch_models import TOLS
from yanerf_tpu.models import MODELS as JAX_MODELS
from yanerf_tpu.ops import harmonics as jh
from yanerf_tpu.ops import mip as jm
from yanerf_tpu.ops.structures import EvaluationMode as JaxEvaluationMode
from yanerf_tpu.pipelines import PIPELINES as JAX_PIPELINES
from yanerf_tpu.runners import apis as jax_apis
from yanerf_tpu.runners import optim as jax_optim
from yanerf_tpu_torch.convert import export_jax_params, flatten_tree, load_jax_params
from yanerf_tpu_torch.models import MODELS, MipNeRFMLP
from yanerf_tpu_torch.ops import harmonics as th
from yanerf_tpu_torch.ops import mip as tm
from yanerf_tpu_torch.ops.structures import EvaluationMode
from yanerf_tpu_torch.pipelines import PIPELINES
from yanerf_tpu_torch.runners import RunType, TrainState, create_optimizer, make_train_step, make_train_step_fused
from yanerf_tpu_torch.runners import apis
from yanerf_tpu_torch.runners import train_one_epoch
from yanerf_tpu_torch.serve import CAM_CALIBRATION, orbit_pose

TOL = dict(rtol=1e-6, atol=1e-6)
BASE_RADIUS = (2.0 / np.sqrt(12.0)) / 10.0  # the pixel footprint at focal 10 (the tests' cameras)
MIP = dict(type="MipNeRFMLP", base_radius=BASE_RADIUS, n_layers=3, input_skips=[2], n_harmonic_functions_xyz=3,
           n_harmonic_functions_dir=2, n_hidden_neurons_xyz=32, n_hidden_neurons_dir=16, color_dim=3)


def _lengths(seed=0, shape=(2, 3, 1), n_pts=6, near=1.0):
    rng = np.random.RandomState(seed)
    return np.sort(near + rng.uniform(0.0, 3.0, (*shape, n_pts)), axis=-1).astype(np.float32)


# --- the ops ------------------------------------------------------------------


def _lengths_cases():
    uniform = _lengths()
    # a near plane closer than half the first gap: the first edge would cross the apex
    apex = np.sort(np.random.RandomState(1).uniform(0.0, 2.0, (2, 3, 1, 5)), axis=-1).astype(np.float32)
    apex[..., 0], apex[..., 1] = 0.01, 0.5
    # duplicate depths, also at the end (a zero last gap)
    dup = _lengths(seed=2)
    dup[..., 2] = dup[..., 1]
    dup[0, 0, 0, -1] = dup[0, 0, 0, -2]
    return {"uniform": uniform, "near_apex": apex, "duplicates": dup}


@pytest.mark.parametrize("case", ["uniform", "near_apex", "duplicates"])
@pytest.mark.parametrize("mode", ["midpoints", "boundaries"])
def test_intervals_match_jax(case, mode):
    lengths = _lengths_cases()[case]
    ref = getattr(jm, f"intervals_from_{mode}")(jnp.asarray(lengths))
    got = getattr(tm, f"intervals_from_{mode}")(torch.from_numpy(lengths))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **TOL)
    t0, t1 = (g.numpy() for g in got)
    assert np.all(t0 > 0.0) and np.all(t1 >= t0)


@pytest.mark.parametrize("case", ["uniform", "near_apex", "duplicates"])
def test_conical_frustum_to_gaussian_matches_jax(case):
    lengths = _lengths_cases()[case]
    rng = np.random.RandomState(3)
    origins = rng.randn(*lengths.shape[:-1], 3).astype(np.float32)
    directions = rng.randn(*lengths.shape[:-1], 3).astype(np.float32)
    t0, t1 = jm.intervals_from_midpoints(jnp.asarray(lengths))
    ref = jm.conical_frustum_to_gaussian(jnp.asarray(origins), jnp.asarray(directions), t0, t1, 5.196e-4 * 100)
    got = tm.conical_frustum_to_gaussian(torch.from_numpy(origins), torch.from_numpy(directions),
                                         torch.from_numpy(np.array(t0)), torch.from_numpy(np.array(t1)),
                                         5.196e-4 * 100)
    for g, r in zip(got, ref):
        assert tuple(g.shape) == (*lengths.shape, 3)
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **TOL)
    assert np.all(got[1].numpy() >= -1e-7)


@pytest.mark.parametrize("n_freq,append", [(10, True), (4, True), (3, False)])
def test_integrated_harmonic_embedding_matches_jax(n_freq, append):
    rng = np.random.RandomState(4)
    mean = rng.randn(2, 5, 7, 3).astype(np.float32)
    var = (rng.rand(2, 5, 7, 3) * 1e-2).astype(np.float32)
    ref = jm.integrated_harmonic_embedding(jnp.asarray(mean), jnp.asarray(var), n_freq, append_input=append)
    got = tm.integrated_harmonic_embedding(torch.from_numpy(mean), torch.from_numpy(var), n_freq, append_input=append)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    # var == 0 is the point embedding, bit for bit
    point = tm.integrated_harmonic_embedding(torch.from_numpy(mean), torch.zeros_like(torch.from_numpy(var)), n_freq,
                                             append_input=append)
    assert torch.equal(point, th.harmonic_embedding(torch.from_numpy(mean), n_freq, append_input=append))
    np.testing.assert_allclose(point.numpy(), np.asarray(jh.harmonic_embedding(jnp.asarray(mean), n_freq,
                                                                               append_input=append)), **TOL)


# --- the model ------------------------------------------------------------------


def _inputs(seed=0, n_rays=4, n_pts=6):
    rng = np.random.RandomState(seed)
    origins = rng.randn(1, n_rays, 1, 3).astype(np.float32)
    directions = rng.randn(1, n_rays, 1, 3).astype(np.float32)
    lengths = np.sort(rng.uniform(1, 4, (1, n_rays, 1, n_pts)), axis=-1).astype(np.float32)
    return origins, directions, lengths


def _mip_pair(compute_dtype, interval_mode, seed=0):
    cfg = dict(MIP, compute_dtype=compute_dtype, interval_mode=interval_mode)
    jax_model = JAX_MODELS.build(dict(cfg))
    params = jax_model.init(jax.random.PRNGKey(seed))
    model = load_jax_params(MODELS.build(dict(cfg)), jax.tree_util.tree_map(np.asarray, params))
    return jax_model, params, model


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("interval_mode", ["midpoint", "boundary"])
def test_mip_nerf_mlp_matches_apply(interval_mode, compute_dtype):
    jax_model, params, model = _mip_pair(compute_dtype, interval_mode)
    o, d, l = _inputs()
    ref = jax_model.apply(params, jnp.asarray(o), jnp.asarray(d), jnp.asarray(l), use_pallas=False)
    with torch.no_grad():
        got = model(torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(l), use_pallas=False)
    for key in ("rays_densities", "rays_features"):
        assert got[key].shape == ref[key].shape and got[key].dtype == torch.float32
        np.testing.assert_allclose(got[key].numpy(), np.asarray(ref[key]), **TOLS[compute_dtype], err_msg=key)


def test_a_nerf_mlp_tree_loads_into_mip_nerf_mlp_and_round_trips():
    nerf_cfg = {k: v for k, v in MIP.items() if k != "base_radius"}
    params = jax.tree_util.tree_map(np.asarray, JAX_MODELS.build(dict(nerf_cfg, type="NeRFMLP")).init(
        jax.random.PRNGKey(5)))
    model = load_jax_params(MODELS.build(dict(MIP)), params)
    assert isinstance(model, MipNeRFMLP)
    back = export_jax_params(model)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(params)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(a, b)
    # and the JAX MipNeRFMLP on the same tree gives the same outputs
    o, d, l = _inputs(seed=2)
    ref = JAX_MODELS.build(dict(MIP)).apply(params, jnp.asarray(o), jnp.asarray(d), jnp.asarray(l))
    with torch.no_grad():
        got = model(torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(l))
    np.testing.assert_allclose(got["rays_densities"].numpy(), np.asarray(ref["rays_densities"]), **TOLS["float32"])


@pytest.mark.parametrize(
    "options",
    [dict(base_radius=0.0), dict(base_radius=-1e-3), dict(interval_mode="center"), dict(contract_coords=True),
     dict(use_pallas=True), dict(use_pallas_train=True), dict(input_xyz=False)],
    ids=["zero_radius", "negative_radius", "mode", "contract_coords", "use_pallas", "use_pallas_train", "no_xyz"],
)
def test_mip_nerf_mlp_refuses_what_the_jax_class_refuses(options):
    cfg = dict(MIP, **options)
    with pytest.raises(Exception) as jax_err:
        JAX_MODELS.build(dict(cfg))
    with pytest.raises(type(jax_err.value)):
        MODELS.build(dict(cfg))


def test_mip_nerf_mlp_refuses_one_sample_per_ray_and_the_kernel():
    jax_model, params, model = _mip_pair("float32", "midpoint")
    o, d, l = _inputs(n_pts=1)
    with pytest.raises(ValueError) as jax_err:
        jax_model.apply(params, jnp.asarray(o), jnp.asarray(d), jnp.asarray(l))
    with pytest.raises(type(jax_err.value), match=">= 2 samples"):
        model(*map(torch.from_numpy, (o, d, l)))
    o, d, l = map(torch.from_numpy, _inputs())
    with pytest.raises(ValueError, match="no fused kernel"):
        model(o, d, l, use_pallas=True)
    with pytest.raises(RuntimeError, match="no fused kernel"):
        model.packed_weights()
    assert model.min_samples_per_ray == 2 and not model.use_pallas and not model.use_pallas_train


def test_mip_nerf_mlp_under_the_proposal_renderer():
    """The final model of the proposal family (tests/test_mip.py): an EVALUATION frame as JAX renders it, and a
    TRAINING objective whose gradients are finite."""
    cfg = dict(
        type="NeRFPipeline", chunk_size_grid=64, num_passes=2, output_rasterized_mc=False,
        loss_weights={"loss_rgb_mse": 1.0, "loss_proposal": 1.0},
        model=[
            dict(type="ProposalMLP", n_layers=2, hidden_dim=16, n_harmonic_functions_xyz=2),
            dict(type="MipNeRFMLP", base_radius=6e-4, n_layers=2, input_skips=[1], n_harmonic_functions_xyz=3,
                 n_harmonic_functions_dir=2, n_hidden_neurons_xyz=16, n_hidden_neurons_dir=8, color_dim=3),
        ],
        ray_sampler=dict(type="RaySampler", image_height=4, image_width=4, min_depth=1.0, max_depth=3.0,
                         n_pts_per_ray_training=8, n_pts_per_ray_evaluation=8,
                         n_rays_per_image_sampled_from_mask=16, pixel_replacement=True),
        renderer=dict(type="ProposalEmissionAbsorpsionRenderer", n_pts_per_ray_final_training=4,
                      n_pts_per_ray_final_evaluation=4, n_pts_per_ray_intermediate_training=[],
                      n_pts_per_ray_intermediate_evaluation=[], bg_color=[0.0, 0.0, 0.0],
                      density_noise_std_train=0.0, background_density_bias=1.0e-6),
        feature_extractor=[],
    )
    jax_pipeline = JAX_PIPELINES.build(dict(cfg))
    params = jax_pipeline.init(jax.random.PRNGKey(0))
    for fn in params["implicit_functions"]:  # every ray carries mass (ROADMAP.md Queue 3, "Noted, not faults")
        fn["density_layer"]["b"] = fn["density_layer"]["b"] + 1.0
    pose = (orbit_pose(30.0, -30.0, 2.0) @ CAM_CALIBRATION).astype(np.float32)[None, :3, :4]
    image = np.random.RandomState(0).rand(1, 4, 4, 3).astype(np.float32)
    ref = jax_pipeline.forward(params, jax.random.PRNGKey(1), poses=jnp.asarray(pose),
                               focal_lengths=jnp.asarray([[4.0]]), image_rgb=jnp.asarray(image),
                               evaluation_mode=JaxEvaluationMode.EVALUATION)
    pipeline = PIPELINES.build(dict(cfg), device="cpu")
    load_jax_params(pipeline, jax.tree_util.tree_map(np.asarray, params))
    batch = dict(poses=torch.from_numpy(pose), focal_lengths=torch.tensor([[4.0]]), image_rgb=torch.from_numpy(image))
    with torch.no_grad():
        got = pipeline(evaluation_mode=EvaluationMode.EVALUATION, **batch)
    for key in ("rendered_images", "rendered_depths", "objective"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(ref[key]), rtol=1e-4, atol=1e-4, err_msg=key)
    preds = pipeline(evaluation_mode=EvaluationMode.TRAINING, generator=torch.Generator().manual_seed(2), **batch)
    torch.mean(preds["objective"]).backward()
    assert torch.isfinite(preds["objective"]).all()
    assert all(torch.isfinite(p.grad).all() for p in pipeline.parameters())
    assert pipeline.implicit_functions[1].density_layer.w.grad.abs().max() > 0


# --- one train step ------------------------------------------------------------


def mip_cfg(compute_dtype="float32", hw=HW, chunk_size_grid=40):
    """synth800_mip.yml's structure at a tiny width: one MipNeRFMLP config for both passes of the multipass
    renderer, softplus(raw - 1) densities, density noise 0.2, pixels drawn without replacement."""
    return dict(
        type="NeRFPipeline", chunk_size_grid=chunk_size_grid, num_passes=2, output_rasterized_mc=True,
        loss_weights={"loss_prev_stage_rgb_mse": 1.0, "loss_rgb_mse": 1.0},
        model=dict(MIP, compute_dtype=compute_dtype),
        ray_sampler=dict(type="RaySampler", image_height=hw, image_width=hw, min_depth=1.0, max_depth=3.0,
                         n_pts_per_ray_training=5, n_pts_per_ray_evaluation=5, n_rays_per_image_sampled_from_mask=12),
        renderer=dict(RENDERER, density_activation="softplus", density_pre_activation_bias=-1.0),
        feature_extractor=[],
    )


def test_mip_train_step_matches_jax_make_train_step(monkeypatch):
    cfg = mip_cfg()
    batch = _batch(seed=1)
    jax_pipeline = JAX_PIPELINES.build(dict(cfg))
    params = jax_pipeline.init(jax.random.PRNGKey(2))
    tx = jax_optim.create_optimizer(RUNNER, params)
    rng = jax.random.PRNGKey(11)
    jax_batch = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss_fn(p):
        preds = jax_pipeline.forward(p, jax.random.fold_in(rng, 0), evaluation_mode=JaxEvaluationMode.TRAINING,
                                     output_rasterized_mc=False, **jax_batch)
        return jnp.mean(preds["objective"])

    with monkeypatch.context() as m:
        draws = _capture_draws(m)
        ref_grads = flatten_tree(jax.tree_util.tree_map(np.asarray, jax.jit(jax.grad(loss_fn))(params)))
        jax.effects_barrier()
    assert [tuple(n.shape) for n in draws["density_noise"]] == [(1, 12, 1, 5), (1, 12, 1, 11)]
    assert len(draws["pdf_u"]) == 1 and len(set(draws["pixel_idx"][0].tolist())) == 12, "without replacement"
    _, ref_preds = jax_apis.make_train_step(jax_pipeline, tx, donate=False)(
        jax_optim.create_train_state(params, tx), jax_batch, rng)

    pipeline = PIPELINES.build(dict(cfg), device="cpu")
    assert all(isinstance(fn, MipNeRFMLP) for fn in pipeline.implicit_functions)
    load_jax_params(pipeline, jax.tree_util.tree_map(np.asarray, params))
    state = TrainState(pipeline=pipeline, optimizer=create_optimizer(RUNNER, pipeline), step=0)
    preds = make_train_step(pipeline, RUNNER, seed=0)(state, {k: torch.from_numpy(v) for k, v in batch.items()},
                                                      draws=draws)
    np.testing.assert_allclose(preds["objective"].numpy(), np.asarray(ref_preds["objective"]), rtol=1e-5, atol=1e-5)
    named = dict(pipeline.named_parameters())
    assert set(named) == set(ref_grads)
    for i in range(2):
        largest = max(np.abs(v).max() for k, v in ref_grads.items() if k.startswith(f"implicit_functions.{i}."))
        assert largest > 10 * F32_GRAD_TOL["atol"], (i, largest)
    for key, p in named.items():
        np.testing.assert_allclose(p.grad.numpy(), ref_grads[key], err_msg=key, **F32_GRAD_TOL)


# --- the fused dispatch -----------------------------------------------------------


def test_mip_fused_dispatch_matches_jax_make_train_step_fused(monkeypatch):
    """Three steps at steps_per_call 3: the Gumbel pixel draw, the refinement's u's and both passes' density noise
    of every step are the JAX package's, fed in through the static buffers."""
    cfg = mip_cfg()
    runner = dict(RUNNER, steps_per_call=3)
    rng_np = np.random.RandomState(7)
    poses = np.stack([orbit_pose(30.0 + 40 * i, -30.0, 2.0) @ CAM_CALIBRATION for i in range(3)]).astype(np.float32)
    focal = np.full((3, 1), 10.0, np.float32)
    images = rng_np.rand(3, HW, HW, 3).astype(np.float32)
    idx = np.array([[2], [0], [1]])
    wrapper = namedtuple("Batch", ["poses", "focal_lengths", "image_rgb"])

    jax_pipeline = JAX_PIPELINES.build(dict(cfg))
    params = jax_pipeline.init(jax.random.PRNGKey(1))
    tx = jax_optim.create_optimizer(runner, params)
    rng = jax.random.PRNGKey(11)
    jax_arrays = (jnp.asarray(poses), jnp.asarray(focal), jnp.asarray(images))

    step = jax_apis.make_train_step(jax_pipeline, tx, donate=False)
    state = jax_optim.create_train_state(params, tx)
    draws, grads, per_step_params = [], [], []
    for k in range(3):
        batch = {key: a[idx[k]] for key, a in zip(wrapper._fields, jax_arrays)}

        def loss_fn(p, batch=batch, k=k):
            preds = jax_pipeline.forward(p, jax.random.fold_in(rng, k), evaluation_mode=JaxEvaluationMode.TRAINING,
                                         output_rasterized_mc=False, **batch)
            return jnp.mean(preds["objective"])

        per_step_params.append(flatten_tree(jax.tree_util.tree_map(np.asarray, state.params)))
        with monkeypatch.context() as m:
            draws.append(_capture_draws(m))
            grads.append(flatten_tree(jax.tree_util.tree_map(np.asarray, jax.grad(loss_fn)(state.params))))
            jax.effects_barrier()
        state, _ = step(state, batch, rng)

    fused = jax_apis.make_train_step_fused(jax_pipeline, tx, wrapper, donate=False)
    ref_state, ref_hist = fused(jax_optim.create_train_state(params, tx), jax_arrays, jnp.asarray(idx), rng)
    ref_params = flatten_tree(jax.tree_util.tree_map(np.asarray, ref_state.params))

    pipeline = PIPELINES.build(dict(cfg), device="cpu")
    load_jax_params(pipeline, jax.tree_util.tree_map(np.asarray, params))
    port = TrainState(pipeline=pipeline, optimizer=create_optimizer(runner, pipeline), step=0)

    def fed_draws(pipeline, batch_size, seed, step, out=None):
        for key, value in draws[step].items():
            targets = out[key] if isinstance(out[key], list) else [out[key]]
            for target, v in zip(targets, value if isinstance(value, list) else [value]):
                target.copy_(v)
        return out

    monkeypatch.setattr(apis, "make_step_draws", fed_draws)
    trainer = make_train_step_fused(pipeline, runner, 0, wrapper)
    hist = trainer(port, tuple(torch.from_numpy(a) for a in (poses, focal, images)), idx)
    assert port.step == 3 and trainer.dispatches == 1
    assert {d.key for d in pipeline.training_draws(1)} == {"pixel_idx", "strata_u", "pdf_u", "density_noise"}
    np.testing.assert_allclose(hist["objective"].numpy(), np.asarray(ref_hist["objective"]), rtol=1e-5, atol=1e-5)
    for key in ("loss_rgb_mse", "loss_prev_stage_rgb_mse"):
        np.testing.assert_allclose(hist[key].numpy(), np.asarray(ref_hist[key]), rtol=1e-5, atol=1e-6, err_msg=key)
    lr = float(port.optimizer.param_groups[0]["init_lr"])
    for key, p in pipeline.named_parameters():
        new, ref = p.detach().numpy(), ref_params[key]
        # Adam's update is lr * m / (sqrt(v) + eps): where a gradient is within its atol the sign is float32 noise
        settled = np.all(
            [np.abs(g[key] + RUNNER["weight_decay"] * w[key]) > F32_GRAD_TOL["atol"] for g, w in zip(grads, per_step_params)],
            axis=0,
        )
        np.testing.assert_allclose(new[settled], ref[settled], err_msg=key, **F32_GRAD_TOL)
        assert np.all(np.abs(new - ref) <= 2.0 * 3 * lr * (1 + 1e-5)), key


def test_mip_fused_epochs_equal_per_step_epochs_bit_for_bit(tmp_path):
    """Two epochs of 7 steps at K=3 on the uint8 device cache, with the vis step every 4 iterations."""
    loader = _train_loader(tmp_path, 7, True)
    runner = dict(RUNNER, steps_per_call=3, val_per_iter=4, print_per_iter=2)
    cfg = mip_cfg()

    def state():
        pipeline = PIPELINES.build(dict(cfg), generator=torch.Generator().manual_seed(4), device="cpu")
        return TrainState(pipeline=pipeline, optimizer=create_optimizer(runner, pipeline), step=0)

    per_step, fused = state(), state()
    step = make_train_step(per_step.pipeline, runner, seed=5)
    vis = make_train_step(per_step.pipeline, runner, seed=5, rasterize_mc=True)
    trainer = make_train_step_fused(fused.pipeline, runner, 5, loader.data_wrapper)
    fused_vis = make_train_step(fused.pipeline, runner, seed=5, rasterize_mc=True)
    assert apis._fused_eligible(runner, loader, trainer)
    for epoch in range(2):
        _, stats = train_one_epoch(RunType.TRAIN, runner, epoch, per_step, loader, step, train_step_vis=vis)
        _, fused_stats = train_one_epoch(RunType.TRAIN, runner, epoch, fused, loader, step,
                                         train_step_vis=fused_vis, train_step_fused=trainer)
        _assert_states_equal(fused, per_step)
        stats.pop("step_s", None), fused_stats.pop("step_s", None)
        assert fused_stats == stats
    assert trainer.steps == 10 and trainer.dispatches == 5
