"""The training path of yanerf_tpu_torch against yanerf_tpu, on the CPU.

Held to the JAX package on the same weights, batch and random draws:
  * the Monte-Carlo ray sampler (uniform pixel indices with replacement,
    stratified depth jitter) with the reference's draws fed in;
  * the ground-truth view metrics (MSE, Huber, PSNR, SSIM);
  * the learning-rate schedules at every step of warmup and decay;
  * Adam (coupled weight decay, ``lr_param_groups``) against optax;
  * one whole train step of a tiny two-level proposal config, the NeRF-MLP
    on the fused autograd.Function (K1 forward, K3 backward, their plain
    versions here) against ``make_train_step``'s step with the Pallas
    custom VJP in interpret mode: objective at 1e-5, parameter gradients at
    rtol 2e-4 / atol 2e-5, parameters after the Adam update at 1e-5 where
    the gradient exceeds that atol;
  * a short ``python -m yanerf_tpu_torch.run --device cpu`` drive.

The reference's draws are taken by wrapping the JAX functions that draw
(``uniform_sample_with_replacement``, ``jiggle_within_stratas``,
``sample_pdf``) with pytest's ``monkeypatch`` while ``jax.grad`` of the step's
loss runs eagerly; ``make_train_step``'s jitted step then draws the same.
"""

import json
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import yanerf_tpu.ops.rays as jax_rays
import yanerf_tpu.ops.sampling as jax_sampling
import yanerf_tpu.pipelines.ray_sampler as jax_ray_sampler
import yanerf_tpu.pipelines.renderer as jax_renderer
from yanerf_tpu.ops import metrics as jax_metrics
from yanerf_tpu.ops.structures import EvaluationMode as JaxEvaluationMode
from yanerf_tpu.pipelines import PIPELINES as JAX_PIPELINES
from yanerf_tpu.pipelines import RAY_SAMPLERS as JAX_RAY_SAMPLERS
from yanerf_tpu.runners import apis as jax_apis
from yanerf_tpu.runners import optim as jax_optim
from yanerf_tpu.runners import schedules as jax_schedules
from yanerf_tpu.utils import Config as JaxConfig
from yanerf_tpu_torch import run as port_run
from yanerf_tpu_torch.convert import flatten_tree, load_jax_params
from yanerf_tpu_torch.ops import metrics
from yanerf_tpu_torch.ops.kernels import nerf_mlp_bwd as K3
from yanerf_tpu_torch.ops.kernels import nerf_mlp_fwd as K1
from yanerf_tpu_torch.ops.rays import jiggle_within_stratas
from yanerf_tpu_torch.ops.sampling import weighted_sample_without_replacement
from yanerf_tpu_torch.ops.structures import EvaluationMode
from yanerf_tpu_torch.pipelines import PIPELINES, RAY_SAMPLERS
from yanerf_tpu_torch.runners import (
    TrainState,
    checkpoint_params_tree,
    create_lr_schedule,
    create_optimizer,
    load_checkpoint,
    make_train_step,
    set_learning_rates,
)
from yanerf_tpu_torch.serve import CAM_CALIBRATION, orbit_pose
from yanerf_tpu_torch.synth_scene import write_scene
from yanerf_tpu_torch.utils import Config

HW = 8
F32_GRAD_TOL = dict(rtol=2e-4, atol=2e-5)


def _pipeline_cfg(compute_dtype="float32"):
    return dict(
        type="NeRFPipeline",
        chunk_size_grid=42,
        num_passes=3,
        output_rasterized_mc=True,
        loss_weights={"loss_rgb_mse": 1.0, "loss_proposal": 1.0},
        model=[
            dict(type="ProposalMLP", n_layers=2, hidden_dim=16, compute_dtype=compute_dtype),
            dict(type="ProposalMLP", n_layers=2, hidden_dim=16, compute_dtype=compute_dtype),
            dict(type="NeRFMLP", n_layers=3, input_skips=[2], n_harmonic_functions_xyz=3,
                 n_harmonic_functions_dir=2, n_hidden_neurons_xyz=32, n_hidden_neurons_dir=16,
                 compute_dtype=compute_dtype, use_pallas_train=True),
        ],
        ray_sampler=dict(
            type="RaySampler", image_height=HW, image_width=HW, min_depth=1.0, max_depth=3.0,
            n_pts_per_ray_training=5, n_pts_per_ray_evaluation=6, n_rays_per_image_sampled_from_mask=12,
            pixel_replacement=True,
        ),
        renderer=dict(
            type="ProposalEmissionAbsorpsionRenderer", n_pts_per_ray_final_training=4,
            n_pts_per_ray_final_evaluation=5, n_pts_per_ray_intermediate_training=[6],
            n_pts_per_ray_intermediate_evaluation=[6], bg_color=[0.0, 0.0, 0.0],
            density_noise_std_train=0.0, background_density_bias=1e-6,
        ),
        feature_extractor=[],
    )


RUNNER = dict(
    init_lr=5e-3, min_lr=5e-4, lr_decay_type="exponential", lr_decay_rate=0.1, lr_decay_iters=1000,
    warmup_steps=0, warmup_lr=1e-5, weight_decay=1e-3, num_iters=100,
    lr_param_groups=[dict(prefix="implicit_functions.0", base=0.5)],
)


def _batch(seed=0):
    rng = np.random.RandomState(seed)
    pose = (orbit_pose(30.0, -30.0, 2.0) @ CAM_CALIBRATION).astype(np.float32)
    return dict(
        poses=pose[None],
        focal_lengths=np.asarray([[10.0]], np.float32),
        image_rgb=rng.rand(1, HW, HW, 3).astype(np.float32),
    )


def _capture_draws(monkeypatch):
    """Record the draws of the JAX functions that draw, as the port's ``draws`` takes them."""
    draws = {"pdf_u": []}
    pixels, jiggle, pdf = (
        jax_ray_sampler.uniform_sample_with_replacement, jax_rays.jiggle_within_stratas, jax_renderer.sample_pdf
    )

    def record_pixels(rng, batch_size, n, num_samples):
        out = pixels(rng, batch_size, n, num_samples)
        draws["pixel_idx"] = torch.from_numpy(np.asarray(out).astype(np.int64))
        return out

    def record_jiggle(rng, bin_centers):
        u = jax.random.uniform(rng, bin_centers.shape, dtype=bin_centers.dtype)
        draws["strata_u"] = torch.from_numpy(np.array(u))
        return jiggle(rng, bin_centers)

    def record_pdf(bins, weights, n_samples, rng=None, **kw):
        u = jax.random.uniform(rng, (*bins.shape[:-1], n_samples), dtype=bins.dtype)
        draws["pdf_u"].append(torch.from_numpy(np.array(u)))
        return pdf(bins, weights, n_samples, rng=rng, **kw)

    monkeypatch.setattr(jax_ray_sampler, "uniform_sample_with_replacement", record_pixels)
    monkeypatch.setattr(jax_rays, "jiggle_within_stratas", record_jiggle)
    monkeypatch.setattr(jax_renderer, "sample_pdf", record_pdf)
    return draws


# --- ray sampling ---------------------------------------------------------


def test_strata_jitter_with_fed_draws_matches_jax():
    rng = jax.random.PRNGKey(3)
    centers = np.sort(np.random.RandomState(0).rand(2, 5, 1, 7).astype(np.float32) * 4 + 1, axis=-1)
    ref = jax_rays.jiggle_within_stratas(rng, jnp.asarray(centers))
    u = torch.from_numpy(np.array(jax.random.uniform(rng, centers.shape, dtype=jnp.float32)))
    got = jiggle_within_stratas(torch.from_numpy(centers), u=u)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)
    drawn = jiggle_within_stratas(torch.from_numpy(centers), generator=torch.Generator().manual_seed(0))
    lo = np.concatenate([centers[..., :1], 0.5 * (centers[..., 1:] + centers[..., :-1])], -1)
    hi = np.concatenate([0.5 * (centers[..., 1:] + centers[..., :-1]), centers[..., -1:]], -1)
    assert np.all(drawn.numpy() >= lo - 1e-6) and np.all(drawn.numpy() <= hi + 1e-6)


def test_monte_carlo_ray_sampler_with_fed_draws_matches_jax(monkeypatch):
    cfg = _pipeline_cfg()["ray_sampler"]
    batch = _batch()
    draws = _capture_draws(monkeypatch)
    ref = JAX_RAY_SAMPLERS.build(dict(cfg))(
        jax.random.PRNGKey(7), jnp.asarray(batch["poses"][:, :3]), jnp.asarray(batch["focal_lengths"]),
        JaxEvaluationMode.TRAINING,
    )
    sampler = RAY_SAMPLERS.build(dict(cfg))
    got = sampler(
        torch.from_numpy(batch["poses"]), torch.from_numpy(batch["focal_lengths"]), EvaluationMode.TRAINING,
        pixel_idx=draws["pixel_idx"], strata_u=draws["strata_u"],
    )
    assert tuple(got.xys.shape) == (1, 12, 1, 2) and tuple(got.lengths.shape) == (1, 12, 1, 5)
    for name in ("origins", "directions", "lengths", "xys"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(ref, name)), rtol=1e-5, atol=1e-6,
                                   err_msg=name)
    drawn = sampler(
        torch.from_numpy(batch["poses"]), torch.from_numpy(batch["focal_lengths"]), EvaluationMode.TRAINING,
        generator=torch.Generator().manual_seed(0),
    )
    xys = drawn.xys.numpy()
    assert xys.shape == (1, 12, 1, 2) and xys.min() >= 0 and xys.max() <= HW - 1


def test_sampling_without_replacement_with_fed_gumbel_matches_jax():
    """The Gumbel top-k with the JAX package's Gumbel draws gives its indices, with approx_top_k too."""
    rng = np.random.RandomState(2)
    weights = np.ones((3, 40), np.float32)
    weights[1] = rng.rand(40)
    weights[1, ::3] = 0.0  # zero-weight pixels are never picked
    weights[2, 5:] = 0.0  # 5 positive weights for 8 samples: padded with zero-weight pixels
    key = jax.random.PRNGKey(4)
    ref = np.asarray(jax_sampling.weighted_sample_without_replacement(key, jnp.asarray(weights), 8))
    gumbel = torch.from_numpy(np.array(jax.random.gumbel(key, weights.shape, dtype=jnp.float32)))
    got = weighted_sample_without_replacement(torch.from_numpy(weights), 8, gumbel=gumbel).numpy()
    np.testing.assert_array_equal(got[:2], ref[:2])
    # the -inf keys of the padding tie: JAX takes the lowest indices, topk any of them
    np.testing.assert_array_equal(got[2, :5], ref[2, :5])
    assert sorted(got[2, :5]) == [0, 1, 2, 3, 4] and np.all(weights[2, got[2, 5:]] == 0.0)
    assert np.all(weights[1, got[1]] > 0.0) and all(len(set(row)) == 8 for row in got)
    drawn = weighted_sample_without_replacement(torch.from_numpy(weights), 8,
                                                generator=torch.Generator().manual_seed(0))
    assert drawn.shape == (3, 8) and np.all(weights[1, drawn[1].numpy()] > 0.0)
    # approx_top_k: the exact top-k, which is what lax.approx_max_k gives on the JAX CPU backend
    ref_approx = np.asarray(jax_sampling.weighted_sample_without_replacement(key, jnp.asarray(weights), 8,
                                                                             approx=True))
    got_approx = weighted_sample_without_replacement(torch.from_numpy(weights), 8, gumbel=gumbel, approx=True)
    np.testing.assert_array_equal(got_approx.numpy()[:2], ref_approx[:2])
    np.testing.assert_array_equal(got_approx.numpy(), got)

    # the ray sampler's uniform case (lego.yml's default pixel_replacement: false)
    cfg = dict(_pipeline_cfg()["ray_sampler"], pixel_replacement=False)
    batch = _batch()
    poses, focal = torch.from_numpy(batch["poses"]), torch.from_numpy(batch["focal_lengths"])
    bundle = RAY_SAMPLERS.build(dict(cfg))(poses, focal, EvaluationMode.TRAINING,
                                           generator=torch.Generator().manual_seed(1))
    flat = bundle.xys[0, :, 0].numpy()
    assert flat.shape == (12, 2) and len({tuple(xy) for xy in flat}) == 12, "no pixel twice"
    approx = RAY_SAMPLERS.build(dict(cfg, approx_top_k=True))(poses, focal, EvaluationMode.TRAINING,
                                                               generator=torch.Generator().manual_seed(1))
    assert torch.equal(approx.xys, bundle.xys), "the same draws pick the same pixels"


# --- ground-truth metrics -------------------------------------------------


@pytest.mark.parametrize("spatial", [(12, 1), (16, 16)])
def test_view_metrics_with_ground_truth_match_jax(spatial):
    rng = np.random.RandomState(4)
    images = rng.rand(2, 16, 16, 3).astype(np.float32)
    pred = rng.rand(2, *spatial, 3).astype(np.float32)
    if spatial == (16, 16):
        grid = np.stack(np.meshgrid(np.arange(16), np.arange(16), indexing="xy"), -1)[None].repeat(2, 0)
    else:
        grid = rng.randint(0, 16, size=(2, *spatial, 2))
    grid = grid.astype(np.float32)
    ref = jax_metrics.view_metrics(jnp.asarray(grid), images=jnp.asarray(images), images_pred=jnp.asarray(pred))
    got = metrics.view_metrics(torch.from_numpy(grid), images=torch.from_numpy(images), images_pred=torch.from_numpy(pred))
    assert set(got) == set(ref) and ("loss_rgb_ssim" in got) == (spatial == (16, 16))
    for key in ref:
        assert tuple(got[key].shape) == (2,), key
        np.testing.assert_allclose(got[key].numpy(), np.asarray(ref[key]), rtol=1e-5, atol=1e-6, err_msg=key)


def test_psnr_and_masked_mse_match_jax():
    rng = np.random.RandomState(5)
    x, y = rng.rand(3, 10).astype(np.float32), rng.rand(3, 10).astype(np.float32)
    mask = (rng.rand(3, 10) > 0.5).astype(np.float32)
    for kw in ({}, {"mask": mask}):
        ref = jax_metrics.calc_psnr(jnp.asarray(x), jnp.asarray(y), **{k: jnp.asarray(v) for k, v in kw.items()})
        got = metrics.calc_psnr(torch.from_numpy(x), torch.from_numpy(y), **{k: torch.from_numpy(v) for k, v in kw.items()})
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5)
    assert metrics.mse2psnr(0.01) == pytest.approx(jax_metrics.mse2psnr(0.01)) == pytest.approx(20.0)


def test_depth_metrics_are_refused():
    """No longer refused: the depth metrics are ported (tests/test_torch_masks.py holds ``eval_depth``)."""
    rng = np.random.RandomState(6)
    grid = rng.randint(0, 4, size=(1, 2, 1, 2)).astype(np.float32)
    depths, depths_pred = rng.rand(1, 4, 4, 1).astype(np.float32) + 0.5, rng.rand(1, 2, 1, 1).astype(np.float32)
    got = metrics.view_metrics(torch.from_numpy(grid), depths=torch.from_numpy(depths),
                               depths_pred=torch.from_numpy(depths_pred))
    ref = jax_metrics.view_metrics(jnp.asarray(grid), depths=jnp.asarray(depths), depths_pred=jnp.asarray(depths_pred))
    assert set(got) == set(ref) == {"loss_depth_abs"}
    np.testing.assert_allclose(got["loss_depth_abs"].numpy(), np.asarray(ref["loss_depth_abs"]), rtol=1e-6, atol=1e-6)


# --- schedules and Adam ---------------------------------------------------


@pytest.mark.parametrize(
    "cfg",
    [
        dict(init_lr=5e-4, min_lr=5e-5, lr_decay_type="exponential", lr_decay_rate=0.1, lr_decay_iters=250,
             warmup_steps=10, warmup_lr=1e-5),
        dict(init_lr=1e-3, min_lr=1e-4, lr_decay_type="cosine", lr_decay_iters=1, num_iters=60, warmup_steps=5,
             warmup_lr=0.0),
        dict(init_lr=2e-3, min_lr=1e-3, lr_decay_type="exponential", lr_decay_rate=0.01, lr_decay_iters=20),
    ],
)
def test_lr_schedule_matches_jax_at_every_step(cfg):
    ref, got = jax_schedules.create_lr_schedule(cfg), create_lr_schedule(cfg)
    for step in range(60):
        assert got(step) == pytest.approx(float(ref(step)), rel=1e-6, abs=1e-12), step
    half = create_lr_schedule(cfg, init_lr=0.5 * cfg["init_lr"])
    assert half(cfg.get("warmup_steps", 0) + 1) <= got(cfg.get("warmup_steps", 0) + 1)


def test_adam_with_decay_and_param_groups_matches_optax():
    cfg = _pipeline_cfg()
    jax_pipeline = JAX_PIPELINES.build(dict(cfg))
    params = jax_pipeline.init(jax.random.PRNGKey(0))
    pipeline = PIPELINES.build(dict(cfg), device="cpu")
    load_jax_params(pipeline, jax.tree_util.tree_map(np.asarray, params))
    runner = dict(RUNNER, warmup_steps=2)
    tx = jax_optim.create_optimizer(runner, params)
    opt_state = tx.init(params)
    optimizer = create_optimizer(runner, pipeline)
    assert [len(g["params"]) for g in optimizer.param_groups] == [6, 20]  # as the JAX package labels them
    rng = np.random.RandomState(6)
    for step in range(5):
        grads_np = {k: rng.randn(*p.shape).astype(np.float32) for k, p in pipeline.named_parameters()}
        grads = jax.tree_util.tree_map(jnp.asarray, jax.tree_util.tree_map(np.asarray, _tree_like(params, grads_np)))
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        for k, p in pipeline.named_parameters():
            p.grad = torch.from_numpy(grads_np[k])
        set_learning_rates(runner, optimizer, step)
        optimizer.step()
    ref = flatten_tree(jax.tree_util.tree_map(np.asarray, params))
    for k, p in pipeline.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), ref[k], rtol=1e-5, atol=1e-6, err_msg=k)


def _tree_like(params, flat):
    ref = flatten_tree(jax.tree_util.tree_map(np.asarray, params))
    assert set(ref) == set(flat)
    paths = jax.tree_util.tree_flatten_with_path(params)[0]
    leaves = [flat[jax_optim.path_to_dotted(path)] for path, _ in paths]
    return jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(params), leaves)


# --- one whole train step -------------------------------------------------


def test_train_step_matches_jax_make_train_step(monkeypatch):
    cfg = _pipeline_cfg()
    batch = _batch(seed=1)
    jax_pipeline = JAX_PIPELINES.build(dict(cfg))
    # from this init every model gets a gradient well above the tolerance
    # (from some, a proposal's densities are all clipped and its gradient is 0)
    params = jax_pipeline.init(jax.random.PRNGKey(1))
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
    assert len(draws["pdf_u"]) == 2
    for i in range(3):
        largest = max(np.abs(v).max() for k, v in ref_grads.items() if k.startswith(f"implicit_functions.{i}."))
        assert largest > 10 * F32_GRAD_TOL["atol"], (i, largest)
    step = jax_apis.make_train_step(jax_pipeline, tx, donate=False)
    new_state, ref_preds = step(jax_optim.create_train_state(params, tx), jax_batch, rng)
    ref_params = flatten_tree(jax.tree_util.tree_map(np.asarray, new_state.params))
    init_params = flatten_tree(jax.tree_util.tree_map(np.asarray, params))

    pipeline = PIPELINES.build(dict(cfg), device="cpu")
    load_jax_params(pipeline, jax.tree_util.tree_map(np.asarray, params))
    state = TrainState(pipeline=pipeline, optimizer=create_optimizer(RUNNER, pipeline), step=0)
    launches = (K1.launches, K3.launches)
    preds = make_train_step(pipeline, RUNNER, seed=0)(
        state, {k: torch.from_numpy(v) for k, v in batch.items()}, draws=draws
    )
    assert (K1.launches, K3.launches) == launches, "CPU tensors take the plain versions"
    assert state.step == 1
    np.testing.assert_allclose(preds["objective"].numpy(), np.asarray(ref_preds["objective"]), rtol=1e-5, atol=1e-5)
    for key in ("loss_rgb_mse", "loss_proposal"):
        np.testing.assert_allclose(preds[key].numpy(), np.asarray(ref_preds[key]), rtol=1e-5, atol=1e-6, err_msg=key)
    named = dict(pipeline.named_parameters())
    assert set(named) == set(ref_grads)
    for key, p in named.items():
        np.testing.assert_allclose(p.grad.numpy(), ref_grads[key], err_msg=key, **F32_GRAD_TOL)
        # Adam's first update is lr * d / (|d| + eps) with d = g + weight_decay * p:
        # where |d| is within the gradients' atol, its sign is float32 noise
        # and the update may go either way; elsewhere the new parameters
        # agree at 1e-5
        lr = float(state.optimizer.param_groups[0 if key.startswith("implicit_functions.0") else 1]["lr"])
        settled = np.abs(ref_grads[key] + RUNNER["weight_decay"] * init_params[key]) > F32_GRAD_TOL["atol"]
        new, ref = p.detach().numpy(), ref_params[key]
        np.testing.assert_allclose(new[settled], ref[settled], rtol=1e-5, atol=1e-5, err_msg=key)
        assert np.all(np.abs(new - ref) <= 2.0 * lr * (1 + 1e-5)), key


def test_train_step_runs_the_fused_function_only_when_switched_on():
    cfg = _pipeline_cfg()
    cfg["model"][2] = dict(cfg["model"][2], use_pallas_train=False, use_pallas=True)
    pipeline = PIPELINES.build(dict(cfg), device="cpu")
    calls = []
    nerf = pipeline.implicit_functions[2]
    original = nerf.forward

    def spy(*args, **kwargs):
        calls.append(kwargs.get("use_pallas"))
        return original(*args, **kwargs)

    nerf.forward = spy
    state = TrainState(pipeline=pipeline, optimizer=create_optimizer(RUNNER, pipeline), step=0)
    batch = {k: torch.from_numpy(v) for k, v in _batch().items()}
    make_train_step(pipeline, RUNNER, seed=0)(state, batch)
    assert calls == [False], "TRAINING reads use_pallas_train, never use_pallas"


# --- the CLI --------------------------------------------------------------


def _write_drive(tmp_path):
    data = write_scene(tmp_path / "data", hw=16, n_train=4, n_val=2, n_test=2, n_spheres=3, seed=1)
    cfg = dict(
        datasets=[dict(type="BlenderDataset", base_dir=str(data), split=s, test_skip=1) for s in ("train", "val", "test")],
        runner=dict(
            eval_last_epoch_model=True, seed=0, output_dir=str(tmp_path / "results"), print_per_iter=2,
            val_per_iter=4, save_per_iter=4, batch_size_list=[1, 1, 1], num_workers_list=[0, 0, 0], num_iters=8,
            cache_dataset_on_device=True, cache_quantize_images=True, steps_per_call=4,
            **{k: v for k, v in RUNNER.items() if k != "num_iters"},
        ),
        pipeline=dict(_pipeline_cfg("bfloat16"), chunk_size_grid=256),
    )
    cfg["pipeline"]["ray_sampler"] = dict(cfg["pipeline"]["ray_sampler"], image_height=16, image_width=16)
    path = tmp_path / "tiny.json"
    path.write_text(json.dumps(cfg))
    return path


def test_run_trains_checkpoints_and_resumes_on_the_cpu(tmp_path):
    cfg_path = _write_drive(tmp_path)
    result = port_run.main(["--config", str(cfg_path), "--device", "cpu"])
    out = result["output_dir"]
    assert out.name == "version_0"
    assert sorted(p.name for p in (out / "ckpts").iterdir()) == ["ckpts_-001", "ckpts_0000", "ckpts_0001"]
    train = [json.loads(line) for line in (out / "train_stats.json").read_text().splitlines()]
    assert len(train) == 2 and all(math.isfinite(r["train_objective"]) for r in train)
    assert "test_loss_rgb_psnr" in json.loads((out / "test_stats.json").read_text())
    state = result["state"]
    assert state.step == 8
    # steps_per_call=4 on the device cache: the fused dispatch, groups 1-3 after each epoch's vis step
    assert result["train_step_fused"].dispatches == 2 and result["train_step_fused"].steps == 6
    assert "fused path is ineligible" not in (out / "run.log").read_text()
    assert sorted(p.name for p in (out / "visualization" / "train" / "rendered_images").iterdir()) == ["00000", "00001"]

    fresh = PIPELINES.build(Config.fromfile(str(out / "config.yml")).pipeline, device="cpu")
    fresh_state = TrainState(pipeline=fresh, optimizer=create_optimizer(RUNNER, fresh), step=0)
    meta = load_checkpoint(out / "ckpts" / "ckpts_0001", fresh_state)
    assert meta["epoch"] == 1 and fresh_state.step == 8
    for (k, p), q in zip(state.pipeline.named_parameters(), fresh.parameters()):
        assert torch.equal(p.detach(), q.detach()), k
    assert fresh_state.optimizer.state_dict()["state"].keys() == state.optimizer.state_dict()["state"].keys()

    # a checkpoint's params are a tree the JAX package's pipeline takes
    tree = checkpoint_params_tree(out / "ckpts" / "ckpts_0001")
    jax_pipeline = JAX_PIPELINES.build(JaxConfig.fromfile(str(out / "config.yml")).pipeline)
    ref = jax_pipeline.init(jax.random.PRNGKey(0))
    assert jax.tree_util.tree_structure(ref) == jax.tree_util.tree_structure(tree)
    for a, b in zip(jax.tree_util.tree_leaves(ref), jax.tree_util.tree_leaves(tree)):
        assert a.shape == b.shape

    resumed = port_run.main(["--config", str(cfg_path), "--device", "cpu",
                             "--checkpoint", str(out / "ckpts" / "ckpts_0000")])
    assert resumed["output_dir"].name == "version_1" and resumed["state"].step == 8
    assert len(resumed["train_stats"]) == 1


def test_run_refuses_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    config = Path(__file__).resolve().parent.parent / "configs" / "nerf" / "lego_proposal.yml"
    with pytest.raises(RuntimeError, match="cuda"):
        port_run.main(["--config", str(config)])


def test_chip_smoke_train_and_step_phases_run_on_the_cpu(tmp_path, monkeypatch):
    """chip_smoke.py's train and step phases at a tiny size (on the card they run lego_proposal.yml)."""
    import chip_smoke

    cfg_path = _write_drive(tmp_path)
    for name, value in (("DEVICE", "cpu"), ("CONFIG", cfg_path), ("TRAIN_STEPS", 8)):
        monkeypatch.setattr(chip_smoke, name, value)
    # CPU tensors take the plain versions, which count no launch: count the calls instead
    for module, name in ((K1, "nerf_mlp_fwd"), (K3, "nerf_mlp_bwd")):

        def counting(*args, _module=module, _plain=getattr(module, name), **kwargs):
            _module.launches += 1
            return _plain(*args, **kwargs)

        monkeypatch.setattr(module, name, counting)
    numbers, launches = chip_smoke.train(torch, K1, K3, tmp_path / "data", tmp_path / "smoke")
    assert all(numbers["checks"].values()), numbers["checks"]
    assert launches == {"nerf_mlp_fwd": 8, "nerf_mlp_fwd_pipelined": 0, "nerf_mlp_bwd": 8}
    step = chip_smoke.step_equivalence(torch, tmp_path / "data")
    assert all(step["checks"].values()), step


def test_chip_smoke_fused_phase_runs_on_the_cpu(tmp_path, monkeypatch):
    """chip_smoke.py's fused phase at a tiny size: steps_per_call=3 against two per-step runs, 8 steps."""
    import chip_smoke

    cfg_path = _write_drive(tmp_path)
    for name, value in (("DEVICE", "cpu"), ("CONFIG", cfg_path), ("FUSED_TRAIN_STEPS", 8),
                        ("FUSED_STEPS_PER_CALL", 3)):
        monkeypatch.setattr(chip_smoke, name, value)
    # CPU tensors take the plain versions, which count no launch: count the calls instead
    for module, name in ((K1, "nerf_mlp_fwd"), (K3, "nerf_mlp_bwd")):

        def counting(*args, _module=module, _plain=getattr(module, name), **kwargs):
            _module.launches += 1
            return _plain(*args, **kwargs)

        monkeypatch.setattr(module, name, counting)
    numbers, launches = chip_smoke.fused_train(torch, K1, K3, tmp_path / "data", tmp_path / "fused")
    assert all(numbers["checks"].values()), numbers["checks"]
    assert numbers["fused_bit_equal_to_per_step"] and numbers["per_step_runs_bit_equal"]
    assert numbers["dispatches"] == 2 and numbers["group_sizes"] == [3]
    assert launches == {"nerf_mlp_fwd": 8, "nerf_mlp_fwd_pipelined": 0, "nerf_mlp_bwd": 8}
