"""Sampling masks, the masked samplers and the depth metrics, held to ``yanerf_tpu``.

* ``weighted_sample_with_replacement`` with the JAX u fed in gives the JAX
  indices;
* one TRAINING call of the flagship at tiny widths with ``mask_crop``, a
  ``(B, H, W)`` and a two-layer ``(B, L, H, W)`` ``sampling_prob_mask``,
  with and without replacement, against the JAX pipeline with its pixel,
  jitter and pdf draws fed in: objective 1e-5, gradients rtol 2e-4 /
  atol 2e-5, float32;
* the JAX ray sampler's ``ValueError`` s raised alike;
* ``eval_depth`` and ``view_metrics`` with depths at 1e-6.
"""

from collections import namedtuple

import jax
import jax.numpy as jnp
import numpy as np
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
from torch_config_pin import with_mass
from yanerf_tpu_torch.convert import flatten_tree, load_jax_params
from yanerf_tpu_torch.ops import metrics
from yanerf_tpu_torch.ops.sampling import weighted_sample_with_replacement
from yanerf_tpu_torch.ops.structures import EvaluationMode
from yanerf_tpu_torch.pipelines import PIPELINES, RAY_SAMPLERS
from yanerf_tpu_torch.runners import TrainState, create_optimizer, make_train_step
from yanerf_tpu_torch.serve import CAM_CALIBRATION, orbit_pose

HW = 8
N_RAYS = 12
F32_GRAD_TOL = dict(rtol=2e-4, atol=2e-5)


def _cfg(pixel_replacement=True):
    return dict(
        type="NeRFPipeline", chunk_size_grid=42, num_passes=3, output_rasterized_mc=False,
        loss_weights={"loss_rgb_mse": 1.0, "loss_proposal": 1.0},
        model=[
            dict(type="ProposalMLP", n_layers=2, hidden_dim=16),
            dict(type="ProposalMLP", n_layers=2, hidden_dim=16),
            dict(type="NeRFMLP", n_layers=3, input_skips=[2], n_harmonic_functions_xyz=3, n_harmonic_functions_dir=2,
                 n_hidden_neurons_xyz=32, n_hidden_neurons_dir=16, use_pallas_train=True),
        ],
        ray_sampler=dict(type="RaySampler", image_height=HW, image_width=HW, min_depth=1.0, max_depth=3.0,
                         n_pts_per_ray_training=5, n_pts_per_ray_evaluation=6,
                         n_rays_per_image_sampled_from_mask=N_RAYS, pixel_replacement=pixel_replacement),
        renderer=dict(type="ProposalEmissionAbsorpsionRenderer", n_pts_per_ray_final_training=4,
                      n_pts_per_ray_final_evaluation=5, n_pts_per_ray_intermediate_training=[6],
                      n_pts_per_ray_intermediate_evaluation=[6], bg_color=[0.0, 0.0, 0.0],
                      density_noise_std_train=0.0, background_density_bias=1e-6),
        feature_extractor=[],
    )


def _masks(batch_size, kind, seed=0):
    """The call's mask arguments; every row keeps well over N_RAYS positive pixels."""
    rng = np.random.RandomState(seed)
    if kind == "mask_crop":
        mask = np.zeros((batch_size, 1, HW // 2, HW // 2), np.float32)  # nearest-resized to the grid
        mask[:, :, 1:4, 1:4] = 1.0
        return {"mask_crop": mask}
    if kind == "prob":
        prob = rng.rand(batch_size, HW, HW).astype(np.float32)
        prob[:, :, :2] = 0.0
        return {"sampling_prob_mask": prob}
    prob = rng.rand(batch_size, 2, HW, HW).astype(np.float32)
    prob[:, 0, :4] = 0.0  # layer 0 draws from the lower half, layer 1 from the upper
    prob[:, 1, 4:] = 0.0
    return {"sampling_prob_mask": prob, "n_rays_per_image": [N_RAYS // 2, N_RAYS // 2]}


def _weights(masks):
    """The call's ``(B, L, H * W)`` pixel weights, one layer per ray budget."""
    if "mask_crop" in masks:
        return np.repeat(np.repeat(masks["mask_crop"], 2, axis=2), 2, axis=3).reshape(-1, 1, HW * HW)
    prob = masks["sampling_prob_mask"]
    return prob.reshape(prob.shape[0], -1, HW * HW)


def _batch(batch_size=2, seed=1):
    rng = np.random.RandomState(seed)
    poses = np.stack([(orbit_pose(30.0 + 20 * i, -30.0, 2.0) @ CAM_CALIBRATION) for i in range(batch_size)])
    return dict(poses=poses.astype(np.float32), focal_lengths=np.full((batch_size, 1), 10.0, np.float32),
                image_rgb=rng.rand(batch_size, HW, HW, 3).astype(np.float32))


def _capture_draws(monkeypatch):
    """Record the JAX pipeline's draws as the port's masked ``draws`` take them."""
    draws = {"pixel_u": [], "pixel_gumbel": [], "pdf_u": []}
    with_repl, without_repl = jax_ray_sampler.weighted_sample_with_replacement, \
        jax_ray_sampler.weighted_sample_without_replacement
    jiggle, pdf = jax_rays.jiggle_within_stratas, jax_renderer.sample_pdf

    def record_with(rng, weights, num_samples):
        u = jax.random.uniform(rng, (*weights.shape[:-1], num_samples), dtype=weights.dtype)
        draws["pixel_u"].append(torch.from_numpy(np.array(u)))
        out = with_repl(rng, weights, num_samples)
        draws.setdefault("jax_idx", []).append(np.asarray(out))
        return out

    def record_without(rng, weights, num_samples, approx=False):
        g = jax.random.gumbel(rng, weights.shape, dtype=weights.dtype)
        draws["pixel_gumbel"].append(torch.from_numpy(np.array(g)))
        out = without_repl(rng, weights, num_samples, approx=approx)
        draws.setdefault("jax_idx", []).append(np.asarray(out))
        return out

    def record_jiggle(rng, bin_centers):
        draws["strata_u"] = torch.from_numpy(np.array(jax.random.uniform(rng, bin_centers.shape,
                                                                          dtype=bin_centers.dtype)))
        return jiggle(rng, bin_centers)

    def record_pdf(bins, weights, n_samples, rng=None, **kw):
        u = jax.random.uniform(rng, (*bins.shape[:-1], n_samples), dtype=bins.dtype)
        draws["pdf_u"].append(torch.from_numpy(np.array(u)))
        return pdf(bins, weights, n_samples, rng=rng, **kw)

    monkeypatch.setattr(jax_ray_sampler, "weighted_sample_with_replacement", record_with)
    monkeypatch.setattr(jax_ray_sampler, "weighted_sample_without_replacement", record_without)
    monkeypatch.setattr(jax_rays, "jiggle_within_stratas", record_jiggle)
    monkeypatch.setattr(jax_renderer, "sample_pdf", record_pdf)
    return draws


# --- the samplers ----------------------------------------------------------


def test_weighted_sample_with_replacement_with_fed_u_matches_jax():
    rng = np.random.RandomState(3)
    weights = rng.rand(3, 50).astype(np.float32)
    weights[0, ::2] = 0.0
    weights[1] = (weights[1] > 0.7).astype(np.float32)
    weights[2, :] = 0.0
    weights[2, 0] = 1.0  # one pixel: every draw picks it
    key = jax.random.PRNGKey(5)
    ref = np.asarray(jax_sampling.weighted_sample_with_replacement(key, jnp.asarray(weights), 16))
    u = torch.from_numpy(np.array(jax.random.uniform(key, (3, 16), dtype=jnp.float32)))
    got = weighted_sample_with_replacement(torch.from_numpy(weights), 16, u=u).numpy()
    np.testing.assert_array_equal(got, ref)
    assert np.all(weights[np.arange(3)[:, None], got] > 0) and np.all(got[2] == 0)
    # a draw of exactly 0 never picks a zero-weight pixel (searchsorted on the right side)
    zero = weighted_sample_with_replacement(torch.from_numpy(weights), 4, u=torch.zeros(3, 4)).numpy()
    assert np.all(weights[np.arange(3)[:, None], zero] > 0)
    drawn = weighted_sample_with_replacement(torch.from_numpy(weights), 64, generator=torch.Generator().manual_seed(0))
    assert np.all(weights[np.arange(3)[:, None], drawn.numpy()] > 0)
    with pytest.raises(ValueError, match="generator"):
        weighted_sample_with_replacement(torch.from_numpy(weights), 4)


@pytest.mark.parametrize("kind", ["mask_crop", "prob", "prob_layers"])
@pytest.mark.parametrize("pixel_replacement", [True, False], ids=["replacement", "gumbel"])
def test_masked_ray_sampler_with_fed_draws_matches_jax(monkeypatch, kind, pixel_replacement):
    cfg = _cfg(pixel_replacement)["ray_sampler"]
    batch, masks = _batch(), _masks(2, kind)
    draws = _capture_draws(monkeypatch)
    jax_kw = {"mask" if k == "mask_crop" else k: (jnp.asarray(v) if k != "n_rays_per_image" else v)
              for k, v in masks.items()}
    ref = JAX_RAY_SAMPLERS.build(dict(cfg))(
        jax.random.PRNGKey(7), jnp.asarray(batch["poses"][:, :3]), jnp.asarray(batch["focal_lengths"]),
        JaxEvaluationMode.TRAINING, **jax_kw,
    )
    assert len(draws["pixel_u" if pixel_replacement else "pixel_gumbel"]) == (2 if kind == "prob_layers" else 1)
    port_kw = {"mask" if k == "mask_crop" else k: (torch.from_numpy(v) if k != "n_rays_per_image" else v)
               for k, v in masks.items()}
    sampler = RAY_SAMPLERS.build(dict(cfg))
    got = sampler(
        torch.from_numpy(batch["poses"]), torch.from_numpy(batch["focal_lengths"]), EvaluationMode.TRAINING,
        strata_u=draws["strata_u"], pixel_u=draws["pixel_u"] or None, pixel_gumbel=draws["pixel_gumbel"] or None,
        **port_kw,
    )
    np.testing.assert_array_equal(got.xys.numpy(), np.asarray(ref.xys))
    for name in ("origins", "directions", "lengths"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(ref, name)), rtol=1e-5, atol=1e-6,
                                   err_msg=name)
    # drawn from a generator: every pixel has weight > 0 (each layer's pixels by its own layer)
    drawn = sampler(torch.from_numpy(batch["poses"]), torch.from_numpy(batch["focal_lengths"]),
                    EvaluationMode.TRAINING, generator=torch.Generator().manual_seed(0), **port_kw)
    xy = drawn.xys[:, :, 0].numpy().astype(np.int64)
    flat = xy[..., 0] + HW * xy[..., 1]
    weights = _weights(masks)
    layer = np.repeat(np.arange(weights.shape[1]), N_RAYS // weights.shape[1])
    assert flat.shape == (2, N_RAYS)
    assert np.all(weights[np.arange(2)[:, None], layer[None], flat] > 0)


def test_mask_errors_match_jax():
    cfg = _cfg()["ray_sampler"]
    batch = _batch()
    jax_sampler, port_sampler = JAX_RAY_SAMPLERS.build(dict(cfg)), RAY_SAMPLERS.build(dict(cfg))
    jax_args = (jax.random.PRNGKey(0), jnp.asarray(batch["poses"][:, :3]), jnp.asarray(batch["focal_lengths"]),
                JaxEvaluationMode.TRAINING)
    port_args = (torch.from_numpy(batch["poses"]), torch.from_numpy(batch["focal_lengths"]), EvaluationMode.TRAINING)
    gen = torch.Generator().manual_seed(0)
    prob3 = np.ones((2, 3, HW, HW), np.float32)
    cases = [
        (dict(sampling_prob_mask=prob3, n_rays_per_image=[4, 4]), "3 layers but len\\(n_rays_per_image\\) == 2"),
        (dict(sampling_prob_mask=np.ones((2, 2, HW, HW + 1), np.float32), n_rays_per_image=[4, 4]),
         "Invalid sampling_prob_mask shape"),
        (dict(sampling_prob_mask=np.ones((2, HW * HW), np.float32)), "want \\(B, H, W\\) or \\(B, L, H, W\\)"),
        (dict(sampling_prob_mask=np.ones((2, HW, HW), np.float32), n_rays_per_image=[4, 4]), "is a list"),
        (dict(n_rays_per_image=[4, 4]), "is a list"),
    ]
    for kw, match in cases:
        with pytest.raises(ValueError, match=match):
            jax_sampler(*jax_args, **{k: jnp.asarray(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()})
        with pytest.raises(ValueError, match=match):
            port_sampler(*port_args, generator=gen,
                         **{k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()})
    # a mask without a static ray count
    no_count = dict(cfg, n_rays_per_image_sampled_from_mask=None)
    mask = np.ones((2, 1, HW, HW), np.float32)
    with pytest.raises(ValueError, match="static ray count"):
        JAX_RAY_SAMPLERS.build(dict(no_count))(*jax_args, mask=jnp.asarray(mask))
    with pytest.raises(ValueError, match="static ray count"):
        RAY_SAMPLERS.build(dict(no_count))(*port_args, mask=torch.from_numpy(mask))


# --- one TRAINING call of the flagship -----------------------------------------


@pytest.mark.parametrize("kind", ["mask_crop", "prob", "prob_layers"])
@pytest.mark.parametrize("pixel_replacement", [True, False], ids=["replacement", "gumbel"])
def test_masked_training_call_matches_jax(monkeypatch, kind, pixel_replacement):
    cfg = _cfg(pixel_replacement)
    batch, masks = _batch(), _masks(2, kind, seed=3)
    jax_pipeline = JAX_PIPELINES.build(dict(cfg))
    params = with_mass(jax_pipeline.init(jax.random.PRNGKey(1)))
    jax_batch = {k: jnp.asarray(v) for k, v in batch.items()}
    jax_masks = {k: (jnp.asarray(v) if k != "n_rays_per_image" else v) for k, v in masks.items()}

    def loss_fn(p):
        preds = jax_pipeline.forward(p, jax.random.PRNGKey(11), evaluation_mode=JaxEvaluationMode.TRAINING,
                                     **jax_batch, **jax_masks)
        return jnp.mean(preds["objective"]), preds

    with monkeypatch.context() as m:
        draws = _capture_draws(m)
        (_, ref_preds), ref_grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
    ref_grads = flatten_tree(jax.tree_util.tree_map(np.asarray, ref_grads))
    jax_idx = np.concatenate(draws.pop("jax_idx"), axis=-1)
    weights = _weights(masks)
    layer = np.repeat(np.arange(weights.shape[1]), N_RAYS // weights.shape[1])
    assert np.all(weights[np.arange(2)[:, None], layer[None], jax_idx] > 0), "the JAX draws respect the masks"
    for key in ("pixel_u", "pixel_gumbel"):
        if not draws[key]:
            del draws[key]

    pipeline = PIPELINES.build(dict(cfg), device="cpu")
    load_jax_params(pipeline, jax.tree_util.tree_map(np.asarray, params))
    port_masks = {k: (torch.from_numpy(v) if k != "n_rays_per_image" else v) for k, v in masks.items()}
    preds = pipeline(evaluation_mode=EvaluationMode.TRAINING, draws=draws,
                     **{k: torch.from_numpy(v) for k, v in batch.items()}, **port_masks)
    np.testing.assert_allclose(preds["objective"].detach().numpy(), np.asarray(ref_preds["objective"]), rtol=1e-5,
                               atol=1e-5)
    torch.mean(preds["objective"]).backward()
    named = dict(pipeline.named_parameters())
    assert set(named) == set(ref_grads)
    for key, p in named.items():
        np.testing.assert_allclose(p.grad.numpy(), ref_grads[key], err_msg=key, **F32_GRAD_TOL)


@pytest.mark.parametrize("kind", ["mask_crop", "prob_layers"])
def test_masked_train_step_draws_by_the_mask_and_the_fused_dispatch_refuses_it(kind):
    cfg = _cfg(pixel_replacement=kind == "mask_crop")
    cfg["output_rasterized_mc"] = True
    pipeline = PIPELINES.build(dict(cfg), device="cpu")
    masks = _masks(2, kind)
    batch = {k: torch.from_numpy(v) for k, v in _batch().items()}
    batch.update({k: (torch.from_numpy(v) if k != "n_rays_per_image" else v) for k, v in masks.items()})
    runner = dict(init_lr=1e-3, min_lr=1e-4, lr_decay_type="exponential", lr_decay_rate=0.1, lr_decay_iters=100,
                  warmup_steps=0, warmup_lr=0.0, weight_decay=0.0, num_iters=10)
    state = TrainState(pipeline=pipeline, optimizer=create_optimizer(runner, pipeline), step=0)
    assert pipeline.masked_training(batch)
    specs = pipeline.training_draws(2, n_rays_per_image=masks.get("n_rays_per_image"), masked=True)
    assert [s.key for s in specs if s.key.startswith("pixel")] == (["pixel_u"] if kind == "mask_crop"
                                                                   else ["pixel_gumbel"] * 2)
    preds = make_train_step(pipeline, runner, seed=0, rasterize_mc=True)(state, batch)
    assert state.step == 1 and bool(torch.isfinite(preds["objective"]).all())
    hit = preds["rendered_alpha_masks"][..., 0] > 0
    allowed = torch.from_numpy(_weights(masks).max(axis=1).reshape(2, HW, HW) > 0)
    assert bool(hit.any()) and not bool((hit & ~allowed).any()), "no ray outside the mask"
    with pytest.raises(ValueError, match="pixel_u / pixel_gumbel"):
        pipeline(evaluation_mode=EvaluationMode.TRAINING, draws={"pixel_idx": torch.zeros(2, N_RAYS, dtype=torch.long)},
                 **batch)

    from yanerf_tpu_torch.runners.apis import make_train_step_fused

    fields = [k for k in batch if k != "n_rays_per_image"]
    wrapper = namedtuple("Batch", fields)  # a cache with the mask as one more field
    fused = make_train_step_fused(pipeline, dict(runner, steps_per_call=2), 0, wrapper)
    arrays = [batch[k] for k in fields]
    with pytest.raises(NotImplementedError, match="mask_crop / sampling_prob_mask"):
        fused(state, arrays, np.zeros((2, 2), np.int64))


# --- depth metrics -----------------------------------------------------------


@pytest.mark.parametrize("get_best_scale", [True, False])
@pytest.mark.parametrize("crop,with_mask", [(0, False), (1, False), (2, True), (0, True)])
def test_eval_depth_matches_jax(get_best_scale, crop, with_mask):
    rng = np.random.RandomState(crop + 2 * with_mask)
    gt = rng.rand(3, 9, 10, 1).astype(np.float32) * 4
    gt[gt < 0.6] = 0.0  # pixels without ground truth
    pred = (gt * 1.7 + rng.rand(3, 9, 10, 1) * 0.3).astype(np.float32)
    mask = rng.rand(3, 9, 10, 1).astype(np.float32) if with_mask else None
    kw = dict(crop=crop, get_best_scale=get_best_scale)
    ref = jax_metrics.eval_depth(jnp.asarray(pred), jnp.asarray(gt), mask=None if mask is None else jnp.asarray(mask),
                                 **kw)
    got = metrics.eval_depth(torch.from_numpy(pred), torch.from_numpy(gt),
                             mask=None if mask is None else torch.from_numpy(mask), **kw)
    for g, r in zip(got, ref):
        assert tuple(g.shape) == (3,)
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-6, atol=1e-6)
    scale = metrics.estimate_depth_scale_factor(torch.from_numpy(pred), torch.from_numpy(gt),
                                                torch.from_numpy((gt > 0).astype(np.float32)), 1e-4)
    ref_scale = jax_metrics.estimate_depth_scale_factor(jnp.asarray(pred), jnp.asarray(gt),
                                                        jnp.asarray((gt > 0).astype(np.float32)), 1e-4)
    np.testing.assert_allclose(scale.numpy(), np.asarray(ref_scale), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("spatial", [(12, 1), (16, 16)])
def test_view_metrics_with_depths_match_jax(spatial):
    rng = np.random.RandomState(9)
    images, depths = rng.rand(2, 16, 16, 3).astype(np.float32), rng.rand(2, 16, 16, 1).astype(np.float32) + 0.1
    pred, depths_pred = rng.rand(2, *spatial, 3).astype(np.float32), rng.rand(2, *spatial, 1).astype(np.float32)
    reweight = rng.rand(2, 16, 16, 3).astype(np.float32)
    grid = rng.randint(0, 16, size=(2, *spatial, 2)).astype(np.float32)
    args = dict(images=images, images_pred=pred, depths=depths, depths_pred=depths_pred, loss_reweight_masks=reweight)
    ref = jax_metrics.view_metrics(jnp.asarray(grid), **{k: jnp.asarray(v) for k, v in args.items()})
    got = metrics.view_metrics(torch.from_numpy(grid), **{k: torch.from_numpy(v) for k, v in args.items()})
    assert set(got) == set(ref) and "loss_depth_abs" in got
    for key in ref:
        np.testing.assert_allclose(got[key].numpy(), np.asarray(ref[key]), rtol=1e-6, atol=1e-6, err_msg=key)
