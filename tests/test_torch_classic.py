"""The classic coarse -> fine family (configs/nerf/lego.yml) of yanerf_tpu_torch against yanerf_tpu, on the CPU.

The structure of lego.yml at tiny widths: one NeRFMLP config with
``num_passes: 2`` (two NeRFMLPs with their own weights), the
``MultipassEmissionAbsorpsionRenderer`` with the coarse samples appended to
the fine ones and sorted, density noise in training, pixels sampled
without replacement, and ``loss_prev_stage_rgb_mse`` in the objective. The
same weights go to both packages through ``convert.py``; the random draws
of the JAX package (pixel indices, strata jitter, the refinement's u's,
the density noise) are taken by wrapping the JAX functions that draw with
pytest's ``monkeypatch`` and fed to the port.

Tolerances: the renderer and a whole EVALUATION frame at rtol/atol 1e-4 in
float32 (the refinement's inverse CDF divides by per-bin CDF steps, which
scales the ops' ~1e-6 differences up before the fine pass, as in
tests/test_torch_pipeline.py) and 5e-3 in bfloat16 (a bf16 rounding that
goes the other way in a coarse density moves the resampled depths by as
much). A whole train step: objective 1e-5, every gradient of both NeRFMLPs
rtol 2e-4 / atol 2e-5, the Adam update 1e-5 where the gradient exceeds
that atol (as tests/test_torch_train.py).
"""

import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import yanerf_tpu.ops.rays as jax_rays
import yanerf_tpu.pipelines.ray_sampler as jax_ray_sampler
import yanerf_tpu.pipelines.renderer as jax_renderer
from yanerf_tpu.models import MODELS as JAX_MODELS
from yanerf_tpu.ops.structures import EvaluationMode as JaxEvaluationMode
from yanerf_tpu.pipelines import PIPELINES as JAX_PIPELINES
from yanerf_tpu.runners import apis as jax_apis
from yanerf_tpu.runners import optim as jax_optim
from yanerf_tpu.runners.stats import create_stats as jax_create_stats
from yanerf_tpu.utils import Config as JaxConfig
from yanerf_tpu_torch import run as port_run
from yanerf_tpu_torch.convert import flatten_tree, load_jax_params
from yanerf_tpu_torch.models import MODELS
from yanerf_tpu_torch.ops.kernels import nerf_mlp_bwd as K3
from yanerf_tpu_torch.ops.kernels import nerf_mlp_fwd as K1
from yanerf_tpu_torch.ops.structures import EvaluationMode
from yanerf_tpu_torch.pipelines import PIPELINES, RENDERERS
from yanerf_tpu_torch.runners import (
    TrainState,
    checkpoint_params_tree,
    create_optimizer,
    create_stats,
    load_checkpoint,
    make_train_step,
)
from yanerf_tpu_torch.serve import CAM_CALIBRATION, orbit_pose, service_from_config
from yanerf_tpu_torch.synth_scene import write_scene
from yanerf_tpu_torch.utils import Config

HW = 8
F32_GRAD_TOL = dict(rtol=2e-4, atol=2e-5)
MODEL = dict(type="NeRFMLP", n_layers=3, input_skips=[2], n_harmonic_functions_xyz=3, n_harmonic_functions_dir=2,
             n_hidden_neurons_xyz=32, n_hidden_neurons_dir=16)
RENDERER = dict(type="MultipassEmissionAbsorpsionRenderer", append_coarse_samples_to_fine=True,
                bg_color=[0.0, 0.0, 0.0], density_noise_std_train=0.2, n_pts_per_ray_fine_training=6,
                n_pts_per_ray_fine_evaluation=7, background_density_bias=1e-6)
RUNNER = dict(init_lr=5e-3, min_lr=5e-4, lr_decay_type="exponential", lr_decay_rate=0.1, lr_decay_iters=1000,
              warmup_steps=0, warmup_lr=1e-5, weight_decay=1e-3, num_iters=100, lr_param_groups=[])


def _cfg(compute_dtype="float32", chunk_size_grid=40, **model):
    """lego.yml's structure; 64 eval rays of 5 coarse points make 8 chunks of 8 rays at chunk_size_grid 40."""
    return dict(
        type="NeRFPipeline",
        chunk_size_grid=chunk_size_grid,
        num_passes=2,
        output_rasterized_mc=True,
        loss_weights={"loss_prev_stage_rgb_mse": 1.0, "loss_rgb_mse": 1.0},
        model=dict(MODEL, compute_dtype=compute_dtype, **model),
        ray_sampler=dict(type="RaySampler", image_height=HW, image_width=HW, min_depth=1.0, max_depth=3.0,
                         n_pts_per_ray_training=5, n_pts_per_ray_evaluation=5, n_rays_per_image_sampled_from_mask=12),
        renderer=dict(RENDERER),
        feature_extractor=[],
    )


def _batch(seed=0):
    rng = np.random.RandomState(seed)
    pose = (orbit_pose(30.0, -30.0, 2.0) @ CAM_CALIBRATION).astype(np.float32)
    return dict(poses=pose[None], focal_lengths=np.asarray([[10.0]], np.float32),
                image_rgb=rng.rand(1, HW, HW, 3).astype(np.float32))


def _capture_draws(monkeypatch):
    """Record the JAX package's draws in the form of the port's ``draws``.

    Each wrapper computes the draw from the key it is given, as the wrapped
    function does, and hands it out through ``jax.debug.callback``, so the
    recording also works inside ``jit`` and ``grad``. Draws of one kind are
    stored in the order the program was traced (``jax.effects_barrier()``
    after the run makes sure they have all arrived).
    """
    draws = {"pdf_u": [], "density_noise": []}
    pixels, jiggle = jax_ray_sampler.weighted_sample_without_replacement, jax_rays.jiggle_within_stratas
    pdf, composite = jax_renderer.sample_pdf, jax_renderer.emission_absorption

    def keep(name, value, dtype=None):
        def store(v, slot=len(draws[name]) if name in ("pdf_u", "density_noise") else None):
            t = torch.from_numpy(np.array(v, dtype=dtype))
            if slot is None:
                draws[name] = t
            else:
                draws[name][slot] = t

        if name in ("pdf_u", "density_noise"):
            draws[name].append(None)
        jax.debug.callback(store, value)

    def record_pixels(rng, weights, num_samples, approx=False):
        out = pixels(rng, weights, num_samples, approx=approx)
        keep("pixel_idx", out, np.int64)
        return out

    def record_jiggle(rng, bin_centers):
        keep("strata_u", jax.random.uniform(rng, bin_centers.shape, dtype=bin_centers.dtype))
        return jiggle(rng, bin_centers)

    def record_pdf(bins, weights, n_samples, rng=None, **kw):
        if not kw.get("det", False):
            keep("pdf_u", jax.random.uniform(rng, (*bins.shape[:-1], n_samples), dtype=bins.dtype))
        return pdf(bins, weights, n_samples, rng=rng, **kw)

    def record_composite(rays_densities, *args, density_noise_std=0.0, rng=None, **kw):
        if density_noise_std > 0.0:
            keep("density_noise", jax.random.normal(rng, rays_densities.shape[:-1], dtype=rays_densities.dtype))
        return composite(rays_densities, *args, density_noise_std=density_noise_std, rng=rng, **kw)

    monkeypatch.setattr(jax_ray_sampler, "weighted_sample_without_replacement", record_pixels)
    monkeypatch.setattr(jax_rays, "jiggle_within_stratas", record_jiggle)
    monkeypatch.setattr(jax_renderer, "sample_pdf", record_pdf)
    monkeypatch.setattr(jax_renderer, "emission_absorption", record_composite)
    return draws


# --- the multipass renderer -----------------------------------------------


def _renderer_pair(seed=0, density_bias=2.0):
    """Two JAX NeRFMLPs with their params, and the port's on the same weights.

    The density head's bias is set to ``density_bias`` so that every ray has
    mass. On an empty ray (all weights ~1e-6, where ``1 - exp(-x)`` cancels)
    the refinement's pdf is the eps floor, and one ulp of ``exp`` between
    the two libraries moves its resampled depths by ~1e-3: float32 noise
    the inverse CDF amplifies, not a difference of the two renderers.
    """
    jax_fns, fns = [], []
    for k in range(2):
        jax_model = JAX_MODELS.build(dict(MODEL))
        params = jax_model.init(jax.random.PRNGKey(seed + k))
        params["density_layer"]["b"] = jnp.full_like(params["density_layer"]["b"], density_bias)
        model = MODELS.build(dict(MODEL))
        load_jax_params(model, jax.tree_util.tree_map(np.asarray, params))
        jax_fns.append((jax_model, params))
        fns.append(model)
    return jax_fns, fns


def _rays(seed=1, n_rays=6, n_pts=5):
    rng = np.random.RandomState(seed)
    origins = (rng.randn(2, n_rays, 1, 3) * 0.3).astype(np.float32)
    directions = rng.randn(2, n_rays, 1, 3).astype(np.float32)
    base = np.linspace(1.0, 3.0, n_pts, dtype=np.float32)
    lengths = np.sort(base + rng.uniform(-0.15, 0.15, (2, n_rays, 1, n_pts)), axis=-1).astype(np.float32)
    xys = rng.randint(0, HW, (2, n_rays, 1, 2)).astype(np.float32)
    return origins, directions, lengths, xys


def _stages(out):
    stages = []
    while out is not None:
        stages.append(out)
        out = out.prev_stage
    return stages


@pytest.mark.parametrize("mode", ["training", "evaluation"])
def test_multipass_renderer_matches_jax(mode, monkeypatch):
    """Coarse -> fine with density noise and jitter fed in (TRAINING) or deterministic (EVALUATION)."""
    jax_fns, fns = _renderer_pair()
    rays = _rays()
    jax_mode, port_mode = (
        (JaxEvaluationMode.TRAINING, EvaluationMode.TRAINING) if mode == "training"
        else (JaxEvaluationMode.EVALUATION, EvaluationMode.EVALUATION)
    )
    jax_lengths, port_lengths = [], []

    def jax_fn(k):
        def fn(o, d, l, **kw):
            jax_lengths.append(l)
            return jax_fns[k][0].apply(jax_fns[k][1], o, d, l, **kw)

        return fn

    def port_fn(k):
        def fn(o, d, l, **kw):
            port_lengths.append(l.detach().numpy())
            return fns[k](o, d, l, **kw)

        return fn

    jax_renderer_fn = jax_renderer.MultipassEmissionAbsorpsionRenderer(**{k: v for k, v in RENDERER.items() if k != "type"})
    with monkeypatch.context() as m:
        draws = _capture_draws(m)
        ref, jax_lengths = jax.jit(
            lambda rng, *r: (jax_renderer_fn(rng, *r, None, implicit_functions=[jax_fn(0), jax_fn(1)],
                                             evaluation_mode=jax_mode), jax_lengths)
        )(jax.random.PRNGKey(3), *map(jnp.asarray, rays))
        jax.effects_barrier()
    training = mode == "training"
    assert (len(draws["pdf_u"]), len(draws["density_noise"])) == ((1, 2) if training else (0, 0))
    renderer = RENDERERS.build(dict(RENDERER))
    with torch.no_grad():
        got = renderer(
            *map(torch.from_numpy, rays), None, implicit_functions=[port_fn(0), port_fn(1)],
            evaluation_mode=port_mode, pdf_u=draws["pdf_u"] or None, density_noise=draws["density_noise"] or None,
        )
    # the fine pass runs at 5 coarse + 6 (training) or 7 (evaluation) points, merged and sorted
    fine_pts = 5 + (6 if training else 7)
    assert [x.shape[-1] for x in port_lengths] == [5, fine_pts]
    assert np.all(np.diff(port_lengths[1], axis=-1) >= 0)
    np.testing.assert_allclose(port_lengths[1], np.asarray(jax_lengths[1]), rtol=1e-4, atol=1e-4)
    got_stages, ref_stages = _stages(got), _stages(ref)
    assert len(got_stages) == len(ref_stages) == 2
    for k, (g, r) in enumerate(zip(got_stages, ref_stages)):
        for name in ("features", "depths", "alpha_masks"):
            np.testing.assert_allclose(getattr(g, name).numpy(), np.asarray(getattr(r, name)), rtol=1e-4, atol=1e-4,
                                       err_msg=f"stage {k} {name}")
        np.testing.assert_allclose(g.aux["weights"].numpy(), np.asarray(r.aux["weights"]), rtol=1e-4, atol=1e-4)
    # eval_compositing_dtype is ported (tests/test_torch_switches.py holds its frames to JAX's)
    assert RENDERERS.build(dict(RENDERER, eval_compositing_dtype="bfloat16")).eval_compositing_dtype == torch.bfloat16
    if training:
        with pytest.raises(ValueError, match="generator"):
            renderer(*map(torch.from_numpy, rays), None, implicit_functions=fns, evaluation_mode=port_mode,
                     pdf_u=draws["pdf_u"])


# --- a whole EVALUATION frame ----------------------------------------------


@pytest.mark.parametrize("compute_dtype,tol", [("float32", 1e-4), ("bfloat16", 5e-3)])
def test_classic_eval_frame_matches_jax_pipeline(compute_dtype, tol):
    """Both NeRFMLPs on the fused kernel (K1's plain version here, Pallas in interpret mode there)."""
    cfg = _cfg(compute_dtype, use_pallas=True)
    jax_pipeline = JAX_PIPELINES.build(dict(cfg))
    params = jax_pipeline.init(jax.random.PRNGKey(0))
    batch = _batch()
    pose = batch["poses"][:, :3, :4]
    ref = jax_pipeline.forward(params, jax.random.PRNGKey(1), poses=jnp.asarray(pose),
                               focal_lengths=jnp.asarray([10.0]), image_rgb=jnp.asarray(batch["image_rgb"]),
                               evaluation_mode=JaxEvaluationMode.EVALUATION)
    pipeline = PIPELINES.build(dict(cfg), device="cpu")
    assert len(pipeline.implicit_functions) == 2
    load_jax_params(pipeline, jax.tree_util.tree_map(np.asarray, params))
    launches = (K1.launches, K1.pipelined_launches)
    with torch.no_grad():
        got = pipeline(poses=torch.from_numpy(pose), focal_lengths=torch.tensor([10.0]),
                       image_rgb=torch.from_numpy(batch["image_rgb"]), evaluation_mode=EvaluationMode.EVALUATION)
    assert (K1.launches, K1.pipelined_launches) == launches, "on the CPU the plain version runs, no launch"
    keys = ("rendered_images", "rendered_depths", "rendered_alpha_masks", "loss_rgb_mse", "loss_prev_stage_rgb_mse",
            "objective")
    assert set(keys) <= set(got) and set(keys) <= set(ref)
    for key in keys:
        assert tuple(got[key].shape) == tuple(ref[key].shape), key
        np.testing.assert_allclose(got[key].numpy(), np.asarray(ref[key]), rtol=tol, atol=tol, err_msg=key)
    assert float(got["rendered_images"].std()) > 0.0, "the frame is not blank"
    # the runner's stats: the prev_stage losses and PSNRs, as the JAX runner reports them
    stats, ref_stats = create_stats(got), jax_create_stats(ref)
    assert set(stats) == set(ref_stats) and "loss_prev_stage_rgb_psnr" in stats
    for key in ref_stats:
        assert stats[key] == pytest.approx(ref_stats[key], rel=tol, abs=tol), key


# --- one whole train step --------------------------------------------------


def _port_step(cfg, params, batch, draws):
    pipeline = PIPELINES.build(dict(cfg), device="cpu")
    load_jax_params(pipeline, jax.tree_util.tree_map(np.asarray, params))
    state = TrainState(pipeline=pipeline, optimizer=create_optimizer(RUNNER, pipeline), step=0)
    preds = make_train_step(pipeline, RUNNER, seed=0)(state, {k: torch.from_numpy(v) for k, v in batch.items()},
                                                      draws=draws)
    return pipeline, state, preds


def test_classic_train_step_matches_jax_make_train_step(monkeypatch):
    """Noise 0.2, pixels without replacement, loss_prev_stage_rgb_mse weighted; the eager NeRFMLPs."""
    cfg = _cfg()
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
    assert len(draws["pdf_u"]) == 1
    assert [tuple(n.shape) for n in draws["density_noise"]] == [(1, 12, 1, 5), (1, 12, 1, 11)]
    assert len(set(draws["pixel_idx"][0].tolist())) == 12, "without replacement"
    for i in range(2):
        largest = max(np.abs(v).max() for k, v in ref_grads.items() if k.startswith(f"implicit_functions.{i}."))
        assert largest > 10 * F32_GRAD_TOL["atol"], (i, largest)
    step = jax_apis.make_train_step(jax_pipeline, tx, donate=False)
    new_state, ref_preds = step(jax_optim.create_train_state(params, tx), jax_batch, rng)
    ref_params = flatten_tree(jax.tree_util.tree_map(np.asarray, new_state.params))
    init_params = flatten_tree(jax.tree_util.tree_map(np.asarray, params))

    pipeline, state, preds = _port_step(cfg, params, batch, draws)
    assert state.step == 1
    np.testing.assert_allclose(preds["objective"].numpy(), np.asarray(ref_preds["objective"]), rtol=1e-5, atol=1e-5)
    for key in ("loss_rgb_mse", "loss_prev_stage_rgb_mse"):
        np.testing.assert_allclose(preds[key].numpy(), np.asarray(ref_preds[key]), rtol=1e-5, atol=1e-6, err_msg=key)
    named = dict(pipeline.named_parameters())
    assert set(named) == set(ref_grads) and {k.split(".")[1] for k in named} == {"0", "1"}
    lr = float(state.optimizer.param_groups[0]["lr"])
    for key, p in named.items():
        np.testing.assert_allclose(p.grad.numpy(), ref_grads[key], err_msg=key, **F32_GRAD_TOL)
        # Adam's first update is lr * d / (|d| + eps): where |d| is within the
        # gradients' atol its sign is float32 noise (tests/test_torch_train.py)
        settled = np.abs(ref_grads[key] + RUNNER["weight_decay"] * init_params[key]) > F32_GRAD_TOL["atol"]
        new, ref = p.detach().numpy(), ref_params[key]
        np.testing.assert_allclose(new[settled], ref[settled], rtol=1e-5, atol=1e-5, err_msg=key)
        assert np.all(np.abs(new - ref) <= 2.0 * lr * (1 + 1e-5)), key


def test_classic_fused_train_step_matches_the_eager_step():
    """use_pallas_train on both NeRFMLPs (K1 / K3's plain versions through FusedNerfMlp) against the eager step."""
    cfg = _cfg()
    params = JAX_PIPELINES.build(dict(cfg)).init(jax.random.PRNGKey(2))
    batch = _batch(seed=1)
    gen = torch.Generator().manual_seed(4)
    draws = {
        "pixel_idx": torch.randperm(HW * HW, generator=gen)[None, :12],
        "strata_u": torch.rand(1, 12, 1, 5, generator=gen),
        "pdf_u": [torch.rand(1, 12, 1, 6, generator=gen)],
        "density_noise": [torch.randn(1, 12, 1, 5, generator=gen), torch.randn(1, 12, 1, 11, generator=gen)],
    }
    launches = (K1.launches, K3.launches)
    fused, _, fused_preds = _port_step(_cfg(use_pallas_train=True), params, batch, draws)
    assert (K1.launches, K3.launches) == launches, "CPU tensors take the plain versions"
    eager, _, eager_preds = _port_step(cfg, params, batch, draws)
    np.testing.assert_allclose(fused_preds["objective"].numpy(), eager_preds["objective"].numpy(),
                               rtol=1e-5, atol=1e-5)
    eager_params = dict(eager.named_parameters())
    for key, p in fused.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), eager_params[key].grad.numpy(), err_msg=key, **F32_GRAD_TOL)


# --- the CLI ----------------------------------------------------------------


def _write_drive(tmp_path):
    """A 16x16 procedural scene and a classic config that trains on it through the host DataLoader."""
    data = write_scene(tmp_path / "data", hw=16, n_train=4, n_val=2, n_test=2, n_spheres=3, seed=1)
    pipeline = _cfg("bfloat16", chunk_size_grid=256)
    pipeline["ray_sampler"] = dict(pipeline["ray_sampler"], image_height=16, image_width=16)
    cfg = dict(
        datasets=[dict(type="BlenderDataset", base_dir=str(data), split=s, test_skip=1)
                  for s in ("train", "val", "test")],
        runner=dict(eval_last_epoch_model=True, seed=0, output_dir=str(tmp_path / "results"), print_per_iter=2,
                    val_per_iter=4, save_per_iter=4, batch_size_list=[1, 1, 1], num_workers_list=[2, 0, 0],
                    **dict(RUNNER, num_iters=8)),
        pipeline=pipeline,
    )
    cfg_path = tmp_path / "classic.json"
    cfg_path.write_text(json.dumps(cfg))
    return data, cfg_path


def test_classic_run_trains_checkpoints_and_resumes_on_the_cpu(tmp_path):
    """lego.yml's runner path: the host DataLoader (no device cache), both NeRFMLPs in the checkpoints."""
    _, cfg_path = _write_drive(tmp_path)
    result = port_run.main(["--config", str(cfg_path), "--device", "cpu"])
    out = result["output_dir"]
    assert sorted(p.name for p in (out / "ckpts").iterdir()) == ["ckpts_-001", "ckpts_0000", "ckpts_0001"]
    train = [json.loads(line) for line in (out / "train_stats.json").read_text().splitlines()]
    assert len(train) == 2 and all(math.isfinite(r["train_objective"]) for r in train)
    assert "train_loss_prev_stage_rgb_psnr" in train[-1]
    test_stats = json.loads((out / "test_stats.json").read_text())
    assert {"test_loss_rgb_psnr", "test_loss_prev_stage_rgb_psnr"} <= set(test_stats)
    assert result["state"].step == 8

    # the checkpoint holds both NeRFMLPs, as a tree the JAX package's pipeline takes
    tree = checkpoint_params_tree(out / "ckpts" / "ckpts_0001")
    assert len(tree["implicit_functions"]) == 2
    ref = JAX_PIPELINES.build(JaxConfig.fromfile(str(out / "config.yml")).pipeline).init(jax.random.PRNGKey(0))
    assert jax.tree_util.tree_structure(ref) == jax.tree_util.tree_structure(tree)
    fresh = PIPELINES.build(Config.fromfile(str(out / "config.yml")).pipeline, device="cpu")
    fresh_state = TrainState(pipeline=fresh, optimizer=create_optimizer(RUNNER, fresh), step=0)
    load_checkpoint(out / "ckpts" / "ckpts_0001", fresh_state)
    for (k, p), q in zip(result["state"].pipeline.named_parameters(), fresh.parameters()):
        assert torch.equal(p.detach(), q.detach()), k

    resumed = port_run.main(["--config", str(cfg_path), "--device", "cpu",
                             "--checkpoint", str(out / "ckpts" / "ckpts_0000")])
    assert resumed["output_dir"].name == "version_1" and resumed["state"].step == 8


def test_chip_smoke_classic_phases_run_on_the_cpu(tmp_path, monkeypatch):
    """chip_smoke.py's serve, frame (K2 at the kernel entry), train and step phases on a tiny classic config."""
    import chip_smoke

    # CPU tensors take the plain versions, which count no launch: count the calls instead
    def counting_fwd(*args, pipelined=False, _entry=K1.nerf_mlp_fwd, **kwargs):
        if pipelined:
            K1.pipelined_launches += 1
        else:
            K1.launches += 1
        return _entry(*args, pipelined=pipelined, **kwargs)

    def counting_bwd(*args, _entry=K3.nerf_mlp_bwd, **kwargs):
        K3.launches += 1
        return _entry(*args, **kwargs)

    monkeypatch.setattr(K1, "nerf_mlp_fwd", counting_fwd)
    monkeypatch.setattr(K3, "nerf_mlp_bwd", counting_bwd)
    service = service_from_config(Config({"pipeline": _cfg("bfloat16", use_pallas=True),
                                          "serve": {"default_focal": 10.0}}), device="cpu")
    assert [fn.use_pallas for fn in service._pipeline.implicit_functions] == [True, True]
    chunks = 8  # 64 rays x 5 coarse points at chunk_size_grid 40
    launches = chip_smoke.serve(torch, K1, K3, service, "cpu", "classic", 2 * chunks)
    assert launches["nerf_mlp_fwd"] == 2 * 2 * chunks and launches["nerf_mlp_bwd"] == 0
    assert chip_smoke.frame(torch, K1, service, "cpu", "classic", with_k2=True) == {
        "nerf_mlp_fwd": 2 * chunks, "nerf_mlp_fwd_pipelined": 2 * chunks}

    data, cfg_path = _write_drive(tmp_path)
    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")
    assert chip_smoke.nerf_mlp_keys(cfg_path) == ["pipeline.model"]
    numbers, launches = chip_smoke.train(torch, K1, K3, data, tmp_path / "smoke", cfg_path, 4)
    assert all(numbers["checks"].values()), numbers["checks"]
    assert launches == {"nerf_mlp_fwd": 8, "nerf_mlp_fwd_pipelined": 0, "nerf_mlp_bwd": 8}
    step = chip_smoke.step_equivalence(torch, data, cfg_path)
    assert all(step["checks"].values()) and len(step["nerf_mlp_grad_cosine"]) == 2, step
