"""``configs/nerf/lego_tpu.yml`` (the classic pair at 16,384 rays with ``approx_top_k``) on yanerf_tpu_torch, on the CPU.

  * ``approx_top_k``: the port takes the exact top-k, which is what
    ``lax.approx_max_k(keys, k, recall_target=0.95)`` returns on the JAX
    CPU backend; from the same Gumbel draws the port's sampler gives the
    JAX indices, in the same order, and so does the ray sampler;
  * the config's pipeline builds at its published widths; at tiny widths
    (3 layers, 32 / 16 wide, 8x8 image, 12 rays, float32) one train step matches the
    JAX package's ``make_train_step`` with its draws fed in: objective
    1e-5, every gradient rtol 2e-4 / atol 2e-5 (tests/test_torch_classic.py);
  * the CLI on the config at tiny widths takes the fused dispatch
    (``runner.steps_per_call: 8`` on the uint8 device cache).
"""

import copy
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

from test_torch_classic import F32_GRAD_TOL, RUNNER, _batch, _capture_draws, _port_step
from yanerf_tpu.ops import sampling as jax_sampling
from yanerf_tpu.ops.structures import EvaluationMode as JaxEvaluationMode
from yanerf_tpu.pipelines import PIPELINES as JAX_PIPELINES
from yanerf_tpu.runners import apis as jax_apis
from yanerf_tpu.runners import optim as jax_optim
from yanerf_tpu_torch import run as port_run
from yanerf_tpu_torch.convert import flatten_tree
from yanerf_tpu_torch.ops.sampling import weighted_sample_without_replacement
from yanerf_tpu_torch.ops.structures import EvaluationMode
from yanerf_tpu_torch.pipelines import PIPELINES, RAY_SAMPLERS
from yanerf_tpu_torch.synth_scene import write_scene
from yanerf_tpu_torch.utils import Config

REPO = Path(__file__).resolve().parent.parent
LEGO_TPU = REPO / "configs" / "nerf" / "lego_tpu.yml"
TINY = {"n_layers": 3, "input_skips": [2], "n_harmonic_functions_xyz": 3, "n_harmonic_functions_dir": 2,
        "n_hidden_neurons_xyz": 32, "n_hidden_neurons_dir": 16}


def tiny_lego_tpu(hw=8, n_rays=12, compute_dtype="float32"):
    """lego_tpu.yml's pipeline at tiny widths, its sampler and renderer as they ship (approx_top_k on); float32,
    where the two packages' bf16 roundings would part by more than the tolerances."""
    cfg = copy.deepcopy(Config.fromfile(str(LEGO_TPU)).pipeline)
    cfg.model.update(TINY, compute_dtype=compute_dtype)
    cfg.ray_sampler.update(image_height=hw, image_width=hw, min_depth=1.0, max_depth=3.0, n_pts_per_ray_training=5,
                           n_pts_per_ray_evaluation=5, n_rays_per_image_sampled_from_mask=n_rays)
    cfg.renderer.update(n_pts_per_ray_fine_training=6, n_pts_per_ray_fine_evaluation=7)
    cfg.chunk_size_grid = 64
    return cfg.to_dict()


def test_approx_top_k_gives_the_jax_cpu_indices():
    rng = np.random.RandomState(0)
    weights = rng.rand(2, 4096).astype(np.float32)
    weights[1, ::5] = 0.0
    key = jax.random.PRNGKey(7)
    approx = np.asarray(jax_sampling.weighted_sample_without_replacement(key, jnp.asarray(weights), 100, approx=True))
    exact = np.asarray(jax_sampling.weighted_sample_without_replacement(key, jnp.asarray(weights), 100))
    np.testing.assert_array_equal(approx, exact)  # lax.approx_max_k on the CPU backend: lax.top_k's indices
    gumbel = torch.from_numpy(np.array(jax.random.gumbel(key, weights.shape, dtype=jnp.float32)))
    got = weighted_sample_without_replacement(torch.from_numpy(weights), 100, gumbel=gumbel, approx=True)
    np.testing.assert_array_equal(got.numpy(), approx)
    assert np.all(weights[1, got[1].numpy()] > 0.0)

    # the ray sampler of the config at 16 x 16 pixels (256 keys, 32 samples: the approximate branch's size)
    sampler_cfg = dict(tiny_lego_tpu(hw=16, n_rays=32)["ray_sampler"])
    assert sampler_cfg["approx_top_k"] is True
    sampler = RAY_SAMPLERS.build(sampler_cfg)
    poses, focal = torch.from_numpy(_batch()["poses"]), torch.tensor([[10.0]])
    bundle = sampler(poses, focal, EvaluationMode.TRAINING, generator=torch.Generator().manual_seed(3))
    exact = RAY_SAMPLERS.build(dict(sampler_cfg, approx_top_k=False))(
        poses, focal, EvaluationMode.TRAINING, generator=torch.Generator().manual_seed(3))
    assert torch.equal(bundle.xys, exact.xys) and len({tuple(xy) for xy in bundle.xys[0, :, 0].tolist()}) == 32


def test_lego_tpu_pipeline_builds_and_a_tiny_train_step_matches_jax(monkeypatch):
    full = Config.fromfile(str(LEGO_TPU))
    pipeline = PIPELINES.build(full.pipeline, device="cpu")
    assert len(pipeline.implicit_functions) == 2 and pipeline.chunk_size_grid == 1048576
    sampler = pipeline.ray_sampler.sampler(EvaluationMode.TRAINING)
    assert sampler.approx_top_k and sampler.n_rays_per_image == 16384 and not sampler.pixel_replacement
    assert [d.kind for d in pipeline.training_draws(1)][0] == "pixels_without_replacement"
    assert pipeline.training_draws(1)[0].approx
    del pipeline

    cfg = tiny_lego_tpu()
    batch = _batch(seed=2)
    jax_pipeline = JAX_PIPELINES.build(copy.deepcopy(cfg))
    params = jax_pipeline.init(jax.random.PRNGKey(3))
    tx = jax_optim.create_optimizer(RUNNER, params)
    rng = jax.random.PRNGKey(12)
    jax_batch = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss_fn(p):
        preds = jax_pipeline.forward(p, jax.random.fold_in(rng, 0), evaluation_mode=JaxEvaluationMode.TRAINING,
                                     output_rasterized_mc=False, **jax_batch)
        return jnp.mean(preds["objective"])

    with monkeypatch.context() as m:
        draws = _capture_draws(m)
        ref_grads = flatten_tree(jax.tree_util.tree_map(np.asarray, jax.jit(jax.grad(loss_fn))(params)))
        jax.effects_barrier()
    assert len(set(draws["pixel_idx"][0].tolist())) == 12
    _, ref_preds = jax_apis.make_train_step(jax_pipeline, tx, donate=False)(
        jax_optim.create_train_state(params, tx), jax_batch, rng)

    pipeline, state, preds = _port_step(cfg, params, batch, draws)
    assert state.step == 1
    np.testing.assert_allclose(preds["objective"].numpy(), np.asarray(ref_preds["objective"]), rtol=1e-5, atol=1e-5)
    named = dict(pipeline.named_parameters())
    assert set(named) == set(ref_grads)
    for key, p in named.items():
        np.testing.assert_allclose(p.grad.numpy(), ref_grads[key], err_msg=key, **F32_GRAD_TOL)


def test_lego_tpu_cli_takes_the_fused_dispatch(tmp_path):
    scene = write_scene(tmp_path / "scene", hw=16, n_train=8, n_val=1, n_test=1, n_spheres=3, seed=1)
    options = [f"pipeline.model.{k}={v}" for k, v in TINY.items() if k != "input_skips"]
    options += ["pipeline.model.input_skips=[2]", "pipeline.ray_sampler.image_height=16",
                "pipeline.ray_sampler.image_width=16", "pipeline.ray_sampler.n_rays_per_image_sampled_from_mask=32",
                "pipeline.ray_sampler.n_pts_per_ray_training=5", "pipeline.ray_sampler.n_pts_per_ray_evaluation=5",
                "pipeline.renderer.n_pts_per_ray_fine_training=6", "pipeline.renderer.n_pts_per_ray_fine_evaluation=6",
                "pipeline.model.use_pallas_train=True", "runner.num_iters=16", "runner.val_per_iter=16",
                "runner.save_per_iter=8", "runner.num_workers_list=[0,0,0]", "runner.train_vis=False",
                f"runner.output_dir={tmp_path / 'results'}", *(f"datasets.{i}.base_dir={scene}" for i in range(3))]
    result = port_run.main(["--config", str(LEGO_TPU), "--device", "cpu", "--cfg_options", *options])
    trainer = result["train_step_fused"]
    assert trainer is not None and trainer.dispatches == 2 and trainer.steps == 16 == result["state"].step
    assert sorted(trainer.seen_group_sizes) == [8]
    assert all(np.isfinite(s["objective"]) for s in result["train_stats"])
