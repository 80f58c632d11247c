"""Shared body of the config pin tests (``tests/test_torch_pin_configs_*.py``).

Every ``configs/nerf/*.yml`` is built in both packages at tiny widths (2
layers, 32 wide, float32, 8 points per pass), on an 8x8 image, with the
JAX params carried across by ``convert.py`` (+2 on every density bias, so
that every ray carries mass: on an empty ray the two packages'
refinements part by ~1e-3, and NDC chunks are ill-conditioned at the
init's densities). Then:
  * one EVALUATION frame of one pose, in chunks: images, depths and
    alpha masks at 1e-4;
  * one TRAINING call of 4 rays with the JAX draws fed in: the objective
    at 1e-5 and every gradient at rtol 2e-4 / atol 2e-5.
The latent config is fed a ``scene_id``.
"""

from __future__ import annotations

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

import yanerf_tpu.ops.rays as jax_rays
import yanerf_tpu.pipelines.ray_sampler as jax_ray_sampler
import yanerf_tpu.pipelines.renderer as jax_renderer
from yanerf_tpu.ops.structures import EvaluationMode as JaxEvaluationMode
from yanerf_tpu.pipelines import PIPELINES as JAX_PIPELINES
from yanerf_tpu_torch.convert import flatten_tree, load_jax_params
from yanerf_tpu_torch.ops.structures import EvaluationMode
from yanerf_tpu_torch.pipelines import PIPELINES
from yanerf_tpu_torch.serve import CAM_CALIBRATION, orbit_pose
from yanerf_tpu_torch.utils import Config

REPO = Path(__file__).resolve().parent.parent
CONFIGS = sorted(p.name for p in (REPO / "configs" / "nerf").glob("*.yml"))
HW = 8
N_RAYS = 4
FRAME_TOL = dict(rtol=1e-4, atol=1e-4)
OBJECTIVE_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=2e-4, atol=2e-5)
DENSITY_BIAS = 2.0


def tiny_pipeline_config(name: str) -> dict:
    """The config's pipeline at tiny widths, float32, on an 8x8 image."""
    pipeline = Config.fromfile(str(REPO / "configs" / "nerf" / name)).pipeline.to_dict()
    models = pipeline["model"] if isinstance(pipeline["model"], list) else [pipeline["model"]]
    for model in models:
        model["compute_dtype"] = "float32"
        if model["type"] in ("NeRFMLP", "MipNeRFMLP"):
            model.update(n_layers=2, input_skips=[1], n_hidden_neurons_xyz=32, n_hidden_neurons_dir=16,
                         n_harmonic_functions_xyz=3, n_harmonic_functions_dir=2)
        elif model["type"] == "ProposalMLP":
            model.update(n_layers=2, hidden_dim=32)
        elif model["type"] == "HashGridNeRF":
            model.update(n_levels=4, table_size_log2=8, hidden_dim=32, max_resolution=64)
    sampler = pipeline["ray_sampler"]
    sampler.update(image_height=HW, image_width=HW, n_rays_per_image_sampled_from_mask=N_RAYS,
                   n_pts_per_ray_training=8, n_pts_per_ray_evaluation=8)
    renderer = pipeline["renderer"]
    for key in list(renderer):
        if key.startswith("n_pts_per_ray_intermediate"):
            renderer[key] = [8]
        elif key.startswith("n_pts_per_ray_"):
            renderer[key] = 6
    pipeline["chunk_size_grid"] = 160  # 64 rays of 8 points: 4 chunks, the last edge-padded
    return pipeline


def with_mass(params, bias: float = DENSITY_BIAS):
    """The JAX params with ``bias`` added to every density bias: every ray carries mass."""
    def add(path, leaf):
        key = jax.tree_util.keystr(path)
        return leaf + bias if "density" in key and key.endswith("['b']") else leaf
    return jax.tree_util.tree_map_with_path(add, params)


def _pair(name: str):
    cfg = tiny_pipeline_config(name)
    jax_pipeline = JAX_PIPELINES.build(dict(cfg))
    params = with_mass(jax_pipeline.init(jax.random.PRNGKey(0)))
    pipeline = PIPELINES.build(dict(cfg), device="cpu")
    load_jax_params(pipeline, jax.tree_util.tree_map(np.asarray, params))
    return jax_pipeline, params, pipeline


def _inputs(name: str):
    pose = (orbit_pose(30.0, -30.0, 4.0) @ CAM_CALIBRATION).astype(np.float32)[None]
    batch = dict(poses=pose, focal_lengths=np.asarray([[10.0]], np.float32),
                 image_rgb=np.random.RandomState(0).rand(1, HW, HW, 3).astype(np.float32))
    extra = {"scene_id": np.asarray([1], np.int32)} if "latent" in name else {}
    return batch, extra


def check_eval_frame(name: str) -> None:
    jax_pipeline, params, pipeline = _pair(name)
    batch, extra = _inputs(name)
    ref = jax_pipeline.forward(params, jax.random.PRNGKey(1), evaluation_mode=JaxEvaluationMode.EVALUATION,
                               **{k: jnp.asarray(v) for k, v in {**batch, **extra}.items()})
    with torch.no_grad():
        got = pipeline(evaluation_mode=EvaluationMode.EVALUATION,
                       **{k: torch.from_numpy(v) for k, v in {**batch, **extra}.items()})
    for key in ("rendered_images", "rendered_depths", "rendered_alpha_masks"):
        assert tuple(got[key].shape) == tuple(ref[key].shape), key
        np.testing.assert_allclose(got[key].numpy(), np.asarray(ref[key]), err_msg=key, **FRAME_TOL)
    assert float(got["rendered_alpha_masks"].min()) > 0.0, "every ray carries mass"


def _capture_draws(monkeypatch) -> dict:
    """The JAX draws, in the port's ``draws`` layout (as tests/test_torch_classic.py records them)."""
    draws = {"pdf_u": [], "density_noise": []}
    without, with_repl = jax_ray_sampler.weighted_sample_without_replacement, \
        jax_ray_sampler.uniform_sample_with_replacement
    jiggle, pdf, composite = jax_rays.jiggle_within_stratas, jax_renderer.sample_pdf, jax_renderer.emission_absorption

    def keep(name, value, dtype=None):
        listed = name in ("pdf_u", "density_noise")
        if listed:
            draws[name].append(None)

        def store(v, slot=len(draws[name]) - 1 if listed else None):
            t = torch.from_numpy(np.array(v, dtype=dtype))
            if slot is None:
                draws[name] = t
            else:
                draws[name][slot] = t
        jax.debug.callback(store, value)

    def record_without(rng, weights, num_samples, approx=False):
        out = without(rng, weights, num_samples, approx=approx)
        keep("pixel_idx", out, np.int64)
        return out

    def record_with(rng, batch_size, n, num_samples):
        out = with_repl(rng, batch_size, n, num_samples)
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

    monkeypatch.setattr(jax_ray_sampler, "weighted_sample_without_replacement", record_without)
    monkeypatch.setattr(jax_ray_sampler, "uniform_sample_with_replacement", record_with)
    monkeypatch.setattr(jax_rays, "jiggle_within_stratas", record_jiggle)
    monkeypatch.setattr(jax_renderer, "sample_pdf", record_pdf)
    monkeypatch.setattr(jax_renderer, "emission_absorption", record_composite)
    return draws


def check_train_step(name: str, monkeypatch) -> None:
    jax_pipeline, params, pipeline = _pair(name)
    batch, extra = _inputs(name)
    jax_inputs = {k: jnp.asarray(v) for k, v in {**batch, **extra}.items()}

    def loss_fn(p):
        preds = jax_pipeline.forward(p, jax.random.PRNGKey(11), evaluation_mode=JaxEvaluationMode.TRAINING,
                                     output_rasterized_mc=False, **jax_inputs)
        return jnp.mean(preds["objective"]), preds["objective"]

    with monkeypatch.context() as m:
        draws = _capture_draws(m)
        (_, ref_objective), ref_grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
        jax.effects_barrier()
    ref_grads = flatten_tree(jax.tree_util.tree_map(np.asarray, ref_grads))
    draws = {k: v for k, v in draws.items() if not (isinstance(v, list) and not v)}
    preds = pipeline(evaluation_mode=EvaluationMode.TRAINING, output_rasterized_mc=False, draws=draws,
                     **{k: torch.from_numpy(v) for k, v in {**batch, **extra}.items()})
    np.testing.assert_allclose(preds["objective"].detach().numpy(), np.asarray(ref_objective), **OBJECTIVE_TOL)
    torch.mean(preds["objective"]).backward()
    named = dict(pipeline.named_parameters())
    assert set(named) == set(ref_grads)
    assert max(float(np.abs(g).max()) for g in ref_grads.values()) > 10 * GRAD_TOL["atol"], "a gradient to check"
    for key, p in named.items():
        np.testing.assert_allclose(p.grad.numpy(), ref_grads[key], err_msg=key, **GRAD_TOL)
