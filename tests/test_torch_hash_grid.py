"""The hash-grid family (configs/nerf/lego_ngp.yml) of yanerf_tpu_torch against yanerf_tpu, on the CPU.

  * the level resolutions and table sizes equal the JAX package's, for the
    shipped config (16 levels, 2^19 rows, 16 -> 2048) and a small one;
  * the corner rows of every level equal JAX's exactly, dense and hashed
    levels, on seeded points away from cell faces (and outside the bound,
    where both clip exactly); near a face ``x01 = (p + b) / (2b)`` may
    round into the neighbouring cell on one side only, and the
    interpolation is continuous there, so ``encode`` is compared on every
    point at atol 1e-6 (f32);
  * ``table_lookup``'s table gradient against the JAX custom VJP with heavy
    collisions (300 indices into 64 rows) at rtol 1e-5 / atol 1e-6;
  * the model's forward against ``apply`` at the ``TOLS`` of
    tests/test_torch_models.py (f32 1e-5, bf16 one bf16 ulp);
  * one train step of lego_ngp.yml's structure (4 levels, 2^10 rows, so
    dense and hashed levels) against ``make_train_step``: objective 1e-5,
    every gradient rtol 2e-4 / atol 2e-5, the tables included;
  * the weight bridge both ways, serving from a JAX ``.npz``, and the CLI
    on a 16x16 scene for both new families (train, checkpoint, resume,
    serve the run's checkpoint); ``ZeroOutputer``'s analytic frame.
"""

import json
import threading
import urllib.request
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import yanerf_tpu.models.hash_grid as jax_hash_grid
from test_torch_classic import F32_GRAD_TOL, HW, RENDERER, RUNNER, _batch, _capture_draws
from test_torch_mip import mip_cfg
from test_torch_models import TOLS
from yanerf_tpu.models import MODELS as JAX_MODELS
from yanerf_tpu.ops.structures import EvaluationMode as JaxEvaluationMode
from yanerf_tpu.pipelines import PIPELINES as JAX_PIPELINES
from yanerf_tpu.runners import apis as jax_apis
from yanerf_tpu.runners import optim as jax_optim
from yanerf_tpu.utils import Config as JaxConfig
from yanerf_tpu_torch import run as port_run
from yanerf_tpu_torch.convert import export_jax_params, flatten_tree, load_jax_params
from yanerf_tpu_torch.models import MODELS, HashGridNeRF, ZeroOutputer
from yanerf_tpu_torch.models import hash_grid
from yanerf_tpu_torch.ops.structures import EvaluationMode
from yanerf_tpu_torch.pipelines import PIPELINES
from yanerf_tpu_torch.runners import TrainState, create_optimizer, load_checkpoint, make_train_step
from yanerf_tpu_torch.serve import CAM_CALIBRATION, create_server, orbit_pose, service_from_config
from yanerf_tpu_torch.synth_scene import write_scene
from yanerf_tpu_torch.utils import Config

SMALL = dict(type="HashGridNeRF", n_levels=4, table_size_log2=10, n_features_per_level=2, base_resolution=4,
             max_resolution=32, hidden_dim=16, geo_feature_dim=7, n_color_layers=2, n_harmonic_functions_dir=2,
             scene_bound=1.5)
SHIPPED = dict(type="HashGridNeRF", n_levels=16, table_size_log2=19, n_features_per_level=2, base_resolution=16,
               max_resolution=2048, hidden_dim=64, geo_feature_dim=15, n_color_layers=2, n_harmonic_functions_dir=4,
               color_dim=3, scene_bound=1.5)


def _pair(cfg, compute_dtype="float32", seed=0):
    cfg = dict(cfg, compute_dtype=compute_dtype)
    jax_model = JAX_MODELS.build(dict(cfg))
    params = jax_model.init(jax.random.PRNGKey(seed))
    return jax_model, params, load_jax_params(MODELS.build(dict(cfg)), jax.tree_util.tree_map(np.asarray, params))


def _points(seed, n, bound=1.5):
    """``n`` points, a fifth of them outside the scene's box in some coordinate."""
    rng = np.random.RandomState(seed)
    pts = rng.uniform(-bound, bound, (n, 3))
    out = rng.rand(n) < 0.2
    pts[out, rng.randint(0, 3, out.sum())] = rng.choice([-1.0, 1.0], out.sum()) * bound * rng.uniform(1.01, 2.0,
                                                                                                     out.sum())
    return pts.astype(np.float32)


# --- the grid --------------------------------------------------------------------


@pytest.mark.parametrize("cfg", [SHIPPED, SMALL, dict(SMALL, n_levels=1)], ids=["shipped", "small", "one_level"])
def test_resolutions_and_table_sizes_match_jax(cfg):
    ref = JAX_MODELS.build(dict(cfg))
    model = MODELS.build(dict(cfg))
    assert model.resolutions == ref.resolutions and model.level_table_sizes == ref.level_table_sizes
    assert [tuple(t.shape) for t in model.tables] == [(n, 2) for n in ref.level_table_sizes]
    if cfg is SHIPPED:
        assert model.resolutions[0] == 16 and model.resolutions[-1] == 2048
        dense = [model._is_dense(level) for level in range(16)]
        assert dense[0] and not dense[-1] and model.level_table_sizes[-1] == 1 << 19


@pytest.mark.parametrize("cfg", [SHIPPED, SMALL], ids=["shipped", "small"])
def test_corner_rows_equal_jax_exactly(cfg, monkeypatch):
    """The rows each level gathers, recorded at both packages' ``table_lookup``, on points away from cell faces."""
    jax_model, params, model = _pair(cfg)
    pts = _points(1, 4000)
    # keep the points whose every inside coordinate sits at least 1e-3 of a cell from a face, at every level
    x01 = np.clip((pts.astype(np.float64) + 1.5) / 3.0, 0.0, 1.0)
    inside = (x01 > 0.0) & (x01 < 1.0)
    keep = np.ones(len(pts), bool)
    for res in model.resolutions:
        frac = x01 * res - np.floor(x01 * res)
        keep &= np.all(~inside | ((frac > 1e-3) & (frac < 1 - 1e-3)), axis=-1)
    pts = pts[keep]
    assert len(pts) > 500 and (~inside[keep]).any(), "points outside the box are kept"

    recorded = {"jax": [], "port": []}
    jax_lookup, port_lookup = jax_hash_grid.table_lookup, hash_grid.table_lookup
    monkeypatch.setattr(jax_hash_grid, "table_lookup",
                        lambda t, i: (recorded["jax"].append(np.asarray(i)), jax_lookup(t, i))[1])
    monkeypatch.setattr(hash_grid, "table_lookup",
                        lambda t, i: (recorded["port"].append(i.numpy()), port_lookup(t, i))[1])
    jax_model.encode(params["tables"], jnp.asarray(pts))
    with torch.no_grad():
        model.encode(list(model.tables), torch.from_numpy(pts))
    assert len(recorded["port"]) == len(recorded["jax"]) == model.n_levels
    kinds = set()
    for level, (got, ref) in enumerate(zip(recorded["port"], recorded["jax"])):
        kinds.add(model._is_dense(level))
        assert got.dtype == np.int64 and got.min() >= 0 and got.max() < model.level_table_sizes[level]
        np.testing.assert_array_equal(got, ref.astype(np.int64), err_msg=f"level {level}")
    assert kinds == {True, False}, "dense and hashed levels"


@pytest.mark.parametrize("cfg", [SHIPPED, SMALL], ids=["shipped", "small"])
def test_encode_matches_jax(cfg):
    jax_model, params, model = _pair(cfg, seed=2)
    with torch.no_grad():
        for t in model.tables:  # features of order 1, so the tolerance is not looser than the values
            t.mul_(1e4)
    tables = [jnp.asarray(t.detach().numpy()) for t in model.tables]
    pts = _points(3, 3000)
    # a grid of points on the cell faces of the coarsest level, where x01 may round either way
    face = (np.stack(np.meshgrid(*[np.arange(1, 4)] * 3, indexing="ij"), -1).reshape(-1, 3) / 4.0 * 3.0 - 1.5)
    pts = np.concatenate([pts, face.astype(np.float32)])
    ref = jax_model.encode(tables, jnp.asarray(pts))
    with torch.no_grad():
        got = model.encode(list(model.tables), torch.from_numpy(pts))
    assert tuple(got.shape) == (len(pts), model.encoding_dim)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0.0, atol=1e-6)


def test_table_lookup_gradient_with_collisions_matches_the_jax_custom_vjp():
    key = jax.random.PRNGKey(7)
    table = jax.random.normal(key, (64, 2))
    idx = jax.random.randint(jax.random.fold_in(key, 1), (300,), 0, 64)
    ct = jax.random.normal(jax.random.fold_in(key, 2), (300, 2))
    ref = jax.grad(lambda t: jnp.sum(jax_hash_grid.table_lookup(t, idx) * ct))(table)
    t = torch.from_numpy(np.array(table)).requires_grad_(True)
    rows = hash_grid.table_lookup(t, torch.from_numpy(np.asarray(idx).astype(np.int64)))
    np.testing.assert_array_equal(rows.detach().numpy(), np.asarray(table)[np.asarray(idx)])
    torch.sum(rows * torch.from_numpy(np.array(ct))).backward()
    assert len(np.unique(np.asarray(idx))) <= 64 < 300, "rows collide"
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)


# --- the model ---------------------------------------------------------------------


def _inputs(seed=0, n_rays=5, n_pts=6):
    rng = np.random.RandomState(seed)
    origins = (rng.randn(2, n_rays, 1, 3) * 0.5).astype(np.float32)
    directions = rng.randn(2, n_rays, 1, 3).astype(np.float32)
    lengths = np.sort(rng.uniform(0.1, 2.5, (2, n_rays, 1, n_pts)), axis=-1).astype(np.float32)
    return origins, directions, lengths


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("input_dir", [True, False])
def test_hash_grid_nerf_matches_apply(compute_dtype, input_dir):
    jax_model, params, model = _pair(dict(SMALL, input_dir=input_dir), compute_dtype, seed=3)
    o, d, l = _inputs()
    ref = jax_model.apply(params, *map(jnp.asarray, (o, d, l)))
    with torch.no_grad():
        got = model(*map(torch.from_numpy, (o, d, l)), use_pallas=False)
    for key in ("rays_densities", "rays_features"):
        assert got[key].shape == ref[key].shape and got[key].dtype == torch.float32
        np.testing.assert_allclose(got[key].numpy(), np.asarray(ref[key]), **TOLS[compute_dtype], err_msg=key)


def test_hash_grid_parameters_init_and_refusals():
    model = MODELS.build(dict(SHIPPED, generator=torch.Generator().manual_seed(0)))
    names = [k for k, _ in model.named_parameters()]
    assert names[:2] == ["tables.0", "tables.1"] and "density_mlp.0.w" in names and names[-1] == "color_mlp.2.b"
    assert set(flatten_tree(JAX_MODELS.build(dict(SHIPPED)).init(jax.random.PRNGKey(0)))) == set(names)
    tables = torch.cat([t.detach().flatten() for t in model.tables])
    assert float(tables.abs().max()) <= 1e-4 and float(tables.abs().max()) > 0.99e-4
    w = model.density_mlp[0].w.detach()
    assert float(w.abs().max()) <= 1.0 / np.sqrt(32)  # torch default U(1/sqrt(fan_in))
    again = MODELS.build(dict(SHIPPED, generator=torch.Generator().manual_seed(0)))
    assert all(torch.equal(a, b) for a, b in zip(model.parameters(), again.parameters()))
    with pytest.raises(NotImplementedError, match="unbounded scenes"):
        MODELS.build(dict(SMALL, contract_coords=True, scene_bound=2.0))
    o, d, l = map(torch.from_numpy, _inputs())
    with pytest.raises(ValueError, match="no fused kernel"):
        model(o, d, l, use_pallas=True)
    with pytest.raises(ValueError, match="latent"):
        model(o, d, l, global_codes=torch.zeros(2, 4))
    # encode_chunk changes nothing
    small = MODELS.build(dict(SMALL, generator=torch.Generator().manual_seed(1)))
    chunked = MODELS.build(dict(SMALL, encode_chunk=7, generator=torch.Generator().manual_seed(1)))
    with torch.no_grad():
        assert torch.equal(small(o, d, l)["rays_features"], chunked(o, d, l)["rays_features"])


def test_bridge_round_trips_both_new_families_exactly():
    for cfg in (SMALL, dict(mip_cfg()["model"])):
        params = jax.tree_util.tree_map(np.asarray, JAX_MODELS.build(dict(cfg)).init(jax.random.PRNGKey(4)))
        back = export_jax_params(load_jax_params(MODELS.build(dict(cfg)), params))
        assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(params)
        for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(params)):
            np.testing.assert_array_equal(a, b)


# --- one train step ----------------------------------------------------------------


def ngp_cfg(compute_dtype="float32", hw=HW, chunk_size_grid=40):
    """lego_ngp.yml's structure: one HashGridNeRF config for both passes of the multipass renderer, no density
    noise, pixels without replacement; 4 levels of 2^10 rows (two dense, two hashed)."""
    return dict(
        type="NeRFPipeline", chunk_size_grid=chunk_size_grid, num_passes=2, output_rasterized_mc=True,
        loss_weights={"loss_prev_stage_rgb_mse": 1.0, "loss_rgb_mse": 1.0},
        model=dict(SMALL, compute_dtype=compute_dtype),
        ray_sampler=dict(type="RaySampler", image_height=hw, image_width=hw, min_depth=1.0, max_depth=3.0,
                         n_pts_per_ray_training=5, n_pts_per_ray_evaluation=5, n_rays_per_image_sampled_from_mask=12),
        renderer=dict(RENDERER, density_noise_std_train=0.0),
        feature_extractor=[],
    )


def test_ngp_train_step_matches_jax_make_train_step(monkeypatch):
    cfg = ngp_cfg()
    batch = _batch(seed=1)
    jax_pipeline = JAX_PIPELINES.build(dict(cfg))
    params = jax_pipeline.init(jax.random.PRNGKey(2))
    # every ray carries mass (ROADMAP.md Queue 3, "Noted, not faults"); features of order 1, and a first layer
    # that lifts every table's gradient well above the gradients' atol
    for fn in params["implicit_functions"]:
        fn["density_mlp"][1]["b"] = fn["density_mlp"][1]["b"].at[0].add(1.0)
        fn["tables"] = [t * 1e4 for t in fn["tables"]]
        fn["density_mlp"][0]["w"] = fn["density_mlp"][0]["w"] * 30.0
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
    assert len(draws["pdf_u"]) == 1 and not draws["density_noise"]
    _, ref_preds = jax_apis.make_train_step(jax_pipeline, tx, donate=False)(
        jax_optim.create_train_state(params, tx), jax_batch, rng)

    pipeline = PIPELINES.build(dict(cfg), device="cpu")
    assert all(isinstance(fn, HashGridNeRF) for fn in pipeline.implicit_functions)
    load_jax_params(pipeline, jax.tree_util.tree_map(np.asarray, params))
    state = TrainState(pipeline=pipeline, optimizer=create_optimizer(RUNNER, pipeline), step=0)
    preds = make_train_step(pipeline, RUNNER, seed=0)(state, {k: torch.from_numpy(v) for k, v in batch.items()},
                                                      draws={k: v for k, v in draws.items() if v != []})
    np.testing.assert_allclose(preds["objective"].numpy(), np.asarray(ref_preds["objective"]), rtol=1e-5, atol=1e-5)
    named = dict(pipeline.named_parameters())
    assert set(named) == set(ref_grads)
    for i in range(2):
        for level in range(4):
            key = f"implicit_functions.{i}.tables.{level}"
            assert np.abs(ref_grads[key]).max() > 10 * F32_GRAD_TOL["atol"], key
    for key, p in named.items():
        np.testing.assert_allclose(p.grad.numpy(), ref_grads[key], err_msg=key, **F32_GRAD_TOL)


# --- serving and the CLI -----------------------------------------------------------


FAMILIES = {"mip": mip_cfg, "ngp": ngp_cfg}


@pytest.mark.parametrize("family", ["mip", "ngp"])
def test_serve_answers_from_a_jax_npz(family, tmp_path):
    """The frame from a JAX param tree saved as ``.npz`` is JAX's EVALUATION frame (f32, 1e-4), over HTTP too."""
    cfg = FAMILIES[family](hw=8, chunk_size_grid=40)
    jax_pipeline = JAX_PIPELINES.build(dict(cfg))
    params = jax_pipeline.init(jax.random.PRNGKey(6))
    npz = tmp_path / "params.npz"
    np.savez(npz, **flatten_tree(jax.tree_util.tree_map(np.asarray, params)))
    service = service_from_config(Config({"pipeline": cfg, "serve": {"default_focal": 10.0}}), checkpoint=str(npz),
                                  device="cpu")
    pose = (orbit_pose(30.0, -30.0, 2.0) @ CAM_CALIBRATION)[:3, :4].astype(np.float32)
    rgb, depth = service.render(pose, 10.0)
    ref = jax_pipeline.forward(params, jax.random.PRNGKey(0), poses=jnp.asarray(pose)[None],
                               focal_lengths=jnp.asarray([10.0]), evaluation_mode=JaxEvaluationMode.EVALUATION)
    np.testing.assert_allclose(rgb, np.asarray(ref["rendered_images"][0]), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(depth, np.asarray(ref["rendered_depths"][0, ..., 0]), rtol=1e-4, atol=1e-4)
    server = create_server(service, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        url = f"http://127.0.0.1:{server.server_address[1]}/render?theta=30&phi=-30&radius=2&format=json"
        with urllib.request.urlopen(url, timeout=120) as resp:
            grid = json.loads(resp.read())
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    assert grid["shape"] == [8, 8, 3] and np.isfinite(grid["data"]).all()


def _write_drive(tmp_path, family):
    """A 16x16 procedural scene and a config of ``family`` at a tiny width that trains on it as the shipped config
    does: mip fused (device cache, steps_per_call 3), ngp per step on the uint8 device cache."""
    data = write_scene(tmp_path / "data", hw=16, n_train=4, n_val=2, n_test=2, n_spheres=3, seed=1)
    pipeline = FAMILIES[family]("bfloat16", hw=16, chunk_size_grid=256)
    runner = dict(RUNNER, num_iters=8, cache_dataset_on_device=True)
    if family == "mip":
        runner["steps_per_call"] = 3
    else:
        runner["cache_quantize_images"] = True
    cfg = dict(
        datasets=[dict(type="BlenderDataset", base_dir=str(data), split=s, test_skip=1)
                  for s in ("train", "val", "test")],
        runner=dict(eval_last_epoch_model=True, seed=0, output_dir=str(tmp_path / "results"), print_per_iter=2,
                    val_per_iter=4, save_per_iter=4, batch_size_list=[1, 1, 1], num_workers_list=[0, 0, 0], **runner),
        pipeline=pipeline,
    )
    cfg_path = tmp_path / f"{family}.json"
    cfg_path.write_text(json.dumps(cfg))
    return cfg_path


@pytest.mark.parametrize("family", ["mip", "ngp"])
def test_run_trains_checkpoints_resumes_and_serves_each_new_family_on_the_cpu(family, tmp_path):
    cfg_path = _write_drive(tmp_path, family)
    result = port_run.main(["--config", str(cfg_path), "--device", "cpu"])
    out = result["output_dir"]
    assert sorted(p.name for p in (out / "ckpts").iterdir()) == ["ckpts_-001", "ckpts_0000", "ckpts_0001"]
    train = [json.loads(line) for line in (out / "train_stats.json").read_text().splitlines()]
    assert len(train) == 2 and all(np.isfinite(r["train_objective"]) for r in train)
    assert np.isfinite(json.loads((out / "test_stats.json").read_text())["test_loss_rgb_psnr"])
    assert result["state"].step == 8
    fused = result["train_step_fused"]
    assert (fused is not None and fused.steps > 0) == (family == "mip"), "mip on the fused dispatch, ngp per step"

    # the checkpoint is a tree the JAX package's pipeline takes, and reloads into a fresh pipeline
    fresh = PIPELINES.build(Config.fromfile(str(out / "config.yml")).pipeline, device="cpu")
    ref = JAX_PIPELINES.build(JaxConfig.fromfile(str(out / "config.yml")).pipeline).init(jax.random.PRNGKey(0))
    assert set(flatten_tree(ref)) == {k for k, _ in fresh.named_parameters()}
    fresh_state = TrainState(pipeline=fresh, optimizer=create_optimizer(RUNNER, fresh), step=0)
    load_checkpoint(out / "ckpts" / "ckpts_0001", fresh_state)
    for (k, p), q in zip(result["state"].pipeline.named_parameters(), fresh.parameters()):
        assert torch.equal(p.detach(), q.detach()), k

    resumed = port_run.main(["--config", str(cfg_path), "--device", "cpu",
                             "--checkpoint", str(out / "ckpts" / "ckpts_0000")])
    assert resumed["output_dir"].name == "version_1" and resumed["state"].step == 8

    # serve the run's final checkpoint: the frame of the trained weights
    serve_cfg = Config({"pipeline": Config.fromfile(str(out / "config.yml")).pipeline,
                        "serve": {"default_focal": 20.0}})
    service = service_from_config(serve_cfg, checkpoint=str(out / "ckpts" / "ckpts_0001"), device="cpu")
    pose = (orbit_pose(30.0, -30.0, 4.0) @ CAM_CALIBRATION)[:3, :4].astype(np.float32)
    rgb, _ = service.render(pose, service.default_focal)
    with torch.no_grad():
        preds = result["state"].pipeline(poses=torch.from_numpy(pose)[None], focal_lengths=torch.tensor([20.0]),
                                         evaluation_mode=EvaluationMode.EVALUATION)
    np.testing.assert_array_equal(rgb, preds["rendered_images"][0].numpy())
    assert rgb.shape == (16, 16, 3) and np.isfinite(rgb).all()


# --- ZeroOutputer -----------------------------------------------------------------------


def test_zero_outputer_renders_the_analytic_background():
    """Zero density everywhere: the frame is the background image and the loss against it is 0
    (tests/test_pipeline.py for the JAX package)."""
    cfg = dict(
        type="NeRFPipeline", chunk_size_grid=40, num_passes=1, output_rasterized_mc=True,
        loss_weights=dict(loss_rgb_mse=1.0), model=dict(type="ZeroOutputer"),
        ray_sampler=dict(type="RaySampler", image_height=6, image_width=10, min_depth=0.1, max_depth=8.0,
                         n_pts_per_ray_training=6, n_pts_per_ray_evaluation=6, n_rays_per_image_sampled_from_mask=8),
        renderer=dict(type="MultipassEmissionAbsorpsionRenderer", n_pts_per_ray_fine_training=6,
                      n_pts_per_ray_fine_evaluation=6, bg_color=[0.0, 0.0, 0.0], density_noise_std_train=0.0,
                      blend_output=False, background_density_bias=0.0),
        feature_extractor=[],
    )
    pipeline = PIPELINES.build(dict(cfg), device="cpu")
    assert isinstance(pipeline.implicit_functions[0], ZeroOutputer)
    assert [k for k, _ in pipeline.named_parameters()] == ["implicit_functions.0.dummy"]
    params = JAX_PIPELINES.build(dict(cfg)).init(jax.random.PRNGKey(0))
    assert set(flatten_tree(params)) == {"implicit_functions.0.dummy"}
    image = torch.rand(2, 6, 10, 3, generator=torch.Generator().manual_seed(0))
    poses = torch.eye(4)[None, :3, :4].repeat(2, 1, 1)
    poses[:, 2, 3] = -2.0
    batch = dict(poses=poses, focal_lengths=torch.full((2, 1), 8.0), bg_image_rgb=image, image_rgb=image)
    with torch.no_grad():
        preds = pipeline(evaluation_mode=EvaluationMode.EVALUATION, **batch)
    assert tuple(preds["rendered_images"].shape) == (2, 6, 10, 3)
    torch.testing.assert_close(preds["rendered_images"], image, rtol=0.0, atol=1e-5)
    assert float(preds["objective"].abs().max()) <= 1e-6
    assert tuple(preds["rendered_depths"].shape) == (2, 6, 10, 1)
    preds = pipeline(evaluation_mode=EvaluationMode.TRAINING, generator=torch.Generator().manual_seed(1), **batch)
    assert tuple(preds["objective"].shape) == (2,) and float(preds["objective"].detach().abs().max()) <= 1e-6
    torch.mean(preds["objective"]).backward()
    assert pipeline.implicit_functions[0].dummy.grad is not None


# --- the profilers and chip_smoke.py's phases of the new families --------------------

REPO_CONFIGS = Path(__file__).resolve().parent.parent / "configs" / "nerf"


@pytest.mark.parametrize(
    "config,model,serving,training",
    [("synth800_mip.yml", "MipNeRFMLP", [], []), ("lego_ngp.yml", "HashGridNeRF", [], []),
     ("lego.yml", "NeRFMLP", ["nerf_mlp_fwd"], ["nerf_mlp_fwd", "nerf_mlp_bwd"])],
)
def test_profilers_take_configs_with_no_nerf_mlp(config, model, serving, training):
    from yanerf_tpu_torch.profile_serving import serving_config
    from yanerf_tpu_torch.profile_training import training_config

    cfg, kernels = serving_config(str(REPO_CONFIGS / config))
    assert kernels == serving and cfg.pipeline.model.get("use_pallas", False) == bool(serving)
    cfg, kernels = training_config(str(REPO_CONFIGS / config))
    assert kernels == training and cfg.pipeline.model.get("use_pallas_train", False) == bool(training)
    assert training_config(str(REPO_CONFIGS / config), eager=True)[1] == []
    pipeline = PIPELINES.build(cfg.pipeline, generator=torch.Generator().manual_seed(0), device="cpu")
    assert [type(fn).__name__ for fn in pipeline.implicit_functions] == [model, model]


def test_chip_smoke_new_family_phases_run_on_the_cpu(tmp_path, monkeypatch):
    """chip_smoke.py's frame, serve, train, fused and family phases of both new families at a tiny size."""
    import chip_smoke
    from yanerf_tpu_torch.ops.kernels import nerf_mlp_bwd as K3
    from yanerf_tpu_torch.ops.kernels import nerf_mlp_fwd as K1

    # CPU tensors take the plain versions, which count no launch: count the calls instead
    for module, name in ((K1, "nerf_mlp_fwd"), (K3, "nerf_mlp_bwd")):

        def counting(*args, _module=module, _plain=getattr(module, name), **kwargs):
            _module.launches += 1
            return _plain(*args, **kwargs)

        monkeypatch.setattr(module, name, counting)
    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")
    for family in ("mip", "ngp"):
        service = service_from_config(Config({"pipeline": FAMILIES[family](hw=8),
                                              "serve": {"default_focal": 10.0}}), device="cpu")
        assert chip_smoke.family_frame(torch, K1, K3, service, "cpu", family) == chip_smoke.NO_LAUNCHES
        if family == "ngp":
            assert chip_smoke.serve(torch, K1, K3, service, "cpu", family, 0) == chip_smoke.NO_LAUNCHES

    ngp_path, mip_path = _write_drive(tmp_path / "ngp", "ngp"), _write_drive(tmp_path / "mip", "mip")
    data = tmp_path / "ngp" / "data"
    assert chip_smoke.nerf_mlp_keys(ngp_path) == chip_smoke.nerf_mlp_keys(mip_path) == []
    numbers, launches = chip_smoke.train(torch, K1, K3, data, tmp_path / "smoke_ngp", ngp_path, 4)
    assert all(numbers["checks"].values()), numbers["checks"]
    assert launches == chip_smoke.NO_LAUNCHES and numbers["params_moved"] == "28/28"  # 4 tables and 5 layers, two models

    numbers, launches = chip_smoke.fused_train(torch, K1, K3, data, tmp_path / "smoke_mip", mip_path, 8, 3)
    assert all(numbers["checks"].values()), numbers["checks"]
    assert numbers["fused_bit_equal_to_per_step"] and numbers["per_step_runs_bit_equal"]
    assert numbers["dispatches"] == 2 and numbers["group_sizes"] == [3]
    assert launches == numbers["per_step_launches"] == chip_smoke.NO_LAUNCHES

    for path in (mip_path, ngp_path):
        family = chip_smoke.family_check(torch, data, path, eval_rays=20, train_rays=12)
        assert all(family["checks"].values()), family
        assert family["card_step_bit_equal_twice"] and family["eval_chunk_max_abs_err"] == 0.0
    assert len(family["tables_grad_cosine"]) == 8
