"""The reference's ``.pth`` checkpoints and the async checkpoint saves of yanerf_tpu_torch, on the CPU.

  * ``.pth``: a file written by the JAX package's ``export_torch_checkpoint``
    from seeded JAX params loads into the port with no tensor left over; the
    port's NeRFMLPs then give the JAX models' outputs on an eval chunk at
    1e-5 and the JAX pipeline's frame (after the JAX importer read the same
    file) at 1e-4 (the classic frame's tolerance, tests/test_torch_classic.py).
    The port's ``export_torch_checkpoint`` writes the JAX writer's file, and
    the JAX importer reads it back to the port's arrays bit for bit; a
    shape mismatch, a model outside the NeRFMLP family and a tensor with no
    slot behave as in the JAX package. ``run.py --checkpoint x.pth
    --test_only``, ``serve`` and ``render`` take the file;
  * async saves: a checkpoint saved with ``async_save=True`` equals the
    synchronous one of the same step tensor for tensor, while the fused
    dispatch (uncaptured on the CPU) goes on stepping and the writer is
    held back until it has; a synchronous save of the same name waits for
    it; ``wait_for_async_saves`` leaves no ``.tmp``.
"""

import json
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_classic import MODEL, _batch, _cfg, _write_drive
from test_torch_fused_step import RUNNER as FUSED_RUNNER
from test_torch_fused_step import _state, _train_loader, proposal_cfg
from yanerf_tpu.models import MODELS as JAX_MODELS
from yanerf_tpu.ops.structures import EvaluationMode as JaxEvaluationMode
from yanerf_tpu.pipelines import PIPELINES as JAX_PIPELINES
from yanerf_tpu.runners import checkpoints as jax_checkpoints
from yanerf_tpu_torch import render as port_render
from yanerf_tpu_torch import run as port_run
from yanerf_tpu_torch.convert import export_jax_params, flatten_tree
from yanerf_tpu_torch.ops.structures import EvaluationMode
from yanerf_tpu_torch.pipelines import PIPELINES
from yanerf_tpu_torch.runners import (
    checkpoints,
    export_torch_checkpoint,
    import_torch_checkpoint,
    make_train_step_fused,
    save_checkpoint,
    wait_for_async_saves,
)
from yanerf_tpu_torch.serve import load_pipeline
from yanerf_tpu_torch.utils import Config


def _flat_np(tree):
    return flatten_tree(jax.tree_util.tree_map(np.asarray, tree))


def _jax_pth(tmp_path, cfg, seed=0, name="ref.pth"):
    """The JAX package's ``.pth`` of ``init(PRNGKey(seed))``: ``(path, JAX pipeline, params)``."""
    jax_pipeline = JAX_PIPELINES.build(dict(cfg))
    params = jax_pipeline.init(jax.random.PRNGKey(seed))
    pth = tmp_path / name
    jax_checkpoints.export_torch_checkpoint(params, pth)
    return pth, jax_pipeline, params


# --- the reference's .pth ---------------------------------------------------------------------


def test_jax_pth_loads_into_the_port_and_gives_the_jax_outputs(tmp_path):
    cfg = _cfg(use_pallas=True)
    pth, jax_pipeline, _ = _jax_pth(tmp_path, cfg, seed=0)
    # the JAX importer, into params of another seed: every NeRFMLP tensor comes from the file
    imported, jax_missing = jax_checkpoints.import_torch_checkpoint(pth, jax_pipeline.init(jax.random.PRNGKey(5)))
    pipeline = PIPELINES.build(dict(cfg), generator=torch.Generator().manual_seed(7), device="cpu")
    assert import_torch_checkpoint(pth, pipeline) == jax_missing == 0
    ours, theirs = _flat_np(export_jax_params(pipeline)), _flat_np(imported)
    assert ours.keys() == theirs.keys()
    for key in theirs:
        assert np.array_equal(ours[key], theirs[key]), key

    # an eval chunk through each NeRFMLP (the kernel's plain version here, Pallas in interpret mode there)
    rng = np.random.RandomState(3)
    origins = (rng.randn(1, 16, 3) * 0.3).astype(np.float32)
    directions = rng.randn(1, 16, 3).astype(np.float32)
    lengths = np.sort(rng.uniform(1.0, 3.0, (1, 16, 7)), axis=-1).astype(np.float32)
    for i, fn in enumerate(pipeline.implicit_functions):
        ref = JAX_MODELS.build(dict(MODEL, use_pallas=True)).apply(
            imported["implicit_functions"][i], *map(jnp.asarray, (origins, directions, lengths)))
        with torch.no_grad():
            got = fn(*map(torch.from_numpy, (origins, directions, lengths)))
        for key in ("rays_densities", "rays_features"):
            np.testing.assert_allclose(got[key].numpy(), np.asarray(ref[key]), rtol=1e-5, atol=1e-5, err_msg=key)

    # and the whole frame
    batch = _batch()
    pose = batch["poses"][:, :3, :4]
    ref = jax_pipeline.forward(imported, jax.random.PRNGKey(1), poses=jnp.asarray(pose),
                               focal_lengths=jnp.asarray([10.0]), evaluation_mode=JaxEvaluationMode.EVALUATION)
    with torch.no_grad():
        got = pipeline(poses=torch.from_numpy(pose), focal_lengths=torch.tensor([10.0]),
                       evaluation_mode=EvaluationMode.EVALUATION)
    np.testing.assert_allclose(got["rendered_images"].numpy(), np.asarray(ref["rendered_images"]), rtol=1e-4,
                               atol=1e-4)
    assert float(got["rendered_images"].std()) > 0.0


def test_port_pth_is_the_jax_file_and_reads_back_bit_for_bit(tmp_path):
    cfg = _cfg(compute_dtype="bfloat16")
    pipeline = PIPELINES.build(dict(cfg), generator=torch.Generator().manual_seed(1), device="cpu")
    port_pth, jax_pth = tmp_path / "port.pth", tmp_path / "jax.pth"
    assert export_torch_checkpoint(pipeline, port_pth, epoch=3) == 2 * (2 * (3 + 2 + 2))
    tree = export_jax_params(pipeline)
    jax_checkpoints.export_torch_checkpoint(tree, jax_pth, epoch=3)
    ours, theirs = (torch.load(p, weights_only=True) for p in (port_pth, jax_pth))
    assert (ours["epoch"], ours["optimizer"]) == (theirs["epoch"], theirs["optimizer"]) == (3, {})
    assert list(ours["model"]) == list(theirs["model"])
    assert "implicit_functions.1._fn.color_layer.2.weight" in ours["model"]
    for key, value in theirs["model"].items():
        assert torch.equal(ours["model"][key], value), key
    # the JAX importer gives the port's arrays back, bit for bit
    jax_params = JAX_PIPELINES.build(dict(cfg)).init(jax.random.PRNGKey(9))
    imported, missing = jax_checkpoints.import_torch_checkpoint(port_pth, jax_params)
    assert missing == 0
    got, want = _flat_np(imported), _flat_np(tree)
    for key in want:
        assert np.array_equal(got[key], want[key]), key


@pytest.mark.parametrize("case", ["shape_mismatch", "not_a_nerf_mlp", "unmapped_tensor"])
def test_pth_errors_and_counts_are_the_jax_importers(tmp_path, case):
    cfg = _cfg()
    pipeline = PIPELINES.build(dict(cfg), device="cpu")
    jax_params = JAX_PIPELINES.build(dict(cfg)).init(jax.random.PRNGKey(0))
    if case == "shape_mismatch":
        wider = _cfg(n_hidden_neurons_dir=24)
        pth, _, _ = _jax_pth(tmp_path, wider)
        with pytest.raises(ValueError) as port_error:
            import_torch_checkpoint(pth, pipeline)
        with pytest.raises(ValueError) as jax_error:
            jax_checkpoints.import_torch_checkpoint(pth, jax_params)
        assert str(port_error.value) == str(jax_error.value)
        assert str(port_error.value).startswith("shape mismatch at implicit_functions.0.color_layer.0.w")
    elif case == "not_a_nerf_mlp":
        proposal = PIPELINES.build(proposal_cfg(), device="cpu")
        with pytest.raises(ValueError) as port_error:
            export_torch_checkpoint(proposal, tmp_path / "x.pth")
        with pytest.raises(ValueError) as jax_error:
            jax_checkpoints.export_torch_checkpoint(export_jax_params(proposal), tmp_path / "y.pth")
        assert str(port_error.value) == str(jax_error.value)
        assert "implicit function 0 is not a NeRFMLP param tree" in str(port_error.value)
    else:
        pth, _, _ = _jax_pth(tmp_path, cfg)
        blob = torch.load(pth, weights_only=True)
        blob["model"]["implicit_functions.0._fn.embedding.weight"] = torch.zeros(3, 2)
        blob["model"]["renderer.bg"] = torch.zeros(3)
        torch.save(blob, pth)
        before = {k: p.detach().clone() for k, p in pipeline.named_parameters()}
        assert import_torch_checkpoint(pth, pipeline) == jax_checkpoints.import_torch_checkpoint(pth, jax_params)[1] == 2
        assert any(not torch.equal(before[k], p) for k, p in pipeline.named_parameters())


def test_run_serve_and_render_take_a_pth(tmp_path):
    """``run.py --checkpoint x.pth --test_only`` renders the frame of the same weights loaded from ``.npz``."""
    data, cfg_path = _write_drive(tmp_path)
    cfg = Config.fromfile(str(cfg_path))
    pth, _, params = _jax_pth(tmp_path, json.loads(cfg_path.read_text())["pipeline"], seed=3)
    npz = tmp_path / "params.npz"
    np.savez(npz, **_flat_np(params))
    result = port_run.main(["--config", str(cfg_path), "--device", "cpu", "--checkpoint", str(pth), "--test_only"])
    log = (result["output_dir"] / "run.log").read_text()
    assert f"Imported reference .pth weights from: {pth} (0 unmapped tensors)" in log
    assert result["state"].step == 0 and result["state"].optimizer.state_dict()["state"] == {}
    from_npz = load_pipeline(cfg, str(npz), "cpu")
    from_pth = load_pipeline(cfg, str(pth), "cpu")
    for (key, p), q, r in zip(result["state"].pipeline.named_parameters(), from_npz.parameters(),
                              from_pth.parameters()):
        assert torch.equal(p.detach(), q.detach()) and torch.equal(q.detach(), r.detach()), key
    pose = torch.from_numpy(_batch()["poses"][:, :3, :4])
    frames = []
    for pipeline in (result["state"].pipeline, from_npz):
        with torch.inference_mode():
            frames.append(pipeline(poses=pose, focal_lengths=torch.tensor([10.0]),
                                   evaluation_mode=EvaluationMode.EVALUATION)["rendered_images"])
    assert torch.equal(*frames) and frames[0].shape == (1, 16, 16, 3)
    test_stats = json.loads((result["output_dir"] / "test_stats.json").read_text())
    assert np.isfinite(test_stats["test_loss_rgb_psnr"])

    out = port_render.main(["--config", str(cfg_path), "--checkpoint", str(pth), "--device", "cpu",
                            "--trajectory", "test", "--n_frames", "1", "--output_dir", str(tmp_path / "renders")])
    assert out["frames"] == 1 and (tmp_path / "renders" / "rgb" / "00000.png").exists()


# --- async saves -------------------------------------------------------------------------------


def _assert_payloads_equal(a, b, where="payload"):
    if isinstance(a, torch.Tensor):
        assert isinstance(b, torch.Tensor) and a.dtype == b.dtype and torch.equal(a, b), where
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            _assert_payloads_equal(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_payloads_equal(x, y, f"{where}[{i}]")
    else:
        assert a == b, where


def _fused_state(tmp_path):
    loader = _train_loader(tmp_path, 4, True)
    assert loader._ensure_cache()
    runner = dict(FUSED_RUNNER, steps_per_call=2)
    state = _state(proposal_cfg(), runner)
    trainer = make_train_step_fused(state.pipeline, runner, 0, loader.data_wrapper)
    idx = np.array([[0], [1]])
    trainer(state, loader._arrays, idx)
    return state, lambda: trainer(state, loader._arrays, idx)


def test_async_save_equals_the_sync_save_while_the_fused_dispatch_steps_on(tmp_path, monkeypatch):
    state, dispatch = _fused_state(tmp_path)
    sync_path = save_checkpoint(tmp_path / "sync", state, epoch=0)
    release, write = threading.Event(), checkpoints._write
    monkeypatch.setattr(checkpoints, "_write", lambda payload, path: (release.wait(60), write(payload, path))[1])
    async_path = save_checkpoint(tmp_path / "async", state, epoch=0, async_save=True)
    step = state.step
    dispatch()  # writes the parameters and Adam's moments in place
    assert state.step == step + 2 and not async_path.exists()
    release.set()
    wait_for_async_saves()
    assert sorted(p.name for p in async_path.parent.iterdir()) == ["ckpts_0000"], "no .tmp left"
    ours, theirs = (torch.load(p, weights_only=True) for p in (async_path, sync_path))
    assert ours["step"] == step
    _assert_payloads_equal(ours, theirs)
    changed = torch.load(save_checkpoint(tmp_path / "later", state, epoch=0), weights_only=True)
    assert not all(torch.equal(changed["params"][k], v) for k, v in ours["params"].items())


def test_a_sync_save_waits_for_the_async_save_of_the_same_name(tmp_path, monkeypatch):
    state, dispatch = _fused_state(tmp_path)
    release, write = threading.Event(), checkpoints._write
    monkeypatch.setattr(checkpoints, "_write", lambda payload, path: (release.wait(60), write(payload, path))[1])
    save_checkpoint(tmp_path, state, epoch=1, async_save=True)
    dispatch()
    timer = threading.Timer(0.2, release.set)
    timer.start()
    path = save_checkpoint(tmp_path, state, epoch=1)
    timer.join()
    assert torch.load(path, weights_only=True)["step"] == state.step
    assert sorted(p.name for p in path.parent.iterdir()) == ["ckpts_0001"]


def test_a_failed_async_write_raises_at_the_wait(tmp_path, monkeypatch):
    state, _ = _fused_state(tmp_path)

    def fail(payload, path):
        raise OSError("disk full")

    monkeypatch.setattr(checkpoints, "_write", fail)
    save_checkpoint(tmp_path, state, epoch=0, async_save=True)
    with pytest.raises(OSError, match="disk full"):
        wait_for_async_saves()
    wait_for_async_saves()  # nothing left pending


# --- chip_smoke.py's phases of the checkpoints, the export, --debug, lego_tpu.yml and the saves ---------------


def test_chip_smoke_checkpoint_export_debug_lego_tpu_and_save_phases_run_on_the_cpu(tmp_path, monkeypatch):
    """At tiny widths: "pth serve" on the classic structure, "export" on tests/test_export.py's TINY_CFG in a
    fresh process, "debug" and "async save" on a tiny flagship, "lego_tpu" on the config cut to 16x16."""
    import chip_smoke
    from test_torch_export import PALLAS_CFG
    from test_torch_lego_tpu import LEGO_TPU, TINY
    from yanerf_tpu_torch.ops.kernels import nerf_mlp_bwd as K3
    from yanerf_tpu_torch.ops.kernels import nerf_mlp_fwd as K1
    from yanerf_tpu_torch.serve import service_from_config
    from yanerf_tpu_torch.synth_scene import write_scene

    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")
    # CPU tensors take the plain versions, which count no launch: count the calls instead
    for module, name in ((K1, "nerf_mlp_fwd"), (K3, "nerf_mlp_bwd")):

        def counting(*args, _module=module, _entry=getattr(module, name), **kwargs):
            if kwargs.get("pipelined"):
                _module.pipelined_launches += 1
            else:
                _module.launches += 1
            return _entry(*args, **kwargs)

        monkeypatch.setattr(module, name, counting)

    classic = tmp_path / "classic.json"
    classic.write_text(json.dumps({"pipeline": _cfg("bfloat16", use_pallas=True), "serve": {"default_focal": 10.0}}))
    service = service_from_config(Config.fromfile(str(classic)), device="cpu")
    (tmp_path / "pth").mkdir()
    launches = chip_smoke.pth_serve_phase(torch, K1, K3, service, "cpu", tmp_path / "pth", classic)
    assert launches == {"nerf_mlp_fwd": 2 * 8, "nerf_mlp_fwd_pipelined": 0, "nerf_mlp_bwd": 0}

    tiny = tmp_path / "tiny.yml"
    tiny.write_text(PALLAS_CFG)
    (tmp_path / "export").mkdir()
    paths = chip_smoke.export_phase(torch, K1, "cpu", tmp_path / "export", tiny, {"pipeline.chunk_size_grid": 96})
    assert paths["export_serve"]["nerf_mlp_fwd"] == 4  # 64 rays x 6 points in chunks of 96

    scene = write_scene(tmp_path / "scene", hw=16, n_train=4, n_val=2, n_test=2, n_spheres=3, seed=1)
    flagship = Config.fromfile(str(chip_smoke.CONFIG))
    flagship.merge_from_dict({
        "pipeline.ray_sampler.image_height": 16, "pipeline.ray_sampler.image_width": 16,
        "pipeline.ray_sampler.n_rays_per_image_sampled_from_mask": 16, "pipeline.chunk_size_grid": 4096,
        "runner.num_workers_list": [0, 0, 0], "pipeline.model.2.n_layers": 3, "pipeline.model.2.input_skips": [2],
        "pipeline.model.2.n_hidden_neurons_xyz": 32, "pipeline.model.2.n_hidden_neurons_dir": 16,
        **{f"pipeline.model.{i}.{k}": v for i in (0, 1) for k, v in (("n_layers", 2), ("hidden_dim", 16))}})
    flagship.dump(str(tmp_path / "flagship.yml"))
    launches = chip_smoke.debug_phase(torch, K1, K3, "cpu", scene, tmp_path / "debug", tmp_path / "flagship.yml")
    assert launches == {"nerf_mlp_fwd": 2, "nerf_mlp_fwd_pipelined": 0, "nerf_mlp_bwd": 2}
    launches = chip_smoke.async_save_phase(torch, K1, K3, "cpu", scene, tmp_path / "saves", tmp_path / "flagship.yml",
                                           epochs=2, frames=4)
    assert launches["nerf_mlp_fwd"] == launches["nerf_mlp_bwd"] == 8

    options = [f"pipeline.model.{k}={v}" for k, v in TINY.items() if k != "input_skips"]
    options += ["pipeline.model.input_skips=[2]", "pipeline.ray_sampler.image_height=16",
                "pipeline.ray_sampler.image_width=16", "pipeline.ray_sampler.n_rays_per_image_sampled_from_mask=32",
                "pipeline.ray_sampler.n_pts_per_ray_training=5", "pipeline.ray_sampler.n_pts_per_ray_evaluation=5",
                "pipeline.renderer.n_pts_per_ray_fine_training=6", "pipeline.renderer.n_pts_per_ray_fine_evaluation=6",
                "runner.num_workers_list=[0,0,0]"]
    launches = chip_smoke.lego_tpu_phase(torch, K1, K3, "cpu", scene, tmp_path / "lego_tpu", LEGO_TPU, 4, options)
    assert launches == {"nerf_mlp_fwd": 2 * 4, "nerf_mlp_fwd_pipelined": 0, "nerf_mlp_bwd": 2 * 4}
