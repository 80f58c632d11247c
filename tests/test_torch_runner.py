"""The rest of the port's runner, on the CPU, against yanerf_tpu where it has a counterpart.

  * ``scatter_rays_to_image`` and ``vis_batch_img`` (file names and pixels)
    against the JAX package's;
  * the host DataLoader's prefetch thread: the batches of the serial
    loader, in order, at depth 1 and 3, and a worker's error raised;
  * eval with 1 and 3 frames in flight: equal stats, the frames written;
  * hooks called where the JAX loops call them, and a trace written;
  * SIGTERM through ``PreemptionGuard`` stops between steps (between fused
    dispatches) and ``--auto_resume`` from the emergency checkpoint ends
    where an unbroken run ends, bit for bit;
  * ``serve`` from the runner's checkpoint renders the frame it renders
    from the equivalent ``.npz``;
  * ``synth_scene.py`` writes the scene of ``scripts/make_synth_scene.py``:
    the same poses, the same decoded pixels.
"""

import json
import os
import signal
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_train import _write_drive
from yanerf_tpu.ops import sampling as jax_sampling
from yanerf_tpu.runners import vis as jax_vis
from yanerf_tpu_torch import run as port_run
from yanerf_tpu_torch.convert import export_jax_params, flatten_tree
from yanerf_tpu_torch.datasets import BlenderDataset, DataLoader, create_sampler
from yanerf_tpu_torch.ops.sampling import scatter_rays_to_image
from yanerf_tpu_torch.runners import (
    HOOKS,
    RunType,
    TrainState,
    apis,
    create_optimizer,
    eval_one_epoch,
    make_train_step,
    train_one_epoch,
    vis_batch_img,
)
from yanerf_tpu_torch.runners.hooks import EvalDataHook, EvalOutputsHook, TrainDataHook, TrainOutputsHook
from yanerf_tpu_torch.serve import CAM_CALIBRATION, orbit_pose, service_from_config
from yanerf_tpu_torch.synth_scene import write_scene
from yanerf_tpu_torch.utils import Config
from yanerf_tpu_torch.utils.images import load_image

REPO = Path(__file__).resolve().parent.parent


# --- rasterization and vis --------------------------------------------------


def test_scatter_rays_to_image_matches_jax():
    rng = np.random.RandomState(0)
    values = rng.rand(2, 10, 1, 3).astype(np.float32)
    flat = np.stack([rng.permutation(6 * 5)[:10] for _ in range(2)])  # no pixel twice
    grid = np.stack([flat % 5, flat // 5], axis=-1)[:, :, None].astype(np.float32)
    bg = rng.rand(2, 6, 5, 3).astype(np.float32)
    for background in (None, bg):
        ref = jax_sampling.scatter_rays_to_image(jnp.asarray(values), jnp.asarray(grid), 6, 5,
                                                 None if background is None else jnp.asarray(background))
        got = scatter_rays_to_image(torch.from_numpy(values), torch.from_numpy(grid), 6, 5,
                                    None if background is None else torch.from_numpy(background))
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert not scatter_rays_to_image(torch.ones(1, 2, 1, 1, requires_grad=True), torch.zeros(1, 2, 1, 2), 2, 2).requires_grad


def test_vis_batch_img_writes_the_jax_files(tmp_path):
    rng = np.random.RandomState(1)
    preds = {
        "rendered_images": rng.rand(2, 6, 5, 3).astype(np.float32),
        "rendered_depths": 4.0 * rng.rand(2, 6, 5, 1).astype(np.float32),
        "rendered_alpha_masks": np.zeros((2, 6, 5, 1), np.float32),
        "image_rgb": rng.rand(2, 6, 5, 3).astype(np.float32),  # not a rendered prefix: not written
        "loss_rgb_mse": np.ones(2, np.float32),
    }
    for prefix in ("00003/", "val_"):
        jax_vis.vis_batch_img(preds, jax_vis.RunType.VAL, tmp_path / "jax", 3, 5, prefix)
        vis_batch_img({k: torch.from_numpy(v) for k, v in preds.items()}, RunType.VAL, tmp_path / "port", 3, 5, prefix)
    jax_files = sorted(p.relative_to(tmp_path / "jax") for p in (tmp_path / "jax").rglob("*.png"))
    port_files = sorted(p.relative_to(tmp_path / "port") for p in (tmp_path / "port").rglob("*.png"))
    assert port_files == jax_files and len(port_files) == 3 * 2 * 2
    for rel in port_files:
        a, b = load_image(tmp_path / "jax" / rel), load_image(tmp_path / "port" / rel)
        np.testing.assert_array_equal(a, b, err_msg=str(rel))


# --- the host DataLoader's prefetch ------------------------------------------


class _Items:
    data_wrapper = None

    def __init__(self, n, fail_at=None):
        self.n, self.fail_at = n, fail_at

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        if i == self.fail_at:
            raise OSError(f"item {i} is unreadable")
        return np.full((2, 2), i, np.float32), float(i)


@pytest.mark.parametrize("depth", [1, 3])
def test_prefetch_gives_the_serial_batches_and_raises_a_workers_error(depth):
    items = _Items(11)
    sampler = create_sampler(items, shuffle=True, seed=4)
    serial = list(DataLoader(items, sampler, batch_size=2, is_train=True, num_workers=0))
    prefetched = DataLoader(items, sampler, batch_size=2, is_train=True, num_workers=2, prefetch_depth=depth)
    got = list(prefetched)
    assert len(got) == len(serial) == 5
    for a, b in zip(got, serial):
        np.testing.assert_array_equal(a[0], b[0])
        assert a[1] == b[1]
    bad = DataLoader(_Items(11, fail_at=int(sampler.indices()[5])), sampler, batch_size=2, is_train=True,
                     num_workers=1, prefetch_depth=depth)
    with pytest.raises(OSError, match="unreadable"):
        list(bad)


# --- eval with frames in flight, hooks, traces -------------------------------


def _pipeline_state(cfg_path):
    from yanerf_tpu_torch.pipelines import PIPELINES

    cfg = Config.fromfile(str(cfg_path))
    pipeline = PIPELINES.build(cfg.pipeline, generator=torch.Generator().manual_seed(0), device="cpu")
    return cfg, TrainState(pipeline=pipeline, optimizer=create_optimizer(cfg.runner, pipeline), step=0)


def _loader(cfg, split):
    from yanerf_tpu_torch.datasets import create_loader

    ds_cfg = next(d for d in cfg.datasets if d.split == split)
    dataset = BlenderDataset(ds_cfg.base_dir, split, test_skip=1)
    return create_loader(dataset, create_sampler(dataset, shuffle=split == "train", seed=0), 1, 0,
                         is_train=split == "train")


def test_eval_frames_in_flight_give_equal_stats_and_write_the_frames(tmp_path):
    cfg, state = _pipeline_state(_write_drive(tmp_path))
    loader = _loader(cfg, "test")
    stats = {}
    for depth in (1, 3):
        runner = dict(cfg.runner, eval_frames_in_flight=depth, output_dir=str(tmp_path / f"out{depth}"))
        stats[depth] = eval_one_epoch(RunType.TEST, runner, -1, state.pipeline, loader, seed=0)
        written = sorted(p.relative_to(tmp_path / f"out{depth}") for p in (tmp_path / f"out{depth}").rglob("*.png"))
        assert [str(p) for p in written] == [
            f"visualization/test/rendered_{kind}/{i:05d}.png" for kind in ("alpha_masks", "depths", "images")
            for i in range(2)
        ]
    assert stats[1] == stats[3] and np.isfinite(stats[1]["loss_rgb_psnr"])


class _Recorder(TrainDataHook, TrainOutputsHook, EvalDataHook, EvalOutputsHook):
    def __init__(self):
        self.calls = []

    def __call__(self, data=None, outputs=None, iter=None, epoch=None, config=None, **kwargs):
        self.calls.append(("data" if outputs is None else "outputs", iter, epoch))
        return data if outputs is None else outputs


def test_hooks_are_called_where_the_jax_loops_call_them_and_a_trace_is_written(tmp_path):
    cfg, state = _pipeline_state(_write_drive(tmp_path))
    hook = _Recorder()
    runner = dict(cfg.runner, hooks=[hook], steps_per_call=1, profile_dir=str(tmp_path / "trace"),
                  profile_start_iter=1, profile_num_iters=2)
    train_one_epoch(RunType.TRAIN, runner, 1, state, _loader(cfg, "train"), make_train_step(state.pipeline, runner, 0))
    assert hook.calls == [(kind, it, 1) for it in range(4, 8) for kind in ("data", "outputs")]
    assert not (tmp_path / "trace").exists(), "traces are taken in epoch 0 only"
    train_one_epoch(RunType.TRAIN, runner, 0, state, _loader(cfg, "train"), make_train_step(state.pipeline, runner, 0))
    assert json.loads((tmp_path / "trace" / "train_trace.json").read_text())["traceEvents"]
    hook.calls.clear()
    eval_one_epoch(RunType.VAL, runner, 0, state.pipeline, _loader(cfg, "val"), seed=0)
    assert hook.calls == [("data", 0, 0), ("data", 1, 0), ("outputs", 0, 0), ("outputs", 1, 0)]
    assert HOOKS.get("ADNeRFTrainDataHook") is not None and HOOKS.get("SDNeRFOutputsHook") is not None


# --- preemption and resume ---------------------------------------------------


@pytest.mark.parametrize("steps_per_call", [1, 2], ids=["per_step", "fused"])
def test_sigterm_stops_between_steps_and_auto_resume_ends_where_an_unbroken_run_ends(tmp_path, monkeypatch,
                                                                                      steps_per_call):
    """8 steps in 2 epochs of 4, vis steps at 0 and 4 (fused: groups 1-2, 3 | 5-6, 7). SIGTERM arrives during
    update 6 (per step) or right after the dispatch of 5-6 (fused): the run stops with 7 updates, and the
    resumed run takes the last one."""
    cfg_path = _write_drive(tmp_path)
    options = ["--cfg_options", f"runner.steps_per_call={steps_per_call}"]
    handler = signal.getsignal(signal.SIGTERM)
    unbroken = port_run.main(["--config", str(cfg_path), "--device", "cpu", "--output_dir", str(tmp_path / "a"),
                              *options])
    if steps_per_call == 1:
        set_learning_rates = apis.set_learning_rates

        def spy(runner_config, optimizer, step):
            set_learning_rates(runner_config, optimizer, step)
            if step == 6:
                os.kill(os.getpid(), signal.SIGTERM)

        monkeypatch.setattr(apis, "set_learning_rates", spy)
    else:
        dispatch = apis.FusedTrainStep.__call__

        def spy(self, state, arrays, idx):
            out = dispatch(self, state, arrays, idx)
            if state.step == 7:
                os.kill(os.getpid(), signal.SIGTERM)
            return out

        monkeypatch.setattr(apis.FusedTrainStep, "__call__", spy)
    preempted = port_run.main(["--config", str(cfg_path), "--device", "cpu", "--output_dir", str(tmp_path / "b"),
                               *options])
    monkeypatch.undo()
    assert signal.getsignal(signal.SIGTERM) is handler, "the guard restores the previous handler"
    assert preempted["preempted"].name == "ckpts_preempt" and preempted["state"].step == 7
    assert "test_stats" not in preempted
    resumed = port_run.main(["--config", str(cfg_path), "--device", "cpu", "--output_dir", str(tmp_path / "b"),
                             "--auto_resume", *options])
    assert resumed["output_dir"] == preempted["output_dir"] and resumed["state"].step == 8
    assert len(resumed["train_stats"]) == 1
    for (key, p), q in zip(unbroken["state"].pipeline.named_parameters(), resumed["state"].pipeline.parameters()):
        assert torch.equal(p, q), key
    assert resumed["test_stats"] == unbroken["test_stats"]
    if steps_per_call > 1:
        assert resumed["train_step_fused"].steps == 1 and unbroken["train_step_fused"].steps == 6


# --- serving the runner's checkpoints ----------------------------------------


def test_serve_renders_the_same_frame_from_a_runner_checkpoint_and_its_npz(tmp_path):
    from yanerf_tpu_torch.runners import save_checkpoint

    cfg, state = _pipeline_state(_write_drive(tmp_path))
    with torch.no_grad():
        for p in state.pipeline.parameters():
            p.add_(0.01)
    ckpt = save_checkpoint(tmp_path / "run", state, epoch=-1)
    npz = tmp_path / "params.npz"
    np.savez(npz, **flatten_tree(export_jax_params(state.pipeline)))
    serve_cfg = Config({"pipeline": cfg.pipeline, "serve": {"default_focal": 20.0}})
    pose = (orbit_pose(30.0, -30.0, 4.0) @ CAM_CALIBRATION)[:3, :4].astype(np.float32)
    frames = []
    for checkpoint in (ckpt, npz):
        service = service_from_config(serve_cfg, checkpoint=str(checkpoint), device="cpu", seed=9)
        frames.append(service.render(pose, service.default_focal))
    np.testing.assert_array_equal(frames[0][0], frames[1][0])
    np.testing.assert_array_equal(frames[0][1], frames[1][1])
    fresh = service_from_config(serve_cfg, checkpoint=None, device="cpu", seed=9)
    assert not np.array_equal(fresh.render(pose, fresh.default_focal)[0], frames[0][0])


# --- the same scene as scripts/make_synth_scene.py ----------------------------


def test_synth_scene_writes_the_scene_of_make_synth_scene(tmp_path, monkeypatch):
    sys.path.insert(0, str(REPO / "scripts"))
    try:
        import make_synth_scene
    finally:
        sys.path.remove(str(REPO / "scripts"))
    args = ["--hw", "48", "--n_train", "3", "--n_val", "2", "--n_test", "2", "--seed", "3", "--n_spheres", "5"]
    monkeypatch.setattr(sys, "argv", ["make_synth_scene.py", "--out_dir", str(tmp_path / "ref"), *args])
    make_synth_scene.main()
    write_scene(tmp_path / "port", hw=48, n_train=3, n_val=2, n_test=2, n_spheres=5, seed=3)
    for split in ("train", "val", "test"):
        ref = json.loads((tmp_path / "ref" / f"transforms_{split}.json").read_text())
        got = json.loads((tmp_path / "port" / f"transforms_{split}.json").read_text())
        assert got == ref, split
        for frame in ref["frames"]:
            name = frame["file_path"] + ".png"
            np.testing.assert_array_equal(load_image(tmp_path / "port" / name), load_image(tmp_path / "ref" / name))
