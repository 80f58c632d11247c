"""Two real processes over gloo: the port's parallel layer (``yanerf_tpu_torch/parallel``) against one process.

Mirrors tests/test_multiprocess.py (the eval gather, truncate and mean, the
barrier, checkpoints saved by every rank) and the numerical claims of
tests/test_parallel.py, on a tiny flagship in float32, under a (data 2 x
rays 1) and a (data 1 x rays 2) mesh:
  * one train step with the draws fed in, and three steps of the fused
    dispatch (``FusedTrainStep``, uncaptured on the CPU), against the
    one-process step on the same global batch and draws (each data index
    draws from ``seed + data_index``, as the runner makes them, and the
    one-process reference takes those draws concatenated): each step's
    objective within 1e-6, every reduced gradient within 1e-6 of its
    tensor's largest entry, and after the fused steps Adam's moments
    likewise. The fused steps run at a learning rate of 0, so that every
    step is taken at the same weights: the flagship's interlevel loss is a
    histogram bound whose gradient jumps when a resampled depth crosses a
    bin, so two runs whose weights differ in the last bit part after a
    step or two whatever the layout. The weights after the one step are
    held at 1e-5 (measured up to 4.3e-6): Adam divides each gradient by
    its magnitude plus 1e-8, so an entry near 1e-8 turns the gradient's
    sums in another order into a larger step;
  * the EVALUATION frame under the ray split within 1e-6 of the frame of
    one process, and ``eval_one_epoch`` over a 3-frame split (wraparound
    padding on the data axis) giving one process's stats;
  * ``python -m yanerf_tpu_torch.run`` in two processes (``--world_size 2
    --dist_url tcp://...``, ``runner.mesh`` 1 x 2): the main process
    alone writes the log, the stats and the checkpoints, and its test
    stats are one process's within 1e-6 (at a learning rate of 0).
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import pytest

from yanerf_tpu_torch.synth_scene import write_scene
from yanerf_tpu_torch.utils import Config

REPO = Path(__file__).resolve().parent.parent
NARROW = {"n_layers": 3, "input_skips": [2], "n_hidden_neurons_xyz": 32, "n_hidden_neurons_dir": 16,
          "compute_dtype": "float32"}
TOL = 1e-6
PARAMS_TOL = 1e-5  # after one Adam update, see the docstring

WORKER = r"""
import json, os, sys
import numpy as np
import torch
from yanerf_tpu_torch.datasets import BlenderDataset, DeviceCachedLoader, create_loader, create_sampler
from yanerf_tpu_torch.ops.structures import EvaluationMode
from yanerf_tpu_torch.parallel import (barrier, concat_all_gather, create_mesh, get_rank, get_world_size,
                                       init_distributed_mode, is_dist_avail_and_initialized, is_main_process,
                                       mesh_context)
from yanerf_tpu_torch.pipelines import PIPELINES
from yanerf_tpu_torch.runners import (TrainState, apis, create_optimizer, eval_one_epoch, load_checkpoint,
                                      make_step_draws, make_train_step, prepare_batch, save_checkpoint)
from yanerf_tpu_torch.runners.apis import FusedTrainStep, _gather_batch
from yanerf_tpu_torch.utils import Config

assert init_distributed_mode(device="cpu") is True and is_dist_avail_and_initialized()
rank, world = get_rank(), get_world_size()
assert world == 2 and rank == int(os.environ["RANK"]) and is_main_process() == (rank == 0)
cfg = Config.fromfile(os.environ["CFG"])
scene, out = os.environ["SCENE"], os.environ["OUT"]
SEED, B = 7, 2
dataset = BlenderDataset(scene, "train")
cache = DeviceCachedLoader(create_loader(dataset, None, B, 0, is_train=True), "cpu")
assert cache._ensure_cache()
arrays, wrapper = cache._arrays, dataset.data_wrapper
batch = _gather_batch(arrays, wrapper, torch.tensor([1, 3]))
idx = np.array([[0, 1], [2, 3], [3, 0]])  # three fused steps of two images


def build():
    return PIPELINES.build(cfg.pipeline, generator=torch.Generator().manual_seed(SEED), device="cpu")


def cat_draws(pipe, data_parallel, step):
    # the global batch's draws: each data index's own (seed + index), concatenated on the batch axis
    parts = [make_step_draws(pipe, B // data_parallel, SEED + d, step) for d in range(data_parallel)]
    return {k: [torch.cat(t) for t in zip(*(p[k] for p in parts))] if isinstance(parts[0][k], list)
            else torch.cat([p[k] for p in parts]) for k in parts[0]}


def local(draws, mesh):
    n = B // mesh.data_parallel
    part = lambda t: t[mesh.data_index * n:(mesh.data_index + 1) * n]
    return {k: [part(t) for t in v] if isinstance(v, list) else part(v) for k, v in draws.items()}


def params(pipe):
    return {k: v.detach().clone() for k, v in pipe.named_parameters()}


def max_diff(a, b):
    return max(float((a[k] - b[k]).abs().max()) for k in a)


def rel_diff(a, b):
    # per tensor, over the reference's largest entry: gradients and Adam's moments
    return max(float((a[k] - b[k]).abs().max() / b[k].abs().max().clamp_min(1e-30)) for k in b)


def grads(pipe):
    return {k: v.grad.detach().clone() for k, v in pipe.named_parameters()}


def moments(state):
    return {f"{i}.{m}": s[m] for i, s in enumerate(state.optimizer.state.values()) for m in ("exp_avg", "exp_avg_sq")}


frozen = dict(cfg.runner, init_lr=0.0, min_lr=0.0, warmup_lr=0.0)  # the fused steps all at the init
warm = build()  # the process's first pass pays its one-off costs
make_train_step(warm, cfg.runner, SEED)(TrainState(warm, create_optimizer(cfg.runner, warm)), batch,
                                        cat_draws(warm, 1, 0))
report = {}
for data_parallel, ray_parallel in ((2, 1), (1, 2)):
    mesh = create_mesh(data_parallel, ray_parallel)
    name = f"{data_parallel}x{ray_parallel}"
    n = B // data_parallel
    rows = slice(mesh.data_index * n, (mesh.data_index + 1) * n)
    # one step, draws fed in: the reference on the whole batch, no mesh
    ref = build()
    draws = cat_draws(ref, data_parallel, 0)
    ref_state = TrainState(ref, create_optimizer(cfg.runner, ref))
    ref_preds = make_train_step(ref, cfg.runner, SEED)(ref_state, batch, draws)
    pipe = build()
    state = TrainState(pipe, create_optimizer(cfg.runner, pipe))
    with mesh_context(mesh):
        preds = make_train_step(pipe, cfg.runner, SEED + mesh.data_index)(
            state, {k: v[rows] for k, v in batch.items()}, local(draws, mesh))
    report[f"{name}_step_objective"] = float((preds["objective"] - ref_preds["objective"][rows]).abs().max())
    report[f"{name}_step_grads"] = rel_diff(grads(pipe), grads(ref))
    report[f"{name}_step_params"] = max_diff(params(pipe), params(ref))

    # three fused steps: the reference takes the concatenated per-index draws
    ref = build()
    ref_state = TrainState(ref, create_optimizer(frozen, ref))
    fused_ref = FusedTrainStep(ref, frozen, SEED, wrapper, 3)
    make = apis.make_step_draws
    apis.make_step_draws = lambda pipe, b, seed, step, out=None: {
        k: (([o.copy_(t) for o, t in zip(out[k], v)]) if isinstance(v, list) else out[k].copy_(v))
        for k, v in cat_draws(pipe, data_parallel, step).items()}
    hist_ref = fused_ref(ref_state, arrays, idx)
    apis.make_step_draws = make
    pipe = build()
    state = TrainState(pipe, create_optimizer(frozen, pipe))
    fused = FusedTrainStep(pipe, frozen, SEED + mesh.data_index, wrapper, 3)
    with mesh_context(mesh):
        hist = fused(state, arrays, idx[:, rows])
    report[f"{name}_fused_objective"] = float((hist["objective"] - hist_ref["objective"][:, rows]).abs().max())
    report[f"{name}_fused_grads"] = rel_diff(grads(pipe), grads(ref))
    report[f"{name}_fused_moments"] = rel_diff(moments(state), moments(ref_state))

    # the EVALUATION frame: each process renders its slice of every chunk
    pipe.eval()
    with torch.inference_mode():
        kw = dict(poses=batch["poses"][:1], focal_lengths=batch["focal_lengths"][:1],
                  evaluation_mode=EvaluationMode.EVALUATION)
        alone = pipe(**kw)["rendered_images"]
        with mesh_context(mesh):
            split = pipe(**kw)["rendered_images"]
    report[f"{name}_frame"] = float((split - alone).abs().max())

    # eval over 3 frames: sharded over the data axis with wraparound, gathered, truncated, meaned
    val = BlenderDataset(scene, "val")
    loader = create_loader(val, create_sampler(val, False, mesh.data_parallel, mesh.data_index), 1, 0, False)
    with mesh_context(mesh):
        stats = eval_one_epoch("val", cfg.runner, 0, pipe, loader, SEED)
    stats_alone = eval_one_epoch("val", cfg.runner, 0, pipe, create_loader(val, create_sampler(val, False), 1, 0, False),
                                 SEED)
    report[f"{name}_eval"] = max(abs(stats[k] - stats_alone[k]) for k in stats_alone)
    assert stats.keys() == stats_alone.keys()

# the gather, truncate and mean of tests/test_multiprocess.py, and the barrier
chunks = []
for value in {0: [0.0, 2.0, 4.0], 1: [1.0, 3.0, 0.0]}[rank]:
    chunks.append(concat_all_gather(np.asarray([value], dtype=np.float32)))
    barrier("per-batch")
gathered = np.concatenate(chunks)
assert np.allclose(gathered, [0.0, 1.0, 2.0, 3.0, 4.0, 0.0]), gathered
assert abs(float(np.mean(gathered[:5])) - 2.0) < 1e-6

# every rank saves; the main one writes; every rank reads it back
path = save_checkpoint(out, state, epoch=3)
barrier("saved")
pipe2 = build()
state2 = TrainState(pipe2, create_optimizer(cfg.runner, pipe2))
assert load_checkpoint(path, state2)["epoch"] == 3 and max_diff(params(pipe2), params(pipe)) == 0.0
barrier("done")
if rank == 0:
    print("REPORT " + json.dumps(report), flush=True)
print(f"WORKER_OK rank={rank}", flush=True)
torch.distributed.destroy_process_group()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _tiny_flagship(path: Path, scene: Path) -> Path:
    cfg = Config.fromfile(str(REPO / "configs" / "nerf" / "lego_proposal.yml"))
    cfg.merge_from_dict({"runner.output_dir": str(path.parent / "results"),
        "pipeline.ray_sampler.image_height": 8, "pipeline.ray_sampler.image_width": 8,
        "pipeline.ray_sampler.n_rays_per_image_sampled_from_mask": 16, "pipeline.chunk_size_grid": 256,
        "runner.num_workers_list": [0, 0, 0], "runner.init_lr": 5e-3, "runner.warmup_steps": 0,
        "runner.linear_scale": False, "runner.num_iters": 4, "runner.val_per_iter": 4, "runner.save_per_iter": 4,
        "runner.print_per_iter": 1, "runner.steps_per_call": 1, "runner.cache_dataset_on_device": False,
        **{f"datasets.{i}.base_dir": str(scene) for i in range(3)},
        **{f"pipeline.model.2.{k}": v for k, v in NARROW.items()},
        **{f"pipeline.model.{i}.{k}": v for i in (0, 1) for k, v in (("n_layers", 2), ("hidden_dim", 16),
                                                                    ("compute_dtype", "float32"))}})
    cfg.dump(str(path))
    return path


def _spawn(argv, tmp_path, extra_env):
    port = _free_port()
    procs = []
    for rank in range(2):
        # one thread each: two processes of tiny tensors, beside the other test workers
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE="2", MASTER_ADDR="localhost", MASTER_PORT=str(port),
                   OMP_NUM_THREADS="1", MKL_NUM_THREADS="1",
                   PYTHONPATH=str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", ""), **extra_env)
        env.pop("XLA_FLAGS", None)
        procs.append(subprocess.Popen([sys.executable, *argv], env=env, cwd=REPO, stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, text=True))
    outs = [p.communicate(timeout=600) for p in procs]
    for rank, (proc, (out, err)) in enumerate(zip(procs, outs)):
        assert proc.returncode == 0, f"rank {rank} failed:\n{out[-2000:]}\n{err[-4000:]}"
    return [o for o, _ in outs]


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mp")
    return write_scene(tmp / "scene", hw=8, n_train=4, n_val=3, n_test=1, n_spheres=3, seed=1)


def test_two_processes_step_fused_dispatch_frame_eval_gather_and_checkpoints(scene, tmp_path):
    cfg = _tiny_flagship(tmp_path / "tiny.yml", scene)
    outs = _spawn(["-c", WORKER], tmp_path, {"CFG": str(cfg), "SCENE": str(scene), "OUT": str(tmp_path / "run")})
    assert all(f"WORKER_OK rank={r}" in out for r, out in enumerate(outs))
    report = json.loads(next(line for line in outs[0].splitlines() if line.startswith("REPORT "))[7:])
    assert len(report) == 16
    for key, value in report.items():
        assert value <= (PARAMS_TOL if key.endswith("_params") else TOL), (key, value, json.dumps(report))
    assert (tmp_path / "run" / "ckpts" / "ckpts_0003").exists()


def test_run_cli_in_two_processes_matches_one_process(scene, tmp_path):
    cfg = _tiny_flagship(tmp_path / "tiny.yml", scene)
    # at a learning rate of 0 (see the first test: steps at other weights part for the flagship's loss)
    options = ["--cfg_options", "runner.init_lr=0.0", "runner.min_lr=0.0", "runner.warmup_lr=0.0"]
    run = ["-m", "yanerf_tpu_torch.run", "--config", str(cfg), "--device", "cpu", "--seed", "3"]
    port = _free_port()
    _spawn([*run, "--output_dir", str(tmp_path / "two"), "--world_size", "2", "--dist_url",
            f"tcp://localhost:{port}", *options, "runner.mesh.data_parallel=1", "runner.mesh.ray_parallel=2"],
           tmp_path, {})
    from yanerf_tpu_torch import run as port_run

    alone = port_run.main([*run[2:], "--output_dir", str(tmp_path / "one"), *options])
    two = tmp_path / "two" / "version_0"
    assert (two / "run.log").exists() and not (tmp_path / "two" / "version_1").exists()
    assert "World size: 2; mesh: {'data': 1, 'rays': 2}" in (two / "run.log").read_text()
    assert sorted(p.name for p in (two / "ckpts").iterdir()) == sorted(
        p.name for p in (alone["output_dir"] / "ckpts").iterdir())
    test = json.loads((two / "test_stats.json").read_text().splitlines()[-1])
    assert len((two / "test_stats.json").read_text().splitlines()) == 1  # written once, by the main process
    for key, value in alone["test_stats"].items():
        assert abs(test[f"test_{key}"] - value) <= TOL, key
