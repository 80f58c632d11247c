"""Where one train step's time goes on the card: a torch.profiler breakdown.

    python -m yanerf_tpu_torch.profile_training [--config configs/nerf/lego.yml] [--steps 20] [--eager]
        [--steps_per_call 20] [--data_dir DIR [--batch N]] [--cfg_options key=value ...]

Builds the pipeline of ``--config`` (``configs/nerf/lego_proposal.yml`` by
default) with the fused NeRF-MLP kernels on for training on every NeRFMLP
of the config (``use_pallas_train``; ``--eager`` turns them off; a config
with no NeRFMLP runs its models' own paths: ``synth800_mip.yml`` prints
``"kernels": []``, ``lego_ngp.yml`` K4 and K5, which the device picks), seeded
random weights, Adam with the config's schedule, and one
random 800x800 image as the batch (``--data_dir``: the first item of the
config's train dataset there, an LLFF view with its per-image bounds, say,
or ``--batch`` items spread evenly over it, one view of each of four scenes
of a multi-scene dataset at ``--batch 4``; ``--cfg_options`` overrides the
config). A latent NeRFMLP runs its eager path whatever the switch says, so
its config prints ``"kernels": []`` too. It takes three warm-up steps, times
``--steps`` steps on the host clock (ending in a synchronize), then profiles
one more and prints one JSON line: ms per step, train rays/s, the peak
device memory from the first warm-up step on, device busy time (kernels and copies), the device's
idle share, kernel launches per step and the device time of the top kernels. The optimizer's range
annotation also lands on the device timeline: it is left out of the busy time and given on its own
(``annotation_device_s``). With
``--steps_per_call K > 1`` the steps run as the CLI's fused dispatches
(``make_train_step_fused``: one captured CUDA graph replayed K times, the
image as a one-frame device cache): one warm-up dispatch (the capture),
``--steps`` rounded down to whole dispatches timed, one dispatch profiled,
its numbers given per step. Needs a GPU; prints the card's name and power
limit beside the numbers.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch

from .datasets import DATASETS, stack_batch
from .datasets.blender import BlenderDatasetWrapper
from .pipelines import PIPELINES, hash_grid_kernels, set_nerf_mlp_option
from .runners import TrainState, create_optimizer, make_train_step, make_train_step_fused
from .serve import CAM_CALIBRATION, orbit_pose
from .utils import Config
from .utils.config import DictAction

CONFIG = "configs/nerf/lego_proposal.yml"
TOP_KERNELS = 12


def training_config(path: str, eager: bool = False, options=None):
    """The config of ``path`` (merged with ``options``) with the fused NeRF-MLP kernels on (off with ``eager``),
    and the kernels a step launches: K1 / K3 on a NeRFMLP, K4 / K5 on a HashGridNeRF."""
    cfg = Config.fromfile(path)
    if options:
        cfg.merge_from_dict(options)
    keys = set_nerf_mlp_option(cfg, "use_pallas_train", not eager)
    models = cfg.pipeline.model if isinstance(cfg.pipeline.model, (list, tuple)) else [cfg.pipeline.model]
    on_kernels = any(m["type"] == "NeRFMLP" and m.get("latent_dim", 0) == 0 and m.get("input_xyz", True)
                     for m in models)
    nerf_mlp = ["nerf_mlp_fwd", "nerf_mlp_bwd"] if keys and on_kernels and not eager else []
    return cfg, nerf_mlp + hash_grid_kernels(cfg)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--config", default=CONFIG)
    parser.add_argument("--steps", type=int, default=20, help="steps timed on the host clock")
    parser.add_argument("--eager", action="store_true", help="the eager NeRF-MLP instead of the fused kernels")
    parser.add_argument("--steps_per_call", type=int, default=1,
                        help="K > 1: fused dispatches of K steps (a captured CUDA graph replayed K times)")
    parser.add_argument("--data_dir", default=None, help="take the batch from the config's train dataset here")
    parser.add_argument("--batch", type=int, default=1, help="with --data_dir: items spread evenly over the dataset")
    parser.add_argument("--cfg_options", nargs="+", action=DictAction)
    args = parser.parse_args(argv)

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    cfg, nerf_mlp_kernels = training_config(args.config, args.eager, args.cfg_options)
    device = torch.device("cuda")
    pipeline = PIPELINES.build(cfg.pipeline, generator=torch.Generator().manual_seed(0), device=device)
    state = TrainState(pipeline=pipeline, optimizer=create_optimizer(cfg.runner, pipeline), step=0)
    step = make_train_step(pipeline, cfg.runner, seed=0)
    h, w = pipeline.render_image_height, pipeline.render_image_width
    if args.data_dir:
        dataset = DATASETS.build(dict(cfg.datasets[0], base_dir=args.data_dir))
        wrapper = dataset.data_wrapper
        items = [dataset[int(i)] for i in np.linspace(0, len(dataset) - 1, args.batch)]
        batch = {k: torch.as_tensor(v, device=device) for k, v in wrapper(*stack_batch(items))._asdict().items()}
    else:
        gen = torch.Generator(device=device).manual_seed(1)
        pose = orbit_pose(30.0, -30.0, 4.0) @ CAM_CALIBRATION
        wrapper = BlenderDatasetWrapper
        batch = {
            "poses": torch.as_tensor(pose, dtype=torch.float32, device=device)[None],
            "focal_lengths": torch.full((1, 1), 1111.0, device=device),
            "image_rgb": torch.rand(1, h, w, 3, generator=gen, device=device),
        }
    n_rays = cfg.pipeline.ray_sampler.n_rays_per_image_sampled_from_mask
    per_call, capture_s = 1, None
    run = lambda: step(state, batch)  # noqa: E731
    if args.steps_per_call > 1:
        per_call = args.steps_per_call
        fused = make_train_step_fused(pipeline, dict(cfg.runner, steps_per_call=per_call), 0, wrapper)
        arrays = tuple(batch[k] for k in wrapper._fields)
        rows = np.tile(np.arange(len(batch["poses"])), (per_call, 1))
        run = lambda: fused(state, arrays, rows)  # noqa: E731
    torch.cuda.reset_peak_memory_stats(device)  # the warm-up counts: the capture allocates the graph's pool
    for _ in range(max(1, 3 // per_call)):
        run()
    torch.cuda.synchronize()
    if per_call > 1:
        capture_s = fused.capture_s

    calls = max(1, args.steps // per_call)
    t = time.perf_counter()
    for _ in range(calls):
        run()
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t) / (calls * per_call)
    peak_gb = torch.cuda.max_memory_allocated(device) / 1e9

    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        t = time.perf_counter()
        run()
        torch.cuda.synchronize()
        profiled_s = (time.perf_counter() - t) / per_call

    on_device = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    kernels = [e for e in on_device if not getattr(e, "is_user_annotation", False)]
    busy_us = sum(e.device_time for e in kernels) / per_call
    annotation_us = sum(e.device_time for e in on_device if getattr(e, "is_user_annotation", False)) / per_call
    by_name = {}
    for e in kernels:
        total, count = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (total + e.device_time, count + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:TOP_KERNELS]
    print(
        json.dumps(
            {
                "card": card,
                "config": args.config,
                "kernels": nerf_mlp_kernels,
                "steps_per_call": per_call,
                "batch": len(batch["poses"]),
                "capture_s": capture_s,
                "ms_per_step": step_s * 1e3,
                "train_rays_per_s": n_rays * len(batch["poses"]) / step_s,
                "peak_memory_gb": peak_gb,
                "profiled_step_s": profiled_s,
                "device_busy_s": busy_us / 1e6,
                "annotation_device_s": annotation_us / 1e6,
                "device_idle_share": 1.0 - busy_us / 1e6 / profiled_s,
                "device_kernels_per_step": len(kernels) / per_call,
                "top_kernels": [
                    {"name": name[:80], "device_s": total / 1e6 / per_call, "count": count / per_call,
                     "share_of_busy": total / per_call / busy_us}
                    for name, (total, count) in top
                ],
            }
        )
    )


if __name__ == "__main__":
    main()
