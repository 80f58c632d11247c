"""Where one train step's time goes on the card: a torch.profiler breakdown.

    python -m yanerf_tpu_torch.profile_training [--steps 20] [--eager]

Builds the pipeline of ``configs/nerf/lego_proposal.yml`` with the fused
NeRF-MLP kernels on for training (``use_pallas_train``; ``--eager`` turns
them off), seeded random weights, Adam with the config's schedule, and one
random 800x800 image as the batch. It takes three warm-up steps, times
``--steps`` steps on the host clock (ending in a synchronize), then profiles
one more and prints one JSON line: ms per step, train rays/s, device busy
time, the device's idle share, kernel launches per step and the device time
of the top kernels. Needs a GPU; prints the card's name and power limit
beside the numbers.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import torch

from .pipelines import PIPELINES
from .runners import TrainState, create_optimizer, make_train_step
from .serve import CAM_CALIBRATION, orbit_pose
from .utils import Config

CONFIG = "configs/nerf/lego_proposal.yml"
TOP_KERNELS = 12


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--steps", type=int, default=20, help="steps timed on the host clock")
    parser.add_argument("--eager", action="store_true", help="the eager NeRF-MLP instead of the fused kernels")
    args = parser.parse_args(argv)

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    cfg = Config.fromfile(CONFIG)
    cfg.merge_from_dict({"pipeline.model.2.use_pallas_train": not args.eager})
    device = torch.device("cuda")
    pipeline = PIPELINES.build(cfg.pipeline, generator=torch.Generator().manual_seed(0), device=device)
    state = TrainState(pipeline=pipeline, optimizer=create_optimizer(cfg.runner, pipeline), step=0)
    step = make_train_step(pipeline, cfg.runner, seed=0)
    h, w = pipeline.render_image_height, pipeline.render_image_width
    gen = torch.Generator(device=device).manual_seed(1)
    pose = orbit_pose(30.0, -30.0, 4.0) @ CAM_CALIBRATION
    batch = {
        "poses": torch.as_tensor(pose, dtype=torch.float32, device=device)[None],
        "focal_lengths": torch.full((1, 1), 1111.0, device=device),
        "image_rgb": torch.rand(1, h, w, 3, generator=gen, device=device),
    }
    n_rays = cfg.pipeline.ray_sampler.n_rays_per_image_sampled_from_mask
    for _ in range(3):
        step(state, batch)
    torch.cuda.synchronize()

    t = time.perf_counter()
    for _ in range(args.steps):
        step(state, batch)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t) / args.steps

    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        t = time.perf_counter()
        step(state, batch)
        torch.cuda.synchronize()
        profiled_s = time.perf_counter() - t

    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.device_time for e in kernels)
    by_name = {}
    for e in kernels:
        total, count = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (total + e.device_time, count + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:TOP_KERNELS]
    print(
        json.dumps(
            {
                "card": card,
                "nerf_mlp": "eager" if args.eager else "fused kernels (K1 forward, K3 backward)",
                "ms_per_step": step_s * 1e3,
                "train_rays_per_s": n_rays / step_s,
                "profiled_step_s": profiled_s,
                "device_busy_s": busy_us / 1e6,
                "device_idle_share": 1.0 - busy_us / 1e6 / profiled_s,
                "device_kernels_per_step": len(kernels),
                "top_kernels": [
                    {"name": name[:80], "device_s": total / 1e6, "count": count, "share_of_busy": total / busy_us}
                    for name, (total, count) in top
                ],
            }
        )
    )


if __name__ == "__main__":
    main()
