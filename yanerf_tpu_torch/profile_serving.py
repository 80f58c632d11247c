"""Where one served frame's time goes on the card: a torch.profiler breakdown.

    python -m yanerf_tpu_torch.profile_serving [--config configs/nerf/lego.yml] [--frames 3]

Builds the service of ``--config`` (``configs/nerf/lego_proposal.yml`` by
default) with the NeRF-MLP kernel on for every NeRFMLP of the config
(seeded random weights; a config with no NeRFMLP, such as
``synth800_mip.yml`` or ``lego_ngp.yml``, runs its models' own eager
paths and prints ``"kernels": []``), renders one warm-up frame, times
``--frames`` frames on the host clock, then profiles one more and prints
one JSON line: frame seconds, device busy time, the device's idle share,
kernel launches per frame and the device time of the top kernels. Needs a
GPU; prints the card's name and power limit beside the numbers.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch

from .pipelines import set_nerf_mlp_option
from .serve import CAM_CALIBRATION, orbit_pose, service_from_config
from .utils import Config

CONFIG = "configs/nerf/lego_proposal.yml"
TOP_KERNELS = 12


def serving_config(path: str):
    """The config of ``path`` with the NeRF-MLP kernel on, and the kernels the frame launches (none without a NeRFMLP)."""
    cfg = Config.fromfile(path)
    return cfg, ["nerf_mlp_fwd"] if set_nerf_mlp_option(cfg, "use_pallas", True) else []


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--config", default=CONFIG)
    parser.add_argument("--frames", type=int, default=3, help="frames timed on the host clock")
    args = parser.parse_args(argv)

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    cfg, nerf_mlp_kernels = serving_config(args.config)
    service = service_from_config(cfg, device="cuda", seed=0)
    pose = (orbit_pose(30.0, -30.0, 4.0) @ CAM_CALIBRATION)[:3, :4].astype(np.float32)
    service.render(pose, service.default_focal)

    frame_s = []
    for _ in range(args.frames):
        t = time.perf_counter()
        service.render(pose, service.default_focal)
        frame_s.append(time.perf_counter() - t)

    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        t = time.perf_counter()
        service.render(pose, service.default_focal)
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
                "config": args.config,
                "kernels": nerf_mlp_kernels,
                "frame_s": frame_s,
                "profiled_frame_s": profiled_s,
                "device_busy_s": busy_us / 1e6,
                "device_idle_share": 1.0 - busy_us / 1e6 / profiled_s,
                "device_kernels_per_frame": len(kernels),
                "top_kernels": [
                    {"name": name[:80], "device_s": total / 1e6, "count": count, "share_of_busy": total / busy_us}
                    for name, (total, count) in top
                ],
            }
        )
    )


if __name__ == "__main__":
    main()
