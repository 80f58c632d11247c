"""Smoke run of yanerf_tpu_torch on one NVIDIA GPU: build, check, serve.

    python3 chip_smoke.py

Phases, each printing its numbers on a line of its own with the card's
name and power limit:
  1. build   compile every kernel of the serving path from the sources in
             this checkout (one nvcc per source, all started together);
  2. kernel  hold each kernel against its plain PyTorch version at the
             shapes the serving path gives it, and time both;
  3. serve   build the service from configs/nerf/lego_proposal.yml with
             the NeRF-MLP kernel on (seeded random weights), start the
             HTTP server on 127.0.0.1, and answer GET /render, POST /render
             and GET /health at 800x800; every kernel must have been
             launched, the NeRF-MLP kernel exactly 313 times per frame;
  4. frame   render one frame with the kernel and again with its plain
             version; the PSNR between the two must reach 40 dB.

Any failure exits non-zero. Imports nothing of JAX or of yanerf_tpu. The
last two lines are the kernels' JSON record and the result:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import io
import json
import math
import subprocess
import sys
import threading
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from unittest import mock

REPO = Path(__file__).resolve().parent
CONFIG = REPO / "configs" / "nerf" / "lego_proposal.yml"
CFG_OPTIONS = {"pipeline.model.2.use_pallas": True}
PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 (NVIDIA data sheet)
PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
FRAMES_PER_RUN = 2  # frames rendered in the serve phase (GET and POST /render)
CHUNKS_PER_FRAME = 313  # ceil(800 * 800 * 64 / 131072)
KERNEL_ATOL = 1e-2  # bf16: sums taken in another order can flip one bf16 rounding (2^-8) of a hidden activation
KERNEL_RTOL = 1e-2
MIN_FRAME_PSNR = 40.0


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def say(card_line: str, phase: str, **numbers) -> None:
    print(json.dumps({"phase": phase, "card": card_line, **numbers}), flush=True)


def time_ms(torch, fn, iters: int = 20) -> float:
    """Mean device time of ``fn`` over ``iters`` launches (CUDA events, after warm-up)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    import numpy as np
    from PIL import Image

    from yanerf_tpu_torch.ops.kernels import nerf_mlp_fwd as K
    from yanerf_tpu_torch.serve import CAM_CALIBRATION, create_server, orbit_pose, service_from_config
    from yanerf_tpu_torch.utils import Config

    card_line = card()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. build: one nvcc per kernel source, all started together
    kernels = {"nerf_mlp_fwd": K}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(kernels)) as pool:
        build_s = dict(zip(kernels, pool.map(lambda mod: mod.load(), kernels.values())))
    say(card_line, "build", seconds=time.perf_counter() - t0, per_kernel_s=build_s,
        ptxas={name: mod.build_report() for name, mod in kernels.items()})

    cfg = Config.fromfile(str(CONFIG))
    cfg.merge_from_dict(CFG_OPTIONS)
    service = service_from_config(cfg, checkpoint=None, device="cuda", seed=0)
    nerf_mlp = service._pipeline.implicit_functions[-1]
    if not nerf_mlp.use_pallas:
        raise SystemExit("the config override did not turn the NeRF-MLP kernel on")
    packed = nerf_mlp.packed_weights()

    # 2. kernel vs plain version at one eval chunk: 2045 rays x 32 points
    gen = torch.Generator().manual_seed(1)
    n_rays, pts_per_ray = 2045, 32
    n_pts = n_rays * pts_per_ray
    points = (torch.rand(n_pts, 3, generator=gen) * 3.0 - 1.5).cuda()
    dirs = torch.randn(n_rays, 3, generator=gen).cuda()
    launches_before = K.launches
    out = K.nerf_mlp_fwd(packed, points, dirs, pts_per_ray)
    torch.cuda.synchronize()
    ref = K.nerf_mlp_fwd_plain(packed, points, dirs, pts_per_ray)
    err = (out - ref).abs()
    max_abs_err = float(err.max())
    if not bool(torch.isfinite(out).all()) or bool((err > KERNEL_ATOL + KERNEL_RTOL * ref.abs()).any()):
        raise SystemExit(f"nerf_mlp_fwd disagrees with its plain version: max abs err {max_abs_err}")
    kernel_ms = time_ms(torch, lambda: K.nerf_mlp_fwd(packed, points, dirs, pts_per_ray))
    plain_ms = time_ms(torch, lambda: K.nerf_mlp_fwd_plain(packed, points, dirs, pts_per_ray))
    K.launches = launches_before  # comparison launches do not count
    flops = K.flops_per_point(packed) * n_pts
    io_bytes = points.numel() * 4 + dirs.numel() * 4 + out.numel() * 4 + K.weight_bytes(packed)
    ops_ms, bytes_ms = flops / PEAK_BF16_FLOPS * 1e3, io_bytes / PEAK_BYTES_PER_S * 1e3
    bound_ms = max(ops_ms, bytes_ms)
    say(
        card_line, "kernel", name="nerf_mlp_fwd", points=n_pts, max_abs_err=max_abs_err,
        atol=KERNEL_ATOL, rtol=KERNEL_RTOL, kernel_us=kernel_ms * 1e3, plain_us=plain_ms * 1e3,
        bound_us=bound_ms * 1e3, gflop=flops / 1e9, achieved_tflops=flops / kernel_ms / 1e9,
    )

    # 3. serve: the port's HTTP server answers at full width (after one
    # warm-up frame, so that the latencies are those of a running server)
    t = time.perf_counter()
    service.warmup()
    warmup_s = time.perf_counter() - t
    server = create_server(service, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    h, w = service.image_hw
    latencies = {}
    try:
        K.launches = 0
        t = time.perf_counter()
        with urllib.request.urlopen(f"{url}/render?theta=30&phi=-30&radius=4", timeout=600) as resp:
            png, png_type = resp.read(), resp.headers["Content-Type"]
        latencies["GET /render png"] = time.perf_counter() - t
        pose = orbit_pose(120.0, -25.0, 4.0)
        body = json.dumps({"pose": pose.tolist(), "format": "json"}).encode()
        req = urllib.request.Request(f"{url}/render", data=body, headers={"Content-Type": "application/json"})
        t = time.perf_counter()
        with urllib.request.urlopen(req, timeout=600) as resp:
            grid = json.loads(resp.read())
        latencies["POST /render json"] = time.perf_counter() - t
        launches = {"nerf_mlp_fwd": K.launches}
        t = time.perf_counter()
        with urllib.request.urlopen(f"{url}/health", timeout=60) as resp:
            health = json.loads(resp.read())
        latencies["GET /health"] = time.perf_counter() - t
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)
    img = np.asarray(Image.open(io.BytesIO(png)))
    arr = np.asarray(grid["data"], dtype=np.float64)
    checks = {
        "png_shape": png_type == "image/png" and img.shape == (h, w, 3),
        "json_shape": grid["shape"] == [h, w, 3] and arr.shape == (h, w, 3),
        "json_finite": bool(np.isfinite(arr).all()),
        "health": health["status"] == "ok" and health["renders"] >= FRAMES_PER_RUN,
        "launches_per_frame": launches["nerf_mlp_fwd"] == CHUNKS_PER_FRAME * FRAMES_PER_RUN,
    }
    say(card_line, "serve", warmup_s=warmup_s, latency_s=latencies, launches=launches, frame_hw=[h, w], checks=checks,
        server_mean_render_s=health["mean_render_s"])
    if not all(checks.values()):
        raise SystemExit(f"serve phase failed: {checks}")

    # 4. frame check: the kernel's frame against the plain version's, same pose
    pose_world = (orbit_pose(30.0, -30.0, 4.0) @ CAM_CALIBRATION)[:3, :4].astype(np.float32)
    t = time.perf_counter()
    rgb_kernel, _ = service.render(pose_world, service.default_focal)
    kernel_frame_s = time.perf_counter() - t
    with mock.patch.object(K, "nerf_mlp_fwd", K.nerf_mlp_fwd_plain):
        t = time.perf_counter()
        rgb_plain, _ = service.render(pose_world, service.default_focal)
        plain_frame_s = time.perf_counter() - t
    mse = float(np.mean((rgb_kernel.astype(np.float64) - rgb_plain) ** 2))
    psnr = -10.0 * math.log10(max(mse, 1e-20))
    say(card_line, "frame", psnr_db=psnr, min_psnr_db=MIN_FRAME_PSNR, kernel_frame_s=kernel_frame_s,
        plain_frame_s=plain_frame_s, mean_rgb=float(rgb_kernel.mean()))
    if not (psnr >= MIN_FRAME_PSNR and np.isfinite(rgb_kernel).all()):
        raise SystemExit(f"kernel frame vs plain frame: {psnr:.2f} dB < {MIN_FRAME_PSNR} dB")

    record = {
        "kernels": [
            {
                "name": "nerf_mlp_fwd",
                "route": "cuda",
                "source": "yanerf_tpu_torch/csrc/nerf_mlp_fwd.cu",
                "replaces": "yanerf_tpu/ops/pallas/nerf_mlp_kernel.py:154",
                "launches": launches["nerf_mlp_fwd"],
                "max_abs_err": max_abs_err,
                "ms": kernel_ms,
                "plain_ms": plain_ms,
                "bound_ms": bound_ms,
                "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
                "library_ms": None,
            }
        ]
    }
    print(json.dumps(record))
    print(card_line)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
