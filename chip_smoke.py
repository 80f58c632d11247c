"""Smoke run of yanerf_tpu_torch on one NVIDIA GPU: build, check, serve, train.

    python3 chip_smoke.py

Phases, each printing its numbers on a line of its own with the card's
name and power limit:
  1. build   compile every kernel of the serving and training paths from
             the sources in this checkout (one nvcc per source, all started
             together);
  2. kernel  hold each kernel against its plain PyTorch version at the
             shapes the paths give it, and time both: the NeRF-MLP forward
             (K1) at one eval chunk (2045 rays x 32 points) and at one train
             step (4096 rays x 48 points), the NeRF-MLP backward (K3) at one
             train step;
  3. serve   build the service from configs/nerf/lego_proposal.yml with
             the NeRF-MLP kernel on (seeded random weights), start the
             HTTP server on 127.0.0.1, and answer GET /render, POST /render
             and GET /health at 800x800; K1 must be launched exactly 313
             times per frame, K3 never;
  4. frame   render one frame with the kernel and again with its plain
             version; the PSNR between the two must reach 40 dB;
  5. train   write a procedural 800x800 Blender-format scene from a seed
             and train lego_proposal.yml on it at full width through
             ``python -m yanerf_tpu_torch.run`` with
             ``pipeline.model.2.use_pallas_train=True``: K1 and K3 launched
             exactly once per step, the objective finite at every step,
             every parameter moved, the final checkpoint reloads to the
             same parameters, Adam state and step;
  6. step    one train step from the same weights, batch and draws with
             the fused kernels and with the eager model: the objectives
             agree within 1e-2 relative and the NeRF-MLP gradients at a
             cosine >= 0.999 (the two bf16 policies differ: the kernels add
             the bias in float32, the eager model in bf16).

Any failure exits non-zero. Imports nothing of JAX or of yanerf_tpu. The
last three lines are the kernels' JSON record, the card's name and power
limit, and the result:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import tempfile
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
TRAIN_RAYS, TRAIN_PTS = 4096, 48  # lego_proposal's rays per step and final points per ray
# K3 against its plain version, per gradient tensor: the same bf16 roundings at
# the same places, but a hidden cotangent whose float32 sum rounds the other
# way (2^-8) moves the weight-gradient sums it enters, by 1-2% of the largest
# entry depending on the weights (tests/test_torch_cuda_kernels.py)
K3_MIN_COSINE = 0.9999
K3_REL_ATOL = 5e-2  # of the tensor's largest entry
TRAIN_FRAMES, TEST_FRAMES = 4, 1  # 800x800 frames of the procedural scene
TRAIN_STEPS = 32  # 8 epochs of 4 frames
DEVICE = "cuda"
STEP_OBJECTIVE_RTOL = 1e-2
STEP_MIN_GRAD_COSINE = 0.999


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


def sync(torch) -> None:
    if DEVICE == "cuda":
        torch.cuda.synchronize()


def bound(flops: float, io_bytes: float):
    """(bound ms, bound_by): the larger of the operations' and the bytes' least times."""
    ops_ms, bytes_ms = flops / PEAK_BF16_FLOPS * 1e3, io_bytes / PEAK_BYTES_PER_S * 1e3
    return max(ops_ms, bytes_ms), ("operations" if ops_ms >= bytes_ms else "bytes")


def cosine(torch, a, b) -> float:
    a, b = a.double().flatten(), b.double().flatten()
    return float(a @ b / torch.clamp(a.norm() * b.norm(), min=1e-30))


def check_k1(torch, K1, packed, n_rays: int, pts_per_ray: int, gen):
    """K1 against its plain version at ``n_rays`` x ``pts_per_ray``; returns its numbers."""
    n_pts = n_rays * pts_per_ray
    points = (torch.rand(n_pts, 3, generator=gen) * 3.0 - 1.5).cuda()
    dirs = torch.randn(n_rays, 3, generator=gen).cuda()
    out = K1.nerf_mlp_fwd(packed, points, dirs, pts_per_ray)
    torch.cuda.synchronize()
    ref = K1.nerf_mlp_fwd_plain(packed, points, dirs, pts_per_ray)
    err = (out - ref).abs()
    max_abs_err = float(err.max())
    if not bool(torch.isfinite(out).all()) or bool((err > KERNEL_ATOL + KERNEL_RTOL * ref.abs()).any()):
        raise SystemExit(f"nerf_mlp_fwd disagrees with its plain version at {n_pts} points: max abs err {max_abs_err}")
    kernel_ms = time_ms(torch, lambda: K1.nerf_mlp_fwd(packed, points, dirs, pts_per_ray))
    plain_ms = time_ms(torch, lambda: K1.nerf_mlp_fwd_plain(packed, points, dirs, pts_per_ray))
    flops = K1.flops_per_point(packed) * n_pts
    bound_ms, bound_by = bound(flops, points.numel() * 4 + dirs.numel() * 4 + out.numel() * 4 + K1.weight_bytes(packed))
    return dict(points=n_pts, max_abs_err=max_abs_err, atol=KERNEL_ATOL, rtol=KERNEL_RTOL, ms=kernel_ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, gflop=flops / 1e9,
                achieved_tflops=flops / kernel_ms / 1e9)


def check_k3(torch, K3, nerf_mlp, packed, gen):
    """K3 against its plain version at one train step's shapes; returns its numbers."""
    n_pts = TRAIN_RAYS * TRAIN_PTS
    points = (torch.rand(n_pts, 3, generator=gen) * 3.0 - 1.5).cuda()
    dirs = torch.randn(TRAIN_RAYS, 3, generator=gen).cuda()
    cot = (torch.randn(n_pts, 1 + packed.color_dim, generator=gen) / n_pts).cuda()
    gw, gb = K3.nerf_mlp_bwd(packed, points, dirs, TRAIN_PTS, cot)
    torch.cuda.synchronize()
    again = K3.nerf_mlp_bwd(packed, points, dirs, TRAIN_PTS, cot)
    rw, rb = K3.nerf_mlp_bwd_plain(packed, points, dirs, TRAIN_PTS, cot)
    got_w, got_b = K3.grad_views(packed, gw, gb)
    ref_w, ref_b = K3.grad_views(packed, rw, rb)
    worst_cos, max_abs_err, failures = 1.0, 0.0, []
    for i, (got, ref) in enumerate(zip(got_w + got_b, ref_w + ref_b)):
        cos = cosine(torch, got, ref)
        err = float((got - ref).abs().max())
        allowed = K3_REL_ATOL * float(ref.abs().max())
        worst_cos, max_abs_err = min(worst_cos, cos), max(max_abs_err, err)
        if not bool(torch.isfinite(got).all()) or err > allowed or (cos < K3_MIN_COSINE and allowed > 0.0):
            failures.append(dict(tensor=i, cosine=cos, max_abs_err=err, allowed=allowed))
    h, nl = packed.hidden, packed.n_layers
    skip = next(s for s in packed.input_skips if 0 < s < nl)
    padded_zero = (
        float(got_w[0][nerf_mlp.embedding_dim_xyz :].abs().max()) == 0.0
        and float(got_w[skip][h + nerf_mlp.embedding_dim_xyz :].abs().max()) == 0.0
        and float(got_w[nl + 2][h + nerf_mlp.embedding_dim_dir :].abs().max()) == 0.0
    )
    deterministic = bool(torch.equal(gw, again[0]) and torch.equal(gb, again[1]))
    if failures or not padded_zero or not deterministic:
        raise SystemExit(f"nerf_mlp_bwd disagrees with its plain version: {failures}, padded rows zero "
                         f"{padded_zero}, same result twice {deterministic}")
    kernel_ms = time_ms(torch, lambda: K3.nerf_mlp_bwd(packed, points, dirs, TRAIN_PTS, cot), iters=10)
    plain_ms = time_ms(torch, lambda: K3.nerf_mlp_bwd_plain(packed, points, dirs, TRAIN_PTS, cot), iters=5)
    flops = K3.flops_per_point(packed) * n_pts
    bound_ms, bound_by = bound(flops, K3.io_bytes(packed, n_pts, TRAIN_RAYS))
    return dict(points=n_pts, max_abs_err=max_abs_err, worst_cosine=worst_cos, min_cosine=K3_MIN_COSINE,
                rel_atol=K3_REL_ATOL, padded_rows_zero=padded_zero, deterministic=deterministic, ms=kernel_ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, gflop=flops / 1e9,
                achieved_tflops=flops / kernel_ms / 1e9)


def train(torch, K1, K3, scene: Path, out_dir: Path):
    """Train lego_proposal.yml on ``scene`` through ``yanerf_tpu_torch.run``; returns its checks and numbers."""
    import yanerf_tpu_torch.runners as runners
    from yanerf_tpu_torch import run
    from yanerf_tpu_torch.pipelines import PIPELINES
    from yanerf_tpu_torch.utils import Config

    argv = ["--config", str(CONFIG), "--device", DEVICE, "--output_dir", str(out_dir), "--cfg_options",
            "pipeline.model.2.use_pallas_train=True", f"runner.num_iters={TRAIN_STEPS}",
            *(f"datasets.{i}.base_dir={scene}" for i in range(3))]
    # observe the run: the parameters it starts from and every step's objective
    objectives, initial = [], {}
    make_train_step = runners.make_train_step

    def observed(pipeline, runner_config, seed):
        initial.update({k: p.detach().clone() for k, p in pipeline.named_parameters()})
        step = make_train_step(pipeline, runner_config, seed)

        def wrapped(state, batch, draws=None):
            preds = step(state, batch, draws)
            objectives.append(preds["objective"])
            return preds

        return wrapped

    with mock.patch.object(runners, "make_train_step", observed):
        K1.launches = K3.launches = 0
        t = time.perf_counter()
        result = run.main(argv)
        sync(torch)
        run_s = time.perf_counter() - t
        launches = {"nerf_mlp_fwd": K1.launches, "nerf_mlp_bwd": K3.launches}

    state = result["state"]
    n_steps = state.step
    final = dict(state.pipeline.named_parameters())
    moved = sum(int(not torch.equal(final[k].detach(), v)) for k, v in initial.items())
    objective = torch.cat([o.flatten() for o in objectives]).float().cpu()

    cfg = Config.fromfile(str(result["output_dir"] / "config.yml"))
    fresh = PIPELINES.build(cfg.pipeline, device=DEVICE)
    reloaded = runners.TrainState(pipeline=fresh, optimizer=runners.create_optimizer(cfg.runner, fresh), step=0)
    runners.load_checkpoint(result["checkpoint"], reloaded)
    same_params = all(torch.equal(p.detach(), final[k].detach()) for k, p in fresh.named_parameters())
    ours, theirs = reloaded.optimizer.state_dict()["state"], state.optimizer.state_dict()["state"]
    same_adam = ours.keys() == theirs.keys() and all(
        torch.equal(ours[i]["exp_avg"].cpu(), theirs[i]["exp_avg"].cpu()) for i in theirs
    )
    step_s = [s["step_s"] for s in result["train_stats"] if "step_s" in s]
    ms_per_step = 1e3 * sorted(step_s)[len(step_s) // 2]
    checks = {
        "steps": n_steps == TRAIN_STEPS == len(objectives),
        "k3_once_per_step": launches["nerf_mlp_bwd"] == n_steps,
        # the test frame at the end renders with the eager model: the config
        # turns the kernel on for training only (use_pallas_train)
        "k1_once_per_step": launches["nerf_mlp_fwd"] == n_steps,
        "objective_finite": bool(torch.isfinite(objective).all()),
        "params_moved": moved == len(initial),
        "checkpoint_reloads": same_params and same_adam and reloaded.step == n_steps,
        "test_metrics_finite": all(math.isfinite(v) for v in result["test_stats"].values()),
    }
    numbers = dict(
        steps=n_steps, run_s=run_s, ms_per_step=ms_per_step, step_s_per_epoch=step_s,
        train_rays_per_s=TRAIN_RAYS / ms_per_step * 1e3, launches=launches,
        objective_first=float(objective[0]), objective_last=float(objective[-1]),
        params_moved=f"{moved}/{len(initial)}", test_stats=result["test_stats"], checks=checks,
    )
    return numbers, launches


def step_equivalence(torch, scene: Path):
    """One train step with the fused kernels and with the eager model, same weights, batch and draws."""
    from yanerf_tpu_torch.datasets import BlenderDataset
    from yanerf_tpu_torch.pipelines import PIPELINES
    from yanerf_tpu_torch.runners import TrainState, create_optimizer, make_train_step, prepare_batch
    from yanerf_tpu_torch.utils import Config

    cfg = Config.fromfile(str(CONFIG))
    cfg.merge_from_dict({"pipeline.model.2.use_pallas_train": True})
    dataset = BlenderDataset(scene, "train")
    batch = prepare_batch(tuple(x[None] for x in dataset[0]), dataset.data_wrapper, torch.device(DEVICE))
    # the draws of one step, fed to both: pixel indices, strata jitter, the u's of both proposal passes
    sampler, renderer = cfg.pipeline.ray_sampler, cfg.pipeline.renderer
    n_rays = sampler.n_rays_per_image_sampled_from_mask
    gen = torch.Generator(device=DEVICE).manual_seed(3)
    draws = {
        "pixel_idx": torch.randint(0, dataset.H * dataset.W, (1, n_rays), generator=gen, device=DEVICE),
        "strata_u": torch.rand(1, n_rays, 1, sampler.n_pts_per_ray_training, generator=gen, device=DEVICE),
        "pdf_u": [
            torch.rand(1, n_rays, 1, n, generator=gen, device=DEVICE)
            for n in [*renderer.n_pts_per_ray_intermediate_training, renderer.n_pts_per_ray_final_training]
        ],
    }
    kernel_pipe = PIPELINES.build(cfg.pipeline, generator=torch.Generator().manual_seed(5), device=DEVICE)
    eager_pipe = PIPELINES.build(cfg.pipeline, generator=torch.Generator().manual_seed(5), device=DEVICE)
    eager_pipe.load_state_dict(kernel_pipe.state_dict())
    eager_pipe.implicit_functions[2].use_pallas_train = False
    out = {}
    for name, pipe in (("kernels", kernel_pipe), ("eager", eager_pipe)):
        state = TrainState(pipeline=pipe, optimizer=create_optimizer(cfg.runner, pipe), step=0)
        preds = make_train_step(pipe, cfg.runner, 0)(state, batch, draws)
        out[name] = (float(preds["objective"].mean()), [p.grad for p in pipe.implicit_functions[2].parameters()])
    (obj_k, tensors_k), (obj_e, tensors_e) = out["kernels"], out["eager"]
    grad_cos = cosine(torch, torch.cat([g.flatten() for g in tensors_k]), torch.cat([g.flatten() for g in tensors_e]))
    checks = {
        "objective": abs(obj_k - obj_e) <= STEP_OBJECTIVE_RTOL * abs(obj_e) and math.isfinite(obj_k),
        "nerf_mlp_grad_cosine": grad_cos >= STEP_MIN_GRAD_COSINE,
    }
    return dict(objective_kernels=obj_k, objective_eager=obj_e, objective_rtol=STEP_OBJECTIVE_RTOL,
                nerf_mlp_grad_cosine=grad_cos, min_grad_cosine=STEP_MIN_GRAD_COSINE,
                worst_tensor_cosine=min(cosine(torch, a, b) for a, b in zip(tensors_k, tensors_e)), checks=checks)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    import numpy as np

    from yanerf_tpu_torch.ops.kernels import nerf_mlp_bwd as K3
    from yanerf_tpu_torch.ops.kernels import nerf_mlp_fwd as K1
    from yanerf_tpu_torch.serve import CAM_CALIBRATION, create_server, orbit_pose, service_from_config
    from yanerf_tpu_torch.synth_scene import write_scene
    from yanerf_tpu_torch.utils import Config
    from yanerf_tpu_torch.utils.images import decode_png

    card_line = card()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. build: one nvcc per kernel source, all started together
    kernels = {"nerf_mlp_fwd": K1, "nerf_mlp_bwd": K3}
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

    # 2. kernels vs plain versions: K1 at one eval chunk and at one train
    # step, K3 at one train step; these launches do not count
    gen = torch.Generator().manual_seed(1)
    k1 = check_k1(torch, K1, packed, 2045, 32, gen)
    say(card_line, "kernel", name="nerf_mlp_fwd", shape="eval chunk, 2045 rays x 32 points", **k1)
    k1_train = check_k1(torch, K1, packed, TRAIN_RAYS, TRAIN_PTS, gen)
    say(card_line, "kernel", name="nerf_mlp_fwd", shape="train step, 4096 rays x 48 points", **k1_train)
    k3 = check_k3(torch, K3, nerf_mlp, packed, gen)
    say(card_line, "kernel", name="nerf_mlp_bwd", shape="train step, 4096 rays x 48 points", **k3)

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
        K1.launches = K3.launches = 0
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
        serve_launches = {"nerf_mlp_fwd": K1.launches, "nerf_mlp_bwd": K3.launches}
        t = time.perf_counter()
        with urllib.request.urlopen(f"{url}/health", timeout=60) as resp:
            health = json.loads(resp.read())
        latencies["GET /health"] = time.perf_counter() - t
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)
    img = decode_png(png)
    arr = np.asarray(grid["data"], dtype=np.float64)
    checks = {
        "png_shape": png_type == "image/png" and img.shape == (h, w, 3),
        "json_shape": grid["shape"] == [h, w, 3] and arr.shape == (h, w, 3),
        "json_finite": bool(np.isfinite(arr).all()),
        "health": health["status"] == "ok" and health["renders"] >= FRAMES_PER_RUN,
        "launches_per_frame": serve_launches == {"nerf_mlp_fwd": CHUNKS_PER_FRAME * FRAMES_PER_RUN, "nerf_mlp_bwd": 0},
    }
    say(card_line, "serve", warmup_s=warmup_s, latency_s=latencies, launches=serve_launches, frame_hw=[h, w],
        checks=checks, server_mean_render_s=health["mean_render_s"])
    if not all(checks.values()):
        raise SystemExit(f"serve phase failed: {checks}")

    # 4. frame check: the kernel's frame against the plain version's, same pose
    pose_world = (orbit_pose(30.0, -30.0, 4.0) @ CAM_CALIBRATION)[:3, :4].astype(np.float32)
    t = time.perf_counter()
    rgb_kernel, _ = service.render(pose_world, service.default_focal)
    kernel_frame_s = time.perf_counter() - t
    with mock.patch.object(K1, "nerf_mlp_fwd", K1.nerf_mlp_fwd_plain):
        t = time.perf_counter()
        rgb_plain, _ = service.render(pose_world, service.default_focal)
        plain_frame_s = time.perf_counter() - t
    mse = float(np.mean((rgb_kernel.astype(np.float64) - rgb_plain) ** 2))
    psnr = -10.0 * math.log10(max(mse, 1e-20))
    say(card_line, "frame", psnr_db=psnr, min_psnr_db=MIN_FRAME_PSNR, kernel_frame_s=kernel_frame_s,
        plain_frame_s=plain_frame_s, mean_rgb=float(rgb_kernel.mean()))
    if not (psnr >= MIN_FRAME_PSNR and np.isfinite(rgb_kernel).all()):
        raise SystemExit(f"kernel frame vs plain frame: {psnr:.2f} dB < {MIN_FRAME_PSNR} dB")
    del service

    # 5. train and 6. step equivalence, on a scene written from a seed
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        t = time.perf_counter()
        scene = write_scene(Path(tmp) / "scene", hw=800, n_train=TRAIN_FRAMES, n_val=1, n_test=TEST_FRAMES, seed=0)
        scene_s = time.perf_counter() - t
        numbers, train_launches = train(torch, K1, K3, scene, Path(tmp) / "results")
        say(card_line, "train", scene_write_s=scene_s, **numbers)
        if not all(numbers["checks"].values()):
            raise SystemExit(f"train phase failed: {numbers['checks']}")
        step = step_equivalence(torch, scene)
        say(card_line, "step", **step)
        if not all(step["checks"].values()):
            raise SystemExit(f"step equivalence failed: {step['checks']}")

    def entry(name, source, replaces, numbers, launches_by_path):
        return {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": sum(launches_by_path.values()), "launches_by_path": launches_by_path,
            "max_abs_err": numbers["max_abs_err"], "ms": numbers["ms"], "plain_ms": numbers["plain_ms"],
            "bound_ms": numbers["bound_ms"], "bound_by": numbers["bound_by"], "library_ms": None,
        }

    record = {
        "kernels": [
            entry("nerf_mlp_fwd", "yanerf_tpu_torch/csrc/nerf_mlp_fwd.cu", "yanerf_tpu/ops/pallas/nerf_mlp_kernel.py:154",
                  k1, {"serve": serve_launches["nerf_mlp_fwd"], "train": train_launches["nerf_mlp_fwd"]}),
            entry("nerf_mlp_bwd", "yanerf_tpu_torch/csrc/nerf_mlp_bwd.cu", "yanerf_tpu/ops/pallas/nerf_mlp_bwd.py:67",
                  k3, {"serve": serve_launches["nerf_mlp_bwd"], "train": train_launches["nerf_mlp_bwd"]}),
        ]
    }
    print(json.dumps(record))
    print(card_line)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
