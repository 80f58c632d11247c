"""Smoke run of yanerf_tpu_torch on one NVIDIA GPU: build, check, serve, train.

    python3 chip_smoke.py

Four configurations at their published widths, random weights from a seed:
configs/nerf/lego_proposal.yml ("proposal": two 4x128 ProposalMLPs and one
8x256 NeRFMLP at 48 points per ray), configs/nerf/lego.yml ("classic":
two 8x256 NeRFMLPs, coarse at 64 points per ray, fine at 64 + 128 merged
and sorted), and the two families with no NeRF-MLP kernel on lego.yml's
multipass renderer: configs/nerf/synth800_mip.yml ("mip": two 8x256
MipNeRFMLPs on the integrated positional encoding, softplus densities) and
configs/nerf/lego_ngp.yml ("ngp": two HashGridNeRFs, 16 levels of 2^19
rows, 64-wide MLPs, 8192 rays per step). Phases, each printing its numbers
on a line of its own with the card's name and power limit:
  1. build   compile every kernel of the serving and training paths from
             the sources in this checkout, one nvcc per source, all started
             together: the NeRF-MLP forward (K1), its pipelined twin (K2)
             and the NeRF-MLP backward (K3); ptxas registers, spills and
             shared memory of each;
  2. kernel  hold each kernel against its plain PyTorch version at the
             shapes the paths give it, and time both: K1 at the proposal
             eval chunk (2045 rays x 32 points), the classic coarse and fine
             eval chunks (2045 x 64, 2045 x 192) and the proposal train step
             (4096 x 48), each K1 line with its yardstick, the eager
             NeRFMLP's bf16 forward under no_grad (eager_ms), timed in
             turns with K1;
             K3 at the proposal train step; K2 bit for bit against K1
             (torch.equal) at the classic fine eval chunk (2045 x 192), the
             proposal train step, 3 x 5 and 1 x 1, and against the plain
             version, K2 and K1 timed in turns at both large shapes; K1 and
             K3 against their plain versions and timed at the classic train
             step's coarse (4096 x 64) and fine (4096 x 192) shapes; each
             K3 line also gives the device time of each of K3's passes and
             its yardstick, the eager NeRFMLP's forward + autograd backward
             (eager_ms), timed in turns with K1 + K3 (k1_k3_ms);
  3. serve   for each configuration, the HTTP server on 127.0.0.1 with the
             NeRF-MLP kernel switched on answers GET /render, POST /render
             and GET /health at 800x800; K1 is launched exactly once per
             chunk and NeRFMLP (313 times per proposal frame, 626 per
             classic frame), K3 never;
  4. frame   for each configuration, one frame with K1 and again with its
             plain version: PSNR >= 40 dB; the classic frame also with K2
             at the kernel entry, which must equal the K1 frame bit for bit
             (626 K2 launches, the path K2 runs on); one frame each of
             ngp (also over HTTP, as in "serve") and mip: RGB finite and in
             [0, 1], no launch of K1, K2 or K3, the frame seconds;
  5. train   write a procedural 800x800 Blender-format scene from a seed
             and train each configuration on it through
             ``python -m yanerf_tpu_torch.run`` with ``use_pallas_train`` on
             every NeRFMLP (32 proposal steps, 16 classic steps with density
             noise 0.2 and pixels drawn without replacement), and ngp (16
             steps at 8192 rays on the uint8 device cache), per step
             (``steps_per_call=1``): K1 and K3
             launched exactly once per step and NeRFMLP (never for ngp),
             the objective finite at every step, every parameter (every
             table) moved, the final checkpoint reloads to the same
             parameters, Adam state and step; ``step_s``, rays/s and the
             peak device memory of the run;
  6. fused   the proposal CLI with ``steps_per_call=20`` on a 40-frame
             scene with the device cache, 80 steps (two epochs of two whole
             groups of 20 after the first step's vis): one captured CUDA
             graph of the whole train step replayed per step, K1 and K3
             counted once per replay; then the same run twice with
             ``steps_per_call=1`` from the same start. The fused run must
             equal the per-step run bit for bit (parameters and Adam
             state) when the two per-step runs equal each other; both
             ``step_s``, the capture seconds and the largest parameter
             differences are printed; then the same for mip with
             ``steps_per_call=8`` on that scene, one epoch of 40 steps (the
             vis step, groups of 8, 8, 8, 8 and 7), no kernel launched;
  7. step    for proposal and classic, one train step from the same weights,
             batch and draws with the fused kernels and with the eager
             model: the objectives agree within 1e-2 relative and each
             NeRF-MLP's gradients at a cosine >= 0.999 (the two bf16
             policies differ: the kernels add the bias in float32, the
             eager model in bf16; each kernel is held tensor by tensor to
             its plain version in phase 2); the peak device memory of each
             step;
  8. family  for mip and ngp, in float32 (TF32 off) from the same weights,
             batch and draws, one eval chunk (2045 rays, both passes) and one
             train step at 512 rays on the card and on the CPU: the chunk's
             outputs within 1e-4, the objectives within 1e-4 relative, each
             parameter tensor's gradient (every table) at a cosine >= 0.9999;
             the card's step twice, whether its gradients are bit-equal.

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
CLASSIC_CONFIG = REPO / "configs" / "nerf" / "lego.yml"
MIP_CONFIG = REPO / "configs" / "nerf" / "synth800_mip.yml"
NGP_CONFIG = REPO / "configs" / "nerf" / "lego_ngp.yml"
PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 (NVIDIA data sheet)
PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
FRAMES_PER_RUN = 2  # frames rendered in the serve phase (GET and POST /render)
CHUNKS_PER_FRAME = 313  # ceil(800 * 800 * 64 / 131072), both configurations
KERNEL_ATOL = 1e-2  # bf16: sums taken in another order can flip one bf16 rounding (2^-8) of a hidden activation
KERNEL_RTOL = 1e-2
MIN_FRAME_PSNR = 40.0
TRAIN_RAYS, TRAIN_PTS = 4096, 48  # lego_proposal's rays per step and final points per ray
CLASSIC_EVAL_COARSE_PTS = 64  # the classic coarse pass at eval
CLASSIC_EVAL_FINE_PTS = 64 + 128  # the classic fine pass at eval: coarse points merged with the fine ones
CLASSIC_TRAIN_PTS = (64, 64 + 128)  # the classic train step's coarse and fine passes
# K3 against its plain version, per gradient tensor: the same bf16 roundings at
# the same places, but a hidden cotangent whose float32 sum rounds the other
# way (2^-8) moves the weight-gradient sums it enters, by 1-2% of the largest
# entry depending on the weights (tests/test_torch_cuda_kernels.py)
K3_MIN_COSINE = 0.9999
K3_REL_ATOL = 5e-2  # of the tensor's largest entry
TRAIN_FRAMES, TEST_FRAMES = 4, 1  # 800x800 frames of the procedural scene
TRAIN_STEPS = 32  # proposal: 8 epochs of 4 frames
CLASSIC_TRAIN_STEPS = 16  # classic: 4 epochs of 4 frames
FUSED_STEPS_PER_CALL = 20  # lego_proposal.yml's steps_per_call
FUSED_TRAIN_FRAMES = 40  # an epoch: the vis step, then groups of 20 and 19 (epoch 0) or two of 20
FUSED_TRAIN_STEPS = 80  # two epochs
DEVICE = "cuda"
STEP_OBJECTIVE_RTOL = 1e-2
STEP_MIN_GRAD_COSINE = 0.999
NGP_TRAIN_STEPS = 16  # lego_ngp: 4 epochs of 4 frames at 8192 rays, per step
MIP_STEPS_PER_CALL = 8  # synth800_mip.yml's steps_per_call
MIP_FUSED_TRAIN_STEPS = FUSED_TRAIN_FRAMES  # one epoch: the vis step, then groups of 8, 8, 8, 8 and 7
FAMILY_EVAL_RAYS = 2045  # one eval chunk of an 800x800 frame (313 chunks)
FAMILY_TRAIN_RAYS = 512
FAMILY_ATOL = 1e-4  # card against CPU in float32, TF32 off: sums in another order
FAMILY_OBJECTIVE_RTOL = 1e-4
FAMILY_MIN_GRAD_COSINE = 0.9999
NO_LAUNCHES = {"nerf_mlp_fwd": 0, "nerf_mlp_fwd_pipelined": 0, "nerf_mlp_bwd": 0}


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


def nerf_mlp_keys(config) -> list:
    """Dotted config keys of the NeRFMLPs of the config file ``config``."""
    from yanerf_tpu_torch.pipelines import nerf_mlp_keys as keys
    from yanerf_tpu_torch.utils import Config

    return keys(Config.fromfile(str(config)))


def mlp_inputs(torch, n_rays: int, pts_per_ray: int, gen):
    points = (torch.rand(n_rays * pts_per_ray, 3, generator=gen) * 3.0 - 1.5).cuda()
    dirs = torch.randn(n_rays, 3, generator=gen).cuda()
    return points, dirs


def k1_bound(K1, packed, points, dirs):
    flops = K1.flops_per_point(packed) * points.shape[0]
    out_bytes = points.shape[0] * (1 + packed.color_dim) * 4
    return flops, bound(flops, points.numel() * 4 + dirs.numel() * 4 + out_bytes + K1.weight_bytes(packed))


def check_k1(torch, K1, nerf_mlp, packed, n_rays: int, pts_per_ray: int, gen):
    """K1 against its plain version at ``n_rays`` x ``pts_per_ray`` ray points; returns its numbers.

    Times: K1 and its plain version (CUDA events), and the yardstick K1 wins
    or loses against: the eager NeRFMLP's bf16 forward under
    ``torch.no_grad()`` on the same rays (``eager_ms``), in turns with K1.
    """
    origins, ray_dirs, lengths, points = ray_inputs(torch, n_rays, pts_per_ray, gen)
    dirs = ray_dirs.reshape(-1, 3).contiguous()
    out = K1.nerf_mlp_fwd(packed, points, dirs, pts_per_ray)
    torch.cuda.synchronize()
    ref = K1.nerf_mlp_fwd_plain(packed, points, dirs, pts_per_ray)
    err = (out - ref).abs()
    max_abs_err = float(err.max())
    if not bool(torch.isfinite(out).all()) or bool((err > KERNEL_ATOL + KERNEL_RTOL * ref.abs()).any()):
        raise SystemExit(f"nerf_mlp_fwd disagrees with its plain version at {points.shape[0]} points: "
                         f"max abs err {max_abs_err}")
    k1 = lambda: K1.nerf_mlp_fwd(packed, points, dirs, pts_per_ray)  # noqa: E731

    def eager():
        with torch.no_grad():
            nerf_mlp(origins, ray_dirs, lengths, use_pallas=False)

    k1_turns = [time_ms(torch, k1)]
    eager_turns = [time_ms(torch, eager), time_ms(torch, eager)]
    k1_turns.append(time_ms(torch, k1))
    kernel_ms = sum(k1_turns) / 2
    plain_ms = time_ms(torch, lambda: K1.nerf_mlp_fwd_plain(packed, points, dirs, pts_per_ray), iters=5)
    flops, (bound_ms, bound_by) = k1_bound(K1, packed, points, dirs)
    return dict(points=points.shape[0], max_abs_err=max_abs_err, atol=KERNEL_ATOL, rtol=KERNEL_RTOL, ms=kernel_ms,
                ms_turns=k1_turns, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, gflop=flops / 1e9,
                achieved_tflops=flops / kernel_ms / 1e9, eager_ms=sum(eager_turns) / 2, eager_ms_turns=eager_turns)


def check_k2(torch, K1, packed, n_rays: int, pts_per_ray: int, gen, timed: bool):
    """K2 against K1 (bit for bit) and against the plain version; with ``timed``, K1 and K2 in turns."""
    points, dirs = mlp_inputs(torch, n_rays, pts_per_ray, gen)
    out = K1.nerf_mlp_fwd(packed, points, dirs, pts_per_ray, pipelined=True)
    k1_out = K1.nerf_mlp_fwd(packed, points, dirs, pts_per_ray)
    torch.cuda.synchronize()
    ref = K1.nerf_mlp_fwd_plain(packed, points, dirs, pts_per_ray)
    err = (out - ref).abs()
    numbers = dict(points=points.shape[0], equal_to_k1=bool(torch.equal(out, k1_out)),
                   max_abs_err=float(err.max()), atol=KERNEL_ATOL, rtol=KERNEL_RTOL)
    if not numbers["equal_to_k1"] or not bool(torch.isfinite(out).all()) or bool(
        (err > KERNEL_ATOL + KERNEL_RTOL * ref.abs()).any()
    ):
        raise SystemExit(f"nerf_mlp_fwd(pipelined=True) at {points.shape[0]} points: {numbers}")
    if timed:
        k2 = lambda: K1.nerf_mlp_fwd(packed, points, dirs, pts_per_ray, pipelined=True)  # noqa: E731
        k1 = lambda: K1.nerf_mlp_fwd(packed, points, dirs, pts_per_ray)  # noqa: E731
        k1_ms = [time_ms(torch, k1)]
        k2_ms = [time_ms(torch, k2), time_ms(torch, k2)]
        k1_ms.append(time_ms(torch, k1))
        flops, (bound_ms, bound_by) = k1_bound(K1, packed, points, dirs)
        numbers.update(ms=sum(k2_ms) / 2, k2_ms_turns=k2_ms, k1_ms=sum(k1_ms) / 2, k1_ms_turns=k1_ms,
                       plain_ms=time_ms(torch, lambda: K1.nerf_mlp_fwd_plain(packed, points, dirs, pts_per_ray)),
                       bound_ms=bound_ms, bound_by=bound_by, gflop=flops / 1e9,
                       achieved_tflops=flops / (sum(k2_ms) / 2) / 1e9,
                       k1_achieved_tflops=flops / (sum(k1_ms) / 2) / 1e9)
    return numbers


def ray_inputs(torch, n_rays: int, pts_per_ray: int, gen):
    """A ray bundle ((1, R, 3) origins and directions, (1, R, P) sorted lengths) and its (R * P, 3) points."""
    from yanerf_tpu_torch.ops.rays import ray_bundle_to_ray_points

    origins = (torch.rand(1, n_rays, 3, generator=gen) * 2.0 - 1.0).cuda()
    dirs = torch.randn(1, n_rays, 3, generator=gen).cuda()
    lengths = torch.sort(torch.rand(1, n_rays, pts_per_ray, generator=gen) * 2.0 + 0.5, dim=-1).values.cuda()
    return origins, dirs, lengths, ray_bundle_to_ray_points(origins, dirs, lengths).reshape(-1, 3).contiguous()


def kernel_ms(torch, fn) -> dict:
    """Device ms of each kernel that one call of ``fn`` launches, by kernel name (torch.profiler)."""
    import re

    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            m = re.search(r"::(\w+)\(", ev.name) or re.search(r"(\w+)<", ev.name)  # K3's passes, PyTorch's fills
            name = m.group(1) if m else ev.name[:48]
            out[name] = out.get(name, 0.0) + ev.device_time / 1e3
    return out


def check_k3(torch, K1, K3, nerf_mlp, packed, gen, n_rays: int = TRAIN_RAYS, pts_per_ray: int = TRAIN_PTS):
    """K3 against its plain version at ``n_rays`` x ``pts_per_ray`` (a train step's shapes); returns its numbers.

    Per gradient tensor: cosine >= K3_MIN_COSINE, max abs error within
    K3_REL_ATOL of the largest entry; the padded weight rows stay zero and
    two launches give the same bits. Times: K3 (CUDA events), each of its
    passes (torch.profiler, one call), and the yardstick K3 loses or wins
    against: the eager NeRFMLP's bf16 forward plus ``torch.autograd.grad``
    to its parameters (``eager_ms``), in turns with K1 + K3 (``k1_k3_ms``)
    on the same ray points and cotangents.
    """
    n_pts = n_rays * pts_per_ray
    origins, ray_dirs, lengths, points = ray_inputs(torch, n_rays, pts_per_ray, gen)
    dirs = ray_dirs.reshape(-1, 3).contiguous()
    cot = (torch.randn(n_pts, 1 + packed.color_dim, generator=gen) / n_pts).cuda()
    gw, gb = K3.nerf_mlp_bwd(packed, points, dirs, pts_per_ray, cot)
    torch.cuda.synchronize()
    again = K3.nerf_mlp_bwd(packed, points, dirs, pts_per_ray, cot)
    rw, rb = K3.nerf_mlp_bwd_plain(packed, points, dirs, pts_per_ray, cot)
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
        raise SystemExit(f"nerf_mlp_bwd disagrees with its plain version at {n_pts} points: {failures}, padded "
                         f"rows zero {padded_zero}, same result twice {deterministic}")
    k3 = lambda: K3.nerf_mlp_bwd(packed, points, dirs, pts_per_ray, cot)  # noqa: E731
    k3_ms = time_ms(torch, k3, iters=10)
    pass_ms = kernel_ms(torch, k3)
    plain_ms = time_ms(torch, lambda: K3.nerf_mlp_bwd_plain(packed, points, dirs, pts_per_ray, cot), iters=5)

    params = list(nerf_mlp.parameters())

    def k1_k3():
        K1.nerf_mlp_fwd(packed, points, dirs, pts_per_ray)
        K3.nerf_mlp_bwd(packed, points, dirs, pts_per_ray, cot)

    def eager():
        res = nerf_mlp(origins, ray_dirs, lengths, use_pallas=False)
        outs = (res["rays_densities"], res["rays_features"])
        torch.autograd.grad(outs, params, (cot[:, :1].reshape(outs[0].shape), cot[:, 1:].reshape(outs[1].shape)))

    k1_k3_turns = [time_ms(torch, k1_k3, iters=10)]
    eager_turns = [time_ms(torch, eager, iters=10), time_ms(torch, eager, iters=10)]
    k1_k3_turns.append(time_ms(torch, k1_k3, iters=10))
    flops = K3.flops_per_point(packed) * n_pts
    bound_ms, bound_by = bound(flops, K3.io_bytes(packed, n_pts, n_rays))
    return dict(points=n_pts, max_abs_err=max_abs_err, worst_cosine=worst_cos, min_cosine=K3_MIN_COSINE,
                rel_atol=K3_REL_ATOL, padded_rows_zero=padded_zero, deterministic=deterministic, ms=k3_ms,
                pass_ms=pass_ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, gflop=flops / 1e9,
                achieved_tflops=flops / k3_ms / 1e9, k1_k3_ms=sum(k1_k3_turns) / 2, k1_k3_ms_turns=k1_k3_turns,
                eager_ms=sum(eager_turns) / 2, eager_ms_turns=eager_turns,
                stash_gb=n_pts * sum(K3.stash_widths(packed.n_layers, packed.n_extra_color)) * 2 / 1e9)


def check_classic_train_shapes(torch, K1, K3, nerf_mlp, packed, gen, card_line):
    """K1 and K3 against their plain versions, and timed, at the classic train step's coarse and fine shapes.

    The weights are those of the proposal config's NeRFMLP, whose layers
    are the classic's (8x256, the same embeddings).
    """
    for name, pts_per_ray in zip(("coarse", "fine"), CLASSIC_TRAIN_PTS):
        shape = f"classic train step, {name} pass, {TRAIN_RAYS} rays x {pts_per_ray} points"
        say(card_line, "kernel", name="nerf_mlp_fwd", shape=shape,
            **check_k1(torch, K1, nerf_mlp, packed, TRAIN_RAYS, pts_per_ray, gen))
        say(card_line, "kernel", name="nerf_mlp_bwd", shape=shape,
            **check_k3(torch, K1, K3, nerf_mlp, packed, gen, TRAIN_RAYS, pts_per_ray))
        torch.cuda.empty_cache()


def serve(torch, K1, K3, service, card_line: str, config_name: str, k1_per_frame: int):
    """The port's HTTP server answers at full width; returns the launches of its two frames."""
    import numpy as np

    from yanerf_tpu_torch.serve import create_server, orbit_pose
    from yanerf_tpu_torch.utils.images import decode_png

    # after one warm-up frame, so that the latencies are those of a running server
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
        K1.launches = K1.pipelined_launches = K3.launches = 0
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
        launches = {"nerf_mlp_fwd": K1.launches, "nerf_mlp_fwd_pipelined": K1.pipelined_launches,
                    "nerf_mlp_bwd": K3.launches}
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
        "launches_per_frame": launches == {"nerf_mlp_fwd": k1_per_frame * FRAMES_PER_RUN,
                                           "nerf_mlp_fwd_pipelined": 0, "nerf_mlp_bwd": 0},
    }
    say(card_line, "serve", config=config_name, warmup_s=warmup_s, latency_s=latencies, launches=launches,
        k1_launches_per_frame=launches["nerf_mlp_fwd"] / FRAMES_PER_RUN, frame_hw=[h, w], checks=checks,
        server_mean_render_s=health["mean_render_s"])
    if not all(checks.values()):
        raise SystemExit(f"{config_name} serve phase failed: {checks}")
    return launches


def frame(torch, K1, service, card_line: str, config_name: str, with_k2: bool):
    """One frame with K1, [with K2 at the kernel entry,] and with the plain version; returns the launches."""
    import numpy as np

    from yanerf_tpu_torch.serve import CAM_CALIBRATION, orbit_pose

    pose_world = (orbit_pose(30.0, -30.0, 4.0) @ CAM_CALIBRATION)[:3, :4].astype(np.float32)
    numbers, launches = {}, {}
    K1.launches = K1.pipelined_launches = 0
    t = time.perf_counter()
    rgb_kernel, depth_kernel = service.render(pose_world, service.default_focal)
    numbers["kernel_frame_s"] = time.perf_counter() - t
    launches["nerf_mlp_fwd"] = K1.launches
    checks = {"finite": bool(np.isfinite(rgb_kernel).all())}
    if with_k2:
        k1_entry = K1.nerf_mlp_fwd
        K1.launches = K1.pipelined_launches = 0
        with mock.patch.object(K1, "nerf_mlp_fwd", lambda *args, **kw: k1_entry(*args, pipelined=True, **kw)):
            t = time.perf_counter()
            rgb_k2, depth_k2 = service.render(pose_world, service.default_focal)
            numbers["k2_frame_s"] = time.perf_counter() - t
        launches["nerf_mlp_fwd_pipelined"] = K1.pipelined_launches
        checks["k2_frame_equals_k1_frame"] = bool(np.array_equal(rgb_k2, rgb_kernel) and
                                                  np.array_equal(depth_k2, depth_kernel))
        checks["k2_launches"] = K1.launches == 0 and K1.pipelined_launches == launches["nerf_mlp_fwd"] > 0
    with mock.patch.object(K1, "nerf_mlp_fwd", K1.nerf_mlp_fwd_plain):
        t = time.perf_counter()
        rgb_plain, _ = service.render(pose_world, service.default_focal)
        numbers["plain_frame_s"] = time.perf_counter() - t
    mse = float(np.mean((rgb_kernel.astype(np.float64) - rgb_plain) ** 2))
    numbers["psnr_db"] = -10.0 * math.log10(max(mse, 1e-20))
    checks["psnr"] = numbers["psnr_db"] >= MIN_FRAME_PSNR
    say(card_line, "frame", config=config_name, min_psnr_db=MIN_FRAME_PSNR, launches=launches,
        mean_rgb=float(rgb_kernel.mean()), checks=checks, **numbers)
    if not all(checks.values()):
        raise SystemExit(f"{config_name} frame phase failed: {checks}")
    return launches


def train(torch, K1, K3, scene: Path, out_dir: Path, config=None, steps=None):
    """Train ``config`` on ``scene`` through ``yanerf_tpu_torch.run``; returns its checks and numbers.

    Every NeRFMLP of the config trains on K1 and K3 (once per step each); a
    config with none (the mip-NeRF and hash-grid families) launches neither.
    """
    import yanerf_tpu_torch.runners as runners
    from yanerf_tpu_torch import run
    from yanerf_tpu_torch.pipelines import PIPELINES
    from yanerf_tpu_torch.utils import Config

    config = CONFIG if config is None else config
    steps = TRAIN_STEPS if steps is None else steps
    keys = nerf_mlp_keys(config)
    argv = ["--config", str(config), "--device", DEVICE, "--output_dir", str(out_dir), "--cfg_options",
            *(f"{key}.use_pallas_train=True" for key in keys), f"runner.num_iters={steps}", "runner.steps_per_call=1",
            *(f"datasets.{i}.base_dir={scene}" for i in range(3))]
    # observe the run: the parameters it starts from and every step's objective
    objectives, initial = [], {}
    make_train_step = runners.make_train_step

    def observed(pipeline, runner_config, seed, **kwargs):
        initial.update({k: p.detach().clone() for k, p in pipeline.named_parameters()})
        step = make_train_step(pipeline, runner_config, seed, **kwargs)

        def wrapped(state, batch, draws=None):
            preds = step(state, batch, draws)
            objectives.append(preds["objective"])
            return preds

        return wrapped

    with mock.patch.object(runners, "make_train_step", observed):
        if DEVICE == "cuda":
            torch.cuda.reset_peak_memory_stats()
        K1.launches = K1.pipelined_launches = K3.launches = 0
        t = time.perf_counter()
        result = run.main(argv)
        sync(torch)
        run_s = time.perf_counter() - t
        launches = {"nerf_mlp_fwd": K1.launches, "nerf_mlp_fwd_pipelined": K1.pipelined_launches,
                    "nerf_mlp_bwd": K3.launches}
        peak_gb = torch.cuda.max_memory_allocated() / 1e9 if DEVICE == "cuda" else None

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
    n_rays = cfg.pipeline.ray_sampler.n_rays_per_image_sampled_from_mask
    n_mlps = sum(int(getattr(fn, "use_pallas_train", False)) for fn in state.pipeline.implicit_functions)
    checks = {
        "steps": n_steps == steps == len(objectives),
        # once per step and NeRFMLP (none without one); the test frame at the
        # end renders with the eager model: the run turns the kernels on for
        # training only (use_pallas_train)
        "k3_per_nerf_mlp_per_step": launches["nerf_mlp_bwd"] == n_mlps * n_steps and (n_mlps > 0) == bool(keys),
        "k1_per_nerf_mlp_per_step": launches["nerf_mlp_fwd"] == n_mlps * n_steps
        and launches["nerf_mlp_fwd_pipelined"] == 0 and (n_mlps > 0) == bool(keys),
        "objective_finite": bool(torch.isfinite(objective).all()),
        "params_moved": moved == len(initial),
        "checkpoint_reloads": same_params and same_adam and reloaded.step == n_steps,
        "test_metrics_finite": all(math.isfinite(v) for v in result["test_stats"].values()),
    }
    numbers = dict(
        config=Path(config).name, nerf_mlps_on_kernels=n_mlps, steps=n_steps, run_s=run_s, ms_per_step=ms_per_step,
        step_s_per_epoch=step_s,
        train_rays_per_s=n_rays / ms_per_step * 1e3, rays_per_step=n_rays, peak_memory_gb=peak_gb, launches=launches,
        objective_first=float(objective[0]), objective_last=float(objective[-1]),
        params_moved=f"{moved}/{len(initial)}", test_stats=result["test_stats"], checks=checks,
    )
    return numbers, launches


def fused_train(torch, K1, K3, scene: Path, out_dir: Path, config=None, steps=None, steps_per_call=None):
    """The CLI of ``config`` with ``steps_per_call`` (fused) and twice with 1 (per step), from the same start.

    On the device cache, as both configs ship: lego_proposal.yml (the
    default) with ``use_pallas_train`` on its NeRFMLP, K1 and K3 once per
    replay; synth800_mip.yml, which has no NeRFMLP and launches neither.
    """
    from yanerf_tpu_torch import run
    from yanerf_tpu_torch.ops.kernels import launch_count

    config = CONFIG if config is None else config
    steps = FUSED_TRAIN_STEPS if steps is None else steps
    steps_per_call = FUSED_STEPS_PER_CALL if steps_per_call is None else steps_per_call
    keys = nerf_mlp_keys(config)

    def cli(name: str, per_call: int):
        argv = ["--config", str(config), "--device", DEVICE, "--output_dir", str(out_dir / name), "--cfg_options",
                *(f"{key}.use_pallas_train=True" for key in keys),
                f"runner.num_iters={steps}", f"runner.steps_per_call={per_call}",
                *(f"datasets.{i}.base_dir={scene}" for i in range(3))]
        sync(torch)
        K1.launches = K1.pipelined_launches = K3.launches = 0
        t = time.perf_counter()
        result = run.main(argv)
        sync(torch)
        run_s = time.perf_counter() - t
        launches = {"nerf_mlp_fwd": K1.launches, "nerf_mlp_fwd_pipelined": K1.pipelined_launches,
                    "nerf_mlp_bwd": K3.launches}
        return result, launches, run_s

    def gap(a, b):
        """(bit-equal parameters and Adam moments, largest parameter difference) of two runs' final states."""
        pa, pb = dict(a["state"].pipeline.named_parameters()), dict(b["state"].pipeline.named_parameters())
        sa, sb = a["state"].optimizer.state_dict()["state"], b["state"].optimizer.state_dict()["state"]
        equal = all(torch.equal(pa[k], pb[k]) for k in pa) and all(
            torch.equal(sa[i][m], sb[i][m]) for i in sa for m in ("exp_avg", "exp_avg_sq"))
        return equal, max(float((pa[k].detach() - pb[k].detach()).abs().max()) for k in pa)

    fused, fused_launches, fused_run_s = cli("fused", steps_per_call)
    trainer = fused["train_step_fused"]
    torch.cuda.empty_cache()
    per_step, per_step_launches, per_step_run_s = cli("per_step", 1)
    torch.cuda.empty_cache()
    again, _, _ = cli("per_step_again", 1)
    per_step_equal, per_step_gap = gap(per_step, again)
    fused_equal, fused_gap = gap(fused, per_step)
    tally = launch_count.per_replay(trainer.tally) if trainer.tally is not None else {}
    n_mlps = sum(int(getattr(fn, "use_pallas_train", False)) for fn in fused["state"].pipeline.implicit_functions)
    step_s = {"fused": [s.get("step_s") for s in fused["train_stats"]],
              "per_step": [s.get("step_s") for s in per_step["train_stats"]]}
    on_card = DEVICE == "cuda"
    per_replay = {"nerf_mlp_fwd.launches": n_mlps, "nerf_mlp_bwd.launches": n_mlps} if n_mlps else {}
    checks = {
        # on the card a captured graph, on the CPU (the tests) the same step uncaptured
        "fused_path_ran": trainer is not None and (trainer.graph is not None) == on_card
        and trainer.dispatches >= steps // steps_per_call
        and steps_per_call in trainer.seen_group_sizes,
        "steps": fused["state"].step == per_step["state"].step == steps,
        "launches_per_replay": tally == per_replay if on_card else trainer.tally is None,
        "k1_k3_per_step": fused_launches["nerf_mlp_fwd"] == fused_launches["nerf_mlp_bwd"]
        == n_mlps * steps == per_step_launches["nerf_mlp_fwd"] == per_step_launches["nerf_mlp_bwd"]
        and fused_launches["nerf_mlp_fwd_pipelined"] == 0 and (n_mlps > 0) == bool(keys),
        # bit for bit where the per-step loop itself is; otherwise no further than it is from itself
        "equal_to_per_step": fused_equal if per_step_equal else fused_gap <= per_step_gap,
        "test_metrics_finite": all(math.isfinite(v) for v in fused["test_stats"].values()),
    }
    numbers = dict(
        config=Path(config).name, steps=steps, steps_per_call=steps_per_call, train_frames=FUSED_TRAIN_FRAMES,
        dispatches=trainer.dispatches, fused_steps=trainer.steps, group_sizes=sorted(trainer.seen_group_sizes),
        capture_s=trainer.capture_s, launches_per_replay=tally, step_s=step_s,
        fused_ms_per_step=1e3 * step_s["fused"][-1], per_step_ms_per_step=1e3 * step_s["per_step"][-1],
        run_s={"fused": fused_run_s, "per_step": per_step_run_s}, launches=fused_launches,
        per_step_launches=per_step_launches,
        per_step_runs_bit_equal=per_step_equal, per_step_max_param_diff=per_step_gap,
        fused_bit_equal_to_per_step=fused_equal, fused_max_param_diff=fused_gap,
        test_stats=fused["test_stats"], checks=checks,
    )
    return numbers, fused_launches


def family_frame(torch, K1, K3, service, card_line: str, config_name: str):
    """One frame of a family with no NeRF-MLP kernel: RGB finite and in [0, 1], no launch of K1, K2 or K3."""
    import numpy as np

    from yanerf_tpu_torch.serve import CAM_CALIBRATION, orbit_pose

    pose_world = (orbit_pose(30.0, -30.0, 4.0) @ CAM_CALIBRATION)[:3, :4].astype(np.float32)
    K1.launches = K1.pipelined_launches = K3.launches = 0
    t = time.perf_counter()
    rgb, depth = service.render(pose_world, service.default_focal)
    frame_s = time.perf_counter() - t
    launches = {"nerf_mlp_fwd": K1.launches, "nerf_mlp_fwd_pipelined": K1.pipelined_launches,
                "nerf_mlp_bwd": K3.launches}
    checks = {
        "finite": bool(np.isfinite(rgb).all() and np.isfinite(depth).all()),
        "rgb_in_0_1": bool(rgb.min() >= 0.0 and rgb.max() <= 1.0),
        "shape": rgb.shape == (*service.image_hw, 3),
        "no_nerf_mlp_kernel": launches == NO_LAUNCHES,
    }
    say(card_line, "frame", config=config_name, frame_s=frame_s, launches=launches, mean_rgb=float(rgb.mean()),
        checks=checks)
    if not all(checks.values()):
        raise SystemExit(f"{config_name} frame phase failed: {checks}")
    return launches


def family_check(torch, scene: Path, config, eval_rays: int = FAMILY_EVAL_RAYS, train_rays: int = FAMILY_TRAIN_RAYS):
    """The card against the CPU for a family with no kernel: one eval chunk and one train step, in float32.

    The same weights, batch and draws on both (``compute_dtype`` overridden
    to float32, TF32 off): the chunk's outputs (both passes) within
    FAMILY_ATOL, the objectives within FAMILY_OBJECTIVE_RTOL relative and
    each parameter tensor's gradient at a cosine >= FAMILY_MIN_GRAD_COSINE.
    The train step runs twice on the card; whether the two runs' gradients
    are bit-equal is printed (the hash grid's scatter-add backward).
    """
    from yanerf_tpu_torch.datasets import BlenderDataset
    from yanerf_tpu_torch.ops.structures import EvaluationMode
    from yanerf_tpu_torch.pipelines import PIPELINES
    from yanerf_tpu_torch.runners import TrainState, create_optimizer, make_step_draws, make_train_step, prepare_batch
    from yanerf_tpu_torch.utils import Config

    cfg = Config.fromfile(str(config))
    cfg.merge_from_dict({"pipeline.model.compute_dtype": "float32",
                         "pipeline.ray_sampler.n_rays_per_image_sampled_from_mask": train_rays})
    cpu = torch.device("cpu")
    pipes = {"cpu": PIPELINES.build(cfg.pipeline, generator=torch.Generator().manual_seed(7), device=cpu)}
    for name in ("card", "card_again"):
        pipes[name] = PIPELINES.build(cfg.pipeline, generator=torch.Generator().manual_seed(7), device=DEVICE)
        pipes[name].load_state_dict(pipes["cpu"].state_dict())
    dataset = BlenderDataset(scene, "train")
    data = tuple(x[None] for x in dataset[0])

    def eval_chunk(pipe):
        """The eval chunk of ``eval_rays`` rays from the middle row of the frame on, through both passes."""
        batch = prepare_batch(data, dataset.data_wrapper, pipe.device)
        with torch.no_grad():
            bundle = pipe.ray_sampler(batch["poses"], batch["focal_lengths"], EvaluationMode.EVALUATION)
            start = (bundle.origins.shape[1] // 2) * bundle.origins.shape[2]
            o, d, l, xys = (t.reshape(1, -1, 1, t.shape[-1])[:, start:start + eval_rays] for t in bundle)
            out = pipe.renderer(o, d, l, xys, None, evaluation_mode=EvaluationMode.EVALUATION,
                                implicit_functions=[pipe._bind_model(fn, {}, False) for fn in pipe.implicit_functions])
        stages = []
        while out is not None:
            stages.append({k: getattr(out, k).cpu() for k in ("features", "depths", "alpha_masks")})
            out = out.prev_stage
        return stages

    chunks = {name: eval_chunk(pipes[name]) for name in ("cpu", "card")}
    chunk_err = max(float((a[k] - b[k]).abs().max()) for a, b in zip(chunks["cpu"], chunks["card"]) for k in a)

    draws = make_step_draws(pipes["cpu"], 1, seed=3, step=0)
    out = {}
    for name, pipe in pipes.items():
        batch = prepare_batch(data, dataset.data_wrapper, pipe.device)
        moved = {k: [t.to(pipe.device) for t in v] if isinstance(v, list) else v.to(pipe.device)
                 for k, v in draws.items()}
        state = TrainState(pipeline=pipe, optimizer=create_optimizer(cfg.runner, pipe), step=0)
        preds = make_train_step(pipe, cfg.runner, 0)(state, batch, moved)
        sync(torch)
        out[name] = (float(preds["objective"].mean()), {k: p.grad.cpu() for k, p in pipe.named_parameters()})
    (obj_cpu, grads_cpu), (obj_card, grads_card), (_, grads_again) = out["cpu"], out["card"], out["card_again"]
    grad_cos = {k: cosine(torch, grads_card[k], g) for k, g in grads_cpu.items()}
    worst = min(grad_cos, key=grad_cos.get)
    bit_equal_twice = all(torch.equal(grads_card[k], grads_again[k]) for k in grads_card)
    checks = {
        "eval_chunk": chunk_err <= FAMILY_ATOL,
        "objective": abs(obj_card - obj_cpu) <= FAMILY_OBJECTIVE_RTOL * abs(obj_cpu) and math.isfinite(obj_card),
        "grad_cosine": grad_cos[worst] >= FAMILY_MIN_GRAD_COSINE,
        "grads_finite": all(bool(torch.isfinite(g).all()) for g in grads_card.values()),
    }
    return dict(config=Path(config).name, eval_rays=eval_rays, train_rays=train_rays, eval_chunk_max_abs_err=chunk_err,
                atol=FAMILY_ATOL, objective_card=obj_card, objective_cpu=obj_cpu, objective_rtol=FAMILY_OBJECTIVE_RTOL,
                worst_grad_cosine=grad_cos[worst], worst_grad_tensor=worst, min_grad_cosine=FAMILY_MIN_GRAD_COSINE,
                tables_grad_cosine=[c for k, c in grad_cos.items() if ".tables." in k],
                card_step_bit_equal_twice=bit_equal_twice, checks=checks)


def step_equivalence(torch, scene: Path, config=None):
    """One train step with the fused kernels and with the eager model, same weights, batch and draws."""
    from yanerf_tpu_torch.datasets import BlenderDataset
    from yanerf_tpu_torch.pipelines import PIPELINES, set_nerf_mlp_option
    from yanerf_tpu_torch.runners import TrainState, create_optimizer, make_step_draws, make_train_step, prepare_batch
    from yanerf_tpu_torch.utils import Config

    config = CONFIG if config is None else config
    cfg = Config.fromfile(str(config))
    set_nerf_mlp_option(cfg, "use_pallas_train", True)
    dataset = BlenderDataset(scene, "train")
    batch = prepare_batch(tuple(x[None] for x in dataset[0]), dataset.data_wrapper, torch.device(DEVICE))
    kernel_pipe = PIPELINES.build(cfg.pipeline, generator=torch.Generator().manual_seed(5), device=DEVICE)
    draws = make_step_draws(kernel_pipe, 1, seed=3, step=0)
    eager_pipe = PIPELINES.build(cfg.pipeline, generator=torch.Generator().manual_seed(5), device=DEVICE)
    eager_pipe.load_state_dict(kernel_pipe.state_dict())
    nerf_mlps = [i for i, fn in enumerate(kernel_pipe.implicit_functions) if getattr(fn, "use_pallas_train", False)]
    for i in nerf_mlps:
        eager_pipe.implicit_functions[i].use_pallas_train = False
    out = {}
    for name, pipe in (("kernels", kernel_pipe), ("eager", eager_pipe)):
        state = TrainState(pipeline=pipe, optimizer=create_optimizer(cfg.runner, pipe), step=0)
        if DEVICE == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        preds = make_train_step(pipe, cfg.runner, 0)(state, batch, draws)
        sync(torch)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9 if DEVICE == "cuda" else None
        grads = [[p.grad for p in pipe.implicit_functions[i].parameters()] for i in nerf_mlps]
        out[name] = (float(preds["objective"].mean()), grads, peak_gb)
    (obj_k, grads_k, peak_k), (obj_e, grads_e, peak_e) = out["kernels"], out["eager"]
    grad_cos = [cosine(torch, torch.cat([g.flatten() for g in gk]), torch.cat([g.flatten() for g in ge]))
                for gk, ge in zip(grads_k, grads_e)]
    worst = [min(cosine(torch, a, b) for a, b in zip(gk, ge)) for gk, ge in zip(grads_k, grads_e)]
    checks = {
        "objective": abs(obj_k - obj_e) <= STEP_OBJECTIVE_RTOL * abs(obj_e) and math.isfinite(obj_k),
        "nerf_mlp_grad_cosine": all(c >= STEP_MIN_GRAD_COSINE for c in grad_cos),
    }
    return dict(config=Path(config).name, objective_kernels=obj_k, objective_eager=obj_e,
                objective_rtol=STEP_OBJECTIVE_RTOL, nerf_mlp_grad_cosine=grad_cos,
                min_grad_cosine=STEP_MIN_GRAD_COSINE, worst_tensor_cosine=worst,
                peak_memory_gb_kernels=peak_k, peak_memory_gb_eager=peak_e, checks=checks)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))

    from yanerf_tpu_torch.models import NeRFMLP
    from yanerf_tpu_torch.ops.kernels import nerf_mlp_bwd as K3
    from yanerf_tpu_torch.ops.kernels import nerf_mlp_fwd as K1
    from yanerf_tpu_torch.pipelines import set_nerf_mlp_option
    from yanerf_tpu_torch.serve import service_from_config
    from yanerf_tpu_torch.synth_scene import write_scene
    from yanerf_tpu_torch.utils import Config

    card_line = card()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    # 1. build: one nvcc per kernel source, all started together
    libraries = {"nerf_mlp_fwd": K1.LIBRARY, "nerf_mlp_fwd_pipelined": K1.PIPELINED_LIBRARY,
                 "nerf_mlp_bwd": K3.LIBRARY}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(libraries)) as pool:
        build_s = dict(zip(libraries, pool.map(lambda lib: lib.load(), libraries.values())))
    say(card_line, "build", seconds=time.perf_counter() - t0, per_kernel_s=build_s,
        ptxas={name: lib.build_report() for name, lib in libraries.items()})

    def build_service(config):
        cfg = Config.fromfile(str(config))
        set_nerf_mlp_option(cfg, "use_pallas", True)
        service = service_from_config(cfg, checkpoint=None, device="cuda", seed=0)
        # by type: MipNeRFMLP subclasses NeRFMLP but has no kernel
        nerf_mlps = [fn for fn in service._pipeline.implicit_functions if type(fn) is NeRFMLP]
        if not nerf_mlps or not all(fn.use_pallas for fn in nerf_mlps):
            raise SystemExit(f"the config override did not turn the NeRF-MLP kernel on in {config}")
        return service, nerf_mlps

    service, nerf_mlps = build_service(CONFIG)
    nerf_mlp = nerf_mlps[-1]
    packed = nerf_mlp.packed_weights()

    # 2. kernels vs plain versions; these launches do not count
    gen = torch.Generator().manual_seed(1)
    k1 = check_k1(torch, K1, nerf_mlp, packed, 2045, 32, gen)
    say(card_line, "kernel", name="nerf_mlp_fwd", shape="proposal eval chunk, 2045 rays x 32 points", **k1)
    for name, pts_per_ray in (("coarse", CLASSIC_EVAL_COARSE_PTS), ("fine", CLASSIC_EVAL_FINE_PTS)):
        say(card_line, "kernel", name="nerf_mlp_fwd", shape=f"classic {name} eval chunk, 2045 rays x {pts_per_ray} points",
            **check_k1(torch, K1, nerf_mlp, packed, 2045, pts_per_ray, gen))
    k1_train = check_k1(torch, K1, nerf_mlp, packed, TRAIN_RAYS, TRAIN_PTS, gen)
    say(card_line, "kernel", name="nerf_mlp_fwd", shape="proposal train step, 4096 rays x 48 points", **k1_train)
    k3 = check_k3(torch, K1, K3, nerf_mlp, packed, gen)
    say(card_line, "kernel", name="nerf_mlp_bwd", shape="proposal train step, 4096 rays x 48 points", **k3)
    k2 = check_k2(torch, K1, packed, 2045, CLASSIC_EVAL_FINE_PTS, gen, timed=True)
    say(card_line, "kernel", name="nerf_mlp_fwd_pipelined", shape="classic fine eval chunk, 2045 rays x 192 points",
        **k2)
    k2_train = check_k2(torch, K1, packed, TRAIN_RAYS, TRAIN_PTS, gen, timed=True)
    say(card_line, "kernel", name="nerf_mlp_fwd_pipelined", shape="proposal train step, 4096 rays x 48 points",
        **k2_train)
    for n_rays, pts_per_ray in ((3, 5), (1, 1)):
        say(card_line, "kernel", name="nerf_mlp_fwd_pipelined", shape=f"ragged, {n_rays} rays x {pts_per_ray} points",
            **check_k2(torch, K1, packed, n_rays, pts_per_ray, gen, timed=False))
    check_classic_train_shapes(torch, K1, K3, nerf_mlp, packed, gen, card_line)
    torch.cuda.empty_cache()

    # 3. serve and 4. frame, proposal then classic
    serve_launches = {"proposal": serve(torch, K1, K3, service, card_line, CONFIG.name, CHUNKS_PER_FRAME)}
    frame(torch, K1, service, card_line, CONFIG.name, with_k2=False)
    del service, nerf_mlps, nerf_mlp
    service, nerf_mlps = build_service(CLASSIC_CONFIG)
    serve_launches["classic"] = serve(torch, K1, K3, service, card_line, CLASSIC_CONFIG.name,
                                      len(nerf_mlps) * CHUNKS_PER_FRAME)
    classic_frame_launches = frame(torch, K1, service, card_line, CLASSIC_CONFIG.name, with_k2=True)
    del service, nerf_mlps
    torch.cuda.empty_cache()

    # the families with no NeRF-MLP kernel: a frame of each, lego_ngp.yml also over HTTP
    new_paths = {}
    for name, config in (("ngp", NGP_CONFIG), ("mip", MIP_CONFIG)):
        service = service_from_config(Config.fromfile(str(config)), checkpoint=None, device="cuda", seed=0)
        if name == "ngp":
            new_paths["ngp_serve"] = serve(torch, K1, K3, service, card_line, config.name, 0)
        new_paths[f"{name}_frame"] = family_frame(torch, K1, K3, service, card_line, config.name)
        del service
        torch.cuda.empty_cache()

    # 5. train and 6. step equivalence, on a scene written from a seed
    train_launches = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        t = time.perf_counter()
        scene = write_scene(Path(tmp) / "scene", hw=800, n_train=TRAIN_FRAMES, n_val=1, n_test=TEST_FRAMES, seed=0)
        scene_s = time.perf_counter() - t
        runs = (("proposal", CONFIG, TRAIN_STEPS), ("classic", CLASSIC_CONFIG, CLASSIC_TRAIN_STEPS))
        for name, config, steps in runs:
            numbers, train_launches[name] = train(torch, K1, K3, scene, Path(tmp) / f"results_{name}", config, steps)
            say(card_line, "train", scene_write_s=scene_s, **numbers)
            if not all(numbers["checks"].values()):
                raise SystemExit(f"{name} train phase failed: {numbers['checks']}")
            torch.cuda.empty_cache()
            if name == "proposal":
                t = time.perf_counter()
                fused_scene = write_scene(Path(tmp) / "fused_scene", hw=800, n_train=FUSED_TRAIN_FRAMES, n_val=1,
                                          n_test=TEST_FRAMES, seed=1)
                fused_numbers, train_launches["proposal_fused"] = fused_train(torch, K1, K3, fused_scene,
                                                                              Path(tmp) / "results_fused")
                say(card_line, "fused", scene_write_s=time.perf_counter() - t, **fused_numbers)
                if not all(fused_numbers["checks"].values()):
                    raise SystemExit(f"fused phase failed: {fused_numbers['checks']}")
                torch.cuda.empty_cache()
            step = step_equivalence(torch, scene, config)
            say(card_line, "step", **step)
            if not all(step["checks"].values()):
                raise SystemExit(f"{name} step equivalence failed: {step['checks']}")
            torch.cuda.empty_cache()

        # the hash grid per step at 8192 rays, the mip-NeRF family fused (steps_per_call 8) and per step
        numbers, new_paths["ngp_train"] = train(torch, K1, K3, scene, Path(tmp) / "results_ngp", NGP_CONFIG,
                                                NGP_TRAIN_STEPS)
        say(card_line, "train", scene_write_s=scene_s, **numbers)
        if not all(numbers["checks"].values()):
            raise SystemExit(f"ngp train phase failed: {numbers['checks']}")
        torch.cuda.empty_cache()
        mip_numbers, new_paths["mip_train_fused"] = fused_train(torch, K1, K3, fused_scene, Path(tmp) / "results_mip",
                                                                MIP_CONFIG, MIP_FUSED_TRAIN_STEPS, MIP_STEPS_PER_CALL)
        new_paths["mip_train_per_step"] = mip_numbers["per_step_launches"]
        say(card_line, "fused", **mip_numbers)
        if not all(mip_numbers["checks"].values()):
            raise SystemExit(f"mip fused phase failed: {mip_numbers['checks']}")
        torch.cuda.empty_cache()

        # the card against the CPU for both families
        for config in (MIP_CONFIG, NGP_CONFIG):
            family = family_check(torch, scene, config)
            say(card_line, "family", **family)
            if not all(family["checks"].values()):
                raise SystemExit(f"{config.name} family phase failed: {family['checks']}")
            torch.cuda.empty_cache()

    def entry(name, source, replaces, numbers, launches_by_path):
        return {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": sum(launches_by_path.values()), "launches_by_path": launches_by_path,
            "max_abs_err": numbers["max_abs_err"], "ms": numbers["ms"], "plain_ms": numbers["plain_ms"],
            "bound_ms": numbers["bound_ms"], "bound_by": numbers["bound_by"], "library_ms": None,
            **{k: numbers[k] for k in ("pass_ms", "k1_k3_ms", "eager_ms") if k in numbers},
        }

    def by_path(kernel):
        paths = {f"{name}_serve": launches[kernel] for name, launches in serve_launches.items()}
        paths["classic_frame"] = classic_frame_launches.get(kernel, 0)
        paths.update({f"{name}_train": launches[kernel] for name, launches in train_launches.items()
                      if name != "proposal_fused"})
        paths["proposal_train_fused"] = train_launches["proposal_fused"][kernel]
        paths.update({name: launches[kernel] for name, launches in new_paths.items()})
        return paths

    record = {
        "kernels": [
            entry("nerf_mlp_fwd", "yanerf_tpu_torch/csrc/nerf_mlp_fwd.cu",
                  "yanerf_tpu/ops/pallas/nerf_mlp_kernel.py:154", k1, by_path("nerf_mlp_fwd")),
            entry("nerf_mlp_fwd_pipelined", "yanerf_tpu_torch/csrc/nerf_mlp_fwd_pipelined.cu",
                  "yanerf_tpu/ops/pallas/nerf_mlp_kernel.py:296", k2, by_path("nerf_mlp_fwd_pipelined")),
            entry("nerf_mlp_bwd", "yanerf_tpu_torch/csrc/nerf_mlp_bwd.cu", "yanerf_tpu/ops/pallas/nerf_mlp_bwd.py:67",
                  k3, by_path("nerf_mlp_bwd")),
        ]
    }
    missing = [k["name"] for k in record["kernels"] if k["launches"] == 0]
    if missing:
        raise SystemExit(f"kernels never launched on their paths: {missing}")
    refused = {name: launches for name, launches in new_paths.items() if launches != NO_LAUNCHES}
    if refused:
        raise SystemExit(f"a NeRF-MLP kernel ran on a path whose models refuse it: {refused}")
    say(card_line, "total", seconds=time.perf_counter() - t_start)
    print(json.dumps(record))
    print(card_line)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
