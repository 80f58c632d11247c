"""Smoke run of yanerf_tpu_torch on one NVIDIA GPU: build, check, serve, train, export, real captures.

    python3 chip_smoke.py

The configurations at their published widths, random weights from a seed:
configs/nerf/lego_proposal.yml ("proposal": two 4x128 ProposalMLPs and one
8x256 NeRFMLP at 48 points per ray), configs/nerf/lego.yml ("classic":
two 8x256 NeRFMLPs, coarse at 64 points per ray, fine at 64 + 128 merged
and sorted), and the two families with no NeRF-MLP kernel on lego.yml's
multipass renderer: configs/nerf/synth800_mip.yml ("mip": two 8x256
MipNeRFMLPs on the integrated positional encoding, softplus densities) and
configs/nerf/lego_ngp.yml ("ngp": two HashGridNeRFs, 16 levels of 2^19
rows, 64-wide MLPs, 8192 rays per step); then LLFF captures, NDC rays and
unbounded scenes: configs/nerf/fern_ndc_proposal.yml ("ndc": the proposal
estimator on NDC rays), synth_llff_360_unbounded.yml ("unbounded": all
three models on contracted points, disparity spacing, per-image bounds),
synth_llff.yml (the classic pair on per-image metric bounds) and
synth800_proposal.yml (the proposal estimator with its eval-only content
box); then multi-scene latent conditioning: synth_multiscene_latent.yml
(per-scene codes on all three models, its NeRFMLP on its eager path, the
JAX package's rule) and synth_multiscene_unconditioned.yml (its control,
K1 / K3); the density tools on the flagship's checkpoint and its frame
with occupancy bounds; the classic frame served from the reference's
``.pth`` layout, the flagship's frame as an exported ``torch.export``
program, ``--debug``, configs/nerf/lego_tpu.yml (the classic pair at
16,384 rays with ``approx_top_k``) and the async checkpoint saves; then
real phone captures from JPEGs, configs/nerf/fern.yml and real_360.yml
on the committed capture ``tests/data/llff_jpeg``, sampling masks on the
flagship, and the parity runbook's smoke. Phases,
each printing its numbers on a line of its own with the card's name and
power limit:
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
             (eager_ms), timed in turns with K1 + K3 (k1_k3_ms); K1 and K3
             again on NDC points (inside [-1, 1]^3) and on contracted
             points (|x| < 2) at the LLFF train step (1024 x 48) and
             fern_ndc_proposal's eval chunk (2027 x 32), K1 also at
             synth_llff_360_unbounded's (15876 x 32); K1 on the density
             tools' lattice chunks (65,536 points, one per ray along
             (0, 0, 1), in [-2, 2]^3 and [-1.5, 1.5]^3);
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
             the card's step twice, whether its gradients are bit-equal;
  9. llff    write two 504x378 LLFF scenes of 24 views from a seed
             (``yanerf_tpu_torch.synth_llff``: forward-facing, and an orbit
             with 16 spheres 80-200 units away); a test view of ndc and of
             unbounded, and an 800x800 synth800_proposal frame, each with K1
             (once per chunk and NeRFMLP) and with its plain version, PSNR
             >= 40 dB; ndc and unbounded trained fused (steps_per_call 20,
             two epochs of 21 steps) against two per-step runs, K1 and K3
             once per replay, the objective finite at every step, every
             parameter moved; synth_llff.yml one epoch per step through the
             host DataLoader; and "family" for ndc and unbounded;
 10. multiscene  write four 128 px scenes of 10 / 2 / 2 views from a seed
             (``yanerf_tpu_torch.synth_multiscene``); both multi-scene
             configs fused (steps_per_call 8, batch 4, 40 steps) against
             two per-step runs, a val and a test eval each; for the latent
             one, each frame of a two-scene eval batch against the frame
             rendered alone and with the other scene's code; the latent
             config card against CPU ("family") at batch 2, two scene ids;
 11. tools   on the flagship's fused checkpoint, each tool's ``main`` (the
             entry point of ``python -m``) with K1 on the final NeRFMLP:
             fit_occupancy and fit_aabb at 128^3, also with K1's plain
             version (only voxels within K1's tolerance of the threshold
             may differ), extract_mesh --vertex_colors, render --trajectory
             test --n_frames 2; each tool's seconds and K1 launches;
 12. occupancy  lego_proposal.yml's 800x800 frame with a constructed
             occupancy grid (a ball of voxels): no grid, the default mode
             (K1 and its plain version, PSNR) and the exact mode, each with
             its seconds and peak memory; each mode's ray bounds on the card
             against the CPU's, the differing rays counted;
 13. pth serve  the classic service's weights written as a reference-layout
             ``.pth`` (``export_torch_checkpoint``) and served from it by a
             service of another seed: the 800x800 frame bit for bit the
             directly loaded one, K1 626 times;
 14. export  lego_proposal.yml at ``chunk_size_grid=4194304`` (10 chunks;
             the program unrolls the chunk loop, and tracing 40 chunks
             takes two minutes):
             the serve frame, then ``export.build_render_fn`` of the same
             seed traced by ``torch.export`` (seconds, graph nodes, one
             operator node per chunk, no parameter among the inputs) and
             saved (MB); a fresh ``python3`` loads the ``.pt2``
             (``load_artifact``) and renders the camera twice: the frame
             within 1e-6 of the serve frame (bitwise printed), its K1
             launches and seconds;
 15. debug   ``run --debug`` on a 2 / 2 / 2-view 800x800 scene: two steps,
             val, test, ``ckpts_-001`` and ``ckpts_0000``;
 16. lego_tpu  lego_tpu.yml as it ships (16,384 rays, ``approx_top_k``,
             fused at 8 on the uint8 cache) with ``use_pallas_train``, one
             epoch of the 40-frame scene: K1 and K3 twice per replay, ms
             per step, capture seconds, peak memory;
 17. async save  the fused flagship CLI for three epochs with a checkpoint
             after each, saved async and sync: the seconds each save holds
             the loop, the CLI's ms per step, and each async file equal to
             a sync save of the same state made right after it;
 18. jpeg decode  the committed capture ``tests/data/llff_jpeg`` (12 views
             at 1008x756, baseline 4:2:0 JPEGs with restart markers)
             decoded by ``yanerf_tpu_torch.native`` (built with g++ in
             phase 1) on this machine's host: each array's sha256 equal to
             the JAX package's libjpeg decode committed beside the files;
             the decode rate one file at a time and batched (MB/s of JPEG,
             megapixels/s);
 19. jpeg capture  a copy of the capture: the ``images_2/`` PNG cache
             written from the JPEGs equal to the JAX ``_minify`` digests;
             configs/nerf/fern.yml fused (steps_per_call 8, 40 steps) at its
             published widths (8x256, 1024 rays, 64 + 64 points) on K1 / K3
             against two per-step runs; a 504x378 test view of
             configs/nerf/real_360.yml (spherified) on K1 against its plain
             version; "family" for both (+1 on the density biases);
 20. masks   one flagship train step with a two-layer
             ``sampling_prob_mask`` and one with ``mask_crop``, K1 + K3:
             every drawn pixel of positive weight, the objective finite, the
             step against the eager model's at the tolerances of "step";
 21. parity smoke  ``python -m yanerf_tpu_torch.repro_parity --smoke
             --device cuda``: every stage ok, the time-to-quality stage at
             its target, the kernels' launches read from its runs' logs.

Any failure exits non-zero, and so does a run in which K1 or K3 did not
launch on an LLFF training path or K1 on an LLFF frame, K1 or K3 on the
multi-scene control's training, K1 on a tool or the occupancy frame, or
either of them on the latent path, or K1 on a path of phases 13-21 (K3
on their training paths). Imports nothing of JAX or of
yanerf_tpu. The
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
NDC_CONFIG = REPO / "configs" / "nerf" / "fern_ndc_proposal.yml"
UNBOUNDED_CONFIG = REPO / "configs" / "nerf" / "synth_llff_360_unbounded.yml"
LLFF_CLASSIC_CONFIG = REPO / "configs" / "nerf" / "synth_llff.yml"
AABB_CONFIG = REPO / "configs" / "nerf" / "synth800_proposal.yml"
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
LLFF_HW = (378, 504)  # the LLFF configs' size (fern's 4032x3024 at factor 8)
# 3 holdout views at test_skip 8 and 21 train views: an epoch holds the vis step and a whole group of 20;
# the fused runs take two epochs (42 steps), synth_llff.yml per step one (21)
LLFF_IMAGES = 24
LLFF_TRAIN_RAYS = 1024  # fern.yml's n_rays_per_image_sampled_from_mask, all four LLFF configs
NDC_EVAL_CHUNK = (2027, 32)  # fern_ndc_proposal: 94 chunks of 378*504 rays at 64 points, 32 final points
UNBOUNDED_EVAL_CHUNK = (15876, 32)  # synth_llff_360_unbounded (chunk_size_grid 2^20): 12 chunks
UNBOUNDED_FAR = (80.0, 200.0)  # the config's scene: --distant_spheres 16 --distant_min 80 --distant_max 200
MULTISCENE_LATENT_CONFIG = REPO / "configs" / "nerf" / "synth_multiscene_latent.yml"
MULTISCENE_CONTROL_CONFIG = REPO / "configs" / "nerf" / "synth_multiscene_unconditioned.yml"
MULTISCENE = dict(n_scenes=4, hw=128, n_train=10, n_val=2, n_test=2)  # the configs' scenes, cut from 30/4/4 views
MULTISCENE_BATCH = 4  # the configs' batch_size_list[0]
MULTISCENE_STEPS_PER_CALL = 8  # the configs' steps_per_call
MULTISCENE_STEPS = 40  # four epochs of 10 steps: groups of 8 and 2
TOOL_RESOLUTION = 128  # fit_occupancy's and fit_aabb's default lattice
LATTICE_CHUNK = 65536  # the tools' --chunk: one K1 launch per chunk of lattice points
OCCUPANCY_BALL = (128, 1.5, 1.0)  # the constructed grid: 128^3 voxels over [-1.5, 1.5]^3, a ball of radius 1
LEGO_TPU_CONFIG = REPO / "configs" / "nerf" / "lego_tpu.yml"
PTH_SEED = 1  # the .pth service's own seed: its weights must come from the file
EXPORT_CHUNK_SIZE_GRID = 4194304  # 10 chunks of the 800x800 flagship frame: the program unrolls the chunk loop
EXPORT_MAX_ERR = 1e-6  # the restored frame against the serve frame
ASYNC_EPOCHS = 3  # the async-save runs: three epochs of the 40-frame scene, a checkpoint after each
FERN_CONFIG = REPO / "configs" / "nerf" / "fern.yml"
REAL_360_CONFIG = REPO / "configs" / "nerf" / "real_360.yml"
JPEG_CAPTURE = REPO / "tests" / "data" / "llff_jpeg"  # 12 views at 1008x756: baseline 4:2:0 JPEGs with restarts
JPEG_FACTOR = 2  # the capture's views at the LLFF configs' 504x378
JPEG_TRAIN_VIEWS = 10  # 12 views, every 8th held out (fern.yml's test_skip)
JPEG_STEPS_PER_CALL = 8
JPEG_TRAIN_STEPS = 40  # four epochs of 10 steps
JPEG_DECODE_REPEATS = 3  # each decode timing is the fastest of this many passes over the capture
MASK_LAYERS = 2  # the multi-layer sampling_prob_mask: one ray budget per layer


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


def kernel_keys(config) -> list:
    """The keys of ``nerf_mlp_keys`` whose NeRFMLP the kernels can compute: ``input_xyz`` and ``latent_dim == 0``.

    A latent NeRFMLP with the switch on runs its eager path, the JAX
    package's rule (yanerf_tpu/models/nerf_mlp.py:183).
    """
    from yanerf_tpu_torch.utils import Config

    cfg = Config.fromfile(str(config))
    models = cfg.pipeline.model

    def model(key):
        return models if key == "pipeline.model" else models[int(key.rsplit(".", 1)[1])]

    return [k for k in nerf_mlp_keys(config) if model(k).get("latent_dim", 0) == 0 and model(k).get("input_xyz", True)]


def kernel_mlps(pipeline) -> int:
    """How many of ``pipeline``'s models train on K1 and K3: the switch on and the kernels' rule met."""
    return sum(int(getattr(fn, "use_pallas_train", False) and getattr(fn, "latent_dim", 0) == 0
                   and getattr(fn, "input_xyz", True)) for fn in pipeline.implicit_functions)


def mlp_inputs(torch, n_rays: int, pts_per_ray: int, gen):
    points = (torch.rand(n_rays * pts_per_ray, 3, generator=gen) * 3.0 - 1.5).cuda()
    dirs = torch.randn(n_rays, 3, generator=gen).cuda()
    return points, dirs


def k1_bound(K1, packed, points, dirs):
    flops = K1.flops_per_point(packed) * points.shape[0]
    out_bytes = points.shape[0] * (1 + packed.color_dim) * 4
    return flops, bound(flops, points.numel() * 4 + dirs.numel() * 4 + out_bytes + K1.weight_bytes(packed))


def check_k1(torch, K1, nerf_mlp, packed, n_rays: int, pts_per_ray: int, gen, kind: str = "world"):
    """K1 against its plain version at ``n_rays`` x ``pts_per_ray`` ray points of ``kind``; returns its numbers.

    Times: K1 and its plain version (CUDA events), and the yardstick K1 wins
    or loses against: the eager NeRFMLP's bf16 forward under
    ``torch.no_grad()`` on the same rays (``eager_ms``), in turns with K1.
    """
    origins, ray_dirs, lengths, points = ray_inputs(torch, n_rays, pts_per_ray, gen, kind)
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
        with torch.no_grad(), contracting(nerf_mlp, kind == "contracted"):
            nerf_mlp(origins, ray_dirs, lengths, use_pallas=False)

    k1_turns = [time_ms(torch, k1)]
    eager_turns = [time_ms(torch, eager), time_ms(torch, eager)]
    k1_turns.append(time_ms(torch, k1))
    kernel_ms = sum(k1_turns) / 2
    plain_ms = time_ms(torch, lambda: K1.nerf_mlp_fwd_plain(packed, points, dirs, pts_per_ray), iters=5)
    flops, (bound_ms, bound_by) = k1_bound(K1, packed, points, dirs)
    return dict(points=points.shape[0], **input_range(points), max_abs_err=max_abs_err, atol=KERNEL_ATOL,
                rtol=KERNEL_RTOL, ms=kernel_ms, ms_turns=k1_turns, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, gflop=flops / 1e9,
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


def ray_inputs(torch, n_rays: int, pts_per_ray: int, gen, kind: str = "world"):
    """A ray bundle ((1, R, 3) origins and directions, (1, R, P) sorted lengths) and its (R * P, 3) points.

    ``kind``: ``world``, rays through [-1, 1]^3 at depths in [0.5, 2.5]
    (points within ~[-1.5, 1.5]^3 and beyond); ``ndc``, the pixels of a
    504x378 camera looking down -z (an LLFF capture's average view) warped
    into NDC, lengths in [0, 1], the points inside [-1, 1]^3; ``contracted``,
    rays from inside the unit ball with disparity-spaced lengths out to 200
    (the unbounded scene's far spheres), the points those the model's
    contraction gives the kernel (|x| < 2). The points are what
    ``NeRFMLP._points`` hands the kernel for this bundle.
    """
    from yanerf_tpu_torch.ops.rays import contract_points, ndc_ray_bundle, ray_bundle_to_ray_points
    from yanerf_tpu_torch.ops.structures import RayBundle

    rand = lambda *shape: torch.rand(*shape, generator=gen)  # noqa: E731
    if kind.startswith("lattice"):
        # the middle chunk of the density tools' 128^3 lattice (fit_occupancy / fit_aabb on [-2, 2]^3,
        # extract_mesh on [-1.5, 1.5]^3): zero-length rays along (0, 0, 1), one point each
        half = 1.5 if kind == "lattice_mesh" else 2.0
        axis = torch.linspace(-half, half, TOOL_RESOLUTION)
        lattice = torch.stack(torch.meshgrid(axis, axis, axis, indexing="ij"), dim=-1).reshape(-1, 3)
        start = (lattice.shape[0] // 2 // n_rays) * n_rays
        origins = lattice[start : start + n_rays][None]
        dirs = torch.tensor([0.0, 0.0, 1.0]).expand(1, n_rays, 3).contiguous()
        lengths = torch.zeros(1, n_rays, pts_per_ray)
    elif kind == "ndc":
        h, w = LLFF_HW
        focal = 0.5 * w / math.tan(0.5 * 0.6911112070083618)
        xy = rand(1, n_rays, 2) * torch.tensor([w, h])
        cam = torch.stack([(xy[..., 0] - w * 0.5) / focal, (xy[..., 1] - h * 0.5) / focal, torch.ones(1, n_rays)], -1)
        dirs = cam * torch.tensor([1.0, -1.0, -1.0])
        origins = (rand(1, n_rays, 3) - 0.5) * torch.tensor([0.2, 0.2, 0.0])
        bundle = ndc_ray_bundle(RayBundle(origins, dirs, rand(1, n_rays, 1), xy), w, h, torch.tensor([[focal]]))
        origins, dirs = bundle.origins, bundle.directions
        lengths = torch.sort(rand(1, n_rays, pts_per_ray), dim=-1).values
    elif kind == "contracted":
        origins = rand(1, n_rays, 3) - 0.5
        dirs = torch.randn(1, n_rays, 3, generator=gen)
        dirs = dirs / dirs.norm(dim=-1, keepdim=True)
        near, far = 0.2, UNBOUNDED_FAR[1]
        lengths = torch.sort(1.0 / (1.0 / far + rand(1, n_rays, pts_per_ray) * (1.0 / near - 1.0 / far)), dim=-1).values
    else:
        origins = rand(1, n_rays, 3) * 2.0 - 1.0
        dirs = torch.randn(1, n_rays, 3, generator=gen)
        lengths = torch.sort(rand(1, n_rays, pts_per_ray) * 2.0 + 0.5, dim=-1).values
    points = ray_bundle_to_ray_points(origins, dirs, lengths)
    if kind == "contracted":
        points = contract_points(points)
    return origins.cuda(), dirs.cuda(), lengths.cuda(), points.reshape(-1, 3).contiguous().cuda()


class contracting:
    """``nerf_mlp.contract_coords`` set to ``on`` inside the block: the eager yardstick does the model's work."""

    def __init__(self, nerf_mlp, on: bool):
        self.nerf_mlp, self.on = nerf_mlp, on

    def __enter__(self):
        self.was, self.nerf_mlp.contract_coords = self.nerf_mlp.contract_coords, self.on

    def __exit__(self, *exc):
        self.nerf_mlp.contract_coords = self.was


def input_range(points) -> dict:
    return dict(points_max_abs=float(points.abs().max()), points_max_norm=float(points.norm(dim=-1).max()))


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


def check_k3(torch, K1, K3, nerf_mlp, packed, gen, n_rays: int = TRAIN_RAYS, pts_per_ray: int = TRAIN_PTS,
             kind: str = "world"):
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
    origins, ray_dirs, lengths, points = ray_inputs(torch, n_rays, pts_per_ray, gen, kind)
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
        with contracting(nerf_mlp, kind == "contracted"):
            res = nerf_mlp(origins, ray_dirs, lengths, use_pallas=False)
        outs = (res["rays_densities"], res["rays_features"])
        torch.autograd.grad(outs, params, (cot[:, :1].reshape(outs[0].shape), cot[:, 1:].reshape(outs[1].shape)))

    k1_k3_turns = [time_ms(torch, k1_k3, iters=10)]
    eager_turns = [time_ms(torch, eager, iters=10), time_ms(torch, eager, iters=10)]
    k1_k3_turns.append(time_ms(torch, k1_k3, iters=10))
    flops = K3.flops_per_point(packed) * n_pts
    bound_ms, bound_by = bound(flops, K3.io_bytes(packed, n_pts, n_rays))
    return dict(points=n_pts, **input_range(points), max_abs_err=max_abs_err, worst_cosine=worst_cos,
                min_cosine=K3_MIN_COSINE,
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


def frame(torch, K1, service, card_line: str, config_name: str, with_k2: bool, view=None, k1_per_frame=None):
    """One frame with K1, [with K2 at the kernel entry,] and with the plain version; returns the launches.

    ``view`` is ``(pose 3x4, focal, min_depth, max_depth)`` (an LLFF test
    view), else an orbit camera at the service's defaults; with
    ``k1_per_frame`` K1 must run exactly that often (once per chunk and
    NeRFMLP).
    """
    import numpy as np

    from yanerf_tpu_torch.serve import CAM_CALIBRATION, orbit_pose

    if view is None:
        view = ((orbit_pose(30.0, -30.0, 4.0) @ CAM_CALIBRATION)[:3, :4].astype(np.float32), service.default_focal,
                None, None)
    pose_world, focal, lo, hi = view
    numbers, launches = {}, {}
    K1.launches = K1.pipelined_launches = 0
    t = time.perf_counter()
    rgb_kernel, depth_kernel = service.render(pose_world, focal, lo, hi)
    numbers["kernel_frame_s"] = time.perf_counter() - t
    launches["nerf_mlp_fwd"] = K1.launches
    checks = {"finite": bool(np.isfinite(rgb_kernel).all())}
    if k1_per_frame is not None:
        checks["k1_once_per_chunk_and_nerf_mlp"] = launches["nerf_mlp_fwd"] == k1_per_frame > 0
    if with_k2:
        k1_entry = K1.nerf_mlp_fwd
        K1.launches = K1.pipelined_launches = 0
        with mock.patch.object(K1, "nerf_mlp_fwd", lambda *args, **kw: k1_entry(*args, pipelined=True, **kw)):
            t = time.perf_counter()
            rgb_k2, depth_k2 = service.render(pose_world, focal, lo, hi)
            numbers["k2_frame_s"] = time.perf_counter() - t
        launches["nerf_mlp_fwd_pipelined"] = K1.pipelined_launches
        checks["k2_frame_equals_k1_frame"] = bool(np.array_equal(rgb_k2, rgb_kernel) and
                                                  np.array_equal(depth_k2, depth_kernel))
        checks["k2_launches"] = K1.launches == 0 and K1.pipelined_launches == launches["nerf_mlp_fwd"] > 0
    with mock.patch.object(K1, "nerf_mlp_fwd", K1.nerf_mlp_fwd_plain):
        t = time.perf_counter()
        rgb_plain, _ = service.render(pose_world, focal, lo, hi)
        numbers["plain_frame_s"] = time.perf_counter() - t
    mse = float(np.mean((rgb_kernel.astype(np.float64) - rgb_plain) ** 2))
    numbers["psnr_db"] = -10.0 * math.log10(max(mse, 1e-20))
    checks["psnr"] = numbers["psnr_db"] >= MIN_FRAME_PSNR
    say(card_line, "frame", config=config_name, min_psnr_db=MIN_FRAME_PSNR, launches=launches,
        frame_hw=list(rgb_kernel.shape[:2]), mean_rgb=float(rgb_kernel.mean()), checks=checks, **numbers)
    if not all(checks.values()):
        raise SystemExit(f"{config_name} frame phase failed: {checks}")
    return launches


class observe_run:
    """Inside the block, record what ``yanerf_tpu_torch.run`` trains: the parameters it starts from and the
    objective of every step, per step (``make_train_step``) and per fused dispatch (``FusedTrainStep``)."""

    def __init__(self, torch):
        import yanerf_tpu_torch.runners as runners
        from yanerf_tpu_torch.runners import apis

        self.torch = torch
        self.initial, self.objectives = {}, []
        make_step, dispatch = runners.make_train_step, apis.FusedTrainStep.__call__

        def observed_step(pipeline, runner_config, seed, **kwargs):
            self._start(pipeline)
            step = make_step(pipeline, runner_config, seed, **kwargs)

            def wrapped(state, batch, draws=None):
                preds = step(state, batch, draws)
                self.objectives.append(preds["objective"].flatten())
                return preds

            return wrapped

        def observed_dispatch(trainer, state, arrays, idx):
            self._start(trainer.pipeline)
            hist = dispatch(trainer, state, arrays, idx)
            self.objectives.append(hist["objective"].flatten())
            return hist

        self.patches = [mock.patch.object(runners, "make_train_step", observed_step),
                        mock.patch.object(apis.FusedTrainStep, "__call__", observed_dispatch)]

    def _start(self, pipeline):
        if not self.initial:
            self.initial.update({k: p.detach().clone() for k, p in pipeline.named_parameters()})

    def __enter__(self):
        for patch in self.patches:
            patch.start()
        return self

    def __exit__(self, *exc):
        for patch in self.patches:
            patch.stop()

    def moved(self, pipeline) -> int:
        """How many parameter tensors of ``pipeline`` differ from where the run started."""
        final = dict(pipeline.named_parameters())
        return sum(int(not self.torch.equal(final[k].detach(), v)) for k, v in self.initial.items())

    def objective(self):
        """Every step's objective, in order, on the host."""
        return self.torch.cat([o.float().cpu() for o in self.objectives])


def train(torch, K1, K3, scene: Path, out_dir: Path, config=None, steps=None, extra_options=()):
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
    keys = kernel_keys(config)
    argv = ["--config", str(config), "--device", DEVICE, "--output_dir", str(out_dir), "--cfg_options",
            *(f"{key}.use_pallas_train=True" for key in nerf_mlp_keys(config)), f"runner.num_iters={steps}", "runner.steps_per_call=1",
            *(f"datasets.{i}.base_dir={scene}" for i in range(3)), *extra_options]
    with observe_run(torch) as seen:
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
    initial, objectives = seen.initial, seen.objectives

    state = result["state"]
    n_steps = state.step
    final = dict(state.pipeline.named_parameters())
    moved = seen.moved(state.pipeline)
    objective = seen.objective()

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
    n_mlps = kernel_mlps(state.pipeline)
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


def fused_train(torch, K1, K3, scene: Path, out_dir: Path, config=None, steps=None, steps_per_call=None,
                extra_options=(), train_frames=FUSED_TRAIN_FRAMES, batch_size=1):
    """The CLI of ``config`` with ``steps_per_call`` (fused) and twice with 1 (per step), from the same start.

    On the device cache, as the configs ship: lego_proposal.yml (the
    default), fern_ndc_proposal.yml, synth_llff_360_unbounded.yml and
    synth_multiscene_unconditioned.yml with ``use_pallas_train`` on their
    NeRFMLP, K1 and K3 once per replay; synth800_mip.yml, which has no
    NeRFMLP, and synth_multiscene_latent.yml, whose NeRFMLP is latent (the
    switch is set and the kernels' rule sends it down its eager path),
    launch neither. ``steps`` are steps of ``batch_size`` images (the
    config's ``num_iters`` counts images). The fused run's objective must be
    finite at every step and every parameter must move.
    """
    from yanerf_tpu_torch import run
    from yanerf_tpu_torch.ops.kernels import launch_count

    config = CONFIG if config is None else config
    steps = FUSED_TRAIN_STEPS if steps is None else steps
    steps_per_call = FUSED_STEPS_PER_CALL if steps_per_call is None else steps_per_call
    keys = kernel_keys(config)

    def cli(name: str, per_call: int):
        argv = ["--config", str(config), "--device", DEVICE, "--output_dir", str(out_dir / name), "--cfg_options",
                *(f"{key}.use_pallas_train=True" for key in nerf_mlp_keys(config)),
                f"runner.num_iters={steps * batch_size}", f"runner.steps_per_call={per_call}",
                *(f"datasets.{i}.base_dir={scene}" for i in range(3)), *extra_options]
        sync(torch)
        if DEVICE == "cuda":
            torch.cuda.reset_peak_memory_stats()
        K1.launches = K1.pipelined_launches = K3.launches = 0
        t = time.perf_counter()
        with observe_run(torch) as seen:
            result = run.main(argv)
        sync(torch)
        result["run_s"] = time.perf_counter() - t
        result["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9 if DEVICE == "cuda" else None
        result["objective"], result["params_moved"] = seen.objective(), (seen.moved(result["state"].pipeline),
                                                                          len(seen.initial))
        launches = {"nerf_mlp_fwd": K1.launches, "nerf_mlp_fwd_pipelined": K1.pipelined_launches,
                    "nerf_mlp_bwd": K3.launches}
        return result, launches, result["run_s"]

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
    n_mlps = kernel_mlps(fused["state"].pipeline)
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
        "objective_finite_every_step": fused["objective"].numel() == steps * batch_size  # one per image and step
        and bool(torch.isfinite(fused["objective"]).all()),
        "params_moved": fused["params_moved"][0] == fused["params_moved"][1] > 0,
        "test_metrics_finite": all(math.isfinite(v) for v in fused["test_stats"].values()),
    }
    numbers = dict(
        config=Path(config).name, steps=steps, steps_per_call=steps_per_call,
        train_frames=train_frames,
        dispatches=trainer.dispatches, fused_steps=trainer.steps, group_sizes=sorted(trainer.seen_group_sizes),
        capture_s=trainer.capture_s, launches_per_replay=tally, step_s=step_s,
        fused_ms_per_step=1e3 * step_s["fused"][-1], per_step_ms_per_step=1e3 * step_s["per_step"][-1],
        run_s={"fused": fused_run_s, "per_step": per_step_run_s},
        peak_memory_gb={"fused": fused["peak_memory_gb"], "per_step": per_step["peak_memory_gb"]},
        objective_first=float(fused["objective"][0]), objective_last=float(fused["objective"][-1]),
        params_moved="{}/{}".format(*fused["params_moved"]), launches=fused_launches,
        per_step_launches=per_step_launches,
        per_step_runs_bit_equal=per_step_equal, per_step_max_param_diff=per_step_gap,
        fused_bit_equal_to_per_step=fused_equal, fused_max_param_diff=fused_gap,
        val_stats=fused["val_stats"], test_stats=fused["test_stats"], checks=checks,
        checkpoint=str(fused["checkpoint"]),
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


def family_check(torch, scene: Path, config, eval_rays: int = FAMILY_EVAL_RAYS, train_rays: int = FAMILY_TRAIN_RAYS,
                 options=None, density_bias: float = 0.0, items=(0,), probe_biases=()):
    """The card against the CPU for a family's eager path: one eval chunk and one train step, in float32.

    The same weights, batch and draws on both (``compute_dtype`` overridden
    to float32, TF32 off): the chunk's outputs (both passes) within
    FAMILY_ATOL, the objectives within FAMILY_OBJECTIVE_RTOL relative and
    each parameter tensor's gradient at a cosine >= FAMILY_MIN_GRAD_COSINE.
    The train step runs twice on the card; whether the two runs' gradients
    are bit-equal is printed (the hash grid's scatter-add backward). The
    batch is the ``items`` of the config's train dataset on ``scene`` (the
    first one by default; ``options``: more config overrides), their
    per-image bounds and scene ids included, the eval chunk taken from each.
    ``density_bias`` is added to every model's density bias first, the same
    on both sides, so that every ray carries mass: with the init's densities
    the proposal estimator on LLFF rays is ill-conditioned (on the CPU a
    1e-7 relative change of the ray directions moves the eval chunk's
    depths by 0.075 in NDC and by 23.9 on the unbounded scene; with +1 on
    the biases by 5e-6 and 1.8e-5), the empty-ray note of ROADMAP.md Queue 3.
    That measure of the chunk's conditioning is printed beside its error
    (``cpu_chunk_sensitivity``: the CPU chunk against itself with the
    directions scaled by 1 + 1e-7), also at each of ``probe_biases``.
    """
    from yanerf_tpu_torch.datasets import DATASETS, stack_batch
    from yanerf_tpu_torch.ops.structures import EvaluationMode
    from yanerf_tpu_torch.pipelines import PIPELINES
    from yanerf_tpu_torch.runners import TrainState, create_optimizer, make_step_draws, make_train_step, prepare_batch
    from yanerf_tpu_torch.utils import Config

    cfg = Config.fromfile(str(config))
    models = cfg.pipeline.model
    dtype_keys = (["pipeline.model.compute_dtype"] if not isinstance(models, (list, tuple))
                  else [f"pipeline.model.{i}.compute_dtype" for i in range(len(models))])
    cfg.merge_from_dict({**{key: "float32" for key in dtype_keys},
                         "pipeline.ray_sampler.n_rays_per_image_sampled_from_mask": train_rays, **(options or {})})
    cpu = torch.device("cpu")
    pipes = {"cpu": PIPELINES.build(cfg.pipeline, generator=torch.Generator().manual_seed(7), device=cpu)}
    if density_bias:
        with torch.no_grad():
            for fn in pipes["cpu"].implicit_functions:
                fn.density_layer.b.add_(density_bias)
    for name in ("card", "card_again"):
        pipes[name] = PIPELINES.build(cfg.pipeline, generator=torch.Generator().manual_seed(7), device=DEVICE)
        pipes[name].load_state_dict(pipes["cpu"].state_dict())
    dataset = DATASETS.build(dict(cfg.datasets[0], base_dir=str(scene)))
    data = stack_batch([dataset[i] for i in items])

    def eval_chunk(pipe, direction_scale: float = 1.0):
        """The eval chunk of ``eval_rays`` rays from the middle row of each frame on, through every pass."""
        batch = prepare_batch(data, dataset.data_wrapper, pipe.device)
        extra = {k: v for k, v in batch.items() if k not in ("poses", "focal_lengths", "image_rgb", "min_depth",
                                                                "max_depth")}
        with torch.no_grad():
            bundle = pipe.ray_sampler(batch["poses"], batch["focal_lengths"], EvaluationMode.EVALUATION,
                                      min_depth=batch.get("min_depth"), max_depth=batch.get("max_depth"))
            start = (bundle.origins.shape[1] // 2) * bundle.origins.shape[2]
            o, d, l, xys = (t.reshape(t.shape[0], -1, 1, t.shape[-1])[:, start:start + eval_rays] for t in bundle)
            d = d * direction_scale
            features = pipe.extract_features(**extra)  # the scene codes of a latent config
            out = pipe.renderer(o, d, l, xys, None, evaluation_mode=EvaluationMode.EVALUATION,
                                implicit_functions=[pipe._bind_model(fn, features, False)
                                                    for fn in pipe.implicit_functions])
        stages = []
        while out is not None:
            stages.append({k: getattr(out, k).cpu() for k in ("features", "depths", "alpha_masks")})
            out = out.prev_stage
        return stages

    chunks = {name: eval_chunk(pipes[name]) for name in ("cpu", "card")}

    def chunk_gap(x, y) -> float:
        return max(float((a[k] - b[k]).abs().max()) for a, b in zip(x, y) for k in a)

    chunk_err = chunk_gap(chunks["cpu"], chunks["card"])
    sensitivity = {density_bias: chunk_gap(chunks["cpu"], eval_chunk(pipes["cpu"], 1.0 + 1e-7))}
    for bias in probe_biases:
        probe = PIPELINES.build(cfg.pipeline, generator=torch.Generator().manual_seed(7), device=cpu)
        with torch.no_grad():
            for fn in probe.implicit_functions:
                fn.density_layer.b.add_(bias)
        sensitivity[bias] = chunk_gap(eval_chunk(probe), eval_chunk(probe, 1.0 + 1e-7))

    draws = make_step_draws(pipes["cpu"], len(items), seed=3, step=0)
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
    return dict(config=Path(config).name, batch=len(items), eval_rays=eval_rays, train_rays=train_rays,
                density_bias=density_bias,
                eval_chunk_max_abs_err=chunk_err,
                cpu_chunk_sensitivity={f"density_bias {b:+g}": v for b, v in sensitivity.items()},
                atol=FAMILY_ATOL, objective_card=obj_card, objective_cpu=obj_cpu, objective_rtol=FAMILY_OBJECTIVE_RTOL,
                worst_grad_cosine=grad_cos[worst], worst_grad_tensor=worst, min_grad_cosine=FAMILY_MIN_GRAD_COSINE,
                tables_grad_cosine=[c for k, c in grad_cos.items() if ".tables." in k],
                card_step_bit_equal_twice=bit_equal_twice, checks=checks)


def step_equivalence(torch, scene: Path, config=None, masks=None):
    """One train step with the fused kernels and with the eager model, same weights, batch and draws.

    ``masks`` (``mask_crop`` / ``sampling_prob_mask`` / ``n_rays_per_image``) join the batch, whose pixels
    are then drawn by the mask; the result then also holds ``drawn_xys``, the pixels the steps drew. Each
    step's kernel launches are counted from 0 (``launches_kernels``, ``launches_eager``).
    """
    from yanerf_tpu_torch.datasets import BlenderDataset
    from yanerf_tpu_torch.ops.kernels import launch_count
    from yanerf_tpu_torch.ops.kernels import nerf_mlp_bwd as K3
    from yanerf_tpu_torch.ops.kernels import nerf_mlp_fwd as K1
    from yanerf_tpu_torch.ops.structures import EvaluationMode
    from yanerf_tpu_torch.pipelines import PIPELINES, set_nerf_mlp_option
    from yanerf_tpu_torch.runners import TrainState, create_optimizer, make_step_draws, make_train_step, prepare_batch
    from yanerf_tpu_torch.utils import Config

    config = CONFIG if config is None else config
    cfg = Config.fromfile(str(config))
    set_nerf_mlp_option(cfg, "use_pallas_train", True)
    dataset = BlenderDataset(scene, "train")
    batch = prepare_batch(tuple(x[None] for x in dataset[0]), dataset.data_wrapper, torch.device(DEVICE))
    batch.update(masks or {})
    kernel_pipe = PIPELINES.build(cfg.pipeline, generator=torch.Generator().manual_seed(5), device=DEVICE)
    draws = make_step_draws(kernel_pipe, 1, seed=3, step=0, masked=kernel_pipe.masked_training(batch),
                            n_rays_per_image=batch.get("n_rays_per_image"))
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
        K1.launches = K1.pipelined_launches = K3.launches = 0
        preds = make_train_step(pipe, cfg.runner, 0)(state, batch, draws)
        sync(torch)
        launches = launch_count.totals()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9 if DEVICE == "cuda" else None
        grads = [[p.grad for p in pipe.implicit_functions[i].parameters()] for i in nerf_mlps]
        out[name] = (float(preds["objective"].mean()), grads, peak_gb, launches)
    (obj_k, grads_k, peak_k, launches_k), (obj_e, grads_e, peak_e, launches_e) = out["kernels"], out["eager"]
    grad_cos = [cosine(torch, torch.cat([g.flatten() for g in gk]), torch.cat([g.flatten() for g in ge]))
                for gk, ge in zip(grads_k, grads_e)]
    worst = [min(cosine(torch, a, b) for a, b in zip(gk, ge)) for gk, ge in zip(grads_k, grads_e)]
    checks = {
        "objective": abs(obj_k - obj_e) <= STEP_OBJECTIVE_RTOL * abs(obj_e) and math.isfinite(obj_k),
        "nerf_mlp_grad_cosine": all(c >= STEP_MIN_GRAD_COSINE for c in grad_cos),
    }
    result = dict(config=Path(config).name, objective_kernels=obj_k, objective_eager=obj_e,
                  objective_rtol=STEP_OBJECTIVE_RTOL, nerf_mlp_grad_cosine=grad_cos,
                  min_grad_cosine=STEP_MIN_GRAD_COSINE, worst_tensor_cosine=worst,
                  peak_memory_gb_kernels=peak_k, peak_memory_gb_eager=peak_e, nerf_mlps=len(nerf_mlps),
                  launches_kernels=launches_k, launches_eager=launches_e, checks=checks)
    if masks:
        bundle = kernel_pipe.ray_sampler(batch["poses"], batch["focal_lengths"], EvaluationMode.TRAINING,
                                         mask=batch.get("mask_crop"), sampling_prob_mask=batch.get("sampling_prob_mask"),
                                         n_rays_per_image=batch.get("n_rays_per_image"),
                                         pixel_u=draws.get("pixel_u"), pixel_gumbel=draws.get("pixel_gumbel"),
                                         strata_u=draws.get("strata_u"))
        result["drawn_xys"] = bundle.xys[0, :, 0].long()
    return result


def build_service(config):
    """The port's render service for ``config`` on DEVICE, the NeRF-MLP kernel switched on; and its NeRFMLPs."""
    from yanerf_tpu_torch.models import NeRFMLP
    from yanerf_tpu_torch.pipelines import set_nerf_mlp_option
    from yanerf_tpu_torch.serve import service_from_config
    from yanerf_tpu_torch.utils import Config

    cfg = Config.fromfile(str(config))
    set_nerf_mlp_option(cfg, "use_pallas", True)
    service = service_from_config(cfg, checkpoint=None, device=DEVICE, seed=0)
    # by type: MipNeRFMLP subclasses NeRFMLP but has no kernel
    nerf_mlps = [fn for fn in service._pipeline.implicit_functions if type(fn) is NeRFMLP]
    if not nerf_mlps or not all(fn.use_pallas for fn in nerf_mlps):
        raise SystemExit(f"the config override did not turn the NeRF-MLP kernel on in {config}")
    return service, nerf_mlps


def check_llff_ranges(torch, K1, K3, nerf_mlp, packed, gen, card_line):
    """K1 and K3 against their plain versions, timed, on NDC points and on contracted points (|x| < 2).

    At the LLFF configs' train step (1024 rays x 48 points) and at
    fern_ndc_proposal's eval chunk; contracted points also at
    synth_llff_360_unbounded's own eval chunk. The harmonic embedding's
    phase reaches |x| * 2^9 rad there: the kernels are built without
    ``--use_fast_math`` and must keep the tolerances they hold elsewhere.
    """
    train, ndc_eval = (LLFF_TRAIN_RAYS, TRAIN_PTS, "LLFF train step"), (*NDC_EVAL_CHUNK, "fern_ndc_proposal eval chunk")
    runs = [("ndc", *train, True), ("ndc", *ndc_eval, True), ("contracted", *train, True),
            ("contracted", *ndc_eval, True),
            ("contracted", *UNBOUNDED_EVAL_CHUNK, "synth_llff_360_unbounded eval chunk", False)]  # K1 only: eval
    for kind, n_rays, pts_per_ray, where, with_k3 in runs:
        shape = f"{kind} points, {where}, {n_rays} rays x {pts_per_ray} points"
        say(card_line, "kernel", name="nerf_mlp_fwd", shape=shape,
            **check_k1(torch, K1, nerf_mlp, packed, n_rays, pts_per_ray, gen, kind))
        if with_k3:
            say(card_line, "kernel", name="nerf_mlp_bwd", shape=shape,
                **check_k3(torch, K1, K3, nerf_mlp, packed, gen, n_rays, pts_per_ray, kind))
        torch.cuda.empty_cache()


def llff_options(config) -> list:
    """The LLFF configs on the procedural scenes: written at the configs' 504x378 (factor 1); one val view and
    one test view (``test_skip`` 24 of 24), the train split held out at ``test_skip`` 8 as the configs ship."""
    return [*(f"datasets.{i}.factor=1" for i in range(3)), "datasets.0.test_skip=8",
            *(f"datasets.{i}.test_skip={LLFF_IMAGES}" for i in (1, 2))]


def frame_chunks(cfg) -> int:
    """Chunks of one eval frame: ceil(H * W * points per ray / chunk_size_grid), the pipeline's arithmetic."""
    rs = cfg.pipeline.ray_sampler
    return -(-rs.image_height * rs.image_width * rs.n_pts_per_ray_evaluation // cfg.pipeline.chunk_size_grid)


def llff_phases(torch, K1, K3, card_line: str, tmp: Path) -> dict:
    """The LLFF family: scenes, frames, fused and per-step training, the card against the CPU.

    Returns the kernels' launches on each of its paths.
    """
    from yanerf_tpu_torch.datasets import DATASETS
    from yanerf_tpu_torch.synth_llff import write_llff_scene
    from yanerf_tpu_torch.utils import Config

    h, w = LLFF_HW
    train_views = LLFF_IMAGES - len(range(0, LLFF_IMAGES, 8))  # held out at the configs' test_skip 8
    t = time.perf_counter()
    scenes = {"forward": write_llff_scene(tmp / "llff_forward", h, w, LLFF_IMAGES, seed=0),
              "orbit": write_llff_scene(tmp / "llff_orbit", h, w, LLFF_IMAGES, mode="orbit", distant_spheres=16,
                                        distant_min=UNBOUNDED_FAR[0], distant_max=UNBOUNDED_FAR[1], seed=0)}
    say(card_line, "llff scene", seconds=time.perf_counter() - t, images=LLFF_IMAGES, hw=[h, w],
        scenes={k: str(v.name) for k, v in scenes.items()})
    paths = {}

    # frames: a test view of each LLFF config, synth800_proposal.yml at 800x800 with its eval-only box
    for name, config, scene in (("ndc", NDC_CONFIG, scenes["forward"]), ("unbounded", UNBOUNDED_CONFIG,
                                                                         scenes["orbit"])):
        service, nerf_mlps = build_service(config)
        cfg = Config.fromfile(str(config))
        test = DATASETS.build(dict(cfg.datasets[2], base_dir=str(scene), factor=1))
        pose, focal, _, lo, hi = test[0]
        view = (pose[:3, :4], float(focal[0]), float(lo[0]), float(hi[0]))
        paths[f"{name}_frame"] = frame(torch, K1, service, card_line, config.name, with_k2=False, view=view,
                                       k1_per_frame=frame_chunks(cfg) * len(nerf_mlps))
        del service, nerf_mlps
        torch.cuda.empty_cache()
    service, nerf_mlps = build_service(AABB_CONFIG)
    paths["synth800_proposal_frame"] = frame(torch, K1, service, card_line, AABB_CONFIG.name, with_k2=False,
                                             k1_per_frame=frame_chunks(Config.fromfile(str(AABB_CONFIG))))
    del service, nerf_mlps
    torch.cuda.empty_cache()

    # fused: both LLFF proposal configs at steps_per_call 20 against two per-step runs
    for name, config, scene in (("ndc", NDC_CONFIG, scenes["forward"]), ("unbounded", UNBOUNDED_CONFIG,
                                                                         scenes["orbit"])):
        numbers, paths[f"{name}_train_fused"] = fused_train(
            torch, K1, K3, scene, tmp / f"results_{name}_fused", config, 2 * train_views, FUSED_STEPS_PER_CALL,
            extra_options=llff_options(config), train_frames=train_views)
        say(card_line, "fused", **numbers)
        if not all(numbers["checks"].values()):
            raise SystemExit(f"{config.name} fused phase failed: {numbers['checks']}")
        torch.cuda.empty_cache()

    # train: the classic synth_llff.yml per step through the host DataLoader, per-image metric bounds
    numbers, paths["synth_llff_train"] = train(
        torch, K1, K3, scenes["forward"], tmp / "results_synth_llff", LLFF_CLASSIC_CONFIG, train_views,
        extra_options=[*llff_options(LLFF_CLASSIC_CONFIG), "runner.cache_dataset_on_device=False"])
    say(card_line, "train", **numbers)
    if not all(numbers["checks"].values()):
        raise SystemExit(f"synth_llff train phase failed: {numbers['checks']}")
    torch.cuda.empty_cache()

    # the card against the CPU in float32: NDC and contraction
    for config, scene in ((NDC_CONFIG, scenes["forward"]), (UNBOUNDED_CONFIG, scenes["orbit"])):
        family = family_check(torch, scene, config, FAMILY_EVAL_RAYS, FAMILY_TRAIN_RAYS, {"datasets.0.factor": 1},
                              density_bias=1.0)
        say(card_line, "family", **family)
        if not all(family["checks"].values()):
            raise SystemExit(f"{config.name} family phase failed: {family['checks']}")
        torch.cuda.empty_cache()
    return paths


def scene_codes(torch, config, checkpoint: str, data: Path) -> dict:
    """Each frame of a two-scene eval batch gets its own scene's code: the batch's frames against each frame
    rendered alone (PSNR), and the first frame with the other scene's id (the mean change)."""
    import numpy as np

    from yanerf_tpu_torch.datasets import DATASETS, stack_batch
    from yanerf_tpu_torch.ops.structures import EvaluationMode
    from yanerf_tpu_torch.runners import prepare_batch
    from yanerf_tpu_torch.serve import load_pipeline
    from yanerf_tpu_torch.utils import Config

    cfg = Config.fromfile(str(config))
    pipeline = load_pipeline(cfg, checkpoint, DEVICE)
    test = DATASETS.build(dict(cfg.datasets[2], base_dir=str(data)))
    items = [0, MULTISCENE["n_test"]]  # the first test view of scenes 0 and 1

    def frames(batch_items, scene_ids=None):
        batch = prepare_batch(stack_batch([test[i] for i in batch_items]), test.data_wrapper, torch.device(DEVICE))
        if scene_ids is not None:
            batch["scene_id"] = torch.tensor(scene_ids, dtype=torch.int32, device=DEVICE)
        with torch.inference_mode():
            return pipeline(evaluation_mode=EvaluationMode.EVALUATION, **batch)["rendered_images"].float().cpu()

    batched = frames(items)
    alone = [frames([i])[0] for i in items]
    swapped = frames([items[0]], [1])[0]

    def psnr(a, b):
        return -10.0 * math.log10(max(float(((a - b) ** 2).mean()), 1e-20))

    numbers = dict(scene_ids=[int(test[i][3]) for i in items], batch_vs_alone_psnr_db=[
        psnr(batched[k], alone[k]) for k in range(2)], other_scene_mean_abs_change=float(
        (swapped - alone[0]).abs().mean()))
    numbers["checks"] = {"own_code": min(numbers["batch_vs_alone_psnr_db"]) >= MIN_FRAME_PSNR,
                         "codes_matter": numbers["other_scene_mean_abs_change"] > 0.0,
                         "finite": bool(np.isfinite(batched.numpy()).all())}
    return numbers


def multiscene_phases(torch, K1, K3, card_line: str, tmp: Path) -> dict:
    """Multi-scene latent conditioning: the scenes, both configs fused against per-step runs, the card against
    the CPU. Returns the kernels' launches on each training path."""
    from yanerf_tpu_torch import synth_multiscene

    data = tmp / "multiscene"
    t = time.perf_counter()
    # the entry point of ``python -m yanerf_tpu_torch.synth_multiscene``
    synth_multiscene.main(["--out_dir", str(data), *(f"--{k}={v}" for k, v in MULTISCENE.items()), "--seed", "0"])
    say(card_line, "multiscene scene", seconds=time.perf_counter() - t, **MULTISCENE)
    paths = {}
    for name, config in (("latent", MULTISCENE_LATENT_CONFIG), ("control", MULTISCENE_CONTROL_CONFIG)):
        # a val epoch at the end of the run; then the test eval
        numbers, paths[f"multiscene_{name}_train_fused"] = fused_train(
            torch, K1, K3, data, tmp / f"results_multiscene_{name}", config, MULTISCENE_STEPS,
            MULTISCENE_STEPS_PER_CALL, extra_options=[f"runner.val_per_iter={MULTISCENE_STEPS * MULTISCENE_BATCH}"],
            train_frames=MULTISCENE["n_scenes"] * MULTISCENE["n_train"], batch_size=MULTISCENE_BATCH)
        numbers["checks"]["val_ran"] = len(numbers["val_stats"]) == 1 and all(
            math.isfinite(v) for v in numbers["val_stats"][0].values())
        if name == "latent":
            numbers["scene_codes"] = scene_codes(torch, config, numbers["checkpoint"], data)
            numbers["checks"].update({f"scene_codes_{k}": v for k, v in numbers["scene_codes"]["checks"].items()})
        say(card_line, "fused", **numbers)
        if not all(numbers["checks"].values()):
            raise SystemExit(f"{config.name} fused phase failed: {numbers['checks']}")
        torch.cuda.empty_cache()
    # +2 on every density bias: at +1 (the LLFF checks') this chunk of the latent config is still ill-conditioned
    # on the CPU itself, its depths moving by more than FAMILY_ATOL under a 1e-7 change of the directions
    # (printed: cpu_chunk_sensitivity)
    family = family_check(torch, data, MULTISCENE_LATENT_CONFIG, FAMILY_EVAL_RAYS, FAMILY_TRAIN_RAYS, density_bias=2.0,
                          items=(0, MULTISCENE["n_train"]), probe_biases=(1.0,))
    say(card_line, "family", **family)
    if not all(family["checks"].values()):
        raise SystemExit(f"{MULTISCENE_LATENT_CONFIG.name} family phase failed: {family['checks']}")
    torch.cuda.empty_cache()
    return paths


def run_tool(torch, K1, K3, module, argv, plain: bool = False):
    """``module.main(argv)``, the entry point of ``python -m``; with ``plain`` K1 is its plain version.

    Returns its result, the kernels' launches and the seconds it took.
    """
    import contextlib

    sync(torch)
    K1.launches = K1.pipelined_launches = K3.launches = 0
    t = time.perf_counter()
    with mock.patch.object(K1, "nerf_mlp_fwd", K1.nerf_mlp_fwd_plain) if plain else contextlib.nullcontext():
        out = module.main(argv)
    sync(torch)
    launches = {"nerf_mlp_fwd": K1.launches, "nerf_mlp_fwd_pipelined": K1.pipelined_launches,
                "nerf_mlp_bwd": K3.launches}
    return out, launches, time.perf_counter() - t


def tools_phases(torch, K1, K3, card_line: str, tmp: Path, checkpoint: str, scene: Path) -> dict:
    """The density-field tools on the flagship's fused checkpoint, K1 on the final NeRFMLP; returns the launches.

    The threshold (and the mesh's iso value) is the 90th percentile of the
    checkpoint's density on fit_occupancy's lattice, so that the grid is
    neither full nor empty whatever a short run learned. fit_occupancy and
    fit_aabb also run with K1's plain version: their grids and boxes may
    differ only at lattice points whose plain density lies within K1's
    tolerance of the threshold.
    """
    import numpy as np

    from yanerf_tpu_torch import extract_mesh, fit_aabb, fit_occupancy, render
    from yanerf_tpu_torch.ops.mesh import evaluate_density_grid, fit_scene_aabb
    from yanerf_tpu_torch.serve import load_pipeline
    from yanerf_tpu_torch.utils import Config

    bounds = (-2.0, 2.0)
    k1_on = ["--cfg_options", "pipeline.model.2.use_pallas=True"]
    cfg = Config.fromfile(str(CONFIG))
    cfg.merge_from_dict({"pipeline.model.2.use_pallas": True})
    with mock.patch.object(K1, "nerf_mlp_fwd", K1.nerf_mlp_fwd_plain):
        density = evaluate_density_grid(load_pipeline(cfg, checkpoint, DEVICE).implicit_functions[-1],
                                        TOOL_RESOLUTION, bounds, LATTICE_CHUNK)
    threshold = float(np.quantile(density, 0.9))
    common = ["--config", str(CONFIG), "--checkpoint", checkpoint, "--device", DEVICE, "--resolution",
              str(TOOL_RESOLUTION), "--chunk", str(LATTICE_CHUNK)]
    paths, numbers = {}, {}

    fit_args = [*common, "--threshold", str(threshold), "--out", str(tmp / "occupancy.npz")]
    fitted, paths["fit_occupancy"], seconds = run_tool(torch, K1, K3, fit_occupancy, [*fit_args, *k1_on])
    plain, _, plain_seconds = run_tool(torch, K1, K3, fit_occupancy, [*fit_args, *k1_on], plain=True)
    near = np.abs(plain["grid"] - threshold) <= KERNEL_ATOL + KERNEL_RTOL * np.abs(plain["grid"])
    flipped = (fitted["grid"] > threshold) != (plain["grid"] > threshold)
    numbers["fit_occupancy"] = dict(seconds=seconds, plain_seconds=plain_seconds, launches=paths["fit_occupancy"],
                                    threshold=threshold, fraction=fitted["fraction"],
                                    plain_fraction=plain["fraction"], voxels_near_threshold=int(near.sum()),
                                    voxels_flipped=int(flipped.sum()), grid_max_abs_err=float(
                                        np.abs(fitted["grid"] - plain["grid"]).max()))
    expected = -(-TOOL_RESOLUTION**3 // LATTICE_CHUNK)
    checks = {"fit_occupancy_k1_per_chunk": paths["fit_occupancy"]["nerf_mlp_fwd"] == expected,
              "fit_occupancy_flips_near_threshold_only": not (flipped & ~near).any()}

    boxed, paths["fit_aabb"], seconds = run_tool(torch, K1, K3, fit_aabb, [*common, "--threshold", str(threshold),
                                                                          *k1_on])
    plain_box, _, _ = run_tool(torch, K1, K3, fit_aabb, [*common, "--threshold", str(threshold), *k1_on], plain=True)
    sure, maybe = (plain["grid"] > threshold) & ~near, (plain["grid"] > threshold) | near
    outer = fit_scene_aabb(maybe.astype(np.float32), bounds, 0.5)
    inner = fit_scene_aabb(sure.astype(np.float32), bounds, 0.5) if sure.any() else None
    got = boxed["aabb"]
    within = bool((got[0] >= outer[0]).all() and (got[1] <= outer[1]).all()) and (
        inner is None or bool((got[0] <= inner[0]).all() and (got[1] >= inner[1]).all()))
    numbers["fit_aabb"] = dict(seconds=seconds, launches=paths["fit_aabb"], aabb=got.tolist(),
                               plain_aabb=plain_box["aabb"].tolist(),
                               equal_to_plain=bool(np.array_equal(got, plain_box["aabb"])))
    checks.update(fit_aabb_k1_per_chunk=paths["fit_aabb"]["nerf_mlp_fwd"] == expected,
                  fit_aabb_within_the_near_threshold_boxes=within)

    mesh, paths["extract_mesh"], seconds = run_tool(torch, K1, K3, extract_mesh, [
        *common, "--iso", str(threshold), "--vertex_colors", "--out", str(tmp / "mesh.obj"), *k1_on])
    numbers["extract_mesh"] = dict(seconds=seconds, launches=paths["extract_mesh"], iso=threshold,
                                   vertices=len(mesh["verts"]), faces=len(mesh["faces"]))
    checks["extract_mesh_obj_written"] = (tmp / "mesh.obj").exists() and paths["extract_mesh"]["nerf_mlp_fwd"] == (
        expected + -(-len(mesh["verts"]) // LATTICE_CHUNK))

    # the scene holds one test view: the test trajectory over the train split's cameras
    rendered, paths["render"], seconds = run_tool(torch, K1, K3, render, [
        "--config", str(CONFIG), "--checkpoint", checkpoint, "--device", DEVICE, "--trajectory", "test",
        "--n_frames", "2", "--output_dir", str(tmp / "renders"), "--cfg_options", "pipeline.model.2.use_pallas=True",
        f"datasets.2.base_dir={scene}", "datasets.2.split=train"])
    numbers["render"] = dict(seconds=seconds, launches=paths["render"], frames=rendered["frames"], fps=rendered["fps"])
    checks["render_pngs_written"] = rendered["frames"] == 2 and all(
        (tmp / "renders" / kind / f"{i:05d}.png").exists() for kind in ("rgb", "depth") for i in range(2))
    say(card_line, "tools", config=CONFIG.name, checkpoint=Path(checkpoint).name, checks=checks, **numbers)
    if not all(checks.values()):
        raise SystemExit(f"tools phase failed: {checks}")
    return paths


def occupancy_phase(torch, K1, card_line: str, tmp: Path) -> dict:
    """lego_proposal.yml's 800x800 frame with a constructed occupancy grid (a ball of voxels), K1 on.

    No grid, the default mode (coarse-to-fine on a decimated image) with
    K1 and with its plain version (PSNR), and the exact mode: each frame's
    seconds and peak memory; the rays' bounds of both modes on the card
    against the CPU's for the same grid and rays, with the rays whose bounds
    differ counted (a probe on a half may round the other way; it can move a
    bound by at most a probe spacing). Returns the launches of each mode.
    """
    import numpy as np

    from yanerf_tpu_torch.ops.occupancy import OccupancyGrid, occupancy_fraction, save_occupancy
    from yanerf_tpu_torch.ops.structures import EvaluationMode
    from yanerf_tpu_torch.pipelines import RAY_SAMPLERS
    from yanerf_tpu_torch.serve import CAM_CALIBRATION, orbit_pose, service_from_config
    from yanerf_tpu_torch.utils import Config

    res, half, radius = OCCUPANCY_BALL
    axis = np.linspace(-half, half, res, dtype=np.float32)
    x, y, z = np.meshgrid(axis, axis, axis, indexing="ij")
    occ = OccupancyGrid(grid=(x * x + y * y + z * z <= radius * radius).astype(np.uint8),
                        aabb=np.asarray([[-half] * 3, [half] * 3], np.float32))
    path = tmp / "ball.npz"
    save_occupancy(str(path), occ, threshold=0.0)
    modes = {"no_grid": {}, "default": {"pipeline.ray_sampler.occupancy_grid": str(path)},
             "exact": {"pipeline.ray_sampler.occupancy_grid": str(path), "pipeline.ray_sampler.occupancy_coarse_factor": 1,
                       "pipeline.ray_sampler.occupancy_block": 1}}
    pose = (orbit_pose(30.0, -30.0, 4.0) @ CAM_CALIBRATION)[:3, :4].astype(np.float32)
    numbers, launches, checks = {}, {}, {}
    for mode, options in modes.items():
        cfg = Config.fromfile(str(CONFIG))
        cfg.merge_from_dict({"pipeline.model.2.use_pallas": True, **options})
        service = service_from_config(cfg, checkpoint=None, device=DEVICE, seed=0)
        service.render(pose, service.default_focal)  # warm-up: the grid reaches the device once
        sync(torch)
        if DEVICE == "cuda":
            torch.cuda.reset_peak_memory_stats()
        K1.launches = 0
        t = time.perf_counter()
        rgb, _ = service.render(pose, service.default_focal)
        numbers[mode] = dict(frame_s=time.perf_counter() - t, k1_launches=K1.launches, mean_rgb=float(rgb.mean()),
                             peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9 if DEVICE == "cuda" else None)
        launches[mode] = {"nerf_mlp_fwd": K1.launches}
        checks[f"{mode}_k1_per_chunk"] = K1.launches == frame_chunks(cfg) and bool(np.isfinite(rgb).all())
        if mode == "no_grid":
            continue
        sampler = service._pipeline.ray_sampler
        rs = cfg.pipeline.ray_sampler
        cpu_sampler = RAY_SAMPLERS.build(dict(rs))
        focal = torch.tensor([[service.default_focal]])
        with torch.inference_mode():
            card_bundle = sampler(torch.as_tensor(pose)[None].to(DEVICE), focal.to(DEVICE), EvaluationMode.EVALUATION)
            cpu_bundle = cpu_sampler(torch.as_tensor(pose)[None], focal, EvaluationMode.EVALUATION)
        card_l, cpu_l = card_bundle.lengths.cpu().numpy(), cpu_bundle.lengths.numpy()
        differ = np.abs(card_l - cpu_l).max(axis=-1) > 1e-5
        n_probe = rs.get("occupancy_n_probe", 128) if mode == "exact" else min(
            rs.get("occupancy_n_probe_coarse", 32), rs.get("occupancy_n_probe_fine", 64))
        spacing = (rs.max_depth - rs.min_depth) / n_probe
        hit = cpu_l[..., -1] < rs.max_depth - 1e-5
        numbers[mode].update(rays_bounds_differ=int(differ.sum()), rays=int(differ.size),
                             bounds_max_abs_diff=float(np.abs(card_l - cpu_l).max()), probe_spacing=spacing,
                             rays_hitting_the_grid=int(hit.sum()))
        checks[f"{mode}_bounds_card_vs_cpu"] = float(np.abs(card_l - cpu_l).max()) <= spacing + 1e-5
        checks[f"{mode}_bounds_not_trivial"] = bool(hit.any() and (~hit).any())
        if mode == "default":
            launches[mode] = frame(torch, K1, service, card_line, f"{CONFIG.name} with occupancy_grid", with_k2=False,
                                   k1_per_frame=frame_chunks(cfg))
        del service
        torch.cuda.empty_cache()
    say(card_line, "occupancy frame", config=CONFIG.name, grid=dict(resolution=res, half_extent=half, ball_radius=radius,
        fraction=occupancy_fraction(occ)), checks=checks, **numbers)
    if not all(checks.values()):
        raise SystemExit(f"occupancy frame phase failed: {checks}")
    return {"occupancy_frame": launches["default"], "occupancy_frame_exact": launches["exact"]}


# -- the reference's checkpoints, the exported renderer, --debug, lego_tpu.yml, async saves -----------------

EXPORT_CONSUMER = """
import json, sys, time
import numpy as np
import torch
from yanerf_tpu_torch.export import load_artifact
from yanerf_tpu_torch.ops.kernels import nerf_mlp_fwd as K1

artifact, poses, focals, out, device = sys.argv[1:6]
t = time.perf_counter()
render = load_artifact(artifact)
load_s = time.perf_counter() - t
poses, focals = (torch.from_numpy(np.load(p)).to(device) for p in (poses, focals))
with torch.inference_mode():
    t = time.perf_counter()
    render(poses, focals).cpu()
    first_s = time.perf_counter() - t
    K1.launches = K1.pipelined_launches = 0
    t = time.perf_counter()
    frame = render(poses, focals).cpu()
    frame_s = time.perf_counter() - t
np.save(out, frame.numpy())
print(json.dumps({"load_s": load_s, "first_frame_s": first_s, "frame_s": frame_s,
                  "launches": {"nerf_mlp_fwd": K1.launches, "nerf_mlp_fwd_pipelined": K1.pipelined_launches}}))
"""


def orbit_view(service):
    """The orbit camera of "frame" (theta 30, phi -30, radius 4) as a world 3x4 pose, and the service's focal."""
    import numpy as np

    from yanerf_tpu_torch.serve import CAM_CALIBRATION, orbit_pose

    return (orbit_pose(30.0, -30.0, 4.0) @ CAM_CALIBRATION)[:3, :4].astype(np.float32), service.default_focal


def kernel_config(config, options=None):
    """``config`` with the NeRF-MLP kernel switched on for serving, and ``options`` merged."""
    from yanerf_tpu_torch.pipelines import set_nerf_mlp_option
    from yanerf_tpu_torch.utils import Config

    cfg = Config.fromfile(str(config))
    set_nerf_mlp_option(cfg, "use_pallas", True)
    cfg.merge_from_dict(dict(options or {}))
    return cfg


def pth_serve_phase(torch, K1, K3, service, card_line: str, tmp: Path, config=None) -> dict:
    """"pth serve": ``service``'s weights written as a reference-layout ``.pth`` and served from it.

    The service built from the file (its own seed differs) must render the
    frame of ``service`` bit for bit, K1 once per chunk and NeRFMLP.
    Returns the launches of the ``.pth`` frame.
    """
    import numpy as np

    from yanerf_tpu_torch.runners import export_torch_checkpoint
    from yanerf_tpu_torch.serve import service_from_config

    config = CLASSIC_CONFIG if config is None else config
    cfg = kernel_config(config)
    pth = tmp / "weights.pth"
    t = time.perf_counter()
    n_tensors = export_torch_checkpoint(service._pipeline, pth)
    write_s = time.perf_counter() - t
    t = time.perf_counter()
    from_pth = service_from_config(cfg, checkpoint=str(pth), device=DEVICE, seed=PTH_SEED)
    load_s = time.perf_counter() - t
    pose, focal = orbit_view(service)
    rgb, depth = service.render(pose, focal)
    sync(torch)
    K1.launches = K1.pipelined_launches = K3.launches = 0
    t = time.perf_counter()
    rgb_pth, depth_pth = from_pth.render(pose, focal)
    frame_s = time.perf_counter() - t
    launches = {"nerf_mlp_fwd": K1.launches, "nerf_mlp_fwd_pipelined": K1.pipelined_launches,
                "nerf_mlp_bwd": K3.launches}
    direct = dict(service._pipeline.named_parameters())
    n_mlps = sum(int(type(fn).__name__ == "NeRFMLP" and fn.use_pallas) for fn in from_pth._pipeline.implicit_functions)
    checks = {
        "weights_from_the_file": all(torch.equal(p, direct[k]) for k, p in from_pth._pipeline.named_parameters()),
        "frame_bit_equal": bool(np.array_equal(rgb_pth, rgb) and np.array_equal(depth_pth, depth)),
        "k1_once_per_chunk_and_nerf_mlp": launches == {"nerf_mlp_fwd": n_mlps * frame_chunks(cfg),
                                                       "nerf_mlp_fwd_pipelined": 0, "nerf_mlp_bwd": 0},
    }
    say(card_line, "pth serve", config=Path(config).name, tensors=n_tensors, pth_mb=pth.stat().st_size / 1e6,
        write_s=write_s, load_s=load_s, frame_s=frame_s, launches=launches, frame_hw=list(rgb.shape[:2]),
        mean_rgb=float(rgb.mean()), checks=checks)
    if not all(checks.values()):
        raise SystemExit(f"pth serve phase failed: {checks}")
    return launches


def export_phase(torch, K1, card_line: str, tmp: Path, config=None, options=None) -> dict:
    """"export": the config's EVALUATION frame as a ``torch.export`` program, loaded in a fresh process.

    The serve frame first (K1 once per chunk), then ``export.build_render_fn``
    of the same seed, traced (seconds, graph nodes, operator nodes) and
    saved (MB); a new ``python3`` loads it (``export.load_artifact``) and
    renders the same camera twice, K1 counted on the second frame. The
    restored frame must be within 1e-6 of the serve frame. Returns the
    launches of the serve frame and of the restored one.
    """
    import numpy as np

    from yanerf_tpu_torch import export
    from yanerf_tpu_torch.serve import service_from_config

    config = CONFIG if config is None else config
    options = {"pipeline.chunk_size_grid": EXPORT_CHUNK_SIZE_GRID} if options is None else options
    cfg = kernel_config(config, options)
    chunks = frame_chunks(cfg)
    service = service_from_config(cfg, checkpoint=None, device=DEVICE, seed=0)
    pose, focal = orbit_view(service)
    service.render(pose, focal)  # warm-up
    sync(torch)
    K1.launches = K1.pipelined_launches = 0
    t = time.perf_counter()
    rgb, _ = service.render(pose, focal)
    serve_s = time.perf_counter() - t
    serve_launches = {"nerf_mlp_fwd": K1.launches, "nerf_mlp_fwd_pipelined": K1.pipelined_launches}
    del service

    render, _ = export.build_render_fn(cfg, None, seed=0, device=DEVICE)
    poses = torch.eye(4, dtype=torch.float32)[None].clone()
    poses[0, :3, :4] = torch.from_numpy(pose)
    focals = torch.tensor([[focal]], dtype=torch.float32)
    inputs = (poses.to(DEVICE), focals.to(DEVICE))
    t = time.perf_counter()
    program = torch.export.export(render, inputs)
    export_s = time.perf_counter() - t
    artifact = tmp / "render.pt2"
    t = time.perf_counter()
    torch.export.save(program, artifact)
    save_s = time.perf_counter() - t
    numbers = dict(chunks=chunks, export_s=export_s, save_s=save_s, nodes=len(program.graph.nodes),
                   op_nodes=export.op_nodes(program), mb=artifact.stat().st_size / 1e6,
                   user_inputs=len(program.graph_signature.user_inputs),
                   parameters=len(program.graph_signature.parameters))
    with torch.inference_mode():
        direct = render(*inputs)[0].cpu().numpy()
    del program, render
    np.save(tmp / "poses.npy", poses.numpy())
    np.save(tmp / "focals.npy", focals.numpy())
    t = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", EXPORT_CONSUMER, str(artifact), str(tmp / "poses.npy"),
                           str(tmp / "focals.npy"), str(tmp / "restored.npy"), DEVICE],
                          cwd=REPO, capture_output=True, text=True, timeout=900)
    process_s = time.perf_counter() - t
    if proc.returncode != 0:
        raise SystemExit(f"export phase: the fresh process failed ({proc.returncode}):\n{proc.stderr[-4000:]}")
    restored_numbers = json.loads(proc.stdout.strip().splitlines()[-1])
    restored = np.load(tmp / "restored.npy")[0]
    err = float(np.abs(restored - rgb).max())
    restored_launches = restored_numbers.pop("launches")
    checks = {
        "restored_within_1e-6_of_serve": restored.shape == rgb.shape and err <= EXPORT_MAX_ERR,
        "direct_equals_serve": bool(np.array_equal(direct, rgb)),
        "one_operator_node_per_chunk": numbers["op_nodes"] == chunks,
        "no_parameter_input": numbers["parameters"] == 0 and numbers["user_inputs"] == 2,
        # the fresh process counts the card's launches; on the CPU (the tests) the plain version counts none
        "k1_once_per_chunk": serve_launches["nerf_mlp_fwd"] == chunks
        and restored_launches["nerf_mlp_fwd"] == (chunks if DEVICE == "cuda" else 0)
        and serve_launches["nerf_mlp_fwd_pipelined"] == restored_launches["nerf_mlp_fwd_pipelined"] == 0,
    }
    say(card_line, "export", config=Path(config).name, options=options, frame_hw=list(rgb.shape[:2]),
        serve_frame_s=serve_s, serve_launches=serve_launches, restored_launches=restored_launches,
        restored_max_abs_err=err, restored_bit_equal=bool(np.array_equal(restored, rgb)),
        fresh_process_s=process_s, **restored_numbers, **numbers, checks=checks)
    if not all(checks.values()):
        raise SystemExit(f"export phase failed: {checks}")
    return {"export_serve": serve_launches, "export_restored": restored_launches}


def debug_phase(torch, K1, K3, card_line: str, scene: Path, out_dir: Path, config=None, extra_options=()) -> dict:
    """"debug": ``python -m yanerf_tpu_torch.run --debug`` on ``scene``, to its checkpoints; returns the launches.

    Every split cut to ``batch_size + 1`` items (``scene`` holds two of
    each, every val and test view kept), one epoch, eval and a checkpoint
    after it, K1 and K3 once per step and NeRFMLP.
    """
    from yanerf_tpu_torch import run

    config = CONFIG if config is None else config
    argv = ["--config", str(config), "--device", DEVICE, "--debug", "--output_dir", str(out_dir), "--cfg_options",
            *(f"{key}.use_pallas_train=True" for key in nerf_mlp_keys(config)),
            *(f"datasets.{i}.base_dir={scene}" for i in range(3)), *(f"datasets.{i}.test_skip=1" for i in (1, 2)),
            *extra_options]
    sync(torch)
    K1.launches = K1.pipelined_launches = K3.launches = 0
    t = time.perf_counter()
    result = run.main(argv)
    sync(torch)
    run_s = time.perf_counter() - t
    launches = {"nerf_mlp_fwd": K1.launches, "nerf_mlp_fwd_pipelined": K1.pipelined_launches,
                "nerf_mlp_bwd": K3.launches}
    out = result["output_dir"]
    steps = result["state"].step
    n_mlps = kernel_mlps(result["state"].pipeline)
    ckpts = sorted(c.name for c in (out / "ckpts").iterdir())
    checks = {
        "debug_mode": "In DEBUG mode, some hyperparameters have been changed." in (out / "run.log").read_text(),
        "steps": steps == 2 and len(result["train_stats"]) == 1,
        "checkpoints": ckpts == ["ckpts_-001", "ckpts_0000"],
        "k1_k3_per_step": launches["nerf_mlp_fwd"] == launches["nerf_mlp_bwd"] == n_mlps * steps > 0,
        "metrics_finite": all(math.isfinite(v) for v in result["test_stats"].values()),
    }
    say(card_line, "debug", config=Path(config).name, run_s=run_s, steps=steps, checkpoints=ckpts, launches=launches,
        val_stats=result["val_stats"], test_stats=result["test_stats"], checks=checks)
    if not all(checks.values()):
        raise SystemExit(f"debug phase failed: {checks}")
    return launches


def lego_tpu_phase(torch, K1, K3, card_line: str, scene: Path, out_dir: Path, config=None, steps=None,
                   extra_options=()) -> dict:
    """"lego_tpu": lego_tpu.yml as it ships (16,384 rays, ``approx_top_k``, ``steps_per_call: 8`` on the uint8
    device cache) with ``use_pallas_train``, ``steps`` steps (one epoch of the 40-frame scene); returns the
    launches.

    K1 and K3 once per step and NeRFMLP (twice per replay), the fused path
    taken, the objective finite at every step, every parameter moved;
    ms per step, the capture's seconds and the peak device memory.
    """
    from yanerf_tpu_torch import run
    from yanerf_tpu_torch.ops.kernels import launch_count
    from yanerf_tpu_torch.ops.structures import EvaluationMode

    config = LEGO_TPU_CONFIG if config is None else config
    steps = FUSED_TRAIN_FRAMES if steps is None else steps
    argv = ["--config", str(config), "--device", DEVICE, "--output_dir", str(out_dir), "--cfg_options",
            *(f"{key}.use_pallas_train=True" for key in nerf_mlp_keys(config)), f"runner.num_iters={steps}",
            *(f"datasets.{i}.base_dir={scene}" for i in range(3)), *extra_options]
    sync(torch)
    if DEVICE == "cuda":
        torch.cuda.reset_peak_memory_stats()
    K1.launches = K1.pipelined_launches = K3.launches = 0
    t = time.perf_counter()
    with observe_run(torch) as seen:
        result = run.main(argv)
    sync(torch)
    run_s = time.perf_counter() - t
    launches = {"nerf_mlp_fwd": K1.launches, "nerf_mlp_fwd_pipelined": K1.pipelined_launches,
                "nerf_mlp_bwd": K3.launches}
    state, trainer = result["state"], result["train_step_fused"]
    sampler = state.pipeline.ray_sampler.sampler(EvaluationMode.TRAINING)
    n_mlps = kernel_mlps(state.pipeline)
    objective = seen.objective()
    tally = launch_count.per_replay(trainer.tally) if trainer is not None and trainer.tally is not None else {}
    on_card = DEVICE == "cuda"
    step_s = [s["step_s"] for s in result["train_stats"] if "step_s" in s]
    checks = {
        "approx_top_k": bool(sampler.approx_top_k) and not sampler.pixel_replacement,
        "fused_path_ran": trainer is not None and trainer.dispatches > 0 and (trainer.graph is not None) == on_card,
        "launches_per_replay": tally == ({"nerf_mlp_fwd.launches": n_mlps, "nerf_mlp_bwd.launches": n_mlps}
                                         if on_card else {}),
        "k1_k3_per_step": launches["nerf_mlp_fwd"] == launches["nerf_mlp_bwd"] == n_mlps * state.step > 0
        and launches["nerf_mlp_fwd_pipelined"] == 0 and state.step == steps,
        "objective_finite": objective.numel() == state.step and bool(torch.isfinite(objective).all()),
        "params_moved": seen.moved(state.pipeline) == len(seen.initial),
        "test_metrics_finite": all(math.isfinite(v) for v in result["test_stats"].values()),
    }
    say(card_line, "lego_tpu", config=Path(config).name, rays_per_step=sampler.n_rays_per_image, steps=state.step,
        steps_per_call=trainer.steps_per_call if trainer is not None else None,
        dispatches=trainer.dispatches if trainer is not None else 0, capture_s=getattr(trainer, "capture_s", None),
        launches=launches, launches_per_replay=tally, ms_per_step=1e3 * step_s[-1] if step_s else None,
        train_rays_per_s=sampler.n_rays_per_image / step_s[-1] if step_s else None, run_s=run_s,
        peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9 if on_card else None,
        objective_first=float(objective[0]), objective_last=float(objective[-1]), test_stats=result["test_stats"],
        checks=checks)
    if not all(checks.values()):
        raise SystemExit(f"lego_tpu phase failed: {checks}")
    return launches


def async_save_phase(torch, K1, K3, card_line: str, scene: Path, out_dir: Path, config=None, epochs=None,
                     frames=None, extra_options=()) -> dict:
    """"async save": the fused flagship CLI with a checkpoint after every epoch, saved async (as it ships) and
    sync; returns the launches of the async run.

    Per run: the seconds each periodic save held the loop, and the CLI's
    ms per step from the first epoch's start to the final save. In the
    async run each async save is followed by a sync save of the same state
    to a side directory before the next dispatch; after the run each async
    file must equal its sync twin tensor for tensor.
    """
    import yanerf_tpu_torch.runners as runners
    from yanerf_tpu_torch import run

    config = CONFIG if config is None else config
    epochs = ASYNC_EPOCHS if epochs is None else epochs
    frames = FUSED_TRAIN_FRAMES if frames is None else frames
    save = runners.save_checkpoint

    train_one_epoch = runners.train_one_epoch

    def cli(run_name: str, async_saves: bool):
        records, started = [], []
        twins = out_dir / f"{run_name}_sync_twins"

        def saving(output_dir, state, epoch, name=None, async_save=False):
            t0 = time.perf_counter()
            path = save(output_dir, state, epoch=epoch, name=name, async_save=async_save and async_saves)
            t1 = time.perf_counter()
            side = save(twins, state, epoch=epoch, name=name) if async_save and async_saves else None
            records.append(dict(path=path, side=side, periodic=async_save, t0=t0, t1=t1,
                                side_s=time.perf_counter() - t1))
            return path

        def epoch_fn(*args, **kwargs):
            started.append(time.perf_counter())
            return train_one_epoch(*args, **kwargs)

        argv = ["--config", str(config), "--device", DEVICE, "--output_dir", str(out_dir / run_name), "--cfg_options",
                *(f"{key}.use_pallas_train=True" for key in nerf_mlp_keys(config)),
                f"runner.num_iters={epochs * frames}", f"runner.save_per_iter={frames}",
                *(f"datasets.{i}.base_dir={scene}" for i in range(3)), *extra_options]
        sync(torch)
        K1.launches = K1.pipelined_launches = K3.launches = 0
        with mock.patch.object(runners, "save_checkpoint", saving), mock.patch.object(runners, "train_one_epoch",
                                                                                      epoch_fn):
            result = run.main(argv)
        launches = {"nerf_mlp_fwd": K1.launches, "nerf_mlp_fwd_pipelined": K1.pipelined_launches,
                    "nerf_mlp_bwd": K3.launches}
        periodic = [r for r in records if r["periodic"]]
        final = records[-1]
        loop_s = final["t0"] - started[0] - sum(r["side_s"] for r in records)
        steps = result["state"].step
        return dict(result=result, launches=launches, periodic=periodic, steps=steps,
                    save_block_ms=[1e3 * (r["t1"] - r["t0"]) for r in periodic],
                    cli_ms_per_step=1e3 * loop_s / steps,
                    step_ms=[1e3 * s["step_s"] for s in result["train_stats"] if "step_s" in s])

    runs = {"async": cli("async", True), "sync": cli("sync", False)}
    twins_equal = []
    for record in runs["async"]["periodic"]:
        a, b = (torch.load(p, weights_only=True) for p in (record["path"], record["side"]))
        twins_equal.append(payloads_equal(torch, a, b) and a["step"] == b["step"])
    # the runs start from one seed; the last periodic file is overwritten by the final save of the same name
    firsts = [torch.load(runs[k]["periodic"][0]["path"], weights_only=True) for k in ("async", "sync")]
    checks = {
        "periodic_saves": [len(r["periodic"]) for r in runs.values()] == [epochs, epochs],
        "async_equals_its_sync_twin": len(twins_equal) == epochs and all(twins_equal),
        "no_tmp_left": not list(out_dir.glob("**/*.tmp")),
        "fused_path_ran": all(r["result"]["train_step_fused"].dispatches > 0 for r in runs.values()),
        "steps": runs["async"]["steps"] == runs["sync"]["steps"] == epochs * frames,
    }
    say(card_line, "async save", config=Path(config).name, epochs=epochs, steps=runs["async"]["steps"],
        **{f"{k}_save_block_ms": r["save_block_ms"] for k, r in runs.items()},
        **{f"{k}_cli_ms_per_step": r["cli_ms_per_step"] for k, r in runs.items()},
        **{f"{k}_step_ms": r["step_ms"] for k, r in runs.items()},
        first_checkpoints_of_the_two_runs_equal=payloads_equal(torch, *firsts),
        launches=runs["async"]["launches"], checks=checks)
    if not all(checks.values()):
        raise SystemExit(f"async save phase failed: {checks}")
    return runs["async"]["launches"]


def jpeg_decode_phase(card_line: str) -> None:
    """Decode the committed capture with ``native`` on this machine's host: every array's sha256 against the
    digest of the JAX package's libjpeg decode (``digests.json``), and the decode rate, one thread and batched."""
    import hashlib
    import os

    from yanerf_tpu_torch import native

    digests = json.loads((JPEG_CAPTURE / "digests.json").read_text())["decode"]
    files = sorted((JPEG_CAPTURE / "images").iterdir())
    jpeg_mb = sum(f.stat().st_size for f in files) / 1e6
    one_s, batch_s = [], []
    for _ in range(JPEG_DECODE_REPEATS):
        t = time.perf_counter()
        single = [native.decode_image(f) for f in files]
        one_s.append(time.perf_counter() - t)
        t = time.perf_counter()
        batched = native.decode_batch(files)
        batch_s.append(time.perf_counter() - t)
    sha = [hashlib.sha256(img.tobytes()).hexdigest() for img in single]
    megapixels = sum(img.shape[0] * img.shape[1] for img in single) / 1e6
    checks = {
        "decode_digests": sha == [digests[f.name] for f in files],
        "batch_digests": [hashlib.sha256(img.tobytes()).hexdigest() for img in batched] == sha,
        "files": len(files) == len(digests) > 0,
    }
    say(card_line, "jpeg decode", where="the card machine's host CPU", cpus=os.cpu_count(), files=len(files),
        jpeg_mb=jpeg_mb, megapixels=megapixels, one_thread_s=min(one_s), batched_s=min(batch_s),
        one_thread_mb_per_s=jpeg_mb / min(one_s), batched_mb_per_s=jpeg_mb / min(batch_s),
        one_thread_megapixels_per_s=megapixels / min(one_s), batched_megapixels_per_s=megapixels / min(batch_s),
        checks=checks)
    if not all(checks.values()):
        raise SystemExit(f"jpeg decode phase failed: {checks}")


def jpeg_capture_phases(torch, K1, K3, card_line: str, tmp: Path, configs=None, factor: int = JPEG_FACTOR,
                        steps: int = JPEG_TRAIN_STEPS) -> dict:
    """fern.yml and real_360.yml from the JPEG capture: the PNG cache against the JAX ``_minify`` digests,
    fern.yml trained fused on K1 / K3 at its published widths, a real_360.yml frame on K1, both held to their
    eager twins on the CPU. ``configs`` (the pair) and ``factor`` (the views' size) stand in for the
    published ones in the tests. Returns the kernels' launches on each path."""
    import hashlib
    import shutil

    from yanerf_tpu_torch.datasets import DATASETS, LLFFDataset
    from yanerf_tpu_torch.utils import Config
    from yanerf_tpu_torch.utils.images import load_image_u8

    fern, real_360 = (FERN_CONFIG, REAL_360_CONFIG) if configs is None else configs
    capture = tmp / "llff_jpeg"
    shutil.copytree(JPEG_CAPTURE, capture)
    digests = json.loads((JPEG_CAPTURE / "digests.json").read_text())
    t = time.perf_counter()
    LLFFDataset._minify(str(capture), factors=[JPEG_FACTOR])
    minify_s = time.perf_counter() - t
    pngs = sorted((capture / digests["minify_dir"]).iterdir())
    images = [load_image_u8(png) for png in pngs]
    checks = {"minify_digests": [hashlib.sha256(img.tobytes()).hexdigest() for img in images]
              == [digests["minify"][png.name] for png in pngs] and len(pngs) == len(digests["minify"]),
              "fern_size": all(img.shape[:2] == LLFF_HW for img in images)}
    say(card_line, "jpeg capture", minify_s=minify_s, views=len(pngs), hw=list(images[0].shape[:2]), checks=checks)
    if not all(checks.values()):
        raise SystemExit(f"jpeg capture phase failed: {checks}")

    paths = {}
    numbers, paths["fern_jpeg_train_fused"] = fused_train(
        torch, K1, K3, capture, tmp / "results_fern_jpeg", fern, steps, JPEG_STEPS_PER_CALL,
        extra_options=[*(f"datasets.{i}.factor={factor}" for i in range(3)), "runner.cache_dataset_on_device=True"],
        train_frames=JPEG_TRAIN_VIEWS)
    say(card_line, "fused", source="JPEG capture", **numbers)
    if not all(numbers["checks"].values()):
        raise SystemExit(f"{Path(fern).name} fused phase on the JPEG capture failed: {numbers['checks']}")
    torch.cuda.empty_cache()

    service, nerf_mlps = build_service(real_360)
    cfg = Config.fromfile(str(real_360))
    pose, focal, _, lo, hi = DATASETS.build(dict(cfg.datasets[2], base_dir=str(capture), factor=factor))[0]
    paths["real_360_jpeg_frame"] = frame(torch, K1, service, card_line, Path(real_360).name, with_k2=False,
                                         view=(pose[:3, :4], float(focal[0]), float(lo[0]), float(hi[0])),
                                         k1_per_frame=frame_chunks(cfg) * len(nerf_mlps))
    del service, nerf_mlps
    torch.cuda.empty_cache()

    for config in (fern, real_360):
        family = family_check(torch, capture, config, FAMILY_EVAL_RAYS, FAMILY_TRAIN_RAYS,
                              {"datasets.0.factor": factor}, density_bias=1.0)
        say(card_line, "family", source="JPEG capture", **family)
        if not all(family["checks"].values()):
            raise SystemExit(f"{Path(config).name} family phase on the JPEG capture failed: {family['checks']}")
        torch.cuda.empty_cache()
    return paths


def mask_phase(torch, card_line: str, scene: Path, config=None, n_rays: int = TRAIN_RAYS) -> dict:
    """One flagship train step with a two-layer ``sampling_prob_mask`` and one with ``mask_crop``, K1 + K3:
    every drawn pixel of positive weight, K1 and K3 once per NeRFMLP, and the step against the eager model's
    (``step_equivalence``). ``config`` / ``n_rays`` (its rays per step) stand in for the flagship in the
    tests. Returns the kernels' launches on each path."""
    from yanerf_tpu_torch.pipelines.ray_sampler import pixel_weights, resize_nearest
    from yanerf_tpu_torch.utils import Config

    config = CONFIG if config is None else config
    sampler = Config.fromfile(str(config)).pipeline.ray_sampler
    h, w = sampler.image_height, sampler.image_width
    gen = torch.Generator().manual_seed(11)
    prob = torch.rand((1, MASK_LAYERS, h, w), generator=gen)
    prob[:, 0, : h // 2] = 0.0  # layer 0 draws from the lower half, layer 1 from the upper
    prob[:, 1, h // 2:] = 0.0
    crop = torch.zeros((1, 1, h // 2, w // 2))  # nearest-resized to the image's grid
    crop[..., h // 8: 3 * h // 8, w // 8: 3 * w // 8] = 1.0
    kinds = {"sampling_prob_mask": {"sampling_prob_mask": prob.to(DEVICE),
                                    "n_rays_per_image": [n_rays // MASK_LAYERS] * MASK_LAYERS},
             "mask_crop": {"mask_crop": crop.to(DEVICE)}}
    paths = {}
    for kind, masks in kinds.items():
        step = step_equivalence(torch, scene, config, masks=masks)
        xy = step.pop("drawn_xys")
        mask = masks.get("mask_crop")
        weights, _ = pixel_weights(1, h, w, masks.get("n_rays_per_image", n_rays),
                                   None if mask is None else resize_nearest(mask, h, w)[:, 0],
                                   masks.get("sampling_prob_mask"), DEVICE)
        layers = weights.shape[1] if weights.ndim == 3 else 1
        flat = xy[:, 0] + w * xy[:, 1]
        layer = torch.arange(layers, device=DEVICE).repeat_interleave(n_rays // layers)
        drawn = weights[0, layer, flat] if weights.ndim == 3 else weights[0, flat]
        launches = step["launches_kernels"]
        paths[f"masks_{kind}_train"] = launches
        step["checks"].update({
            "drawn_pixels_weighted": bool((drawn > 0).all()) and flat.numel() == n_rays,
            "k1_k3_once": launches["nerf_mlp_fwd"] == launches["nerf_mlp_bwd"] == step["nerf_mlps"] > 0,
            "eager_launches_none": step["launches_eager"] == NO_LAUNCHES,
        })
        say(card_line, "masks", kind=kind, rays=int(flat.numel()), layers=layers, **step)
        if not all(step["checks"].values()):
            raise SystemExit(f"masks phase ({kind}) failed: {step['checks']}")
        torch.cuda.empty_cache()
    return paths


def parity_smoke_phase(card_line: str, tmp: Path, smoke_args=()) -> dict:
    """``python -m yanerf_tpu_torch.repro_parity --smoke --device cuda``: its JSON with every stage ok and the
    time-to-quality stage at its target. Returns the kernels' launches its runs logged (``run.log``)."""
    work, out = tmp / "parity_smoke", tmp / "parity_smoke.json"
    t = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "yanerf_tpu_torch.repro_parity", "--smoke", "--device", DEVICE,
                           "--smoke_dir", str(work), "--out", str(out), *smoke_args], cwd=REPO, capture_output=True,
                          text=True, timeout=900)
    seconds = time.perf_counter() - t
    record = json.loads(out.read_text()) if out.exists() else {}
    stages = record.get("stages", {})
    launches = {"nerf_mlp_fwd": 0, "nerf_mlp_fwd_pipelined": 0, "nerf_mlp_bwd": 0}
    for log in work.rglob("run.log"):
        lines = [ln for ln in log.read_text().splitlines() if "kernel launches: " in ln]
        if lines:
            for k, v in json.loads(lines[-1].split("kernel launches: ", 1)[1]).items():
                launches[k] += v
    checks = {"exit_0": proc.returncode == 0, "ok": record.get("ok") is True,
              "stages_ok": bool(stages) and all(stage.get("ok") for stage in stages.values()),
              "time_to_quality_reached": bool(stages.get("time_to_quality", {}).get("reached"))}
    say(card_line, "parity smoke", seconds=seconds, stages=stages, launches=launches, checks=checks)
    if not all(checks.values()):
        raise SystemExit(f"parity smoke phase failed: {checks}\n{proc.stdout[-2000:]}\n{proc.stderr[-2000:]}")
    return {"parity_smoke_train": launches}


def payloads_equal(torch, a, b) -> bool:
    """Two checkpoint payloads equal tensor for tensor (dtype, device and bits), and in every other value."""
    if isinstance(a, torch.Tensor):
        return isinstance(b, torch.Tensor) and (a.dtype, a.device) == (b.dtype, b.device) and torch.equal(a, b)
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(payloads_equal(torch, a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return isinstance(b, (list, tuple)) and len(a) == len(b) and all(
            payloads_equal(torch, x, y) for x, y in zip(a, b))
    return a == b


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))

    from yanerf_tpu_torch.ops.kernels import nerf_mlp_bwd as K3
    from yanerf_tpu_torch.ops.kernels import nerf_mlp_fwd as K1
    from yanerf_tpu_torch.serve import service_from_config
    from yanerf_tpu_torch.synth_scene import write_scene
    from yanerf_tpu_torch.utils import Config

    card_line = card()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    # 1. build: one nvcc per kernel source and g++ for the host JPEG decoder, all started together
    from yanerf_tpu_torch import native

    libraries = {"nerf_mlp_fwd": K1.LIBRARY, "nerf_mlp_fwd_pipelined": K1.PIPELINED_LIBRARY,
                 "nerf_mlp_bwd": K3.LIBRARY}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(libraries) + 1) as pool:
        host_build = pool.submit(native.LIBRARY.load)
        build_s = dict(zip(libraries, pool.map(lambda lib: lib.load(), libraries.values())))
    say(card_line, "build", seconds=time.perf_counter() - t0, per_kernel_s=build_s,
        ptxas={name: lib.build_report() for name, lib in libraries.items()}, jpeg_decoder_gxx_s=host_build.result())

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
    check_llff_ranges(torch, K1, K3, nerf_mlp, packed, gen, card_line)
    k1_lattice = check_k1(torch, K1, nerf_mlp, packed, LATTICE_CHUNK, 1, gen, "lattice")
    say(card_line, "kernel", name="nerf_mlp_fwd", shape=f"density tools' lattice chunk, {LATTICE_CHUNK} points of "
        "[-2, 2]^3 along (0, 0, 1)", **k1_lattice)
    say(card_line, "kernel", name="nerf_mlp_fwd", shape=f"extract_mesh's lattice chunk, {LATTICE_CHUNK} points of "
        "[-1.5, 1.5]^3 along (0, 0, 1)", **check_k1(torch, K1, nerf_mlp, packed, LATTICE_CHUNK, 1, gen, "lattice_mesh"))
    torch.cuda.empty_cache()

    # 3. serve and 4. frame, proposal then classic
    serve_launches = {"proposal": serve(torch, K1, K3, service, card_line, CONFIG.name, CHUNKS_PER_FRAME)}
    frame(torch, K1, service, card_line, CONFIG.name, with_k2=False)
    del service, nerf_mlps, nerf_mlp
    service, nerf_mlps = build_service(CLASSIC_CONFIG)
    serve_launches["classic"] = serve(torch, K1, K3, service, card_line, CLASSIC_CONFIG.name,
                                      len(nerf_mlps) * CHUNKS_PER_FRAME)
    classic_frame_launches = frame(torch, K1, service, card_line, CLASSIC_CONFIG.name, with_k2=True)
    # the classic frame from a reference-layout .pth; the flagship's frame as an exported program
    with tempfile.TemporaryDirectory(prefix="chip_smoke_export_") as tmp:
        checkpoint_paths = {"pth_serve": pth_serve_phase(torch, K1, K3, service, card_line, Path(tmp))}
        del service, nerf_mlps
        torch.cuda.empty_cache()
        checkpoint_paths.update(export_phase(torch, K1, card_line, Path(tmp)))
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

        # LLFF captures, NDC rays and unbounded scenes
        llff_paths = llff_phases(torch, K1, K3, card_line, Path(tmp))

        # multi-scene latent conditioning; the density tools on the flagship's fused checkpoint; occupancy bounds
        slice_paths = multiscene_phases(torch, K1, K3, card_line, Path(tmp))
        (Path(tmp) / "tools").mkdir()
        slice_paths.update(tools_phases(torch, K1, K3, card_line, Path(tmp) / "tools", fused_numbers["checkpoint"],
                                        fused_scene))
        slice_paths.update(occupancy_phase(torch, K1, card_line, Path(tmp)))

        # --debug, lego_tpu.yml as it ships, and the fused flagship CLI with async against sync saves
        debug_scene = write_scene(Path(tmp) / "debug_scene", hw=800, n_train=2, n_val=2, n_test=2, seed=2)
        checkpoint_paths["debug_train"] = debug_phase(torch, K1, K3, card_line, debug_scene, Path(tmp) / "debug")
        torch.cuda.empty_cache()
        checkpoint_paths["lego_tpu_train_fused"] = lego_tpu_phase(torch, K1, K3, card_line, fused_scene,
                                                                  Path(tmp) / "lego_tpu")
        torch.cuda.empty_cache()
        checkpoint_paths["async_save_train_fused"] = async_save_phase(torch, K1, K3, card_line, fused_scene,
                                                                      Path(tmp) / "async_save")
        torch.cuda.empty_cache()

        # real captures from JPEGs (fern.yml, real_360.yml), sampling masks, the parity runbook's smoke
        jpeg_decode_phase(card_line)
        capture_paths = jpeg_capture_phases(torch, K1, K3, card_line, Path(tmp))
        capture_paths.update(mask_phase(torch, card_line, scene))
        capture_paths.update(parity_smoke_phase(card_line, Path(tmp)))

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
        paths.update({name: launches.get(kernel, 0) for name, launches in llff_paths.items()})
        paths.update({name: launches.get(kernel, 0) for name, launches in slice_paths.items()})
        paths.update({name: launches.get(kernel, 0) for name, launches in checkpoint_paths.items()})
        paths.update({name: launches.get(kernel, 0) for name, launches in capture_paths.items()})
        return paths

    record = {
        "kernels": [
            dict(entry("nerf_mlp_fwd", "yanerf_tpu_torch/csrc/nerf_mlp_fwd.cu",
                       "yanerf_tpu/ops/pallas/nerf_mlp_kernel.py:154", k1, by_path("nerf_mlp_fwd")),
                 lattice_chunk={k: k1_lattice[k] for k in ("points", "ms", "plain_ms", "bound_ms", "bound_by",
                                                           "max_abs_err", "eager_ms")}),
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
    def kernels_missing(name, launches):
        """K1 on every LLFF path; K3 on every training path and on no frame."""
        trains = not name.endswith("_frame")
        return launches.get("nerf_mlp_fwd", 0) == 0 or (launches.get("nerf_mlp_bwd", 0) > 0) != trains

    idle = {name: launches for name, launches in llff_paths.items() if kernels_missing(name, launches)}
    if idle:
        raise SystemExit(f"a NeRF-MLP kernel did not run on an LLFF path: {idle}")
    # K1 and K3 on the control's training, K1 on the tools and the occupancy frame; neither on the latent path
    expected = {"multiscene_control_train_fused": ("nerf_mlp_fwd", "nerf_mlp_bwd"), "fit_occupancy": ("nerf_mlp_fwd",),
                "fit_aabb": ("nerf_mlp_fwd",), "extract_mesh": ("nerf_mlp_fwd",), "render": ("nerf_mlp_fwd",),
                "occupancy_frame": ("nerf_mlp_fwd",), "occupancy_frame_exact": ("nerf_mlp_fwd",)}
    idle = {name: slice_paths[name] for name, kernels in expected.items()
            if any(slice_paths[name].get(k, 0) == 0 for k in kernels)}
    if idle or slice_paths["multiscene_latent_train_fused"] != NO_LAUNCHES:
        raise SystemExit(f"a NeRF-MLP kernel did not run on a path of multi-scene training, the tools or the "
                         f"occupancy frame, or ran on the latent path: {idle}, "
                         f"{slice_paths['multiscene_latent_train_fused']}")
    # K1 on every path of the checkpoints, the export, --debug, lego_tpu.yml and the saves; K3 on their training
    idle = {name: launches for name, launches in checkpoint_paths.items()
            if launches.get("nerf_mlp_fwd", 0) == 0 or (launches.get("nerf_mlp_bwd", 0) > 0) != ("_train" in name)}
    if idle:
        raise SystemExit(f"a NeRF-MLP kernel did not run on a path of the checkpoints, the export, --debug, "
                         f"lego_tpu.yml or the async saves: {idle}")
    # K1 on every path of the JPEG captures, the masks and the parity smoke; K3 on their training
    idle = {name: launches for name, launches in capture_paths.items()
            if launches.get("nerf_mlp_fwd", 0) == 0 or (launches.get("nerf_mlp_bwd", 0) > 0) != ("_train" in name)}
    if idle:
        raise SystemExit(f"a NeRF-MLP kernel did not run on a path of the JPEG captures, the masks or the parity "
                         f"smoke: {idle}")
    say(card_line, "total", seconds=time.perf_counter() - t_start)
    print(json.dumps(record))
    print(card_line)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
