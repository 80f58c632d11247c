"""The runner's times on the card against other checkouts: the fused CLI's ``step_s`` and the eval frames.

    python -m yanerf_tpu_torch.cli_timing --out_dir <dir> [--against <checkout>] [--serving_against <checkout>]
        [--rounds 3] [--frames 6]

On a procedural 800x800 Blender scene (40 train views and ``--frames``
test views, written once from a seed), each run a fresh process of the
checkout it times, the checkouts in turns (A B, B A, A B, ...):
  * "fused": ``python -m yanerf_tpu_torch.run`` of
    configs/nerf/lego_proposal.yml with K1 / K3 on its NeRFMLP
    (``use_pallas_train``) at ``steps_per_call`` 20, 80 steps (two epochs),
    no profiler: the last epoch's ``step_s``, in this checkout and in
    ``--against``'s (the parent, unpacked with ``git archive``);
  * "frames": ``run --test_only`` of the same config with K1 on
    (``use_pallas``) over the test views, every frame logged: each frame's
    ``inference`` field from ``run.log`` (the frames still in flight when
    the loop ends, the last ``eval_frames_in_flight`` = 2, read ~0: their
    wait was taken by the frame before them, and they are left out of the
    median); and ``python -m yanerf_tpu_torch.profile_serving --frames``
    in this checkout and in ``--serving_against``'s: each frame's seconds
    on the host clock, one frame in flight.
Prints one JSON line per run, then the medians and quartiles of each
series with the card's name and power limit, and writes them to
``<out_dir>/cli_timing.json``. Needs a GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import statistics
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
CONFIG = "configs/nerf/lego_proposal.yml"
FUSED_OPTIONS = ["pipeline.model.2.use_pallas_train=True", "runner.num_iters=80", "runner.steps_per_call=20"]
FRAME_OPTIONS = ["pipeline.model.2.use_pallas=True", "runner.print_per_iter=1", "datasets.2.test_skip=1"]
IN_FLIGHT = 2  # the eval loop's default eval_frames_in_flight
INFERENCE = re.compile(r"\tinference: ([0-9.]+)")


def python(checkout: Path, args, timeout: int = 900) -> str:
    """``python args`` in ``checkout`` (its own package first on the path); its standard output."""
    env = dict(os.environ, PYTHONPATH=str(checkout))
    proc = subprocess.run([sys.executable, *args], cwd=checkout, env=env, capture_output=True, text=True,
                          timeout=timeout)
    if proc.returncode:
        raise RuntimeError(f"{args} in {checkout} failed:\n{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
    return proc.stdout


def fused_step_s(checkout: Path, scene: Path, out: Path, frames: int) -> float:
    """The fused CLI's ``step_s`` of its last epoch (one test view evaluated at the end)."""
    python(checkout, ["-m", "yanerf_tpu_torch.run", "--config", CONFIG, "--output_dir", str(out), "--cfg_options",
                      *FUSED_OPTIONS, f"datasets.2.test_skip={frames}",
                      *(f"datasets.{i}.base_dir={scene}" for i in range(3))])
    stats = [json.loads(line) for line in (out / "version_0" / "train_stats.json").read_text().splitlines()]
    return stats[-1]["train_step_s"]


def eval_inference_s(checkout: Path, scene: Path, out: Path) -> list:
    """Each test frame's ``inference`` field of ``run --test_only``, in order."""
    python(checkout, ["-m", "yanerf_tpu_torch.run", "--config", CONFIG, "--test_only", "--output_dir", str(out),
                      "--cfg_options", *FRAME_OPTIONS, *(f"datasets.{i}.base_dir={scene}" for i in range(3))])
    return [float(m.group(1)) for m in map(INFERENCE.search, (out / "run.log").read_text().splitlines()) if m]


def serving_frame_s(checkout: Path, frames: int) -> list:
    """``profile_serving --frames``'s frame seconds."""
    out = python(checkout, ["-m", "yanerf_tpu_torch.profile_serving", "--frames", str(frames)])
    return json.loads(out.strip().splitlines()[-1])["frame_s"]


def summary(values: list) -> dict:
    q = statistics.quantiles(values, n=4, method="inclusive") if len(values) > 1 else values * 3
    return {"n": len(values), "median": statistics.median(values), "q1": q[0], "q3": q[2], "min": min(values),
            "max": max(values)}


def main(argv=None) -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out_dir", required=True)
    parser.add_argument("--against", help="a checkout whose fused CLI is timed in turns with this one's")
    parser.add_argument("--serving_against", help="a checkout whose profile_serving is timed in turns")
    parser.add_argument("--rounds", type=int, default=3)
    parser.add_argument("--frames", type=int, default=6, help="test views: frames per eval run and serving run")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("cli_timing: torch.cuda.is_available() is False; the times are the card's")
    from .synth_scene import write_scene

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    out = Path(args.out_dir).resolve()
    scene = write_scene(out / "scene", hw=800, n_train=40, n_val=1, n_test=args.frames, seed=1)
    fused_runs = {"this": REPO}
    if args.against:
        fused_runs["against"] = Path(args.against).resolve()
    frame_runs = {"this_eval": lambda r: eval_inference_s(REPO, scene, out / f"eval_{r}"),
                  "this_serving": lambda r: serving_frame_s(REPO, args.frames)}
    if args.serving_against:
        frame_runs["against_serving"] = lambda r: serving_frame_s(Path(args.serving_against).resolve(), args.frames)
    series: dict = {}
    for r in range(args.rounds):
        turn = (lambda names: names[::-1]) if r % 2 == 0 else list
        for name in turn(list(fused_runs)):
            value = fused_step_s(fused_runs[name], scene, out / f"fused_{name}_{r}", args.frames)
            series.setdefault(f"fused_step_s_{name}", []).append(value)
            print(json.dumps({"card": card, "round": r, "run": f"fused_{name}", "step_s": value}), flush=True)
        for name in turn(list(frame_runs)):
            values = frame_runs[name](r)
            if name == "this_eval":
                series.setdefault("eval_inference_s_in_loop", []).extend(values[:-IN_FLIGHT])
                series.setdefault("eval_inference_s_drained", []).extend(values[-IN_FLIGHT:])
            else:
                series.setdefault(f"{name}_frame_s", []).extend(values)
            print(json.dumps({"card": card, "round": r, "run": name, "seconds": values}), flush=True)
    record = {"card": card, "config": CONFIG, "rounds": args.rounds, "frames": args.frames,
              "against": args.against, "serving_against": args.serving_against,
              "series": series, "summary": {k: summary(v) for k, v in series.items()}}
    (out / "cli_timing.json").write_text(json.dumps(record, indent=1))
    print(json.dumps(record["summary"]))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
