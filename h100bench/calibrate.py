"""Readings that the limits of a cell's check are set from: the program's, the control's and the planted faults'.

    python3 -m h100bench.calibrate --workload lego_proposal.train --seeds 1 2 3 --control 1 2 3 \\
        --faults half_batch --seconds 3 --out calibrate.jsonl

All in one process, one seed after another, each from a fresh set-up.
Per ``--seeds`` seed: the numbers the check compares for a sound run of
the program (set-up and a ``--seconds`` window at the cell's own load,
then the check). Per ``--control`` seed: the same numbers with the
reference computed in float8 put in the program's place. Per fault and
``--fault_seeds`` seed (the ``--control`` seeds if not given): a run of
the program with the fault planted (see ``FAULTS``). One JSON line per
reading, to standard output and ``--out``. The benchmark's own runs
never run this.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import sys
import time
from pathlib import Path
from typing import Iterator

import torch

from h100bench import inputs
from h100bench.reference.nerf import no_tf32
from h100bench.run import ROOT, Benchmark, Context


@contextlib.contextmanager
def half_batch() -> Iterator[None]:
    """The training call's color losses over the first half of its rays only, meaned over that half."""
    from yanerf_tpu_torch.pipelines.nerf_pipeline import NeRFPipeline

    original = NeRFPipeline._get_view_metrics

    def cut(out, n):
        if out is None:
            return None
        return dataclasses.replace(out, features=out.features[:, :n], depths=out.depths[:, :n],
                                   prev_stage=cut(out.prev_stage, n))

    def patched(self, raymarched, xys, image_rgb=None, depth_map=None, keys_prefix="loss_"):
        if not self.training:
            return original(self, raymarched, xys, image_rgb, depth_map, keys_prefix)
        n = xys.shape[1] // 2
        return original(self, cut(raymarched, n), xys[:, :n], image_rgb, depth_map, keys_prefix)

    NeRFPipeline._get_view_metrics = patched
    try:
        yield
    finally:
        NeRFPipeline._get_view_metrics = original


@contextlib.contextmanager
def unchanged_state() -> Iterator[None]:
    """Every optimizer step leaves the parameters and its state as they were."""
    original = torch.optim.Adam.step
    torch.optim.Adam.step = lambda self, closure=None: None
    try:
        yield
    finally:
        torch.optim.Adam.step = original


@contextlib.contextmanager
def stale_answer() -> Iterator[None]:
    """The render service answers each request with the frame of the one before (the first with its own)."""
    from yanerf_tpu_torch.serve import RenderService

    original = RenderService._render_tensors
    last = {}

    def patched(self, *args, **kwargs):
        out = original(self, *args, **kwargs)
        previous = last.get(id(self), out)
        last[id(self)] = out
        return previous

    RenderService._render_tensors = patched
    try:
        yield
    finally:
        RenderService._render_tensors = original


@contextlib.contextmanager
def altered_loss() -> Iterator[None]:
    """The training call's objective comes out 1% high where the pipeline produces it."""
    from yanerf_tpu_torch.pipelines.nerf_pipeline import NeRFPipeline

    original = NeRFPipeline._get_objective

    def patched(self, preds):
        objective = original(self, preds)
        return objective * 1.01 if self.training and objective is not None else objective

    NeRFPipeline._get_objective = patched
    try:
        yield
    finally:
        NeRFPipeline._get_objective = original


@contextlib.contextmanager
def first_row_only() -> Iterator[None]:
    """Every step of a fused dispatch reads the cache rows, learning rates and draws of the dispatch's first step
    (a device counter that the reads do not follow); the loss history is still written row by row."""
    from yanerf_tpu_torch.runners.apis import FusedTrainStep

    original = FusedTrainStep._step

    def first(t: torch.Tensor) -> torch.Tensor:
        return t[:1].expand_as(t)

    def patched(self):
        held = self._idx, self._lr, self._draws
        self._idx, self._lr = first(self._idx), first(self._lr)
        self._draws = {k: [first(t) for t in v] if isinstance(v, list) else first(v) for k, v in held[2].items()}
        try:
            original(self)
        finally:
            self._idx, self._lr, self._draws = held

    FusedTrainStep._step = patched
    try:
        yield
    finally:
        FusedTrainStep._step = original


@contextlib.contextmanager
def top_frequency_dropped() -> Iterator[None]:
    """The fused NeRF-MLP kernels see no sine or cosine of the points' highest embedding frequency: those rows of
    the first and skip layers' packed weights are zeroed after every pack and repack."""
    from yanerf_tpu_torch.ops.kernels import nerf_mlp_fwd

    pack, repack = nerf_mlp_fwd.pack_weights, nerf_mlp_fwd.repack_weights_

    def drop(packed, model):
        n = model.n_harmonic_functions_xyz
        top = [d * n + n - 1 for d in range(3)]  # sin of x, y, z at 2^(n-1); the cosines follow 3n rows on
        with torch.no_grad():
            for i in range(model.n_layers):
                rows = nerf_mlp_fwd._embedding_rows(model, i)
                if rows is not None:
                    for r in top + [3 * n + t for t in top]:
                        packed.weights[i][rows[0] + r].zero_()
        return packed

    nerf_mlp_fwd.pack_weights = lambda model: drop(pack(model), model)
    nerf_mlp_fwd.repack_weights_ = lambda packed, model: drop(repack(packed, model), model)
    try:
        yield
    finally:
        nerf_mlp_fwd.pack_weights, nerf_mlp_fwd.repack_weights_ = pack, repack


FAULTS = {"half_batch": half_batch, "unchanged_state": unchanged_state, "altered_loss": altered_loss,
          "stale_answer": stale_answer, "first_row_only": first_row_only,
          "top_frequency_dropped": top_frequency_dropped}


def readings(bench: Benchmark, name: str, seed: int, seconds: float, device, control: bool = False) -> dict:
    """The check's numbers for one seed: of the program after set-up and a window, or of the float8 control."""
    cell = bench.cell(name)
    traffic = bench.traffic(cell)
    spec = bench.config(cell)
    ctx = Context(name=name, config=spec["config"], traffic=traffic, seed=seed, seeds=inputs.sub_seeds(seed),
                  device=device)
    job = bench.kind(traffic).Cell(ctx)
    job.setup()
    job.window(seconds)
    job.free()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    no_tf32()
    out = job.control() if control else job.check()
    del job
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="*", default=[])
    parser.add_argument("--control", type=int, nargs="*", default=[], help="seeds of the control")
    parser.add_argument("--faults", nargs="*", default=[], choices=sorted(FAULTS))
    parser.add_argument("--fault_seeds", type=int, nargs="*", default=None, help="default: the control's seeds")
    parser.add_argument("--seconds", type=float, default=3.0)
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("h100bench.calibrate: no CUDA card", file=sys.stderr)
        return 2
    bench, device = Benchmark(ROOT), torch.device("cuda", 0)
    runs = [("program", s) for s in args.seeds] + [("control", s) for s in args.control]
    fault_seeds = args.control if args.fault_seeds is None else args.fault_seeds
    runs += [(fault, s) for fault in args.faults for s in fault_seeds]
    out = open(args.out, "a") if args.out else None
    try:
        for what, seed in runs:
            t0 = time.perf_counter()
            with FAULTS[what]() if what in FAULTS else contextlib.nullcontext():
                values = readings(bench, args.workload, seed, args.seconds, device, control=what == "control")
            line = json.dumps({"workload": args.workload, "run": what, "seed": seed, "readings": values,
                               "seconds": time.perf_counter() - t0, "card": torch.cuda.get_device_name(device)})
            print(line, flush=True)
            if out:
                out.write(line + "\n")
                out.flush()
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
