"""Run one cell of the benchmark of ``yanerf_tpu_torch`` once, on the card(s) of this machine.

    python3 -m h100bench.run --workload lego_proposal.train --seed 7 --seconds 10 --trace 0

From the root of a checkout. The cell (an entry of ``BENCHMARK.json``'s
``workloads``) names a configuration (its file under
``h100bench/configs/``) and a traffic mix (``h100bench/traffic/<traffic>.json``,
whose ``kind`` names the generator module beside it); its limits are
``h100bench/limits/<cell>.json`` and each per-layer metric's reader is
``h100bench/metrics/<metric>.py``. Everything is found by its name, so a
new cell, configuration, mix or metric is new files and new entries.

The run makes its weights and inputs from ``--seed``, sets up (counted in
``setup_s`` from the process's start), then either measures the cell's
end-to-end metrics over ``--seconds`` (``--trace 0``) or traces a bounded
stretch and reads the per-layer metrics from it (``--trace 1``). Then it
frees the program's state and compares what the timed path produced with
the plain reference (``h100bench/reference/``). The numbers compared go to
standard error with their limits, and the result is the last line of
standard output, one JSON object. A machine without the card(s) the cell
asks for gets an error and no result; so does a run in which JAX or the
JAX package was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Any, Dict, List, Optional  # noqa: E402

import torch  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "yanerf_tpu")  # top-level module names, compared whole
ROOT = Path(__file__).resolve().parents[1]


def load_module(path: Path):
    """A module from its file, whatever its name (metric files carry dots)."""
    spec = importlib.util.spec_from_file_location(f"h100bench_file_{path.parent.name}_{path.stem}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@dataclasses.dataclass
class Context:
    """What a traffic kind gets: the cell's name, its configuration (the program's settings) and traffic dicts, the
    seeds, the device."""

    name: str
    config: dict
    traffic: dict
    seed: int
    seeds: Dict[str, int]
    device: torch.device

    def weights(self):
        from h100bench import inputs

        return inputs.make_weights(self.config, self.seeds["weights"], self.device)

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


class Benchmark:
    """``BENCHMARK.json`` under ``root`` and the files its names lead to."""

    def __init__(self, root: Path) -> None:
        self.root = Path(root)
        self.spec = json.loads((self.root / "BENCHMARK.json").read_text())
        self.dir = self.root / "h100bench"

    def _entry(self, key: str, name: str) -> dict:
        found = [e for e in self.spec[key] if e["name"] == name]
        if len(found) != 1:
            raise KeyError(f"BENCHMARK.json's {key} has no single entry named {name!r}")
        return found[0]

    def cell(self, name: str) -> dict:
        return self._entry("workloads", name)

    def config(self, cell: dict) -> dict:
        return json.loads((self.root / self._entry("configs", cell["config"])["file"]).read_text())

    def traffic(self, cell: dict) -> dict:
        return json.loads((self.dir / "traffic" / f"{cell['traffic']}.json").read_text())

    def kind(self, traffic: dict):
        return load_module(self.dir / "traffic" / f"{traffic['kind']}.py")

    def limits(self, cell: dict) -> Dict[str, float]:
        return json.loads((self.dir / "limits" / f"{cell['name']}.json").read_text())

    def metrics(self, key: str, cell: dict) -> List[dict]:
        """The ``end_to_end`` or ``per_layer`` metrics the cell reports."""
        return [m for m in self.spec[key] if "workloads" not in m or cell["name"] in m["workloads"]]

    def reader(self, metric: dict):
        return load_module(self.dir / "metrics" / f"{metric['name']}.py")


def forbidden_modules() -> List[str]:
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def card_report() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
        return out.stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi unavailable"


def run_cell(bench: Benchmark, name: str, seed: int, seconds: float, trace: bool, device: torch.device,
             t_start: float) -> dict:
    """Set up, measure or trace, free, compare; returns the result with its ``checks``."""
    from h100bench import inputs
    from h100bench import trace as tracing
    from h100bench.program import kernel_launches
    from h100bench.reference.nerf import no_tf32

    cell = bench.cell(name)
    traffic = bench.traffic(cell)
    spec = bench.config(cell)
    limits = bench.limits(cell)
    ctx = Context(name=name, config=spec["config"], traffic=traffic, seed=seed, seeds=inputs.sub_seeds(seed),
                  device=device)
    unit = {m["name"]: m["unit"] for key in ("end_to_end", "per_layer") for m in bench.spec[key]}
    cuda = device.type == "cuda"  # a fresh process: the peak below is the run's own

    job = bench.kind(traffic).Cell(ctx)
    job.setup()
    ctx.sync()
    setup_s = time.perf_counter() - t_start
    device_info: Dict[str, Any] = {
        "platform": "gpu" if cuda else "cpu",
        "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
        "count": 1,
    }
    breakdown = None
    if trace:
        stretch = tracing.profile(job.stretch, job.work, cuda)
        metrics: Dict[str, float] = {}
        for metric in bench.metrics("per_layer", cell):
            value = bench.reader(metric).read(stretch)
            if value is not None:
                metrics[metric["name"]] = value
        attempted, failed = stretch.units, 0
        device_info.update(busy_s=stretch.busy_s, window_s=stretch.window_s)
        breakdown = stretch.breakdown()
    else:
        out = job.window(seconds)
        metrics = {"setup_s": setup_s}
        for metric in bench.metrics("end_to_end", cell):
            if metric["name"] != "setup_s":
                metrics[metric["name"]] = out["metrics"][metric["name"]]
        attempted, failed = out["attempted"], out["failed"]
    device_info["memory_peak_bytes"] = int(torch.cuda.max_memory_allocated(device)) if cuda else 0
    print(f"h100bench: {name} seed {seed}: setup_s {setup_s}, peak device memory {device_info['memory_peak_bytes']} "
          f"bytes, kernel launches {json.dumps(kernel_launches())}, {card_report() if cuda else 'cpu'}",
          file=sys.stderr)

    job.free()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    no_tf32()
    readings = job.check()
    checks = {k: {"value": readings[k], "limit": float(limits[k])} for k in limits}
    correct = failed == 0 and all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": {k: {"value": v, "unit": unit[k]} for k, v in metrics.items()}, "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    return result


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True, help="a cell of BENCHMARK.json's workloads")
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True, help="the measured window")
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0, help="1: the per-layer metrics of a trace")
    return parser.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> int:
    args = parse_args(argv)
    bench = Benchmark(ROOT)
    chips = int(bench.cell(args.workload)["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"h100bench: {args.workload} needs {chips} CUDA card(s), found {found}", file=sys.stderr)
        return 2
    result = run_cell(bench, args.workload, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0),
                      T_START)
    loaded = forbidden_modules()
    if loaded:
        print(f"h100bench: the run loaded {loaded}: the benchmark measures the port alone", file=sys.stderr)
        return 3
    for key, c in result["checks"].items():
        print(f"check {key} {c['value']!r} limit {c['limit']!r} {'ok' if c['value'] <= c['limit'] else 'FAILED'}",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
