"""A copy of the benchmark at a size the CPU runs in seconds: the same widths and points per ray, 16x16 frames,
64 rays a step, 6 views, a few steps per fused dispatch."""

from __future__ import annotations

import json
import shutil
import time
from pathlib import Path

import torch

from h100bench import run

REPO = Path(__file__).resolve().parents[2]


def tiny_root(tmp: Path, eager_float32: bool = False) -> Path:
    """A benchmark tree under ``tmp``: ``BENCHMARK.json`` and ``h100bench/`` with every configuration and traffic
    file cut to the tiny size; with ``eager_float32`` the models compute in float32 without the kernels."""
    tmp = Path(tmp)
    shutil.copytree(REPO / "h100bench", tmp / "h100bench", ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(REPO / "BENCHMARK.json", tmp / "BENCHMARK.json")
    for path in (tmp / "h100bench" / "configs").glob("*.json"):
        spec = json.loads(path.read_text())
        pipe, runner = spec["config"]["pipeline"], spec["config"]["runner"]
        pipe["ray_sampler"].update(image_height=16, image_width=16, n_rays_per_image_sampled_from_mask=64)
        pipe["chunk_size_grid"] = 4096
        runner["steps_per_call"] = min(3, int(runner.get("steps_per_call", 1)))
        if eager_float32:
            for model in pipe["model"] if isinstance(pipe["model"], list) else [pipe["model"]]:
                model["compute_dtype"] = "float32"
                model.pop("use_pallas", None)
                model.pop("use_pallas_train", None)
        path.write_text(json.dumps(spec))
    for path in (tmp / "h100bench" / "traffic").glob("*.json"):
        traffic = json.loads(path.read_text())
        traffic.update(height=16, width=16)
        if "views" in traffic:
            traffic["views"] = 6
        path.write_text(json.dumps(traffic))
    return tmp


def run_tiny(root: Path, cell: str, seed: int = 123456789012, trace: bool = False, seconds: float = 0.2) -> dict:
    """One run of ``cell`` of the tree at ``root`` on the CPU, as ``run.main`` runs it past its look for a card."""
    return run.run_cell(run.Benchmark(root), cell, seed, seconds, trace, torch.device("cpu"), time.perf_counter())
