"""BENCHMARK.json against the contract, and every name in it against the file it leads to."""

from __future__ import annotations

import json
import math
import re
import subprocess
import sys

import pytest

from h100bench import run
from h100bench.tests.tiny import REPO

NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.\-]{1,16}")
SPEC = json.loads((REPO / "BENCHMARK.json").read_text())
BENCH = run.Benchmark(REPO)
CELLS = [w["name"] for w in SPEC["workloads"]]
METRICS = SPEC["end_to_end"] + SPEC["per_layer"]


def test_top_level_keys():
    assert list(SPEC) == ["command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"]
    assert SPEC["paths"] == ["h100bench"]
    assert 1 <= SPEC["run_seconds"] <= 51 and isinstance(SPEC["run_seconds"], int)
    assert len((REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert not any(w.startswith("/") or ".." in w for w in SPEC["command"])


@pytest.mark.parametrize("entry", SPEC["configs"] + SPEC["workloads"] + METRICS, ids=lambda e: e["name"])
def test_names_and_text(entry):
    assert NAME.fullmatch(entry["name"])
    for key in ("why", "layer", "source"):
        if key in entry:
            assert 1 <= len(entry[key]) <= 200 and "\n" not in entry[key] and "\t" not in entry[key]
    if "unit" in entry:
        assert UNIT.fullmatch(entry["unit"]) and entry["better"] in ("lower", "higher")


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves_to_its_files(cell):
    entry = BENCH.cell(cell)
    assert entry["chips"] == 1
    config = BENCH.config(entry)
    assert config["name"] == entry["config"] and config["reduced"] == []
    traffic = BENCH.traffic(entry)
    kind = BENCH.kind(traffic)
    assert hasattr(kind, "Cell") and kind.METRICS
    limits = BENCH.limits(entry)
    assert limits and all(v > 0 for v in limits.values())
    reported = {m["name"] for m in BENCH.metrics("end_to_end", entry)}
    assert "setup_s" in reported and set(kind.METRICS) <= reported
    assert BENCH.metrics("per_layer", entry)


@pytest.mark.parametrize("metric", SPEC["per_layer"], ids=lambda m: m["name"])
def test_per_layer_metric_resolves_to_its_reader(metric):
    assert callable(BENCH.reader(metric).read)
    moved = [m for m in SPEC["end_to_end"] if m["name"] == metric["moves"]]
    assert moved and set(metric["workloads"]) <= set(moved[0]["workloads"])


def test_bounds():
    for metric in SPEC["end_to_end"]:
        assert 0.01 <= metric["bound"] <= 0.25 and metric["source"] in ("host_clock", "device_trace")
    assert [m["name"] for m in SPEC["end_to_end"]].count("setup_s") == 1


def test_every_config_is_used_and_pairs_are_unique():
    assert {c["name"] for c in SPEC["configs"]} == {w["config"] for w in SPEC["workloads"]}
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(pairs) == len(set(pairs))


@pytest.mark.parametrize("name,found", [
    ("yanerf_tpu_torch.ops", []), ("yanerf_tpu", ["yanerf_tpu"]), ("yanerf_tpu.ops.rays", ["yanerf_tpu"]),
    ("jax.numpy", ["jax"]), ("jaxlib", ["jaxlib"]), ("flax.linen", ["flax"]), ("jax_extra", []),
])
def test_forbidden_modules_by_whole_top_level_name(monkeypatch, name, found):
    for key in [k for k in sys.modules if k.split(".")[0] in run.FORBIDDEN]:
        monkeypatch.delitem(sys.modules, key)
    monkeypatch.setitem(sys.modules, name, math)
    assert run.forbidden_modules() == found


def test_no_card_is_an_error_without_a_result(tmp_path):
    proc = subprocess.run([sys.executable, "-m", "h100bench.run", "--workload", CELLS[0], "--seed", "1",
                           "--seconds", "1", "--trace", "0"], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
    assert "CUDA" in proc.stderr


def test_benchmark_files_alone_are_an_error_without_a_result(tmp_path):
    import shutil

    shutil.copytree(REPO / "h100bench", tmp_path / "h100bench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    proc = subprocess.run([sys.executable, "-m", "h100bench.run", "--workload", CELLS[0], "--seed", "1",
                           "--seconds", "1", "--trace", "0"], cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
