"""Whole runs of every cell at a tiny size on the CPU: the result line, the check against the reference, the faults
it has to catch, and a cell added as files alone. The card tests run the cells at their own size."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest
import torch

from h100bench import calibrate, run
from h100bench.tests.tiny import REPO, run_tiny, tiny_root

SPEC = json.loads((REPO / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in SPEC["workloads"]]
TRAIN = [c for c in CELLS if c.endswith(".train")]
FRAMES = [c for c in CELLS if c.endswith(".frames")]


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return tiny_root(tmp_path_factory.mktemp("tiny"))


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_result_line(tiny, cell, trace):
    result = run_tiny(tiny, cell, trace=bool(trace))
    keys = ["correct", "attempted", "failed", "metrics", "device"] + (["breakdown"] if trace else []) + ["checks"]
    assert list(result) == keys
    json.dumps(result)
    assert result["attempted"] >= 1 and result["failed"] == 0
    entry = run.Benchmark(tiny).cell(cell)
    if trace:
        expected = {m["name"] for m in run.Benchmark(tiny).metrics("per_layer", entry)}
        assert set(result["metrics"]) <= expected  # no kernel trace on the CPU: those readers find nothing
        assert set(result["device"]) == {"platform", "kind", "count", "memory_peak_bytes", "busy_s", "window_s"}
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        expected = {m["name"] for m in run.Benchmark(tiny).metrics("end_to_end", entry)}
        assert set(result["metrics"]) == expected
        assert all(m["value"] > 0 for m in result["metrics"].values())
    assert set(result["checks"]) == set(json.loads((REPO / "h100bench" / "limits" / f"{cell}.json").read_text()))
    assert all(set(c) == {"value", "limit"} for c in result["checks"].values())


@pytest.mark.parametrize("cell", CELLS)
def test_reference_follows_the_float32_program(tmp_path, cell):
    """With the models in float32 and no kernels, the program and the reference agree to rounding: the reference
    makes again the same draws, rays, samples, losses, gradients and Adam steps."""
    result = run_tiny(tiny_root(tmp_path, eager_float32=True), cell)
    assert all(c["value"] < 1e-4 for c in result["checks"].values()), result["checks"]


def test_same_seed_same_inputs(tiny):
    a = run_tiny(tiny, TRAIN[0], seed=2**31 + 11)["checks"]
    b = run_tiny(tiny, TRAIN[0], seed=2**31 + 11)["checks"]
    assert a == b


BENCH = run.Benchmark(REPO)
FUSED = [c for c in TRAIN if int(BENCH.config(BENCH.cell(c))["config"]["runner"].get("steps_per_call", 1) or 1) > 1]
FAULTS = ([(c, f) for c in TRAIN for f in ("unchanged_state", "half_batch", "altered_loss")]
          + [(c, "first_row_only") for c in FUSED] + [(c, "stale_answer") for c in FRAMES])


@pytest.mark.parametrize("cell,fault", FAULTS)
def test_a_planted_fault_is_not_correct(tiny, cell, fault):
    """The run's check catches a fault of the timed path: a step that leaves the state as it was, half of the
    rays left out of the loss, a loss altered where it is produced, a fused dispatch whose steps all read its first
    step's rows, rates and draws, an answer that is another request's. (One card: no exchange between chips to
    leave out.)"""
    with calibrate.FAULTS[fault]():
        result = run_tiny(tiny, cell, seconds=0.5)
    assert result["correct"] is False, result["checks"]


def test_a_new_cell_is_files_and_entries(tiny, tmp_path):
    """A configuration, a traffic mix and a cell added as new files and new entries alone run."""
    import shutil

    root = tmp_path / "bench"
    shutil.copytree(tiny, root)
    configs, traffic = root / "h100bench" / "configs", root / "h100bench" / "traffic"
    spec = json.loads((configs / "synth800.json").read_text())
    spec["name"] = "synth800_wide_chunk"
    spec["config"]["pipeline"]["chunk_size_grid"] = 16384
    (configs / "synth800_wide_chunk.json").write_text(json.dumps(spec))
    mix = json.loads((traffic / "frames_orbit.json").read_text())
    mix.update(poses=3, elevation_deg=[30.0, 40.0])
    (traffic / "frames_near.json").write_text(json.dumps(mix))
    (root / "h100bench" / "limits" / "synth800_wide_chunk.frames.json").write_text('{"rgb_rmse": 1.0}')
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "synth800_wide_chunk", "source": "https://arxiv.org/abs/2003.08934",
                             "file": "h100bench/configs/synth800_wide_chunk.json", "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "synth800_wide_chunk.frames", "config": "synth800_wide_chunk",
                               "traffic": "frames_near", "chips": 1, "why": "a test"})
    for metric in bench["end_to_end"] + bench["per_layer"]:
        if "synth800.frames" in metric.get("workloads", []):
            metric["workloads"].append("synth800_wide_chunk.frames")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    for trace in (False, True):
        result = run_tiny(root, "synth800_wide_chunk.frames", trace=trace)
        assert list(result["checks"]) == ["rgb_rmse"]
    assert set(run_tiny(root, "synth800_wide_chunk.frames")["metrics"]) == {"frame_ms", "setup_s"}


def test_a_run_loads_no_jax():
    code = ("import sys, tempfile, pathlib; from h100bench.tests.tiny import tiny_root, run_tiny; "
            "from h100bench import run; "
            "root = tiny_root(pathlib.Path(tempfile.mkdtemp(dir=sys.argv[1]))); "
            "[run_tiny(root, c, trace=t) for c in ('lego_proposal.train', 'synth800.frames') for t in (False, True)]; "
            "print(run.forbidden_modules(), sorted(m for m in sys.modules if m.startswith('yanerf_tpu_torch'))[:1])")
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        proc = subprocess.run([sys.executable, "-c", code, tmp], cwd=REPO, capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip().splitlines()[-1] == "[] ['yanerf_tpu_torch']"


# -- on the card -----------------------------------------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the cells run at their own size on the card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_the_card(card, cell, trace):
    proc = subprocess.run([sys.executable, "-m", "h100bench.run", "--workload", cell, "--seed", str(2**31 + 7),
                           "--seconds", "3", "--trace", str(trace)], cwd=REPO, capture_output=True, text=True,
                          timeout=900)
    assert proc.returncode == 0, proc.stderr[-4000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["correct"] is True, result["checks"]
    assert result["device"]["platform"] == "gpu" and result["device"]["count"] == 1
    if trace:
        assert result["device"]["busy_s"] > 0 and result["metrics"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_on_the_card_is_not_correct(card, cell):
    """The reference in float8 in the program's place fails the check at the cell's own size."""
    values = calibrate.readings(run.Benchmark(REPO), cell, 2**31 + 9, 2.0, card, control=True)
    limits = json.loads((REPO / "h100bench" / "limits" / f"{cell}.json").read_text())
    assert any(values[k] > limits[k] for k in limits), values
