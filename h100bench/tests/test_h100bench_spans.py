"""The readers of the program's own trace regions: made-up intervals, and a tiny traced CPU run of each cell they
list (the host regions exist on the CPU too)."""

from __future__ import annotations

import json

import pytest

from h100bench import run
from h100bench.tests.tiny import REPO, run_tiny, tiny_root
from h100bench.trace import Trace

BENCH = run.Benchmark(REPO)
SPANS = {  # reader: the region names it sums
    "data_host_ms.train": ("data.batch",),
    "draws_host_ms.train": ("runner.draws",),
    "forward_host_ms.train": ("runner.forward",),
    "backward_host_ms.train": ("runner.backward",),
    "chunk_host_ms.frames": ("pipeline.chunk",),
    "model_host_ms.frames": ("model.NeRFMLP", "model.ProposalMLP"),
    "renderer_host_ms.frames": ("renderer.refine", "renderer.composite", "renderer.losses"),
    "fetch_wait_ms.frames": ("service.fetch",),
}
METRICS = [m for m in BENCH.spec["per_layer"] if m["name"] in SPANS]
CASES = [(m["name"], cell) for m in METRICS for cell in m["workloads"]]


def test_the_eight_readers_are_program_span_entries():
    assert [m["name"] for m in METRICS] == list(SPANS)
    assert all(m["source"] == "program_span" and m["unit"] == "ms" and m["better"] == "lower" for m in METRICS)
    layers = {m["layer"] for m in BENCH.spec["per_layer"] if m["name"] not in SPANS} | {"data", "service"}
    assert {m["layer"] for m in METRICS} <= layers


def made_up(names, units=2) -> Trace:
    """Each of ``names`` twice (10 and 30 us), a region of another name around them, an operator inside."""
    host = [("user_annotation", "service.render", 0.0, 200.0), ("cpu_op", "aten::mm", 5.0, 15.0)]
    for i, name in enumerate(names):
        host += [("user_annotation", name, 100.0 * i, 100.0 * i + 10.0),
                 ("user_annotation", name, 100.0 * i + 50.0, 100.0 * i + 80.0),
                 ("user_annotation", "not." + name, 100.0 * i, 100.0 * i + 90.0)]
    return Trace(device=[("kernel", "k", 0.0, 1.0)], host=host, window=(0.0, 400.0), units=units, work={})


@pytest.mark.parametrize("metric", list(SPANS))
def test_reader_sums_its_regions_per_unit(metric):
    reader = BENCH.reader({"name": metric})
    names = SPANS[metric]
    assert reader.read(made_up(names)) == pytest.approx(len(names) * 40.0 * 1e-3 / 2)
    assert reader.read(made_up(names, units=0)) is None
    assert reader.read(made_up(("elsewhere",))) is None


@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    """One tiny traced run per cell, made when a case first needs it."""
    root, results = tiny_root(tmp_path_factory.mktemp("tiny_spans")), {}

    def result(cell):
        if cell not in results:
            results[cell] = run_tiny(root, cell, trace=True)
        return results[cell]

    return result


@pytest.mark.parametrize("metric,cell", CASES)
def test_reader_reads_in_each_listed_cell(traced, metric, cell):
    result = traced(cell)
    json.dumps(result)
    assert result["metrics"][metric]["value"] > 0 and result["metrics"][metric]["unit"] == "ms"
