"""``chunk_replay_share.frames``: the program's ``pipeline.replay`` regions over its ``pipeline.chunk`` regions,
read from made-up traces."""

from __future__ import annotations

import pytest

from h100bench import run
from h100bench.tests.tiny import REPO
from h100bench.trace import Trace

BENCH = run.Benchmark(REPO)
NAME = "chunk_replay_share.frames"


def frame(chunks: int, replays: int) -> Trace:
    """One frame of ``chunks`` chunk regions, the first ``replays`` of them each around a replay region."""
    host = [("user_annotation", "service.render", 0.0, 10.0 * chunks + 10.0)]
    for i in range(chunks):
        host.append(("user_annotation", "pipeline.chunk", 10.0 * i, 10.0 * i + 8.0))
        if i < replays:
            host.append(("user_annotation", "pipeline.replay", 10.0 * i + 1.0, 10.0 * i + 7.0))
        else:
            host.append(("user_annotation", "model.NeRFMLP", 10.0 * i + 1.0, 10.0 * i + 7.0))
    return Trace(device=[("kernel", "k", 0.0, 1.0)], host=host, window=(0.0, 10.0 * chunks + 10.0), units=1, work={})


def test_entry_reads_the_pipeline_layer_in_both_frames_cells():
    [metric] = [m for m in BENCH.spec["per_layer"] if m["name"] == NAME]
    assert metric == {"name": NAME, "unit": "%", "better": "higher", "source": "program_span",
                      "layer": "pipeline and autograd", "moves": "frame_ms",
                      "workloads": ["lego_proposal.frames", "synth800.frames"]}


@pytest.mark.parametrize("chunks,replays,share", [(313, 0, 0.0), (313, 313, 100.0), (4, 3, 75.0)])
def test_share_of_chunks_replayed(chunks, replays, share):
    assert BENCH.reader({"name": NAME}).read(frame(chunks, replays)) == pytest.approx(share)


def test_no_chunk_region_reads_nothing():
    assert BENCH.reader({"name": NAME}).read(frame(0, 0)) is None
