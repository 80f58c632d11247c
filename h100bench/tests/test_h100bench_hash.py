"""The hash-grid cell's own pieces: its frozen counts against numbers worked by hand, its four readers on made-up
traces, and a hash level left out of the encoding caught by the tiny cell's check. (The tests of every cell pick
the cell up by their own parametrisation: its result line, the float32 reference against the float32 program, the
planted faults.)"""

from __future__ import annotations

import contextlib
import json

import pytest
import torch

from h100bench import run
from h100bench.counts import hash_grid as counts
from h100bench.counts.nerf import least_seconds
from h100bench.tests.tiny import REPO, run_tiny, tiny_root
from h100bench.trace import Trace

BENCH = run.Benchmark(REPO)
CONFIG = json.loads((REPO / "h100bench" / "configs" / "synth800_ngp.json").read_text())["config"]
MODEL = CONFIG["pipeline"]["model"]
CELL = "synth800_ngp.train"
ROWS = 17 ** 3 + 23 ** 3 + 31 ** 3 + 43 ** 3 + 59 ** 3 + 11 * 2 ** 19  # five dense levels, eleven hashed
COARSE, FINE = 8192 * 64, 8192 * 192


def test_widths_are_the_published_ones():
    assert (MODEL["n_levels"], MODEL["n_features_per_level"], MODEL["table_size_log2"]) == (16, 2, 19)
    assert (MODEL["base_resolution"], MODEL["max_resolution"], MODEL["hidden_dim"]) == (16, 2048, 64)
    assert ROWS == 6_098_925 and counts.table_bytes(MODEL) == 8 * ROWS == 48_791_400


def test_mlp_multiply_adds():
    # density 32*64 + 64*16, color (15 + 27)*64 + 64*64 + 64*3; the direction's embedding takes no input gradient
    assert counts.mlp_macs(MODEL) == {"forward": 10_048, "weight_grads": 10_048, "input_grads": 10_048 - 27 * 64}


def test_step_work():
    work = counts.step_work(CONFIG)
    per_point = 3 * 4 + 16 * 2 * 4  # the point in, 32 features (or cotangents) of float32
    expected = [(2 * 8 * 2 * 16 * n, n * per_point + 48_791_400) for n in (COARSE, FINE)]
    assert work["hash_fwd"] == expected and work["hash_bwd"] == expected
    assert work["model_flops"] == 2 * (10_048 + 10_048 + 8_320) * (COARSE + FINE) == 119_185_342_464
    least = sum(least_seconds(ops, io) for ops, io in work["hash_fwd"])
    assert least == pytest.approx((2_097_152 * per_point + 2 * 48_791_400) / 3.35e12)
    assert least == pytest.approx(116.8e-6, rel=1e-3)  # bound by bytes: the blend's operations take 1/80 of it


def made_up(units=2) -> Trace:
    device = [
        ("kernel", "void (anonymous namespace)::hash_encode_fwd_kernel(Levels, float const*, float2*)", 0.0, 100.0),
        ("kernel", "hash_encode_fwd_kernel", 200.0, 300.0),
        ("kernel", "hash_encode_bwd_zero_kernel", 300.0, 310.0),
        ("kernel", "hash_encode_bwd_max_kernel", 310.0, 330.0),
        ("kernel", "hash_encode_bwd_scatter_kernel", 330.0, 630.0),
        ("kernel", "hash_encode_bwd_convert_kernel", 630.0, 650.0),
        ("kernel", "void at::native::elementwise_kernel<128, 4>(int)", 650.0, 900.0),
    ]
    host = [("user_annotation", "model.hash_encode", 0.0, 40.0), ("user_annotation", "model.HashGridNeRF", 0.0, 90.0),
            ("user_annotation", "model.hash_encode", 100.0, 160.0)]
    return Trace(device=device, host=host, window=(0.0, 1000.0), units=units, work=counts.step_work(CONFIG))


@pytest.mark.parametrize("name,value", [
    ("hash_fwd_roofline.train", 100.0 * 2 * 116.8e-6 / 200e-6),
    ("hash_bwd_roofline.train", 100.0 * 2 * 116.8e-6 / 350e-6),
    ("hash_device_ms.train", 550e-3 / 2),
    ("encode_host_ms.train", 100e-3 / 2),
])
def test_readers_on_a_made_up_trace(name, value):
    metric = [m for m in BENCH.spec["per_layer"] if m["name"] == name][0]
    assert metric["workloads"] == [CELL] and metric["moves"] == "train_rays_per_s"
    assert BENCH.reader(metric).read(made_up()) == pytest.approx(value, rel=2e-3)


@contextlib.contextmanager
def level_left_out(level: int):
    """The hash encoding without level ``level``: its features zero on both paths (plain and K4), so its table
    takes no gradient either."""
    from yanerf_tpu_torch.models.hash_grid import HashGridNeRF
    from yanerf_tpu_torch.ops.kernels import hash_encode

    plain, kernels = HashGridNeRF.encode, hash_encode.hash_encode

    def cut(features: torch.Tensor) -> torch.Tensor:
        keep = torch.ones(features.shape[-1], device=features.device)
        keep[2 * level:2 * level + 2] = 0.0
        return features * keep

    HashGridNeRF.encode = lambda self, tables, points: cut(plain(self, tables, points))
    hash_encode.hash_encode = lambda *args, **kwargs: cut(kernels(*args, **kwargs))
    try:
        yield
    finally:
        HashGridNeRF.encode, hash_encode.hash_encode = plain, kernels


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return tiny_root(tmp_path_factory.mktemp("tiny_hash"))


@pytest.mark.parametrize("level", [0, 4, 5, 15])  # the coarsest, the last dense, the first hashed, the finest
def test_a_level_left_out_is_not_correct(tiny, level):
    with level_left_out(level):
        result = run_tiny(tiny, CELL, seconds=0.3)
    assert result["correct"] is False, result["checks"]
