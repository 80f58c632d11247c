"""The reduction of a trace to per-layer metrics, on made-up intervals."""

from __future__ import annotations

import pytest

from h100bench import run
from h100bench.tests.tiny import REPO
from h100bench.trace import K1_NAMES, Trace, idle_percent, mfu, roofline_share, short_name

BENCH = run.Benchmark(REPO)


def made_up(work=None, units=2) -> Trace:
    device = [
        ("kernel", "void nerf_mlp_fwd_kernel(FwdArgs)", 10.0, 30.0),
        ("kernel", "void at::native::elementwise_kernel<128, 4>(int)", 20.0, 40.0),  # overlaps the first
        ("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 35.0, 45.0),  # overlaps the second
        ("kernel", "tile_kernel", 60.0, 70.0),
        ("kernel", "dw_kernel", 80.0, 90.0),
        ("kernel", "nerf_mlp_fwd_kernel", 95.0, 120.0),  # runs past the window's end
    ]
    host = [
        ("user_annotation", "fused_dispatch_K2", 0.0, 50.0),
        ("cpu_op", "aten::copy_", 51.0, 54.0),
        ("user_annotation", "train_step_dispatch", 50.0, 75.0),
        ("cuda_runtime", "cudaLaunchKernel", 46.0, 47.0),
    ]
    return Trace(device=device, host=host, window=(0.0, 100.0), units=units, work=work or {})


def test_busy_is_the_union_of_intervals():
    t = made_up()
    assert t.busy_intervals().tolist() == [[10.0, 45.0], [60.0, 70.0], [80.0, 90.0], [95.0, 100.0]]
    assert t.busy_s == pytest.approx(60e-6)
    assert idle_percent(t) == pytest.approx(40.0)


def test_idle_gaps_by_host_activity():
    # gaps 0-10, 45-60, 70-80, 90-95, each labelled at its middle
    gaps = dict(map(tuple, made_up().breakdown()["idle_gaps"]))
    assert gaps == pytest.approx({"fused_dispatch_K2": 10e-6, "train_step_dispatch > aten::copy_": 15e-6,
                                  "train_step_dispatch": 10e-6, "nothing traced": 5e-6})


def test_device_ops_by_short_name():
    ops = dict(map(tuple, made_up().breakdown()["device_ops"]))
    assert ops["nerf_mlp_fwd_kernel"] == pytest.approx(45e-6)
    assert short_name("void at::native::elementwise_kernel<128, 4>(int)") == "at::native::elementwise_kernel"


def test_roofline_and_mfu():
    t = made_up({"k1": [(989e12 * 10e-6, 1.0)], "model_flops": 989e12 * 5e-6})
    assert roofline_share(t, K1_NAMES, "k1") == pytest.approx(100.0 * 2 * 10e-6 / 45e-6)
    assert mfu(t) == pytest.approx(10.0)
    assert roofline_share(t, K1_NAMES, "k3") is None
    assert roofline_share(t, ("no_such_kernel",), "k1") is None


@pytest.mark.parametrize("metric", BENCH.spec["per_layer"], ids=lambda m: m["name"])
def test_readers_return_nothing_from_an_empty_trace(metric):
    empty = Trace(device=[], host=[], window=(0.0, 100.0), units=1, work={})
    assert BENCH.reader(metric).read(empty) is None


def test_dispatch_regions_per_step():
    reader = BENCH.reader({"name": "dispatch_host_ms.train"})
    assert reader.read(made_up()) == pytest.approx((50.0 + 25.0) * 1e-3 / 2)
