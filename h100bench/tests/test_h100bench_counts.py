"""The frozen counts against numbers worked by hand at the cells' shapes."""

from __future__ import annotations

import json

import pytest

from h100bench.counts import nerf as counts
from h100bench.tests.tiny import REPO

CONFIGS = {n: json.loads((REPO / "h100bench" / "configs" / f"{n}.json").read_text())["config"]
           for n in ("lego_proposal", "synth800")}
NERF = CONFIGS["synth800"]["pipeline"]["model"]
PROPOSAL = CONFIGS["lego_proposal"]["pipeline"]["model"][0]


def test_nerf_mlp_multiply_adds():
    # 63*256 + 7*256*256 + 63*256 (skip) + 256*257 (intermediate, density) + 283*128 + 128*3
    assert counts.nerf_mlp_macs(NERF) == {"forward": 593_408, "weight_grads": 593_408,
                                          "input_grads": 593_408 - 2 * 63 * 256 - 27 * 128}
    assert counts.nerf_mlp_parameters(NERF) == (593_408, 8 * 256 + 256 + 1 + 128 + 3)


def test_proposal_mlp_multiply_adds():
    assert counts.proposal_mlp_macs(PROPOSAL) == {"forward": 57_344, "weight_grads": 57_344,
                                                  "input_grads": 57_344 - 63 * 128}


@pytest.mark.parametrize("name,training,points", [
    ("lego_proposal", True, [64, 64, 48]), ("lego_proposal", False, [64, 64, 32]),
    ("synth800", True, [64, 192]), ("synth800", False, [64, 192]),
])
def test_points_per_ray(name, training, points):
    assert counts.points_per_ray(CONFIGS[name], training) == points


def test_step_work_lego_proposal():
    work = counts.step_work(CONFIGS["lego_proposal"])
    n = 4096 * 48
    assert work["k1"] == [(2 * 593_408 * n, n * 12 + 4096 * 12 + n * 16 + 2 * 593_408 + 4 * 2436)]
    assert work["k3"][0][0] == 2 * (593_408 + 557_696) * n
    per_ray = 2 * (593_408 + 593_408 + 557_696) * 48 + 2 * 2 * (57_344 + 57_344 + 49_280) * 64
    assert work["model_flops"] == per_ray * 4096
    assert 205e6 < per_ray < 215e6  # ~211 MFLOP a ray


def test_k1_is_bound_by_operations_at_the_train_shape():
    ops, io = counts.step_work(CONFIGS["lego_proposal"])["k1"][0]
    assert counts.least_seconds(ops, io) == pytest.approx(2 * 593_408 * 196_608 / 989e12)
    assert counts.least_seconds(ops, io) == pytest.approx(0.236e-3, rel=2e-3)


def test_frame_work_chunks():
    work = counts.frame_work(CONFIGS["lego_proposal"])
    assert len(work["k1"]) == 313  # ceil(640,000 * 64 / 131,072) chunks of 2,045 rays, the last 1,960
    assert work["k1"][0][0] == 2 * 593_408 * 2045 * 32 and work["k1"][-1][0] == 2 * 593_408 * 1960 * 32
    assert sum(w[0] for w in work["k1"]) == 2 * 593_408 * 640_000 * 32
    assert work["model_flops"] == pytest.approx(640_000 * (2 * 57_344 * 128 + 2 * 593_408 * 32))
    synth = counts.frame_work(CONFIGS["synth800"])
    assert len(synth["k1"]) == 2 * 313 and synth["model_flops"] == 2 * 593_408 * 640_000 * 256
