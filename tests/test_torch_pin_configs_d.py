"""Config pin, part 4 of 4: every fourth of ``configs/nerf/*.yml`` (from the 4th on), built in both packages
at tiny widths; an EVALUATION frame and one train step against ``yanerf_tpu`` (tests/torch_config_pin.py).

The configs are split over four files so that ``--dist loadfile`` spreads them over four workers.
"""

import pytest

from torch_config_pin import CONFIGS, check_eval_frame, check_train_step

PART = CONFIGS[3::4]


@pytest.mark.parametrize("config", PART)
def test_eval_frame_matches_jax(config):
    check_eval_frame(config)


@pytest.mark.parametrize("config", PART)
def test_train_step_matches_jax(config, monkeypatch):
    check_train_step(config, monkeypatch)
