"""The shipped configs on the card: every ``configs/nerf/*.yml`` named by chip_smoke.py, its "configs" phase
(``shipped_configs_phase``) on the CPU at a tiny size, and synth800_proposal_2p40.yml's schedule against
``yanerf_tpu``'s."""

import json
from pathlib import Path

import pytest
import torch

import yanerf_tpu.runners.schedules as jax_schedules
from yanerf_tpu_torch.ops.kernels import nerf_mlp_bwd as K3
from yanerf_tpu_torch.ops.kernels import nerf_mlp_fwd as K1
from yanerf_tpu_torch.runners.schedules import create_lr_schedule
from yanerf_tpu_torch.synth_scene import write_scene
from yanerf_tpu_torch.utils import Config

REPO = Path(__file__).resolve().parent.parent
CONFIGS = sorted(p.name for p in (REPO / "configs" / "nerf").glob("*.yml"))
NARROW = {"n_layers": 3, "input_skips": [2], "n_hidden_neurons_xyz": 32, "n_hidden_neurons_dir": 16}
JPEG_FACTOR = 36  # tests/data/llff_jpeg's 1008x756 views at 28x21
TINY_HW = {"blender": (16, 16), "blender_ngp": (16, 16), "jpeg": (21, 28)}  # else the LLFF scenes' 12x16
BLENDER_VIEWS = 6  # synth800 one epoch per step, synth800_proposal_2p40 fused at 3: the vis step, groups of 3 and 2
NGP_STEPS = 4


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The phase runs torch ops on tensors of a few thousand elements: one thread, so that the suite's parallel
    workers do not oversubscribe the cores (the intra-op pool's barriers then dominate)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("config", CONFIGS)
def test_every_shipped_config_is_named_by_chip_smoke(config):
    import chip_smoke

    named = {v.name for v in vars(chip_smoke).values() if isinstance(v, Path) and v.parent == REPO / "configs" / "nerf"}
    assert config in named


@pytest.mark.parametrize("step", [0, 999, 1000, 20000, 39999])
def test_synth800_proposal_2p40_schedule_matches_jax(step):
    runner = Config.fromfile(str(REPO / "configs" / "nerf" / "synth800_proposal_2p40.yml")).runner
    assert (runner.num_iters, runner.lr_decay_iters) == (40000, 45000)
    assert create_lr_schedule(runner)(step) == pytest.approx(float(jax_schedules.create_lr_schedule(runner)(step)),
                                                             rel=1e-6, abs=1e-12)


def _count_calls(monkeypatch):
    """CPU tensors take the plain versions, which count no launch: count the calls instead."""
    for module, name in ((K1, "nerf_mlp_fwd"), (K3, "nerf_mlp_bwd")):

        def counting(*args, _module=module, _entry=getattr(module, name), **kwargs):
            _module.launches += 1
            return _entry(*args, **kwargs)

        monkeypatch.setattr(module, name, counting)


def _tiny_config(config: Path, kind: str, path: Path) -> Path:
    """``config`` at a tiny frame, 16 rays, narrow models and ``steps_per_call`` 3 where it ships fused."""
    cfg = Config.fromfile(str(config))
    h, w = TINY_HW.get(kind, (12, 16))
    opts = {"pipeline.ray_sampler.image_height": h, "pipeline.ray_sampler.image_width": w,
            "pipeline.ray_sampler.n_rays_per_image_sampled_from_mask": 16, "pipeline.chunk_size_grid": 2048,
            "runner.num_workers_list": [0, 0, 0]}
    if int(cfg.runner.get("steps_per_call", 1) or 1) > 1:
        opts["runner.steps_per_call"] = 3
    models = cfg.pipeline.model
    keys = [f"pipeline.model.{i}" for i in range(len(models))] if isinstance(models, list) else ["pipeline.model"]
    for key, model in zip(keys, models if isinstance(models, list) else [models]):
        if model["type"] == "NeRFMLP":
            opts.update({f"{key}.{k}": v for k, v in NARROW.items()})
        elif model["type"] == "HashGridNeRF":
            opts.update({f"{key}.n_levels": 4, f"{key}.table_size_log2": 8, f"{key}.hidden_dim": 16,
                         f"{key}.max_resolution": 64})
        else:
            opts.update({f"{key}.n_layers": 2, f"{key}.hidden_dim": 16})
    cfg.merge_from_dict(opts)
    cfg.dump(str(path))
    return path


def test_chip_smoke_shipped_configs_phase_runs_on_the_cpu(tmp_path, monkeypatch, capsys):
    """The "configs" phase on the seven configs at tiny widths: 12x16 LLFF frames on 8-view scenes (7 train views),
    a 16x16 Blender scene of 6 train views, the JPEG capture at 28x21, steps_per_call 3."""
    import chip_smoke

    _count_calls(monkeypatch)
    for name, value in (("DEVICE", "cpu"), ("LLFF_HW", (12, 16)), ("LLFF_IMAGES", 8), ("FAMILY_EVAL_RAYS", 40),
                        ("FAMILY_TRAIN_RAYS", 64), ("FUSED_TRAIN_FRAMES", BLENDER_VIEWS),
                        ("NGP_TRAIN_STEPS", NGP_STEPS)):
        monkeypatch.setattr(chip_smoke, name, value)
    configs = {name: _tiny_config(config, kind, tmp_path / f"{name}.yml")
               for name, config, kind, _ in chip_smoke.SHIPPED_CONFIGS}
    blender = write_scene(tmp_path / "blender", hw=16, n_train=BLENDER_VIEWS, n_val=1, n_test=1, n_spheres=3, seed=1)
    paths = chip_smoke.shipped_configs_phase(torch, K1, K3, "cpu", tmp_path, scenes={"blender": blender},
                                             configs=configs, factor=JPEG_FACTOR)

    def trained(n):
        return {"nerf_mlp_fwd": n, "nerf_mlp_fwd_pipelined": 0, "nerf_mlp_bwd": n}

    # K1 and K3 once per step and NeRFMLP: the classic pair per step over one epoch, fused over two LLFF epochs
    # (14 steps) and one Blender epoch; K1 once per chunk and NeRFMLP on the frames (64 points per ray in chunks
    # of 2048); the hash grid launches neither, and its paths record its two HashGridNeRFs (K4 / K5 on the card)
    ngp = dict(chip_smoke.NO_LAUNCHES, hash_grids=2)
    assert paths == {
        "synth800_train": trained(2 * BLENDER_VIEWS), "synth800_frame": {"nerf_mlp_fwd": 2 * 8},
        "synth800_ngp_train": ngp, "synth800_ngp_frame": ngp,
        "synth800_proposal_2p40_train_fused": trained(BLENDER_VIEWS),
        "synth_llff_360_train_fused": trained(28), "synth_llff_360_frame": {"nerf_mlp_fwd": 2 * 6},
        "synth_llff_360u_train_fused": trained(28), "synth_llff_360u_frame": {"nerf_mlp_fwd": 2 * 6},
        "synth_llff_ndc_train_fused": trained(28), "synth_llff_ndc_frame": {"nerf_mlp_fwd": 2 * 6},
        "fern_ndc_train": trained(2 * 10), "fern_ndc_frame": {"nerf_mlp_fwd": 2 * 19},  # 28 * 21 * 64 / 2048
    }
    rows = [json.loads(line) for line in capsys.readouterr().out.splitlines() if '"phase": "configs"' in line]
    assert {row["config"]: row["path_ran"] for row in rows} == {
        "synth800.yml": "per step", "synth800_ngp.yml": "per step", "synth800_proposal_2p40.yml": "fused",
        "synth_llff_360.yml": "fused", "synth_llff_360u.yml": "fused", "synth_llff_ndc.yml": "fused",
        "fern_ndc.yml": "per step"}
    schedule = next(row["schedule"] for row in rows if row["config"] == "synth800_proposal_2p40.yml")
    assert schedule["printed_steps"] == 3  # every dispatch: the vis step, groups of 3 and 2
