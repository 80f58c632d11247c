"""The port's parity runbook, ``python -m yanerf_tpu_torch.repro_parity``, against ``scripts/repro_parity.py``.

``--smoke --device cpu`` end to end, as tests/test_repro_parity.py runs
the JAX script: a procedural 64-pixel scene, a reference-layout ``.pth``
of a fresh pipeline imported through ``run --checkpoint x.pth
--test_only``, and the val-polling + SIGTERM time-to-quality loop. Real
mode on an empty data root records every stage as skipped, with why. The
search paths, expected numbers and the smoke overrides are the script's.
"""

import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from yanerf_tpu_torch import repro_parity

REPO = Path(__file__).resolve().parent.parent


def _jax_script():
    spec = importlib.util.spec_from_file_location("jax_repro_parity", REPO / "scripts" / "repro_parity.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_search_paths_expected_numbers_and_smoke_overrides_are_the_scripts():
    script = _jax_script()
    assert repro_parity.EXPECTED == script.EXPECTED
    assert repro_parity.CKPT_SEARCH == script.CKPT_SEARCH
    assert repro_parity.DATA_MARKERS == script.DATA_MARKERS
    versions = [Path(f"r/version_{i}/val_stats.json") for i in (10, 9, 2)]
    assert sorted(versions, key=repro_parity._version_key) == sorted(versions, key=script._version_key)
    assert repro_parity._version_key(Path("r/version_x")) == script._version_key(Path("r/version_x")) == -1
    assert repro_parity.smoke_options(Path("/s"))[1:] == [
        "pipeline.ray_sampler.image_height=64", "pipeline.ray_sampler.image_width=64",
        "pipeline.ray_sampler.n_rays_per_image_sampled_from_mask=64", "pipeline.ray_sampler.n_pts_per_ray_training=8",
        "pipeline.ray_sampler.n_pts_per_ray_evaluation=8", "pipeline.renderer.n_pts_per_ray_fine_training=8",
        "pipeline.renderer.n_pts_per_ray_fine_evaluation=8", "pipeline.model.n_layers=2",
        "pipeline.model.input_skips=[]", "pipeline.model.n_hidden_neurons_xyz=32",
        "pipeline.model.n_hidden_neurons_dir=16", "pipeline.chunk_size_grid=8192",
        "runner.cache_dataset_on_device=False",
    ]
    assert repro_parity._kernel_options("configs/nerf/lego_proposal.yml", "cuda") == [
        "pipeline.model.2.use_pallas=True", "pipeline.model.2.use_pallas_train=True"]
    assert repro_parity._kernel_options("configs/nerf/fern.yml", "cpu") == []


def test_find_ckpt_searches_like_the_script(tmp_path):
    assert repro_parity.find_ckpt("lego", None, tmp_path) is None
    (tmp_path / "data" / "ckpts").mkdir(parents=True)
    (tmp_path / "data" / "fern_v2.pth").write_bytes(b"")
    (tmp_path / "data" / "ckpts" / "lego.ckpts_-001.pth").write_bytes(b"")
    assert repro_parity.find_ckpt("lego", None, tmp_path) == str(tmp_path / "data" / "ckpts" / "lego.ckpts_-001.pth")
    assert repro_parity.find_ckpt("fern", None, tmp_path) == str(tmp_path / "data" / "fern_v2.pth")
    with pytest.raises(FileNotFoundError, match="--fern_ckpt"):
        repro_parity.find_ckpt("fern", str(tmp_path / "typo.pth"), tmp_path)


def test_real_mode_on_an_empty_root_records_every_stage_as_skipped(tmp_path):
    out = tmp_path / "parity_real.json"
    assert repro_parity.main(["--device", "cpu", "--root", str(tmp_path), "--out", str(out)]) == 0
    record = json.loads(out.read_text())
    assert record["mode"] == "real" and set(record["stages"]) == {"lego", "fern", "time_to_30.7"}
    for scene, expected in (("lego", 30.70), ("fern", 27.94)):
        stage = record["stages"][scene]
        assert stage["expected_psnr"] == expected and stage["data_found"] is False and stage["ckpt"] is None
        assert stage["skipped"] == f"no dataset and no released .pth found under {tmp_path}"
    assert record["stages"]["time_to_30.7"] == {"skipped": f"no lego dataset found under {tmp_path}"}


def test_repro_parity_smoke_on_the_cpu(tmp_path):
    out = tmp_path / "parity_smoke.json"
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run(
        [sys.executable, "-m", "yanerf_tpu_torch.repro_parity", "--smoke", "--device", "cpu",
         "--smoke_dir", str(tmp_path / "work"), "--smoke_iters", "600", "--smoke_target_psnr", "9.0",
         "--out", str(out)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=600,
    )
    assert proc.returncode == 0, f"stdout:\n{proc.stdout[-3000:]}\nstderr:\n{proc.stderr[-3000:]}"
    record = json.loads(out.read_text())
    assert record["mode"] == "smoke" and record["ok"] is True and record["pth_tensors"] > 0
    assert record["stages"]["test_only_import"]["ok"] and record["stages"]["test_only_import"]["test_psnr"] > 0
    ttq = record["stages"]["time_to_quality"]
    assert ttq["ok"] and ttq["reached"] and ttq["best_val_psnr"] >= 9.0
    # the time-to-quality run was stopped by SIGTERM and drained: its preemption checkpoint is there
    assert list((tmp_path / "work" / "time_to_quality").glob("version_*/ckpts/ckpts_preempt*"))
