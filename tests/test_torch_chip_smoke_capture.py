"""chip_smoke.py's phases 18-21 on the CPU at a tiny size: "jpeg decode" as it runs on the card machine,
"jpeg capture" with fern.yml / real_360.yml cut to narrow models on the capture at factor 36 (28x21),
"masks" on a tiny flagship and a 16x16 scene, and "parity smoke" with ``--device cpu``."""

import json
from pathlib import Path

import torch

from yanerf_tpu_torch.ops.kernels import nerf_mlp_bwd as K3
from yanerf_tpu_torch.ops.kernels import nerf_mlp_fwd as K1
from yanerf_tpu_torch.synth_scene import write_scene
from yanerf_tpu_torch.utils import Config

REPO = Path(__file__).resolve().parent.parent
NARROW = {"n_layers": 3, "input_skips": [2], "n_hidden_neurons_xyz": 32, "n_hidden_neurons_dir": 16}


def _count_calls(monkeypatch):
    """CPU tensors take the plain versions, which count no launch: count the calls instead."""
    for module, name in ((K1, "nerf_mlp_fwd"), (K3, "nerf_mlp_bwd")):

        def counting(*args, _module=module, _entry=getattr(module, name), **kwargs):
            if kwargs.get("pipelined"):
                _module.pipelined_launches += 1
            else:
                _module.launches += 1
            return _entry(*args, **kwargs)

        monkeypatch.setattr(module, name, counting)


def _narrow_capture_config(config: str, path: Path) -> Path:
    cfg = Config.fromfile(str(REPO / "configs" / "nerf" / config))
    cfg.merge_from_dict({
        "pipeline.ray_sampler.image_height": 21, "pipeline.ray_sampler.image_width": 28,
        "pipeline.ray_sampler.n_rays_per_image_sampled_from_mask": 16, "pipeline.chunk_size_grid": 4096,
        "pipeline.ray_sampler.n_pts_per_ray_training": 8, "pipeline.ray_sampler.n_pts_per_ray_evaluation": 8,
        "pipeline.renderer.n_pts_per_ray_fine_training": 8, "pipeline.renderer.n_pts_per_ray_fine_evaluation": 8,
        "runner.num_workers_list": [0, 0, 0], **{f"pipeline.model.{k}": v for k, v in NARROW.items()}})
    cfg.dump(str(path))
    return path


def test_chip_smoke_capture_mask_and_parity_phases_run_on_the_cpu(tmp_path, monkeypatch):
    import chip_smoke

    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")
    _count_calls(monkeypatch)
    chip_smoke.jpeg_decode_phase("cpu")

    configs = tuple(_narrow_capture_config(c, tmp_path / c) for c in ("fern.yml", "real_360.yml"))
    paths = chip_smoke.jpeg_capture_phases(torch, K1, K3, "cpu", tmp_path, configs, factor=36, steps=20)
    # fern.yml: one model dict, two passes: two NeRFMLPs, each once per step
    assert paths["fern_jpeg_train_fused"] == {"nerf_mlp_fwd": 40, "nerf_mlp_fwd_pipelined": 0, "nerf_mlp_bwd": 40}
    # 28 x 21 rays of 8 points in chunks of 4096: 2 chunks, each through both NeRFMLPs
    assert paths["real_360_jpeg_frame"] == {"nerf_mlp_fwd": 4}

    scene = write_scene(tmp_path / "scene", hw=16, n_train=2, n_val=1, n_test=1, n_spheres=3, seed=1)
    flagship = Config.fromfile(str(chip_smoke.CONFIG))
    flagship.merge_from_dict({
        "pipeline.ray_sampler.image_height": 16, "pipeline.ray_sampler.image_width": 16,
        "pipeline.ray_sampler.n_rays_per_image_sampled_from_mask": 16,
        **{f"pipeline.model.2.{k}": v for k, v in NARROW.items()},
        **{f"pipeline.model.{i}.{k}": v for i in (0, 1) for k, v in (("n_layers", 2), ("hidden_dim", 16))}})
    flagship.dump(str(tmp_path / "flagship.yml"))
    masks = chip_smoke.mask_phase(torch, "cpu", scene, tmp_path / "flagship.yml", n_rays=16)
    for kind in ("sampling_prob_mask", "mask_crop"):
        assert masks[f"masks_{kind}_train"] == {"nerf_mlp_fwd": 1, "nerf_mlp_fwd_pipelined": 0, "nerf_mlp_bwd": 1}

    parity = chip_smoke.parity_smoke_phase("cpu", tmp_path, ["--smoke_iters", "600", "--smoke_target_psnr", "9.0"])
    assert parity == {"parity_smoke_train": {"nerf_mlp_fwd": 0, "nerf_mlp_fwd_pipelined": 0, "nerf_mlp_bwd": 0}}
    logs = list((tmp_path / "parity_smoke").rglob("run.log"))
    assert len(logs) == 2 and all("kernel launches: " in log.read_text().splitlines()[-1] for log in logs)
    assert json.loads((tmp_path / "parity_smoke.json").read_text())["ok"] is True
