"""Real-capture layout from JPEGs: ``LLFFDataset`` over ``tests/data/llff_jpeg`` against the JAX loader, and
``fern.yml`` / ``real_360.yml`` trained and served from it on the CPU.

The capture is 12 views at 1008x756, baseline 4:2:0 JPEGs with restart
markers (``tests/make_llff_jpeg_capture.py``). The port and the JAX
package each read their own copy and write their own resized PNGs; the
datasets must be array-equal (images, poses, focal, bounds) at ``factor``
2, at a ``width`` and a ``height``, and spherified as ``real_360.yml``
sets it, and the port's ``images_2/`` must decode to the digests of the
JAX ``_minify`` output committed beside the capture.
"""

import hashlib
import json
import math
import shutil
from pathlib import Path

import numpy as np
import pytest

from yanerf_tpu.datasets import LLFFDataset as JaxLLFFDataset
from yanerf_tpu_torch import run as port_run
from yanerf_tpu_torch.datasets import LLFFDataset
from yanerf_tpu_torch.serve import service_from_config
from yanerf_tpu_torch.utils import Config
from yanerf_tpu_torch.utils.images import load_image_u8

REPO = Path(__file__).resolve().parent.parent
CAPTURE = REPO / "tests" / "data" / "llff_jpeg"


@pytest.fixture
def capture_pair(tmp_path):
    for root in ("jax", "port"):
        shutil.copytree(CAPTURE, tmp_path / root)
    return tmp_path


@pytest.mark.parametrize(
    "options",
    [dict(factor=2, test_skip=3), dict(factor=2, test_skip=0),
     dict(factor=2, test_skip=8, spherify=True, bd_factor=0.75)],
    ids=["factor2", "factor2_nearest_holdout", "real_360_spherify"],
)
def test_llff_dataset_over_the_jpeg_capture_matches_jax(capture_pair, options):
    for split in ("train", "test"):
        ref = JaxLLFFDataset(str(capture_pair / "jax"), split, **options)
        got = LLFFDataset(str(capture_pair / "port"), split, **options)
        assert len(got) == len(ref) > 0
        for name in ("poses", "bds", "render_poses"):
            assert getattr(got, name).dtype == getattr(ref, name).dtype, name
            np.testing.assert_array_equal(getattr(got, name), getattr(ref, name), err_msg=name)
        assert [Path(f).name for f in got.imgfiles] == [Path(f).name for f in ref.imgfiles]
        for i in range(len(got)):
            for a, b in zip(got[i], ref[i]):
                assert a.dtype == b.dtype and a.shape == b.shape
                np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("size", [dict(width=252), dict(height=150)], ids=["width252", "height150"])
def test_load_data_at_a_width_or_height_over_the_jpeg_capture_matches_jax(capture_pair, size):
    ref = JaxLLFFDataset._load_data(str(capture_pair / "jax"), **size)
    got = LLFFDataset._load_data(str(capture_pair / "port"), **size)
    np.testing.assert_array_equal(got[0], ref[0])
    np.testing.assert_array_equal(got[1], ref[1])
    assert [Path(f).name for f in got[2]] == [Path(f).name for f in ref[2]] and len(got[2]) == 12
    for a, b in zip(got[2], ref[2]):
        assert Path(a).parent.name == Path(b).parent.name != "images"
        np.testing.assert_array_equal(load_image_u8(a), load_image_u8(b))


def test_minify_output_matches_the_committed_jax_digests(tmp_path):
    shutil.copytree(CAPTURE, tmp_path / "capture")
    digests = json.loads((CAPTURE / "digests.json").read_text())
    LLFFDataset._minify(str(tmp_path / "capture"), factors=[2])
    out = tmp_path / "capture" / digests["minify_dir"]
    assert sorted(p.name for p in out.iterdir()) == sorted(digests["minify"])
    for png in sorted(out.iterdir()):
        img = load_image_u8(png)
        assert img.shape == (378, 504, 3)
        assert hashlib.sha256(img.tobytes()).hexdigest() == digests["minify"][png.name], png.name


def _tiny_capture_config(config: str, path: Path, capture: Path, out: Path) -> Path:
    """``config`` on the capture at factor 36 (28x21), 16 rays, a narrow NeRF-MLP, 2 steps."""
    cfg = Config.fromfile(str(REPO / "configs" / "nerf" / config))
    opts = {"pipeline.ray_sampler.image_height": 21, "pipeline.ray_sampler.image_width": 28,
            "pipeline.ray_sampler.n_rays_per_image_sampled_from_mask": 16, "pipeline.chunk_size_grid": 4096,
            "pipeline.ray_sampler.n_pts_per_ray_training": 8, "pipeline.ray_sampler.n_pts_per_ray_evaluation": 8,
            "pipeline.renderer.n_pts_per_ray_fine_training": 8, "pipeline.renderer.n_pts_per_ray_fine_evaluation": 8,
            "pipeline.model.n_layers": 3, "pipeline.model.input_skips": [2], "pipeline.model.n_hidden_neurons_xyz": 32,
            "pipeline.model.n_hidden_neurons_dir": 16, "pipeline.model.use_pallas_train": True,
            "runner.num_iters": 2, "runner.output_dir": str(out), "runner.val_per_iter": 2,
            "runner.save_per_iter": 1, "runner.print_per_iter": 1, "runner.num_workers_list": [0, 0, 0],
            **{f"datasets.{i}.{key}": value for i in range(3)
               for key, value in (("base_dir", str(capture)), ("factor", 36), ("test_skip", 4))}}
    cfg.merge_from_dict(opts)
    cfg.dump(str(path))
    return path


@pytest.mark.parametrize("config", ["fern.yml", "real_360.yml"])
def test_real_capture_configs_train_and_serve_from_jpegs_on_the_cpu(tmp_path, config):
    shutil.copytree(CAPTURE, tmp_path / "capture")
    tiny = _tiny_capture_config(config, tmp_path / "tiny.yml", tmp_path / "capture", tmp_path / "results")
    result = port_run.main(["--config", str(tiny), "--device", "cpu"])
    assert result["state"].step == 9  # one epoch of the 9 training views: 2 iterations round up to it
    assert (tmp_path / "capture" / "images_36").is_dir(), "the PNG cache was written from the JPEGs"
    assert all(math.isfinite(v) for v in result["test_stats"].values())
    cfg = Config.fromfile(str(result["output_dir"] / "config.yml"))
    dataset = LLFFDataset(str(tmp_path / "capture"), "test", factor=36, test_skip=4,
                          spherify=config == "real_360.yml", bd_factor=0.75)
    served = service_from_config(cfg, checkpoint=str(result["checkpoint"]), device="cpu")
    pose, focal, image, min_depth, max_depth = dataset[0]
    frame, depth = served.render(pose[:3, :4], float(focal[0]), float(min_depth[0]), float(max_depth[0]))
    assert frame.shape == image.shape == (21, 28, 3) and depth.shape == (21, 28)
    assert np.isfinite(frame).all() and np.isfinite(depth).all()
