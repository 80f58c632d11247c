"""``--debug`` of yanerf_tpu_torch against yanerf_tpu, on the CPU.

``Subset`` against the JAX class; ``utils/images.resize_linear`` against
``cv2.INTER_LINEAR`` on float32 images at several sizes and factors, within
1e-6 (OpenCV rounds the weights and sums in an order numpy does not follow;
the differences seen are ~1e-7); ``BlenderDataset(debug=True)`` (scale_down
32) and with other factors against the JAX dataset; ``setup_debug_env``
against ``scripts/run.py``'s; ``run.py --debug --device cpu`` to its
checkpoints.
"""

import importlib.util
import json
import logging
from pathlib import Path

import cv2
import numpy as np
import pytest

from test_torch_classic import _write_drive
from yanerf_tpu.datasets import Subset as JaxSubset
from yanerf_tpu.datasets.blender import BlenderDataset as JaxBlenderDataset
from yanerf_tpu_torch import run as port_run
from yanerf_tpu_torch.datasets import BlenderDataset, Subset
from yanerf_tpu_torch.synth_scene import write_scene
from yanerf_tpu_torch.utils.images import resize_linear

REPO = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("src,dst", [
    ((64, 64), (2, 2)),  # debug's factor 32
    ((800, 800), (25, 25)),  # a Blender frame in debug mode
    ((64, 96), (32, 48)),  # factor 2: OpenCV's area average
    ((63, 90), (21, 30)),  # factor 3
    ((37, 41), (18, 20)),  # no integer factor
    ((10, 12), (15, 13)),  # an upscale
])
@pytest.mark.parametrize("channels", [3, None])
def test_resize_linear_is_cv2_inter_linear(src, dst, channels):
    rng = np.random.RandomState(sum(src) + sum(dst))
    img = rng.rand(*src, *((channels,) if channels else ())).astype(np.float32)
    got = resize_linear(img, dst[::-1])
    want = cv2.resize(img, dst[::-1], interpolation=cv2.INTER_LINEAR)
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_subset_is_the_jax_class():
    class Items:
        data_wrapper = tuple

        def __getitem__(self, i):
            return ("item", i)

        def __len__(self):
            return 9

    ours, theirs = Subset(Items(), range(2, 5)), JaxSubset(Items(), range(2, 5))
    assert len(ours) == len(theirs) == 3 and ours.data_wrapper is theirs.data_wrapper is tuple
    assert [ours[i] for i in range(3)] == [theirs[i] for i in range(3)] == [("item", 2), ("item", 3), ("item", 4)]


@pytest.mark.parametrize("hw,kwargs", [(64, dict(debug=True)), (128, dict(debug=True)), (96, dict(scale_down=3)),
                                       (64, dict(scale_down=2.5))])
def test_blender_dataset_in_debug_mode_is_the_jax_dataset(tmp_path, hw, kwargs):
    scene = write_scene(tmp_path / "scene", hw=hw, n_train=2, n_val=1, n_test=1, n_spheres=3, seed=1)
    ours, theirs = BlenderDataset(scene, "train", **kwargs), JaxBlenderDataset(str(scene), "train", **kwargs)
    assert (ours.H, ours.W, ours.focal, ours.scale_down) == (theirs.H, theirs.W, theirs.focal, theirs.scale_down)
    for i in range(len(theirs)):
        for a, b in zip(ours[i], theirs[i]):
            assert a.dtype == b.dtype == np.float32 and a.shape == b.shape
            if kwargs.get("debug"):
                np.testing.assert_array_equal(a, b)
            else:
                np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)


def test_setup_debug_env_is_the_scripts(tmp_path):
    spec = importlib.util.spec_from_file_location("jax_run_script", REPO / "scripts" / "run.py")
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    runner = dict(batch_size_list=[2, 1, 1], num_workers_list=[4, 4, 4], num_iters=100, val_per_iter=10,
                  save_per_iter=10, print_per_iter=5)
    items = [list(range(7)), list(range(5)), list(range(6))]

    class Items(list):
        data_wrapper = tuple

    logger = logging.getLogger("test_torch_debug")
    ours_cfg, theirs_cfg = dict(runner), dict(runner)
    ours = port_run.setup_debug_env(ours_cfg, [Items(x) for x in items], logger)
    theirs = script.setup_debug_env(theirs_cfg, [Items(x) for x in items], logger)
    assert ours_cfg == theirs_cfg and ours_cfg["num_iters"] == 1 and ours_cfg["num_workers_list"] == [0, 0, 0]
    assert [[d[i] for i in range(len(d))] for d in ours] == [[d[i] for i in range(len(d))] for d in theirs] == [
        [0, 1, 2], [0, 1], [0, 1]]


def test_run_debug_completes_on_the_cpu(tmp_path, caplog):
    _, cfg_path = _write_drive(tmp_path)
    with caplog.at_level(logging.DEBUG, logger="yanerf_tpu_torch"):
        result = port_run.main(["--config", str(cfg_path), "--device", "cpu", "--debug"])
    out = result["output_dir"]
    assert "In DEBUG mode, some hyperparameters have been changed." in (out / "run.log").read_text()
    # two train items at batch 1: one epoch of two steps, eval and a checkpoint at the epoch's end
    assert result["state"].step == 2 and len(result["train_stats"]) == 1 and len(result["val_stats"]) == 1
    assert sorted(p.name for p in (out / "ckpts").iterdir()) == ["ckpts_-001", "ckpts_0000"]
    assert np.isfinite(json.loads((out / "test_stats.json").read_text())["test_loss_rgb_psnr"])
