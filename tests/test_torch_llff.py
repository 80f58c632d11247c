"""LLFF captures and NDC rays in yanerf_tpu_torch against yanerf_tpu, on the CPU.

configs/nerf/fern_ndc_proposal.yml's path (and fern.yml / synth_llff.yml's
per-image metric bounds), held to the JAX package on the same inputs and
draws:
  * ``ndc_ray_bundle`` at rtol/atol 1e-6 on rays facing +z and -z (the
    recentered LLFF frame, tests/test_ops.py's -z case), the ``s == 0``
    guard, and a frame warped in two chunks: the facing sign is a sum over
    each call's rays, so a chunk whose rays face the other way warps as it
    does in the JAX package, not as the whole frame would;
  * ``RaySampler(use_ndc)`` in both modes, the JAX draws fed in: the range
    is [0, 1] whatever bounds the batch carries;
  * ``LLFFDataset`` on a fixture of small PNGs, at ``factor`` 1, 2 (an
    integer resize) and 3 (33x41 images: OpenCV's fractional area path),
    with ``spherify``, ``path_zflat``, ``recenter=False``, ``bd_factor=None``,
    ``test_skip`` 0 and 3, and the empty train split: poses, bounds,
    ``render_poses`` and every item array-equal to the JAX dataset's (the
    same numpy code on the same float32 values), the resized PNGs equal to
    ``cv2.INTER_AREA``'s byte for byte; ``_load_data`` by height and by
    width; a JPEG raises;
  * the depth fields stay float32 on the uint8 device cache;
  * ``synth_llff.py --mode forward`` writes the scene of
    ``scripts/make_synth_llff.py``;
  * one eval frame in chunks and one train step of the NDC config's
    structure (two ProposalMLPs, the NeRF-MLP on the fused function,
    pixels with replacement): outputs at 1e-4, objective 1e-5, gradients
    rtol 2e-4 / atol 2e-5; three fused steps against
    ``make_train_step_fused`` on the 5-field LLFF batch;
  * ``serve.py`` builds each of the slice's four configs at the shipped
    widths; ``run.py`` trains each at tiny widths on a tiny scene (one
    epoch, checkpoint reload) and ``serve.py`` renders a view from the
    run's checkpoint.
"""

import json
import math
import shutil
import sys
from collections import namedtuple
from pathlib import Path

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import yanerf_tpu.ops.rays as jrays
from test_torch_classic import F32_GRAD_TOL, RUNNER
from test_torch_train import _capture_draws
from yanerf_tpu.datasets import LLFFDataset as JaxLLFFDataset
from yanerf_tpu.ops.structures import EvaluationMode as JaxEvaluationMode
from yanerf_tpu.ops.structures import RayBundle as JaxRayBundle
from yanerf_tpu.pipelines import PIPELINES as JAX_PIPELINES
from yanerf_tpu.pipelines import RAY_SAMPLERS as JAX_RAY_SAMPLERS
from yanerf_tpu.runners import apis as jax_apis
from yanerf_tpu.runners import optim as jax_optim
from yanerf_tpu_torch import run as port_run
from yanerf_tpu_torch.convert import flatten_tree, load_jax_params
from yanerf_tpu_torch.datasets import (
    DATASETS,
    DeviceCachedLoader,
    LLFFDataset,
    create_loader,
    create_sampler,
)
from yanerf_tpu_torch.ops import rays as trays
from yanerf_tpu_torch.ops.structures import EvaluationMode, RayBundle
from yanerf_tpu_torch.pipelines import PIPELINES, RAY_SAMPLERS
from yanerf_tpu_torch.runners import (
    TrainState,
    apis,
    create_optimizer,
    load_checkpoint,
    make_train_step,
    make_train_step_fused,
)
from yanerf_tpu_torch.serve import CAM_CALIBRATION, orbit_pose, service_from_config
from yanerf_tpu_torch.synth_llff import write_llff_scene
from yanerf_tpu_torch.synth_scene import write_scene
from yanerf_tpu_torch.utils import Config
from yanerf_tpu_torch.utils.images import image_shape, load_image_u8, resize_area

REPO = Path(__file__).resolve().parent.parent
TOL = dict(rtol=1e-6, atol=1e-6)
HW = 8
CALIB = np.diag([1.0, -1.0, -1.0]).astype(np.float32)  # a camera looking down -z, as LLFF's average camera


def _close(got, ref, **tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), **(tol or TOL))


# --- NDC rays -------------------------------------------------------------------------


def _bundle(seed=0, n=24, facing=-1.0):
    """World rays from a cluster of cameras near the origin, facing ``facing`` * z."""
    rng = np.random.RandomState(seed)
    origins = (rng.randn(2, n, 1, 3) * 0.2).astype(np.float32)
    directions = (rng.randn(2, n, 1, 3) * 0.3).astype(np.float32)
    directions[..., 2] = facing * rng.uniform(0.8, 1.2, (2, n, 1))
    lengths = np.sort(rng.uniform(0.0, 1.0, (2, n, 1, 5)), axis=-1).astype(np.float32)
    xys = rng.rand(2, n, 1, 2).astype(np.float32)
    return origins, directions, lengths, xys


def _ndc_pair(arrays, focal, near=1.0, w=12, h=9):
    ref = jrays.ndc_ray_bundle(JaxRayBundle(*map(jnp.asarray, arrays)), w, h, jnp.asarray(focal), near=near)
    got = trays.ndc_ray_bundle(RayBundle(*map(torch.from_numpy, arrays)), w, h, torch.from_numpy(focal), near=near)
    return got, ref


@pytest.mark.parametrize("facing", [1.0, -1.0], ids=["plus_z", "minus_z"])
@pytest.mark.parametrize("near", [1.0, 0.5])
def test_ndc_ray_bundle_matches_jax(facing, near):
    arrays = _bundle(facing=facing)
    got, ref = _ndc_pair(arrays, np.asarray([[7.0], [9.0]], np.float32), near)
    for name in ("origins", "directions", "lengths", "xys"):
        _close(getattr(got, name), getattr(ref, name))
    # the near plane at t' = 0 lands on ndc z = -1, infinity (t' = 1) on +1
    np.testing.assert_allclose(got.origins[..., 2].numpy(), -1.0, atol=1e-5)
    np.testing.assert_allclose((got.origins + got.directions)[..., 2].numpy(), 1.0, atol=1e-5)


def test_ndc_ray_bundle_handles_minus_z_facing_rays_as_jax():
    """tests/test_ops.py's case: a camera at the origin looking down -z (CAM_CALIBRATION), the whole frame."""
    w, h = 8, 6
    poses = np.concatenate([CALIB, np.zeros((3, 1), np.float32)], axis=-1)[None]
    grid = np.broadcast_to(trays._xy_grid_np(h, w), (1, h, w, 2)).copy()
    jax_bundle = jrays.xy_to_ray_bundle(jnp.asarray(poses), w, h, jnp.asarray([[5.0]]), jnp.asarray(grid), 0.0, 1.0, 4)
    bundle = trays.xy_to_ray_bundle(torch.from_numpy(poses), w, h, torch.tensor([[5.0]]), torch.from_numpy(grid),
                                    0.0, 1.0, 4)
    assert float(bundle.directions[..., 2].mean()) < 0
    ref = jrays.ndc_ray_bundle(jax_bundle, w, h, jnp.asarray([[5.0]]), near=1.0)
    got = trays.ndc_ray_bundle(bundle, w, h, torch.tensor([[5.0]]), near=1.0)
    for name in ("origins", "directions"):
        _close(getattr(got, name), getattr(ref, name))
    o, d = got.origins.numpy(), got.directions.numpy()
    assert np.allclose(o[..., 2], -1.0, atol=1e-5) and np.allclose(o[..., 2] + d[..., 2], 1.0, atol=1e-5)
    # mirror equivalence: flipping the rays' world z changes nothing in NDC
    flip = torch.tensor([1.0, 1.0, -1.0])
    mirrored = trays.ndc_ray_bundle(RayBundle(bundle.origins * flip, bundle.directions * flip, bundle.lengths,
                                              bundle.xys), w, h, torch.tensor([[5.0]]), near=1.0)
    np.testing.assert_allclose(mirrored.origins.numpy(), o, atol=1e-5)
    np.testing.assert_allclose(mirrored.directions.numpy(), d, atol=1e-5)


def test_ndc_facing_sign_is_per_call_and_zero_sums_face_plus_z():
    """A frame warped in two chunks: the first faces -z, the second +z. Each call takes its own sign, in both
    packages; the whole frame's sum would warp the second chunk the other way. A sum of exactly 0 faces +z."""
    first, second = _bundle(seed=1, n=12, facing=-1.0), _bundle(seed=2, n=12, facing=1.0)
    second[1][..., 2] *= 0.2  # the whole frame still faces -z
    focal = np.asarray([[7.0], [9.0]], np.float32)
    whole = tuple(np.concatenate([a, b], axis=1) for a, b in zip(first, second))
    got_whole, ref_whole = _ndc_pair(whole, focal)
    for chunk, part in ((first, slice(0, 12)), (second, slice(12, 24))):
        got, ref = _ndc_pair(chunk, focal)
        for name in ("origins", "directions"):
            _close(getattr(got, name), getattr(ref, name))
        same_as_whole = np.allclose(getattr(got, "origins").numpy(), got_whole.origins.numpy()[:, part], atol=1e-5)
        assert same_as_whole == (part.start == 0)
    _close(got_whole.origins, ref_whole.origins)
    zero = _bundle(seed=3, n=2)
    zero[1][..., 2] = np.array([[[0.5], [-0.5]], [[1.0], [-1.0]]], np.float32)
    got, ref = _ndc_pair(zero, focal)
    assert float(torch.sign(got.directions[..., 2]).max()) == 1.0
    for name in ("origins", "directions"):
        _close(getattr(got, name), getattr(ref, name))


def _sampler_cfg(**options):
    return dict(dict(type="RaySampler", image_height=HW, image_width=HW + 2, min_depth=2.0, max_depth=6.0,
                     n_pts_per_ray_training=5, n_pts_per_ray_evaluation=6, n_rays_per_image_sampled_from_mask=12,
                     pixel_replacement=True, use_ndc=True, ndc_near=1.0), **options)


def _ndc_poses(n=3, seed=0):
    rng = np.random.RandomState(seed)
    poses = np.zeros((n, 3, 4), np.float32)
    for i in range(n):
        poses[i, :, :3] = CALIB
        poses[i, :2, 3] = rng.uniform(-0.3, 0.3, 2)
    return poses


@pytest.mark.parametrize("mode", ["training", "evaluation"])
@pytest.mark.parametrize("batch_bounds", [False, True])
def test_ray_sampler_with_ndc_matches_jax(monkeypatch, mode, batch_bounds):
    pose, focal = _ndc_poses(1), np.asarray([[8.0]], np.float32)
    kw = dict(min_depth=np.array([[1.7]], np.float32), max_depth=np.array([[9.0]], np.float32)) if batch_bounds else {}
    draws = _capture_draws(monkeypatch)
    jmode, tmode = ((JaxEvaluationMode.TRAINING, EvaluationMode.TRAINING) if mode == "training"
                    else (JaxEvaluationMode.EVALUATION, EvaluationMode.EVALUATION))
    ref = JAX_RAY_SAMPLERS.build(_sampler_cfg())(jax.random.PRNGKey(5), jnp.asarray(pose), jnp.asarray(focal), jmode,
                                                 **{k: jnp.asarray(v) for k, v in kw.items()})
    got = RAY_SAMPLERS.build(_sampler_cfg())(torch.from_numpy(pose), torch.from_numpy(focal), tmode,
                                             pixel_idx=draws.get("pixel_idx"), strata_u=draws.get("strata_u"),
                                             **{k: torch.from_numpy(v) for k, v in kw.items()})
    for name in ("origins", "directions", "lengths", "xys"):
        _close(getattr(got, name), getattr(ref, name), rtol=1e-5, atol=1e-6)
    assert float(got.lengths.min()) >= 0.0 and float(got.lengths.max()) <= 1.0


# --- the dataset --------------------------------------------------------------------


def _write_llff_fixture(root: Path, n=6, h=32, w=40, seed=1):
    """LLFF-format cameras on a circle looking at the origin ([down, right, back] columns), random PNGs."""
    (root / "images").mkdir(parents=True)
    rng = np.random.RandomState(seed)
    poses = np.zeros((n, 3, 5), dtype=np.float64)
    for i in range(n):
        theta = 0.4 * np.pi * i / n
        pos = np.array([4 * np.cos(theta), 4 * np.sin(theta), 1.0 + 0.1 * i])
        back = pos / np.linalg.norm(pos)
        right = np.cross([0.0, 0.0, 1.0], back)
        right = right / np.linalg.norm(right)
        up = np.cross(back, right)
        poses[i, :, 0], poses[i, :, 1], poses[i, :, 2], poses[i, :, 3] = -up, right, back, pos
        poses[i, :, 4] = (h, w, 50.0)
        Image.fromarray((rng.rand(h, w, 3) * 255).astype(np.uint8)).save(root / "images" / f"img_{i:03d}.png")
    bds = np.stack([rng.uniform(2.0, 3.0, n), rng.uniform(9.0, 11.0, n)], axis=1)
    np.save(root / "poses_bounds.npy", np.concatenate([poses.reshape(n, -1), bds], axis=1))
    return root


@pytest.fixture
def llff_pair(tmp_path):
    """Two copies of one fixture: the JAX loader and the port each write their own resized copies."""
    _write_llff_fixture(tmp_path / "jax")
    shutil.copytree(tmp_path / "jax", tmp_path / "port")
    _write_llff_fixture(tmp_path / "jax_odd", h=33, w=41)
    shutil.copytree(tmp_path / "jax_odd", tmp_path / "port_odd")
    return tmp_path


@pytest.mark.parametrize(
    "options",
    [dict(factor=1, test_skip=3), dict(factor=2, test_skip=3), dict(factor=2, test_skip=0, spherify=True),
     dict(factor=1, test_skip=0, path_zflat=True), dict(factor=1, test_skip=2, recenter=False, bd_factor=None),
     dict(factor=3, test_skip=4, odd=True), dict(factor=2, test_skip=3, odd=True, spherify=True)],
    ids=["factor1", "factor2", "spherify_nearest_holdout", "path_zflat_nearest_holdout", "raw_poses",
         "factor3_fractional_area", "odd_factor2_spherify"],
)
@pytest.mark.parametrize("split", ["train", "test"])
def test_llff_dataset_matches_jax(llff_pair, options, split):
    options = dict(options)
    suffix = "_odd" if options.pop("odd", False) else ""
    ref = JaxLLFFDataset(str(llff_pair / f"jax{suffix}"), split, **options)
    got = DATASETS.build(dict(type="LLFFDataset", base_dir=str(llff_pair / f"port{suffix}"), split=split, **options))
    assert isinstance(got, LLFFDataset) and len(got) == len(ref) > 0
    for name in ("poses", "bds", "render_poses"):
        assert getattr(got, name).dtype == getattr(ref, name).dtype, name
        np.testing.assert_array_equal(getattr(got, name), getattr(ref, name), err_msg=name)
    assert [Path(f).name for f in got.imgfiles] == [Path(f).name for f in ref.imgfiles]
    for i in range(len(got)):
        for a, b in zip(got[i], ref[i]):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)
    assert got.data_wrapper(*got[0])._fields == ref.data_wrapper(*ref[0])._fields
    factor = options["factor"]
    if factor != 1:  # the resized copies are OpenCV's INTER_AREA, byte for byte
        for f in sorted((llff_pair / f"port{suffix}" / f"images_{factor}").iterdir()):
            src = np.array(Image.open(llff_pair / f"port{suffix}" / "images" / f.name).convert("RGB"))
            dsize = (int(round(src.shape[1] / factor)), int(round(src.shape[0] / factor)))
            np.testing.assert_array_equal(load_image_u8(f), cv2.resize(src, dsize, interpolation=cv2.INTER_AREA))
            np.testing.assert_array_equal(load_image_u8(f), load_image_u8(llff_pair / f"jax{suffix}" /
                                                                           f"images_{factor}" / f.name))


def test_llff_dataset_refusals_and_other_sizes_match_jax(llff_pair):
    for cls, root in ((JaxLLFFDataset, "jax"), (LLFFDataset, "port")):
        with pytest.raises(ValueError, match="empty"):
            cls(str(llff_pair / root), "train", factor=1, test_skip=1)
        with pytest.raises(ValueError, match="split"):
            cls(str(llff_pair / root), "holdout", factor=1)
    for kw in (dict(height=16), dict(width=30)):
        ref = JaxLLFFDataset._load_data(str(llff_pair / "jax"), **kw)
        got = LLFFDataset._load_data(str(llff_pair / "port"), **kw)
        np.testing.assert_array_equal(got[0], ref[0])
        for a, b in zip(got[2], ref[2]):
            assert Path(a).name == Path(b).name
            np.testing.assert_array_equal(load_image_u8(a), load_image_u8(b))
    # JPEG sources load as the JAX loader loads them (tests/test_torch_native.py holds the decoder itself),
    # progressive ones too; an arithmetic-coded JPEG is refused by name
    n_views = np.load(llff_pair / "port" / "poses_bounds.npy").shape[0]
    for root in ("jpeg_jax", "jpeg_port"):
        (llff_pair / root / "images").mkdir(parents=True)
        shutil.copy(llff_pair / "port" / "poses_bounds.npy", llff_pair / root)
        for i in range(n_views):
            img = (np.random.RandomState(i).rand(20, 28, 3) * 255).astype(np.uint8)
            Image.fromarray(img).save(llff_pair / root / "images" / f"img_{i:03d}.JPG", quality=90)
    ref = JaxLLFFDataset(str(llff_pair / "jpeg_jax"), "train", factor=2)
    got = LLFFDataset(str(llff_pair / "jpeg_port"), "train", factor=2)
    np.testing.assert_array_equal(got.poses, ref.poses)
    for i in range(len(got)):
        for a, b in zip(got[i], ref[i]):
            np.testing.assert_array_equal(a, b)
    for root in ("jpeg_jax", "jpeg_port"):
        Image.fromarray(np.random.RandomState(9).randint(0, 256, (20, 28, 3)).astype(np.uint8)).save(
            llff_pair / root / "images" / "img_000.JPG", quality=90, progressive=True)
    ref = JaxLLFFDataset(str(llff_pair / "jpeg_jax"), "train", factor=1)
    got = LLFFDataset(str(llff_pair / "jpeg_port"), "train", factor=1)
    for i in range(len(got)):
        for a, b in zip(got[i], ref[i]):
            np.testing.assert_array_equal(a, b)
    arith = bytearray((llff_pair / "jpeg_port" / "images" / "img_001.JPG").read_bytes())
    arith[arith.index(b"\xff\xc0") + 1] = 0xC9  # the frame header of an arithmetic-coded file
    (llff_pair / "jpeg_port" / "images" / "img_000.JPG").write_bytes(bytes(arith))
    with pytest.raises(NotImplementedError, match="img_000.JPG.*SOF9"):
        LLFFDataset(str(llff_pair / "jpeg_port"), "train", factor=1)


@pytest.mark.parametrize("hw,factor", [((40, 32), 2), ((41, 33), 2), ((60, 45), 4), ((64, 48), 3), ((50, 50), 1.5)])
def test_resize_area_is_opencv_inter_area(hw, factor):
    img = (np.random.RandomState(hw[0]).rand(hw[1], hw[0], 3) * 256).astype(np.uint8)
    dsize = (int(round(hw[0] / factor)), int(round(hw[1] / factor)))
    np.testing.assert_array_equal(resize_area(img, dsize), cv2.resize(img, dsize, interpolation=cv2.INTER_AREA))
    gray = img[..., 0]
    np.testing.assert_array_equal(resize_area(gray, dsize), cv2.resize(gray, dsize, interpolation=cv2.INTER_AREA))


def test_png_shape_reads_the_header(tmp_path):
    Image.fromarray(np.zeros((7, 11, 4), np.uint8)).save(tmp_path / "a.png")
    assert image_shape(tmp_path / "a.png") == (7, 11, 3) == cv2.imread(str(tmp_path / "a.png")).shape


def test_depth_fields_stay_float32_on_the_uint8_cache(llff_pair):
    dataset = LLFFDataset(str(llff_pair / "port"), "train", factor=1, test_skip=3)
    host = create_loader(dataset, create_sampler(dataset, shuffle=True, seed=2), 2, 0, is_train=True)
    cached = DeviceCachedLoader(create_loader(dataset, create_sampler(dataset, shuffle=True, seed=2), 2, 0,
                                              is_train=True), "cpu", quantize_images=True)
    assert cached._ensure_cache()
    assert [a.dtype for a in cached._arrays] == [torch.float32, torch.float32, torch.uint8, torch.float32,
                                                 torch.float32]
    for hb, cb in zip(host, cached):
        for h, c in zip(hb, cb):
            np.testing.assert_array_equal(np.asarray(c), np.asarray(h))
    batch = dataset.data_wrapper(*next(iter(cached)))._asdict()
    assert batch["min_depth"].shape == (2, 1) and batch["max_depth"].dtype == torch.float32


def test_synth_llff_forward_writes_the_scene_of_make_synth_llff(tmp_path, monkeypatch):
    sys.path.insert(0, str(REPO / "scripts"))
    try:
        import make_synth_llff
    finally:
        sys.path.remove(str(REPO / "scripts"))
    args = ["--height", "12", "--width", "16", "--n_images", "5", "--n_spheres", "4", "--seed", "2"]
    monkeypatch.setattr(sys, "argv", ["make_synth_llff.py", "--out_dir", str(tmp_path / "ref"), *args])
    make_synth_llff.main()
    write_llff_scene(tmp_path / "port", 12, 16, 5, n_spheres=4, seed=2)
    np.testing.assert_array_equal(np.load(tmp_path / "port" / "poses_bounds.npy"),
                                  np.load(tmp_path / "ref" / "poses_bounds.npy"))
    for i in range(5):
        with Image.open(tmp_path / "ref" / "images" / f"image{i:03d}.png") as im:
            ref = np.array(im.convert("RGB"))
        np.testing.assert_array_equal(load_image_u8(tmp_path / "port" / "images" / f"image{i:03d}.png"), ref)


# --- the NDC config's structure: a frame, a train step, three fused steps ------------------


def ndc_cfg(compute_dtype="float32", chunk_size_grid=192):
    """fern_ndc_proposal.yml at tiny widths: NDC rays, two ProposalMLPs, the NeRF-MLP on the fused function,
    pixels with replacement; the 8x10 frame of 6 points per ray renders in three chunks."""
    return dict(
        type="NeRFPipeline", chunk_size_grid=chunk_size_grid, num_passes=3, output_rasterized_mc=False,
        loss_weights={"loss_rgb_mse": 1.0, "loss_proposal": 1.0},
        model=[
            dict(type="ProposalMLP", n_layers=2, hidden_dim=16, compute_dtype=compute_dtype),
            dict(type="ProposalMLP", n_layers=2, hidden_dim=16, compute_dtype=compute_dtype),
            dict(type="NeRFMLP", n_layers=3, input_skips=[2], n_harmonic_functions_xyz=3, n_harmonic_functions_dir=2,
                 n_hidden_neurons_xyz=32, n_hidden_neurons_dir=16, compute_dtype=compute_dtype,
                 use_pallas_train=True),
        ],
        ray_sampler=_sampler_cfg(),
        renderer=dict(
            type="ProposalEmissionAbsorpsionRenderer", n_pts_per_ray_final_training=4,
            n_pts_per_ray_final_evaluation=5, n_pts_per_ray_intermediate_training=[6],
            n_pts_per_ray_intermediate_evaluation=[6], bg_color=[0.0, 0.0, 0.0], density_noise_std_train=0.0,
            background_density_bias=1e-6, stratified_sampling_training=True,
        ),
        feature_extractor=[],
    )


def _llff_arrays(n=3, seed=0):
    """An LLFF batch's five fields for ``n`` images: 3x4 poses facing -z, focal, image, per-image bounds."""
    rng = np.random.RandomState(seed)
    return (_ndc_poses(n, seed), np.full((n, 1), 8.0, np.float32), rng.rand(n, HW, HW + 2, 3).astype(np.float32),
            rng.uniform(1.5, 2.0, (n, 1)).astype(np.float32), rng.uniform(8.0, 12.0, (n, 1)).astype(np.float32))


LLFFBatch = namedtuple("LLFFBatch", ["poses", "focal_lengths", "image_rgb", "min_depth", "max_depth"])


def _ndc_params(jax_pipeline, seed):
    params = jax_pipeline.init(jax.random.PRNGKey(seed))
    # every ray carries mass: on an empty ray the refined depths differ by ~1e-3 between the packages
    # (ROADMAP.md Queue 3, "Noted, not faults")
    for fn in params["implicit_functions"]:
        fn["density_layer"]["b"] = fn["density_layer"]["b"] + 1.0
    return params


def test_ndc_frame_in_chunks_matches_jax(monkeypatch):
    """The whole frame is warped into NDC before it is cut into chunks, in both packages."""
    cfg = ndc_cfg()
    batch = {k: v[:1] for k, v in zip(LLFFBatch._fields, _llff_arrays(1, seed=3))}
    jax_pipeline = JAX_PIPELINES.build(dict(cfg))
    params = _ndc_params(jax_pipeline, 0)
    ref = jax_pipeline.forward(params, jax.random.PRNGKey(1), evaluation_mode=JaxEvaluationMode.EVALUATION,
                               **{k: jnp.asarray(v) for k, v in batch.items()})
    pipeline = PIPELINES.build(dict(cfg), device="cpu")
    load_jax_params(pipeline, jax.tree_util.tree_map(np.asarray, params))
    chunks, render = [], type(pipeline.renderer).__call__

    def counted(self, *args, **kwargs):
        chunks.append(tuple(args[0].shape))
        return render(self, *args, **kwargs)

    monkeypatch.setattr(type(pipeline.renderer), "__call__", counted)
    with torch.no_grad():
        got = pipeline(evaluation_mode=EvaluationMode.EVALUATION, **{k: torch.from_numpy(v) for k, v in batch.items()})
    assert len(chunks) == math.ceil(HW * (HW + 2) * 6 / 192) == 3
    for key in ("rendered_images", "rendered_depths", "rendered_alpha_masks", "objective"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(ref[key]), rtol=1e-4, atol=1e-4, err_msg=key)


def test_ndc_train_step_matches_jax_make_train_step(monkeypatch):
    cfg = ndc_cfg()
    batch = {k: v[:1] for k, v in zip(LLFFBatch._fields, _llff_arrays(1, seed=1))}
    jax_pipeline = JAX_PIPELINES.build(dict(cfg))
    params = _ndc_params(jax_pipeline, 2)
    tx = jax_optim.create_optimizer(RUNNER, params)
    rng = jax.random.PRNGKey(11)
    jax_batch = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss_fn(p):
        preds = jax_pipeline.forward(p, jax.random.fold_in(rng, 0), evaluation_mode=JaxEvaluationMode.TRAINING,
                                     output_rasterized_mc=False, **jax_batch)
        return jnp.mean(preds["objective"])

    with monkeypatch.context() as m:
        draws = _capture_draws(m)
        ref_grads = flatten_tree(jax.tree_util.tree_map(np.asarray, jax.grad(loss_fn)(params)))
    _, ref_preds = jax_apis.make_train_step(jax_pipeline, tx, donate=False)(
        jax_optim.create_train_state(params, tx), jax_batch, rng)
    for i in range(3):
        largest = max(np.abs(v).max() for k, v in ref_grads.items() if k.startswith(f"implicit_functions.{i}."))
        assert largest > 10 * F32_GRAD_TOL["atol"], (i, largest)

    pipeline = PIPELINES.build(dict(cfg), device="cpu")
    load_jax_params(pipeline, jax.tree_util.tree_map(np.asarray, params))
    state = TrainState(pipeline=pipeline, optimizer=create_optimizer(RUNNER, pipeline), step=0)
    preds = make_train_step(pipeline, RUNNER, seed=0)(state, {k: torch.from_numpy(v) for k, v in batch.items()},
                                                      draws=draws)
    np.testing.assert_allclose(preds["objective"].numpy(), np.asarray(ref_preds["objective"]), rtol=1e-5, atol=1e-5)
    for key in ("loss_rgb_mse", "loss_proposal"):
        np.testing.assert_allclose(preds[key].numpy(), np.asarray(ref_preds[key]), rtol=1e-5, atol=1e-6, err_msg=key)
    for key, p in pipeline.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), ref_grads[key], err_msg=key, **F32_GRAD_TOL)


def test_ndc_fused_dispatch_matches_jax_make_train_step_fused(monkeypatch):
    """Three steps at steps_per_call 3 on the 5-field LLFF batch, the JAX draws fed in through the static
    buffers; the per-image bounds ride along in the gather and NDC ignores them, as in JAX."""
    cfg = ndc_cfg()
    runner = dict(RUNNER, steps_per_call=3)
    arrays = _llff_arrays(3, seed=5)
    idx = np.array([[2], [0], [1]])
    jax_pipeline = JAX_PIPELINES.build(dict(cfg))
    params = _ndc_params(jax_pipeline, 1)
    tx = jax_optim.create_optimizer(runner, params)
    rng = jax.random.PRNGKey(11)
    jax_arrays = tuple(jnp.asarray(a) for a in arrays)

    step = jax_apis.make_train_step(jax_pipeline, tx, donate=False)
    state = jax_optim.create_train_state(params, tx)
    draws, grads, per_step_params = [], [], []
    for k in range(3):
        batch = {key: a[idx[k]] for key, a in zip(LLFFBatch._fields, jax_arrays)}

        def loss_fn(p, batch=batch, k=k):
            preds = jax_pipeline.forward(p, jax.random.fold_in(rng, k), evaluation_mode=JaxEvaluationMode.TRAINING,
                                         output_rasterized_mc=False, **batch)
            return jnp.mean(preds["objective"])

        per_step_params.append(flatten_tree(jax.tree_util.tree_map(np.asarray, state.params)))
        with monkeypatch.context() as m:
            draws.append(_capture_draws(m))
            grads.append(flatten_tree(jax.tree_util.tree_map(np.asarray, jax.grad(loss_fn)(state.params))))
        state, _ = step(state, batch, rng)

    fused = jax_apis.make_train_step_fused(jax_pipeline, tx, LLFFBatch, donate=False)
    ref_state, ref_hist = fused(jax_optim.create_train_state(params, tx), jax_arrays, jnp.asarray(idx), rng)
    ref_params = flatten_tree(jax.tree_util.tree_map(np.asarray, ref_state.params))

    pipeline = PIPELINES.build(dict(cfg), device="cpu")
    load_jax_params(pipeline, jax.tree_util.tree_map(np.asarray, params))
    port = TrainState(pipeline=pipeline, optimizer=create_optimizer(runner, pipeline), step=0)

    def fed_draws(pipeline, batch_size, seed, step, out=None):
        for key, value in draws[step].items():
            targets = out[key] if isinstance(out[key], list) else [out[key]]
            for target, v in zip(targets, value if isinstance(value, list) else [value]):
                target.copy_(v)
        return out

    monkeypatch.setattr(apis, "make_step_draws", fed_draws)
    trainer = make_train_step_fused(pipeline, runner, 0, LLFFBatch)
    hist = trainer(port, tuple(torch.from_numpy(a) for a in arrays), idx)
    assert port.step == 3 and trainer.dispatches == 1
    np.testing.assert_allclose(hist["objective"].numpy(), np.asarray(ref_hist["objective"]), rtol=1e-5, atol=1e-5)
    lr = float(port.optimizer.param_groups[0]["init_lr"])
    for key, p in pipeline.named_parameters():
        new, ref = p.detach().numpy(), ref_params[key]
        # Adam's update is lr * m / (sqrt(v) + eps): where a gradient is within its atol the sign is float32 noise
        settled = np.all([np.abs(g[key] + RUNNER["weight_decay"] * w[key]) > F32_GRAD_TOL["atol"]
                          for g, w in zip(grads, per_step_params)], axis=0)
        np.testing.assert_allclose(new[settled], ref[settled], err_msg=key, **F32_GRAD_TOL)
        assert np.all(np.abs(new - ref) <= 2.0 * 3 * lr * (1 + 1e-5)), key


# --- the slice's four configs through serve.py and run.py -----------------------------


TINY = {
    "fern_ndc_proposal.yml": "forward",
    "synth_llff_360_unbounded.yml": "orbit",
    "synth_llff.yml": "forward",
    "synth800_proposal.yml": "blender",
}


def _tiny_config(config: str, path: Path, scene: Path, out: Path, steps: int = 2, val_per_iter: int = 2) -> Path:
    """``config`` at a 12x16 frame (16x16 for Blender), 16 rays, narrow models and ``steps`` steps on ``scene``,
    written to ``path``."""
    cfg = Config.fromfile(str(REPO / "configs" / "nerf" / config))
    hw = (16, 16) if TINY[config] == "blender" else (12, 16)
    opts = {"pipeline.ray_sampler.image_height": hw[0], "pipeline.ray_sampler.image_width": hw[1],
            "pipeline.ray_sampler.n_rays_per_image_sampled_from_mask": 16, "pipeline.chunk_size_grid": 2048,
            "runner.num_iters": steps, "runner.output_dir": str(out), "runner.val_per_iter": val_per_iter,
            "runner.save_per_iter": 1, "runner.print_per_iter": 1, "runner.num_workers_list": [0, 0, 0],
            **{f"datasets.{i}.base_dir": str(scene) for i in range(3)}}
    models = cfg.pipeline.model
    keys = [f"pipeline.model.{i}" for i in range(len(models))] if isinstance(models, list) else ["pipeline.model"]
    for key, model in zip(keys, models if isinstance(models, list) else [models]):
        if model["type"] == "NeRFMLP":
            opts.update({f"{key}.n_layers": 3, f"{key}.input_skips": [2], f"{key}.n_hidden_neurons_xyz": 32,
                         f"{key}.n_hidden_neurons_dir": 16, f"{key}.use_pallas_train": True})
        else:
            opts.update({f"{key}.n_layers": 2, f"{key}.hidden_dim": 16})
    if TINY[config] != "blender":
        opts.update({f"datasets.{i}.{key}": value for i in range(3)
                     for key, value in (("test_skip", 4), ("factor", 1))})
    cfg.merge_from_dict(opts)
    cfg.dump(str(path))
    return path


def _scene(tmp_path, kind):
    if kind == "blender":
        return write_scene(tmp_path / "blender", hw=16, n_train=3, n_val=1, n_test=1, n_spheres=3, seed=1)
    if kind == "orbit":
        return write_llff_scene(tmp_path / "orbit", 12, 16, 8, n_spheres=3, mode="orbit", distant_spheres=3,
                                distant_min=20.0, distant_max=40.0, seed=1)
    return write_llff_scene(tmp_path / "forward", 12, 16, 8, n_spheres=3, seed=1)


@pytest.mark.parametrize("config", list(TINY))
def test_serve_and_run_build_and_train_the_slice_configs_on_the_cpu(tmp_path, config):
    full = Config.fromfile(str(REPO / "configs" / "nerf" / config))
    service = service_from_config(full, checkpoint=None, device="cpu", seed=0)  # the shipped widths build
    sampler = service._pipeline.ray_sampler
    assert service.image_hw == (full.pipeline.ray_sampler.image_height, full.pipeline.ray_sampler.image_width)
    if config == "fern_ndc_proposal.yml":
        assert sampler.use_ndc and sampler.ndc_near == 1.0
    elif config == "synth_llff_360_unbounded.yml":
        assert all(fn.contract_coords for fn in service._pipeline.implicit_functions)
        assert sampler.sampler(EvaluationMode.TRAINING).sample_in_disparity
    elif config == "synth800_proposal.yml":
        assert sampler.sampler(EvaluationMode.TRAINING).scene_aabb is None
        assert sampler.sampler(EvaluationMode.EVALUATION).scene_aabb.shape == (2, 3)

    scene = _scene(tmp_path, TINY[config])
    tiny = _tiny_config(config, tmp_path / "tiny.yml", scene, tmp_path / "results")
    result = port_run.main(["--config", str(tiny), "--device", "cpu"])
    state = result["state"]
    assert state.step == (3 if TINY[config] == "blender" else 6)  # one epoch: 2 iterations round up to it
    assert all(math.isfinite(v) for v in result["test_stats"].values())
    train = [json.loads(line) for line in (result["output_dir"] / "train_stats.json").read_text().splitlines()]
    assert all(math.isfinite(r["train_objective"]) for r in train)
    cfg = Config.fromfile(str(result["output_dir"] / "config.yml"))
    fresh = PIPELINES.build(cfg.pipeline, device="cpu")
    reloaded = TrainState(pipeline=fresh, optimizer=create_optimizer(cfg.runner, fresh), step=0)
    load_checkpoint(result["checkpoint"], reloaded)
    assert reloaded.step == state.step
    for (k, p), q in zip(state.pipeline.named_parameters(), fresh.parameters()):
        assert torch.equal(p.detach(), q.detach()), k
    # serve the run's checkpoint: a test view of the LLFF scenes (its focal and bounds), an orbit view of Blender's
    served = service_from_config(cfg, checkpoint=str(result["checkpoint"]), device="cpu")
    if TINY[config] == "blender":
        view = ((orbit_pose(30.0, -30.0, 4.0) @ CAM_CALIBRATION)[:3, :4].astype(np.float32), served.default_focal)
    else:
        pose, focal, _, lo, hi = DATASETS.build(dict(cfg.datasets[2], base_dir=str(scene)))[0]
        view = (pose, float(focal[0]), float(lo[0]), float(hi[0]))
    rgb, depth = served.render(*view)
    assert rgb.shape == (*served.image_hw, 3) and depth.shape == served.image_hw
    assert np.isfinite(rgb).all() and rgb.min() >= 0.0 and rgb.max() <= 1.0 and np.isfinite(depth).all()


def test_chip_smoke_llff_phases_run_on_the_cpu(tmp_path, monkeypatch):
    """chip_smoke.py's LLFF phases (scenes, frames, fused and per-step training, the card against the CPU) on the
    four configs at tiny widths and a 12x16 frame, steps_per_call 3 on 8-view scenes (7 train views)."""
    import chip_smoke
    from yanerf_tpu_torch.ops.kernels import nerf_mlp_bwd as K3
    from yanerf_tpu_torch.ops.kernels import nerf_mlp_fwd as K1

    # CPU tensors take the plain versions, which count no launch: count the calls instead
    for module, name in ((K1, "nerf_mlp_fwd"), (K3, "nerf_mlp_bwd")):

        def counting(*args, _module=module, _plain=getattr(module, name), **kwargs):
            _module.launches += 1
            return _plain(*args, **kwargs)

        monkeypatch.setattr(module, name, counting)
    for name, value in (("DEVICE", "cpu"), ("LLFF_HW", (12, 16)), ("LLFF_IMAGES", 8), ("FUSED_STEPS_PER_CALL", 3),
                        ("FAMILY_EVAL_RAYS", 40), ("FAMILY_TRAIN_RAYS", 64)):
        monkeypatch.setattr(chip_smoke, name, value)
    for attr, config in (("NDC_CONFIG", "fern_ndc_proposal.yml"), ("UNBOUNDED_CONFIG", "synth_llff_360_unbounded.yml"),
                         ("LLFF_CLASSIC_CONFIG", "synth_llff.yml"), ("AABB_CONFIG", "synth800_proposal.yml")):
        path = _tiny_config(config, tmp_path / f"{attr}.yml", tmp_path / "unused", tmp_path / "results",
                            val_per_iter=1000)
        monkeypatch.setattr(chip_smoke, attr, path)
    paths = chip_smoke.llff_phases(torch, K1, K3, "cpu", tmp_path)
    # one K1 per chunk and NeRFMLP on the frames; K1 and K3 once per step and NeRFMLP in training, 14 fused
    # steps (two epochs of 7) and one epoch of the classic per step (two NeRFMLPs)
    assert paths["ndc_frame"] == paths["unbounded_frame"] == {"nerf_mlp_fwd": 6}  # 12 * 16 * 64 / 2048 points
    assert paths["synth800_proposal_frame"] == {"nerf_mlp_fwd": 8}
    for name in ("ndc_train_fused", "unbounded_train_fused"):
        assert paths[name] == {"nerf_mlp_fwd": 14, "nerf_mlp_fwd_pipelined": 0, "nerf_mlp_bwd": 14}, name
    assert paths["synth_llff_train"] == {"nerf_mlp_fwd": 14, "nerf_mlp_fwd_pipelined": 0, "nerf_mlp_bwd": 14}
