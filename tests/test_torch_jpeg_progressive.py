"""Progressive JPEGs (SOF2) and JPEGs without DHT through the port's decoder, against OpenCV and the JAX package.

Every file is written here by PIL at a small size. A complete progressive
file must decode ``np.array_equal`` to ``cv2.imread`` (its libjpeg-turbo
3.x) and to ``yanerf_tpu.native.decode_image`` (the system libjpeg-turbo
2.1.x): every sampling, quality, optimised table, restart setting and odd
size. A file cut at the start of a scan is held to ``cv2.imread`` byte for
byte: libjpeg-turbo 3.x's block smoothing of the coefficients not yet
refined. The 2.1.x build smooths slightly differently: within 2 levels of
it once an AC scan has arrived (on a photo-like view); after the DC scan
alone its DC interpolation differs more, so that cut is held to OpenCV
only. ``LLFFDataset`` over the committed progressive capture
(``tests/data/llff_jpeg_progressive``) must equal the JAX loader's.
"""

import hashlib
import json
import shutil
from pathlib import Path

import cv2
import numpy as np
import pytest
from PIL import Image

from yanerf_tpu import native as jax_native
from yanerf_tpu.datasets import LLFFDataset as JaxLLFFDataset
from yanerf_tpu_torch import native
from yanerf_tpu_torch.datasets import LLFFDataset
from yanerf_tpu_torch.synth_llff import write_llff_scene
from yanerf_tpu_torch.utils.images import decode_png, image_shape, load_image_u8

CAPTURE = Path(__file__).resolve().parent / "data" / "llff_jpeg_progressive"
SAMPLINGS = {"444": 0, "422": 1, "420": 2, "grey": None}


def _picture(h, w, seed=0):
    """Smooth gradients plus noise: every DCT frequency and both chroma channels carry signal."""
    y, x = np.mgrid[:h, :w]
    rgb = np.stack([np.sin(x / 7.0) * 100 + 120, np.cos(y / 5.0) * 90 + 120, (x * 3 + y * 5) % 255], -1)
    rgb = rgb + np.random.RandomState(seed).normal(0, 20, rgb.shape)
    return np.clip(rgb, 0, 255).astype(np.uint8)


def _save(path, picture, sampling, **options):
    if SAMPLINGS[sampling] is None:
        Image.fromarray(picture[..., 0]).save(path, "JPEG", **options)
    else:
        Image.fromarray(picture).save(path, "JPEG", subsampling=SAMPLINGS[sampling], **options)
    return path


def _cv2_rgb(path):
    img = cv2.imread(str(path), cv2.IMREAD_UNCHANGED)
    assert img is not None, path
    return np.repeat(img[..., None], 3, axis=-1) if img.ndim == 2 else np.ascontiguousarray(img[..., ::-1])


def _jax_u8(path):
    return np.rint(jax_native.decode_image(str(path)) * 255.0).astype(np.uint8)


def _scan_starts(data: bytes):
    """Offsets of the SOS markers, walking the marker segments and skipping each scan's entropy-coded data."""
    starts, i = [], 2
    while i + 4 <= len(data) and data[i] == 0xFF and data[i + 1] != 0xD9:
        end = i + 2 + int.from_bytes(data[i + 2:i + 4], "big")
        if data[i + 1] == 0xDA:
            starts.append(i)
            while not (data[end] == 0xFF and data[end + 1] not in (0x00, *range(0xD0, 0xD8))):
                end += 1
        i = end
    return starts


@pytest.mark.parametrize("hw", [(23, 37), (17, 33), (1, 1), (120, 161)], ids=lambda hw: f"{hw[1]}x{hw[0]}")
@pytest.mark.parametrize("sampling", list(SAMPLINGS))
def test_progressive_jpegs_decode_as_libjpeg(tmp_path, sampling, hw):
    picture = _picture(*hw, seed=hw[0] + len(sampling))
    for quality in (50, 95):
        for optimize in (False, True):
            for restart in (0, 1):
                extra = {"restart_marker_rows": 1} if restart else {}
                path = _save(tmp_path / f"q{quality}_o{int(optimize)}_r{restart}.jpg", picture, sampling,
                             quality=quality, optimize=optimize, progressive=True, **extra)
                data = path.read_bytes()
                assert b"\xff\xc2" in data and len(_scan_starts(data)) > 1
                assert (b"\xff\xdd" in data) == bool(restart)
                got = native.decode_image_u8(path)
                assert got.shape == (*hw, 3) and native.jpeg_info(path)[:3] == (*hw, 1 if sampling == "grey" else 3)
                np.testing.assert_array_equal(got, _cv2_rgb(path), err_msg=path.name)
                np.testing.assert_array_equal(got, _jax_u8(path), err_msg=path.name)
                np.testing.assert_array_equal(native.decode_image(path), jax_native.decode_image(str(path)))


@pytest.mark.parametrize("layout", ["440", "411"])
def test_opencv_progressive_layouts_decode_as_libjpeg(tmp_path, layout):
    """Sampling layouts PIL does not write (4:4:0, 4:1:1), from OpenCV's encoder, complete and cut at each scan."""
    picture = _picture(45, 61, seed=3)
    for restart in (0, 2):
        path = tmp_path / f"cv_{layout}_r{restart}.jpg"
        cv2.imwrite(str(path), picture, [cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                                         getattr(cv2, f"IMWRITE_JPEG_SAMPLING_FACTOR_{layout}"),
                                         cv2.IMWRITE_JPEG_QUALITY, 90, cv2.IMWRITE_JPEG_PROGRESSIVE, 1,
                                         cv2.IMWRITE_JPEG_RST_INTERVAL, restart])
        data = path.read_bytes()
        assert b"\xff\xc2" in data
        np.testing.assert_array_equal(native.decode_image_u8(path), _cv2_rgb(path))
        np.testing.assert_array_equal(native.decode_image(path), jax_native.decode_image(str(path)))
        for k, at in enumerate(_scan_starts(data)[1:], 1):
            cut = tmp_path / f"cut{k}_{path.name}"
            cut.write_bytes(data[:at] + b"\xff\xd9")
            np.testing.assert_array_equal(native.decode_image_u8(cut), _cv2_rgb(cut), err_msg=cut.name)


def _photo_like(h, w):
    """A view of the procedural LLFF scene: smooth shading and edges, as a camera sees them."""
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        scene = write_llff_scene(Path(tmp), height=h, width=w, n_images=1)
        return decode_png(next((scene / "images").glob("*.png")).read_bytes())


@pytest.mark.parametrize("sampling", ["420", "444", "grey"])
def test_files_cut_at_each_scan_decode_as_cv2(tmp_path, sampling):
    """A truncated upload: the file cut at the start of each scan after the first, then EOI."""
    # "narrow": two blocks across, where libjpeg-turbo 3.x fixed the 5x5 window's right edge
    for name, picture in (("photo", _photo_like(120, 160)), ("noise", _picture(31, 47, seed=5)),
                          ("narrow", _picture(20, 16, seed=6))):
        path = _save(tmp_path / f"{name}.jpg", picture, sampling, quality=85, progressive=True, restart_marker_rows=1)
        data = path.read_bytes()
        starts = _scan_starts(data)
        assert len(starts) == (6 if sampling == "grey" else 10)  # PIL's (libjpeg's) default scan scripts
        for k, at in enumerate(starts[1:], 1):
            cut = tmp_path / f"{name}_cut{k}.jpg"
            cut.write_bytes(data[:at] + b"\xff\xd9")
            got = native.decode_image_u8(cut)
            np.testing.assert_array_equal(got, _cv2_rgb(cut), err_msg=cut.name)
            if name == "photo" and k > 1:  # an AC scan has arrived
                gap = np.abs(got.astype(np.int16) - _jax_u8(cut))
                assert gap.max() <= 2 and (gap > 0).mean() < 0.01, (cut.name, gap.max(), (gap > 0).mean())
        # the whole file never smooths
        np.testing.assert_array_equal(native.decode_image_u8(path), _jax_u8(path))


def _without_dht(data: bytes) -> bytes:
    out, i = bytearray(data[:2]), 2
    while data[i + 1] != 0xDA:
        n = int.from_bytes(data[i + 2:i + 4], "big")
        if data[i + 1] != 0xC4:
            out += data[i:i + 2 + n]
        i += 2 + n
    return bytes(out + data[i:])


@pytest.mark.parametrize("sampling", list(SAMPLINGS))
def test_a_jpeg_without_dht_takes_the_standard_tables(tmp_path, sampling):
    """Motion-JPEG frames carry no DHT: T.81 Annex K.3's tables, which PIL writes unless it optimises."""
    path = _save(tmp_path / "with.jpg", _picture(37, 53, seed=1), sampling, quality=75)
    bare = tmp_path / "bare.jpg"
    bare.write_bytes(_without_dht(path.read_bytes()))
    assert b"\xff\xc4" not in bare.read_bytes()
    got = native.decode_image_u8(bare)
    np.testing.assert_array_equal(got, native.decode_image_u8(path))
    np.testing.assert_array_equal(got, _cv2_rgb(bare))
    np.testing.assert_array_equal(got, _jax_u8(bare))
    # a file's own tables win: an optimised file keeps its DHT and decodes as before
    own = _save(tmp_path / "own.jpg", _picture(37, 53, seed=1), sampling, quality=75, optimize=True)
    np.testing.assert_array_equal(native.decode_image_u8(own), _cv2_rgb(own))


def test_decode_batch_of_baseline_and_progressive_files(tmp_path):
    paths = []
    for i in range(6):
        options = dict(progressive=True) if i % 2 else dict(restart_marker_blocks=3)
        paths.append(_save(tmp_path / f"v{i}.jpg", _picture(30, 44, seed=i), "420", quality=80 + i, **options))
    for n_threads in (0, 1, 4):
        batch = native.decode_batch(paths, n_threads)
        assert batch.shape == (6, 30, 44, 3)
        for i, path in enumerate(paths):
            np.testing.assert_array_equal(batch[i], native.decode_image(path))
    np.testing.assert_array_equal(native.decode_batch(paths), jax_native.decode_batch([str(p) for p in paths]))


def test_exif_orientation_of_a_progressive_file(tmp_path):
    for orientation in (1, 6, 8):
        exif = Image.Exif()
        exif[0x0112] = orientation
        path = _save(tmp_path / f"o{orientation}.jpg", _picture(30, 50), "420", quality=90, progressive=True,
                     exif=exif.tobytes())
        assert native.jpeg_info(path)[3] == orientation
        assert image_shape(path, exif_orientation=True) == cv2.imread(str(path)).shape
        np.testing.assert_array_equal(load_image_u8(path), _cv2_rgb(path))


def test_a_bad_scan_script_raises(tmp_path):
    """A refinement scan must lower Al by one (Al = Ah - 1): Al = Ah is refused as libjpeg refuses it."""
    path = _save(tmp_path / "good.jpg", _picture(24, 40), "420", quality=85, progressive=True)
    data = bytearray(path.read_bytes())
    for start in _scan_starts(bytes(data)):
        ns = data[start + 4]
        ahal = start + 4 + 1 + 2 * ns + 2
        if data[ahal] >> 4:  # the first refinement scan: set Al to Ah
            data[ahal] = (data[ahal] & 0xF0) | (data[ahal] >> 4)
            break
    bad = tmp_path / "bad_script.jpg"
    bad.write_bytes(bytes(data))
    with pytest.raises(IOError, match="bad_script.jpg.*bad progressive scan"):
        native.decode_image(bad)
    with pytest.raises(IOError, match="bad_script.jpg"):
        native.decode_batch([bad])
    with pytest.raises(IOError):
        jax_native.decode_image(str(bad))
    assert cv2.imread(str(bad), cv2.IMREAD_UNCHANGED) is None


def test_the_committed_progressive_capture_decodes_to_the_jax_digests():
    digests = json.loads((CAPTURE / "digests.json").read_text())
    files = sorted((CAPTURE / "images").iterdir())
    assert [f.name for f in files] == sorted(digests["decode"]) and len(files) == 12
    assert sum(f.stat().st_size for f in CAPTURE.rglob("*") if f.is_file()) < 1_000_000
    batch = native.decode_batch(files)
    for f, img in zip(files, batch):
        assert hashlib.sha256(img.tobytes()).hexdigest() == digests["decode"][f.name], f.name
    data = files[0].read_bytes()
    assert b"\xff\xc2" in data and len(_scan_starts(data)) == 10 and b"\xff\xdd" in data
    assert native.jpeg_info(files[0]) == (756, 1008, 3, 1)


@pytest.fixture
def capture_pair(tmp_path):
    for root in ("jax", "port"):
        shutil.copytree(CAPTURE, tmp_path / root)
    return tmp_path


def test_llff_dataset_over_the_progressive_capture_matches_jax(capture_pair):
    for split in ("train", "test"):
        ref = JaxLLFFDataset(str(capture_pair / "jax"), split, factor=2, test_skip=3)
        got = LLFFDataset(str(capture_pair / "port"), split, factor=2, test_skip=3)
        assert len(got) == len(ref) > 0
        for name in ("poses", "bds", "render_poses"):
            np.testing.assert_array_equal(getattr(got, name), getattr(ref, name), err_msg=name)
        for i in range(len(got)):
            for a, b in zip(got[i], ref[i]):
                assert a.dtype == b.dtype and a.shape == b.shape
                np.testing.assert_array_equal(a, b)
    ref = JaxLLFFDataset._load_data(str(capture_pair / "jax"), width=252)
    got = LLFFDataset._load_data(str(capture_pair / "port"), width=252)
    np.testing.assert_array_equal(got[0], ref[0])
    np.testing.assert_array_equal(got[1], ref[1])
    assert [Path(f).name for f in got[2]] == [Path(f).name for f in ref[2]] and len(got[2]) == 12
    for a, b in zip(got[2], ref[2]):
        np.testing.assert_array_equal(load_image_u8(a), load_image_u8(b))


def test_minify_of_the_progressive_capture_matches_the_committed_jax_digests(tmp_path):
    shutil.copytree(CAPTURE, tmp_path / "capture")
    digests = json.loads((CAPTURE / "digests.json").read_text())
    LLFFDataset._minify(str(tmp_path / "capture"), factors=[2])
    out = tmp_path / "capture" / digests["minify_dir"]
    assert sorted(p.name for p in out.iterdir()) == sorted(digests["minify"])
    for png in sorted(out.iterdir()):
        img = load_image_u8(png)
        assert img.shape == (378, 504, 3)
        assert hashlib.sha256(img.tobytes()).hexdigest() == digests["minify"][png.name], png.name


def test_chip_smoke_runs_its_jpeg_phases_on_the_progressive_capture(tmp_path, monkeypatch):
    """chip_smoke.py's "jpeg decode" (both captures, their digests and rates) and "jpeg capture" on the
    progressive capture at a tiny size: fern.yml / real_360.yml cut to narrow models at factor 36 (28x21)."""
    import chip_smoke
    import torch
    from test_torch_chip_smoke_capture import _count_calls, _narrow_capture_config

    from yanerf_tpu_torch.ops.kernels import nerf_mlp_bwd as K3
    from yanerf_tpu_torch.ops.kernels import nerf_mlp_fwd as K1

    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")
    monkeypatch.setattr(chip_smoke, "JPEG_DECODE_REPEATS", 1)
    _count_calls(monkeypatch)
    chip_smoke.jpeg_decode_phase("cpu")
    configs = tuple(_narrow_capture_config(c, tmp_path / c) for c in ("fern.yml", "real_360.yml"))
    paths = chip_smoke.jpeg_capture_phases(torch, K1, K3, "cpu", tmp_path, configs, factor=36, steps=20,
                                           capture=chip_smoke.JPEG_PROGRESSIVE_CAPTURE, family=False)
    assert paths == {"fern_jpeg_progressive_train_fused": {"nerf_mlp_fwd": 40, "nerf_mlp_fwd_pipelined": 0,
                                                           "nerf_mlp_bwd": 40},
                     "real_360_jpeg_progressive_frame": {"nerf_mlp_fwd": 4}}
    assert (tmp_path / "llff_jpeg_progressive" / "images_36").is_dir()
