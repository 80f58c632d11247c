"""Lossless (SOF3), four-component (CMYK / YCCK) and the committed JPEG kinds through the port's decoder.

``tests/data/jpeg_kinds`` (written by ``tests/make_jpeg_kinds.py``) holds
small arithmetic-coded, lossless, CMYK / YCCK, truncated and 12- / 16-bit
files with the digests of what the JAX loaders make of them: the port's
``load_image`` must give the JAX ``yanerf_tpu.datasets.utils.load_image``
array (PIL's CMYK conversion, its fallback for what libjpeg-turbo 2.x does
not read), ``load_image_u8`` the ``cv2.imread(IMREAD_UNCHANGED)`` array
(OpenCV's, which the JAX ``LLFFDataset._minify`` reads), and a refusal of
the JAX call must be the port's too. Two truncated files follow another
libjpeg-turbo build than the JAX call's here (``digests.json`` says which
and why); both are pinned below. Lossless and CMYK files are also written
here by the pure-Python writer, and an LLFF capture of CMYK JPEGs by PIL.
"""

import hashlib
import json
import shutil
from pathlib import Path

import cv2
import numpy as np
import pytest
from PIL import Image

from make_jpeg_kinds import jax_load_image_without_simd, lossless_jpeg, picture
from yanerf_tpu.datasets import LLFFDataset as JaxLLFFDataset
from yanerf_tpu.datasets.utils import load_image as jax_load_image
from yanerf_tpu_torch import native
from yanerf_tpu_torch.datasets import LLFFDataset
from yanerf_tpu_torch.synth_llff import write_llff_scene
from yanerf_tpu_torch.utils.images import decode_png, load_image, load_image_u8

KINDS = Path(__file__).resolve().parent / "data" / "jpeg_kinds"
DIGESTS = json.loads((KINDS / "digests.json").read_text())


def _sha(arr):
    return hashlib.sha256(np.ascontiguousarray(arr).tobytes()).hexdigest()


def _cv2_rgb(path):
    img = cv2.imread(str(path), cv2.IMREAD_UNCHANGED)
    if img is None:
        return None
    return np.repeat(img[..., None], 3, axis=-1) if img.ndim == 2 else np.ascontiguousarray(img[..., ::-1])


def _port(fn, path):
    try:
        return fn(path)
    except (NotImplementedError, IOError) as e:
        return e


@pytest.mark.parametrize("name", sorted(DIGESTS["files"]))
def test_every_committed_kind_decodes_as_the_jax_loaders(name):
    """The committed digests, in both CMYK conventions, and the JAX loaders' live arrays on this machine."""
    path = KINDS / name
    entry, port = DIGESTS["files"][name], DIGESTS["port"].get(name, {})
    got, got_u8 = _port(load_image, path), _port(load_image_u8, path)
    for key, img in (("load_image", got), ("imread", got_u8)):
        want = port.get(key, entry[key])
        if want is None or "raises" in want:
            assert isinstance(img, Exception), (name, key)
        else:
            assert not isinstance(img, Exception), (name, key, img)
            assert list(img.shape) == want["shape"] and _sha(img) == want["sha256"], (name, key)
    try:
        ref = jax_load_image(path)
    except Exception as e:  # noqa: BLE001 -- the JAX call's refusal
        ref = e
    assert isinstance(ref, Exception) == ("raises" in entry["load_image"])
    assert isinstance(ref, Exception) or _sha(ref) == entry["load_image"]["sha256"], "the digest is the JAX call's"
    cv = _cv2_rgb(path)
    assert (cv is None) == (entry["imread"] is None) and (cv is None or _sha(cv) == entry["imread"]["sha256"])
    if not port and not isinstance(ref, Exception):
        np.testing.assert_array_equal(got, ref)
        np.testing.assert_array_equal(got_u8, cv)
    if name.startswith("lossless_") and "sha256" in entry["load_image"]:  # nothing of a lossless file is lost
        with Image.open(path) as im:
            np.testing.assert_array_equal(got_u8, np.asarray(im.convert("RGB")))


def test_a_progressive_arith_file_cut_at_a_scan_smooths_as_libjpeg_turbo_3():
    """Cut before its DC refinement, the file is block-smoothed: libjpeg-turbo 3.x's smoothing (cv2 and PIL)
    byte for byte; the JAX native decoder's system libjpeg-turbo 2.1.x smooths within 1 level of it."""
    path = KINDS / "arith_progressive_cut.jpg"
    got = load_image_u8(path)
    np.testing.assert_array_equal(got, _cv2_rgb(path))
    with Image.open(path) as im:
        np.testing.assert_array_equal(got, np.asarray(im.convert("RGB")))
    gap = np.abs(np.rint(jax_load_image(path) * 255.0) - got)
    assert gap.max() <= 1 and (gap > 0).mean() < 0.01, (gap.max(), (gap > 0).mean())
    np.testing.assert_array_equal(load_image(path), got.astype(np.float32) / np.float32(255.0))


def test_an_arith_file_cut_mid_scan_decodes_as_libjpeg_turbos_c_idct():
    """The zeros fed after the cut decode to coefficients far out of range: the port equals libjpeg-turbo with
    its SIMD off (``JSIMD_FORCENONE=1``, its C IDCT, in a fresh process of the JAX call) byte for byte, and the
    default (SIMD) JAX call and cv2 on every MCU row decoded before the data ran out."""
    path = KINDS / "arith_cut_mid_scan.jpg"
    got = load_image(path)
    np.testing.assert_array_equal(got, jax_load_image_without_simd(path))
    u8 = load_image_u8(path)
    rows = np.flatnonzero((u8 != _cv2_rgb(path)).any(axis=(1, 2)))
    assert rows.size and rows.min() >= 64, rows.min()  # the first 4 MCU rows (16 lines each) decode as cv2
    np.testing.assert_array_equal(got[:64], jax_load_image(path)[:64])


@pytest.mark.parametrize("bits", [12, 16])
def test_lossless_files_at_12_and_16_bits_are_refused_by_everyone(bits):
    path = KINDS / f"lossless_{bits}bit.jpg"
    for fn in (load_image, load_image_u8, native.decode_image):
        with pytest.raises(NotImplementedError, match=f"lossless_{bits}bit.jpg.*SOF3.*{bits}-bit samples"):
            fn(path)
    with pytest.raises(NotImplementedError, match=f"{bits}-bit"):
        native.decode_batch([path])
    with pytest.raises(OSError):
        Image.open(path).convert("RGB")
    assert cv2.imread(str(path), cv2.IMREAD_UNCHANGED) is None
    with pytest.raises(OSError):
        jax_load_image(path)


def test_lossless_colour_conversion_is_refused_by_everyone(tmp_path):
    """libjpeg-turbo converts no colour in a lossless frame: YCbCr (a JFIF marker) and YCCK are refused."""
    ycc = KINDS / "lossless_jfif.jpg"
    ycck = tmp_path / "ycck.jpg"
    ycck.write_bytes(lossless_jpeg(np.zeros((8, 8, 4), np.uint8), adobe=2))
    for path, space in ((ycc, "YCbCr"), (ycck, "YCCK")):
        with pytest.raises(NotImplementedError, match=f"{path.name}.*SOF3.*in {space}"):
            load_image(path)
        with pytest.raises(OSError):
            Image.open(path).convert("RGB")
        assert cv2.imread(str(path), cv2.IMREAD_UNCHANGED) is None


def test_an_arithmetic_lossless_frame_is_refused_by_everyone(tmp_path):
    """SOF11: a lossless frame's header relabelled arithmetic-coded."""
    data = bytearray((KINDS / "lossless_rgb_p1_t0.jpg").read_bytes())
    sof = data.index(b"\xff\xc3")
    data[sof + 1] = 0xCB
    path = tmp_path / "sof11.jpg"
    path.write_bytes(bytes(data))
    with pytest.raises(NotImplementedError, match="sof11.jpg.*SOF11 .arithmetic lossless"):
        load_image(path)
    with pytest.raises(OSError):
        Image.open(path).convert("RGB")
    assert cv2.imread(str(path), cv2.IMREAD_UNCHANGED) is None
    with pytest.raises(OSError):
        jax_load_image(path)


@pytest.mark.parametrize("adobe", [None, 0], ids=["no_app14", "adobe_0"])
def test_every_c_k_pair_converts_as_pil_and_opencv(tmp_path, adobe):
    """All 65,536 (c, k) pairs (and m, y as functions of c) in a lossless CMYK file, whose samples are known
    exactly: PIL's ``convert("RGB")`` of its inverted ``CMYK;I`` samples (and ``Image.frombytes`` of them),
    and ``cv2.imread``'s ``k - ((255 - c) * k >> 8)``, both whatever the Adobe marker says."""
    c, k = np.meshgrid(np.arange(256), np.arange(256), indexing="ij")
    ink = np.stack([c, 255 - c, (c * 7) % 256, k], -1).astype(np.uint8)
    path = tmp_path / "cmyk.jpg"
    path.write_bytes(lossless_jpeg(ink, psv=4, adobe=adobe))
    pil = np.rint(load_image(path) * 255.0).astype(np.uint8)
    np.testing.assert_array_equal(pil, np.asarray(Image.frombytes("CMYK", (256, 256), (255 - ink).tobytes())
                                                  .convert("RGB")))
    with Image.open(path) as im:
        assert im.mode == "CMYK"
        np.testing.assert_array_equal(pil, np.asarray(im.convert("RGB")))
    opencv = load_image_u8(path)
    np.testing.assert_array_equal(opencv, _cv2_rgb(path))
    kk = k[..., None].astype(np.int64)
    np.testing.assert_array_equal(opencv, kk - (((255 - ink[..., :3].astype(np.int64)) * kk) >> 8))
    assert native.jpeg_info(path) == (256, 256, 4, 1)


@pytest.mark.parametrize("sampling", [(1, 1), (2, 2), (1, 2)], ids=["444", "420", "440"])
def test_lossless_files_round_trip_and_decode_as_pil(tmp_path, sampling):
    """Every predictor and point transform, restarts, 'R', 'G', 'B' and 1, 2, 3 IDs, grey, subsampled planes
    replicated: PIL (the JAX ``load_image``'s reader of these) and cv2 byte for byte."""
    pic = picture(16, 24, seed=sampling[0] + 2 * sampling[1])
    for psv in range(1, 8):
        for pt in (0, 3):
            for ids in (b"RGB", (1, 2, 3)):
                path = tmp_path / f"p{psv}_t{pt}_{len(ids)}_{ids[0]}.jpg"
                path.write_bytes(lossless_jpeg(pic, psv, pt, ids=ids, restart_rows=psv % 3, sampling=sampling))
                got = load_image_u8(path)
                if sampling == (1, 1):
                    np.testing.assert_array_equal(got, (pic >> pt) << pt, err_msg=path.name)
                np.testing.assert_array_equal(got, _cv2_rgb(path), err_msg=path.name)
                np.testing.assert_array_equal(load_image(path), jax_load_image(path), err_msg=path.name)
        grey = tmp_path / f"grey_p{psv}.jpg"
        grey.write_bytes(lossless_jpeg(pic[..., 1], psv, 1, restart_rows=2))
        np.testing.assert_array_equal(load_image_u8(grey), np.repeat(((pic[..., 1:2] >> 1) << 1), 3, -1))


@pytest.mark.parametrize("restart_rows", [0, 1, 3])
def test_lossless_files_cut_short_decode_as_cv2(tmp_path, restart_rows):
    """A truncated lossless file: the rows after the data ran out are zero differences from a new first row
    (jdlhuff.c), until a restart marker that is no longer there."""
    pic = picture(24, 32, seed=restart_rows)
    for name, samples, options in (("rgb", pic, dict(ids=b"RGB")), ("grey", pic[..., 1], {}),
                                   ("420", pic, dict(ids=b"RGB", sampling=(2, 2)))):
        data = lossless_jpeg(samples, psv=4, restart_rows=restart_rows, **options)
        for k, frac in enumerate((0.2, 0.45, 0.7, 0.95)):
            cut = tmp_path / f"{name}_cut{k}.jpg"
            cut.write_bytes(data[:int(len(data) * frac)])
            np.testing.assert_array_equal(load_image_u8(cut), _cv2_rgb(cut), err_msg=cut.name)


def test_a_lossless_restart_interval_must_be_whole_rows(tmp_path):
    data = bytearray(lossless_jpeg(picture(8, 8), restart_rows=1))
    dri = data.index(b"\xff\xdd")
    data[dri + 4:dri + 6] = (5).to_bytes(2, "big")  # 5 MCUs: not a whole row of 8
    bad = tmp_path / "bad_restart.jpg"
    bad.write_bytes(bytes(data))
    with pytest.raises(IOError, match="bad_restart.jpg.*restart interval 5"):
        load_image(bad)
    assert cv2.imread(str(bad), cv2.IMREAD_UNCHANGED) is None


def test_decode_batch_of_mixed_kinds_takes_pils_convention(tmp_path):
    """Same-sized lossless, arithmetic and CMYK / YCCK files in one batch, each as ``decode_image`` (PIL's
    conversion, as the JAX ``load_image`` would give them one by one)."""
    names = ["arith_420.jpg", "arith_progressive.jpg", "cmyk_adobe.jpg", "ycck.jpg", "cmyk_no_adobe.jpg"]
    paths = [KINDS / n for n in names]
    for n_threads in (1, 3):
        batch = native.decode_batch(paths, n_threads)
        for img, path in zip(batch, paths):
            np.testing.assert_array_equal(img, native.decode_image(path))
            np.testing.assert_array_equal(img, jax_load_image(path))


def _cmyk_capture(root: Path, h: int = 48, w: int = 64, n: int = 4) -> Path:
    """An LLFF capture of ``n`` CMYK JPEGs written by PIL (Adobe marker, inverted samples)."""
    scene = write_llff_scene(root / "png", height=h, width=w, n_images=n)
    capture = root / "capture"
    (capture / "images").mkdir(parents=True)
    shutil.copy(scene / "poses_bounds.npy", capture / "poses_bounds.npy")
    for png in sorted((scene / "images").glob("*.png")):
        rgb = decode_png(png.read_bytes())
        Image.fromarray(rgb).convert("CMYK").save(capture / "images" / f"{png.stem}.jpg", "JPEG", quality=90)
    return capture


def test_llff_dataset_over_a_cmyk_capture_matches_jax(tmp_path):
    """Without a factor the views are read by ``load_image`` (PIL's conversion); at factor 2 ``_minify``
    resizes what ``cv2.imread`` gives (OpenCV's), as the JAX loader does."""
    capture = _cmyk_capture(tmp_path)
    for root in ("jax", "port"):
        shutil.copytree(capture, tmp_path / root)
    for factor in (None, 2):
        ref = JaxLLFFDataset(str(tmp_path / "jax"), "train", factor=factor, test_skip=3)
        got = LLFFDataset(str(tmp_path / "port"), "train", factor=factor, test_skip=3)
        assert len(got) == len(ref) > 0
        for name in ("poses", "bds", "render_poses"):
            np.testing.assert_array_equal(getattr(got, name), getattr(ref, name), err_msg=name)
        for i in range(len(got)):
            for a, b in zip(got[i], ref[i]):
                assert a.dtype == b.dtype and a.shape == b.shape
                np.testing.assert_array_equal(a, b)
    pngs = sorted((tmp_path / "port" / "images_2").iterdir())
    assert len(pngs) == 4
    for png in pngs:
        np.testing.assert_array_equal(load_image_u8(png), _cv2_rgb(tmp_path / "jax" / "images_2" / png.name))
