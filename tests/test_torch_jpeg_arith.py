"""Arithmetic-coded JPEGs (SOF9 sequential, SOF10 progressive, DAC conditioning) through the port's decoder.

PIL writes no arithmetic coding, so every file here comes from
``tests/jpeg_kinds_writer.c``, built with gcc against the system
libjpeg(-turbo) (``tests/make_jpeg_kinds.py``). A complete file must decode
``np.array_equal`` to ``yanerf_tpu.datasets.utils.load_image`` (the system
libjpeg-turbo through ``yanerf_tpu.native``) and to ``cv2.imread`` (its own
libjpeg-turbo 3.x): every sampling, quality, restart interval, DAC
conditioning and odd size. A progressive file cut at the start of a scan is
held to ``cv2.imread`` byte for byte (libjpeg-turbo 3.x's block smoothing)
and to the JAX call within 1 level (its 2.1.x smoothing). ``LLFFDataset``
over the committed arithmetic capture (``tests/data/llff_jpeg_arith``) must
equal the JAX loader's, and chip_smoke.py's JPEG phases run on it here.
"""

import hashlib
import json
import shutil
from pathlib import Path

import cv2
import numpy as np
import pytest

from make_jpeg_kinds import build_writer, cmyk_picture, libjpeg_file, picture, scan_starts
from yanerf_tpu.datasets import LLFFDataset as JaxLLFFDataset
from yanerf_tpu.datasets.utils import load_image as jax_load_image
from yanerf_tpu_torch import native
from yanerf_tpu_torch.datasets import LLFFDataset
from yanerf_tpu_torch.utils.images import load_image, load_image_u8

CAPTURE = Path(__file__).resolve().parent / "data" / "llff_jpeg_arith"


@pytest.fixture(scope="module")
def writer(tmp_path_factory):
    return build_writer(tmp_path_factory.mktemp("writer"))


def _cv2_rgb(path):
    img = cv2.imread(str(path), cv2.IMREAD_UNCHANGED)
    assert img is not None, path
    return np.repeat(img[..., None], 3, axis=-1) if img.ndim == 2 else np.ascontiguousarray(img[..., ::-1])


def _assert_decodes_as_libjpeg(path):
    got = load_image(path)
    np.testing.assert_array_equal(got, jax_load_image(path), err_msg=path.name)
    np.testing.assert_array_equal(load_image_u8(path), _cv2_rgb(path), err_msg=path.name)
    np.testing.assert_array_equal(native.decode_image(path), got)


@pytest.mark.parametrize("hw", [(23, 37), (1, 1), (120, 161)], ids=lambda hw: f"{hw[1]}x{hw[0]}")
@pytest.mark.parametrize("sampling", ["444", "422", "420", "grey"])
def test_sequential_arith_files_decode_as_libjpeg(tmp_path, writer, sampling, hw):
    pic = picture(*hw, seed=hw[0] + len(sampling))
    pixels = pic[..., 0] if sampling == "grey" else pic
    for quality in (50, 95):
        for restart_rows in (0, 1, 3):
            path = libjpeg_file(writer, tmp_path / f"q{quality}_r{restart_rows}.jpg", pixels, quality=quality,
                                sampling=444 if sampling == "grey" else int(sampling), restart_rows=restart_rows)
            data = path.read_bytes()
            assert b"\xff\xc9" in data and (b"\xff\xdd" in data) == bool(restart_rows)
            assert native.jpeg_info(path)[:3] == (*hw, 1 if sampling == "grey" else 3)
            _assert_decodes_as_libjpeg(path)


@pytest.mark.parametrize("dac", [dict(dc_L=0, dc_U=0, ac_K=1), dict(dc_L=2, dc_U=6, ac_K=12),
                                 dict(dc_L=5, dc_U=15, ac_K=63), dict(dc_L=1, dc_U=3, ac_K=0)],
                         ids=lambda d: "_".join(f"{k}{v}" for k, v in d.items()))
def test_dac_conditioning_decodes_as_libjpeg(tmp_path, writer, dac):
    """The DAC marker's DC bounds L / U and AC Kx of table 0, sequential and progressive."""
    for progressive in (False, True):
        path = libjpeg_file(writer, tmp_path / f"dac_p{int(progressive)}.jpg", picture(40, 56, seed=7),
                            quality=85, progressive=progressive, **dac)
        assert b"\xff\xcc" in path.read_bytes()
        _assert_decodes_as_libjpeg(path)


@pytest.mark.parametrize("sampling", ["420", "444", "grey"])
def test_progressive_arith_files_decode_as_libjpeg(tmp_path, writer, sampling):
    """SOF10 with jpeg_simple_progression's script: DC first and refinement, AC first and refinement."""
    for hw in ((31, 47), (120, 160), (8, 8)):
        pic = picture(*hw, seed=hw[1])
        pixels = pic[..., 0] if sampling == "grey" else pic
        for restart_rows in (0, 2):
            path = libjpeg_file(writer, tmp_path / f"p{hw[1]}_r{restart_rows}.jpg", pixels, quality=80,
                                sampling=444 if sampling == "grey" else int(sampling), progressive=True,
                                restart_rows=restart_rows)
            data = path.read_bytes()
            assert b"\xff\xca" in data and len(scan_starts(data)) == (6 if sampling == "grey" else 10)
            _assert_decodes_as_libjpeg(path)


@pytest.mark.parametrize("sampling", ["420", "grey"])
def test_progressive_arith_files_cut_at_each_scan_smooth_as_libjpeg_turbo_3(tmp_path, writer, sampling):
    """A truncated upload: cut at the start of each scan after the first, then EOI. cv2's libjpeg-turbo 3.x
    byte for byte; the JAX call's system libjpeg-turbo 2.1.x within 1 level once an AC scan has arrived."""
    pic = picture(64, 96, seed=9)
    path = libjpeg_file(writer, tmp_path / "full.jpg", pic[..., 0] if sampling == "grey" else pic, quality=85,
                        sampling=444 if sampling == "grey" else 420, progressive=True, restart_rows=1)
    data = path.read_bytes()
    for k, at in enumerate(scan_starts(data)[1:], 1):
        cut = tmp_path / f"cut{k}.jpg"
        cut.write_bytes(data[:at] + b"\xff\xd9")
        got = load_image_u8(cut)
        np.testing.assert_array_equal(got, _cv2_rgb(cut), err_msg=cut.name)
        if k > 1:
            gap = np.abs(np.rint(jax_load_image(cut) * 255.0) - got)
            assert gap.max() <= 1 and (gap > 0).mean() < 0.02, (cut.name, gap.max(), (gap > 0).mean())
    np.testing.assert_array_equal(load_image(path), jax_load_image(path))


def test_four_component_arith_files_decode_in_both_conventions(tmp_path, writer):
    """CMYK and YCCK, sequential and progressive, arithmetic-coded: PIL's conversion (the JAX ``load_image``)
    and OpenCV's (``cv2.imread``)."""
    ink = cmyk_picture(40, 56, seed=2)
    for ycck in (False, True):
        for progressive in (False, True):
            path = libjpeg_file(writer, tmp_path / f"y{int(ycck)}_p{int(progressive)}.jpg", ink, quality=85,
                                sampling=420, ycck=ycck, progressive=progressive)
            assert native.jpeg_info(path)[2] == 4
            _assert_decodes_as_libjpeg(path)


def test_a_corrupt_arith_file_decodes_as_libjpeg(tmp_path):
    """A Huffman-coded file relabelled SOF9: the QM-coder reads nonsense, byte for byte as libjpeg reads it."""
    pic = picture(24, 40)
    path = tmp_path / "huff.jpg"
    cv2.imwrite(str(path), pic[..., ::-1], [cv2.IMWRITE_JPEG_QUALITY, 75])
    data = bytearray(path.read_bytes())
    sof = data.index(b"\xff\xc0")
    data[sof + 1] = 0xC9
    bad = tmp_path / "relabelled.jpg"
    bad.write_bytes(bytes(data))
    np.testing.assert_array_equal(load_image_u8(bad), _cv2_rgb(bad))


def test_the_committed_arith_capture_decodes_to_the_jax_digests():
    digests = json.loads((CAPTURE / "digests.json").read_text())
    files = sorted((CAPTURE / "images").iterdir())
    assert [f.name for f in files] == sorted(digests["decode"]) and len(files) == 12
    assert sum(f.stat().st_size for f in CAPTURE.rglob("*") if f.is_file()) < 500_000
    batch = native.decode_batch(files)
    for f, img in zip(files, batch):
        assert hashlib.sha256(img.tobytes()).hexdigest() == digests["decode"][f.name], f.name
    assert hashlib.sha256(native.decode_image(files[3]).tobytes()).hexdigest() == digests["decode"][files[3].name]
    data = files[0].read_bytes()
    assert b"\xff\xc9" in data and b"\xff\xdd" in data and len(scan_starts(data)) == 1
    assert native.jpeg_info(files[0]) == (756, 1008, 3, 1)


@pytest.fixture
def capture_pair(tmp_path):
    for root in ("jax", "port"):
        shutil.copytree(CAPTURE, tmp_path / root)
    return tmp_path


@pytest.mark.parametrize("factor", [2, None], ids=["factor2", "full_size"])
def test_llff_dataset_over_the_arith_capture_matches_jax(capture_pair, factor):
    for split in ("train", "test"):
        ref = JaxLLFFDataset(str(capture_pair / "jax"), split, factor=factor, test_skip=3)
        got = LLFFDataset(str(capture_pair / "port"), split, factor=factor, test_skip=3)
        assert len(got) == len(ref) > 0
        for name in ("poses", "bds", "render_poses"):
            np.testing.assert_array_equal(getattr(got, name), getattr(ref, name), err_msg=name)
        for i in range(0, len(got), 2 if factor is None else 1):
            for a, b in zip(got[i], ref[i]):
                assert a.dtype == b.dtype and a.shape == b.shape
                np.testing.assert_array_equal(a, b)


def test_minify_of_the_arith_capture_matches_the_committed_jax_digests(tmp_path):
    shutil.copytree(CAPTURE, tmp_path / "capture")
    digests = json.loads((CAPTURE / "digests.json").read_text())
    LLFFDataset._minify(str(tmp_path / "capture"), factors=[2])
    out = tmp_path / "capture" / digests["minify_dir"]
    assert sorted(p.name for p in out.iterdir()) == sorted(digests["minify"])
    for png in sorted(out.iterdir()):
        img = load_image_u8(png)
        assert img.shape == (378, 504, 3)
        assert hashlib.sha256(img.tobytes()).hexdigest() == digests["minify"][png.name], png.name


def test_chip_smoke_runs_its_jpeg_phases_on_the_arith_capture(tmp_path, monkeypatch):
    """chip_smoke.py's "jpeg decode" (the three captures, their digests and rates), "jpeg kinds" (every file of
    tests/data/jpeg_kinds in both conventions) and "jpeg capture" on the arithmetic capture at a tiny size:
    fern.yml cut to narrow models at factor 36 (28x21), no real_360.yml frame."""
    import chip_smoke
    import torch
    from test_torch_chip_smoke_capture import _count_calls, _narrow_capture_config

    from yanerf_tpu_torch.ops.kernels import nerf_mlp_bwd as K3
    from yanerf_tpu_torch.ops.kernels import nerf_mlp_fwd as K1

    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")
    monkeypatch.setattr(chip_smoke, "JPEG_DECODE_REPEATS", 1)
    lines = []
    monkeypatch.setattr(chip_smoke, "say", lambda card_line, phase, **numbers: lines.append((phase, numbers)))
    _count_calls(monkeypatch)
    chip_smoke.jpeg_decode_phase("cpu")
    rates = {n["capture"]: n for phase, n in lines if phase == "jpeg decode" and "capture" in n}
    assert sorted(rates) == ["arith", "baseline", "progressive"]
    assert all(r["decode_digests"] and r["batch_digests"] for r in rates.values())
    ratios = [n["over_baseline"] for phase, n in lines if "over_baseline" in n]
    assert len(ratios) == 1 and sorted(ratios[0]) == ["arith", "progressive"]
    chip_smoke.jpeg_kinds_phase("cpu")
    kinds = [n for phase, n in lines if phase == "jpeg kinds"]
    assert kinds[0]["files"] == 35 and kinds[0]["checks"] == {"every_file_as_digested": True}
    configs = tuple(_narrow_capture_config(c, tmp_path / c) for c in ("fern.yml", "real_360.yml"))
    paths = chip_smoke.jpeg_capture_phases(torch, K1, K3, "cpu", tmp_path, configs, factor=36, steps=20,
                                           capture=chip_smoke.JPEG_ARITH_CAPTURE, family=False, frame_too=False)
    assert paths == {"fern_jpeg_arith_train_fused": {"nerf_mlp_fwd": 40, "nerf_mlp_fwd_pipelined": 0,
                                                     "nerf_mlp_bwd": 40}}
    assert (tmp_path / "llff_jpeg_arith" / "images_36").is_dir()


def test_a_jpeg_kinds_file_off_its_digest_fails_the_phase(tmp_path):
    """The phase's comparison is real: a kinds directory whose one file differs from its digest fails."""
    import chip_smoke

    kinds = shutil.copytree(chip_smoke.JPEG_KINDS, tmp_path / "kinds")
    shutil.copy(kinds / "arith_444.jpg", kinds / "arith_422.jpg")
    results = chip_smoke.jpeg_kinds_results(kinds)
    assert results["arith_422.jpg"] == {"load_image": False, "load_image_u8": False}
    assert all(all(row.values()) for name, row in results.items() if name != "arith_422.jpg")
    with pytest.raises(SystemExit, match="jpeg kinds phase failed"):
        chip_smoke.jpeg_kinds_phase("cpu", kinds)
