"""The port's JPEG decoder (``yanerf_tpu_torch/native``) against the JAX package's libjpeg decode and OpenCV.

Every file is written by the tests with PIL (or OpenCV, for the sampling
layouts PIL does not write). The port's decode must be ``np.array_equal``
to ``yanerf_tpu.native.decode_image`` and to
``cv2.imread(IMREAD_UNCHANGED)``: libjpeg-turbo's integer IDCT, fancy
upsampling and colour tables, byte for byte. The decoder builds with the
host's g++ wherever the tests run, so none of this skips.
"""

import hashlib
import json
from pathlib import Path

import cv2
import numpy as np
import pytest
from PIL import Image

from yanerf_tpu import native as jax_native
from yanerf_tpu_torch import native
from yanerf_tpu_torch.ops.kernels._build import HostLibrary
from yanerf_tpu_torch.utils.images import image_shape, load_image, load_image_u8, png_bytes

CAPTURE = Path(__file__).resolve().parent / "data" / "llff_jpeg"


def _picture(h, w, seed=0):
    """Smooth gradients plus noise: every DCT frequency and both chroma channels carry signal."""
    y, x = np.mgrid[:h, :w]
    rgb = np.stack([np.sin(x / 7.0) * 100 + 120, np.cos(y / 5.0) * 90 + 120, (x * 3 + y * 5) % 255], -1)
    rgb = rgb + np.random.RandomState(seed).normal(0, 20, rgb.shape)
    return np.clip(rgb, 0, 255).astype(np.uint8)


def _cv2_rgb(path):
    img = cv2.imread(str(path), cv2.IMREAD_UNCHANGED)
    return np.repeat(img[..., None], 3, axis=-1) if img.ndim == 2 else np.ascontiguousarray(img[..., ::-1])


def _assert_decodes_as_libjpeg(path):
    got = native.decode_image(path)
    assert got.dtype == np.float32 and got.shape == (*native.image_dims(path), 3)
    np.testing.assert_array_equal(got, jax_native.decode_image(str(path)))
    np.testing.assert_array_equal(got, _cv2_rgb(path).astype(np.float32) / np.float32(255.0))
    np.testing.assert_array_equal(load_image_u8(path), _cv2_rgb(path))


@pytest.mark.parametrize("hw", [(23, 37), (756, 1008), (17, 33), (1, 1)], ids=lambda hw: f"{hw[1]}x{hw[0]}")
@pytest.mark.parametrize("subsampling", [0, 1, 2], ids=["444", "422", "420"])
def test_pil_jpegs_decode_as_libjpeg(tmp_path, hw, subsampling):
    picture = _picture(*hw, seed=subsampling)
    for quality in (50, 75, 95):
        for restart in (0, 1):
            path = tmp_path / f"q{quality}_r{restart}.jpg"
            extra = {"restart_marker_rows": restart} if restart else {}
            Image.fromarray(picture).save(path, "JPEG", quality=quality, subsampling=subsampling, **extra)
            if restart:
                assert b"\xff\xdd" in path.read_bytes(), "the file carries a restart interval"
            _assert_decodes_as_libjpeg(path)


@pytest.mark.parametrize("hw", [(23, 37), (756, 1008)], ids=lambda hw: f"{hw[1]}x{hw[0]}")
def test_grey_and_other_layouts_decode_as_libjpeg(tmp_path, hw):
    picture = _picture(*hw, seed=7)
    grey = tmp_path / "grey.jpg"
    Image.fromarray(picture[..., 0]).save(grey, "JPEG", quality=80, restart_marker_blocks=5)
    _assert_decodes_as_libjpeg(grey)
    assert native.jpeg_info(grey)[2] == 1
    for name in ("440", "411", "422", "420", "444"):
        path = tmp_path / f"cv_{name}.jpg"
        cv2.imwrite(str(path), picture, [cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                                         getattr(cv2, f"IMWRITE_JPEG_SAMPLING_FACTOR_{name}"),
                                         cv2.IMWRITE_JPEG_QUALITY, 90, cv2.IMWRITE_JPEG_RST_INTERVAL, 3])
        _assert_decodes_as_libjpeg(path)


def test_unsupported_jpegs_raise_naming_the_file(tmp_path):
    """Arithmetic coding and CMYK wait for a later slice; DNL, hierarchical frames and 12-bit samples are refused
    by the JAX package's libjpeg too. (Progressive files decode: tests/test_torch_jpeg_progressive.py.)"""
    picture = _picture(24, 40)
    Image.fromarray(picture).convert("CMYK").save(tmp_path / "cmyk.jpg", "JPEG")
    base = tmp_path / "base.jpg"
    Image.fromarray(picture).save(base, "JPEG")
    data = bytearray(base.read_bytes())
    sof = data.index(b"\xff\xc0")
    arith = bytearray(data)
    arith[sof + 1] = 0xC9  # the frame header of an arithmetic-coded file
    (tmp_path / "arith.jpg").write_bytes(arith)
    twelve = bytearray(data)
    twelve[sof + 4] = 12  # 12-bit samples
    (tmp_path / "twelve.jpg").write_bytes(twelve)
    dnl = bytearray(data)
    dnl[sof + 5:sof + 7] = b"\x00\x00"  # height 0: the height would follow the scan in a DNL marker
    (tmp_path / "dnl.jpg").write_bytes(dnl)
    sof5 = bytearray(data)
    sof5[sof + 1] = 0xC5  # a differential (hierarchical) frame
    (tmp_path / "sof5.jpg").write_bytes(sof5)
    for name, what in (("arith", "SOF9"), ("cmyk", "4 components"), ("twelve", "12-bit"), ("dnl", "height 0 .DNL"),
                       ("sof5", "SOF5")):
        path = tmp_path / f"{name}.jpg"
        with pytest.raises(NotImplementedError, match=f"{name}.jpg.*{what}"):
            native.decode_image(path)
        with pytest.raises(NotImplementedError, match=f"{name}.jpg"):
            native.decode_batch([path])
        if name in ("dnl", "sof5"):  # the JAX package refuses these too
            with pytest.raises(IOError):
                jax_native.decode_image(str(path))
            assert cv2.imread(str(path), cv2.IMREAD_UNCHANGED) is None, name
    with pytest.raises(NotImplementedError, match="arith.jpg.*arithmetic"):
        load_image(tmp_path / "arith.jpg")


def _with_huffman_table(data, tc, th, counts, values):
    """``data`` with Huffman table (class ``tc``, slot ``th``) replaced by the given code lengths and symbols."""
    out, i = bytearray(data[:2]), 2
    while data[i + 1] != 0xDA:  # every marker segment up to the scan
        n = int.from_bytes(data[i + 2:i + 4], "big")
        body = data[i + 4:i + 2 + n]
        if data[i + 1] == 0xC4:
            tables, j = bytearray(), 0
            while j < len(body):
                total = sum(body[j + 1:j + 17])
                if body[j] == (tc << 4 | th):
                    tables += bytes([body[j]]) + bytes(counts + [0] * (16 - len(counts))) + bytes(values)
                else:
                    tables += body[j:j + 17 + total]
                j += 17 + total
            body = bytes(tables)
        out += data[i:i + 2] + (len(body) + 2).to_bytes(2, "big") + body
        i += 2 + n
    return bytes(out + data[i:])


def test_bad_huffman_tables_raise_as_libjpeg_refuses_them(tmp_path):
    base = tmp_path / "base.jpg"
    Image.fromarray(_picture(24, 40)).save(base, "JPEG", quality=85)
    data = base.read_bytes()
    dc_counts, dc_values = [0, 1, 5, 1, 1, 1, 1, 1, 1], list(range(12))  # the standard luminance DC table
    same = tmp_path / "same.jpg"
    same.write_bytes(_with_huffman_table(data, 0, 0, dc_counts, dc_values))
    _assert_decodes_as_libjpeg(same)  # the rewrite itself keeps the file as it was
    cases = {
        "three_one_bit": (0, [3], [0, 1, 2]),  # over-subscribed: three codes of one bit
        "all_ones": (0, [2], [0, 1]),  # the code "1" is all ones
        "ac_255_one_bit": (1, [255], list(range(255))),  # would write far past a 9-bit lookup
        "dc_symbol_16": (0, dc_counts, dc_values[:11] + [16]),  # a DC magnitude category above 15
        "dc_symbol_255": (0, dc_counts, [255] + dc_values[1:]),
    }
    for name, (tc, counts, values) in cases.items():
        path = tmp_path / f"{name}.jpg"
        path.write_bytes(_with_huffman_table(data, tc, 0, counts, values))
        with pytest.raises(IOError, match=f"{name}.jpg.*bad Huffman table"):
            native.decode_image(path)
        with pytest.raises(IOError, match=f"{name}.jpg"):
            native.decode_batch([path])
        with pytest.raises(IOError):
            jax_native.decode_image(str(path))
        assert cv2.imread(str(path), cv2.IMREAD_UNCHANGED) is None, name


def test_decode_batch_equals_decode_image(tmp_path):
    paths = []
    for i in range(5):
        path = tmp_path / f"v{i}.JPG"
        Image.fromarray(_picture(30, 44, seed=i)).save(path, "JPEG", quality=85, restart_marker_blocks=2)
        paths.append(path)
    png = tmp_path / "v5.png"
    png.write_bytes(png_bytes(_picture(30, 44, seed=5)))
    paths.append(png)
    for n_threads in (0, 1, 3):
        batch = native.decode_batch(paths, n_threads)
        assert batch.shape == (6, 30, 44, 3) and batch.dtype == np.float32
        for i, path in enumerate(paths):
            np.testing.assert_array_equal(batch[i], native.decode_image(path))
    np.testing.assert_array_equal(native.decode_batch(paths[:5]), jax_native.decode_batch([str(p) for p in paths[:5]]))
    Image.fromarray(_picture(31, 44)).save(tmp_path / "odd.jpg", "JPEG")
    with pytest.raises(IOError, match="odd.jpg.*expected 44x30"):
        native.decode_batch(paths[:2] + [tmp_path / "odd.jpg"])
    with pytest.raises(ValueError, match="empty"):
        native.decode_batch([])


def test_exif_orientation_turns_the_shape_as_cv2_imread(tmp_path):
    picture = _picture(30, 50)
    for orientation in (1, 3, 6, 8):
        path = tmp_path / f"o{orientation}.jpg"
        exif = Image.Exif()
        exif[0x0112] = orientation
        Image.fromarray(picture).save(path, "JPEG", quality=90, exif=exif.tobytes())
        assert native.jpeg_info(path)[3] == orientation
        assert image_shape(path, exif_orientation=True) == cv2.imread(str(path)).shape
        assert image_shape(path) == (30, 50, 3) == cv2.imread(str(path), cv2.IMREAD_UNCHANGED).shape
        _assert_decodes_as_libjpeg(path)  # the pixels are decoded unturned, as libjpeg and IMREAD_UNCHANGED


def test_a_build_error_raises_with_the_compilers_report(tmp_path):
    broken = tmp_path / "broken.cpp"
    broken.write_text('extern "C" int f() { return not_declared_anywhere; }\n')
    library = HostLibrary(broken, lambda lib: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed on broken.cpp(.|\n)*not_declared_anywhere"):
        library.library()
    assert native.available()
    assert native.LIBRARY.path().parent.name == "_build"


def test_the_committed_capture_decodes_to_the_jax_digests():
    digests = json.loads((CAPTURE / "digests.json").read_text())
    files = sorted((CAPTURE / "images").iterdir())
    assert [f.name for f in files] == sorted(digests["decode"]) and len(files) == 12
    assert sum(f.stat().st_size for f in CAPTURE.rglob("*") if f.is_file()) < 1_000_000
    batch = native.decode_batch(files)
    for f, img in zip(files, batch):
        assert hashlib.sha256(img.tobytes()).hexdigest() == digests["decode"][f.name], f.name
        np.testing.assert_array_equal(img, jax_native.decode_image(str(f)))
    data = files[0].read_bytes()
    assert data.count(b"\xff\xdd") == 1 and sum(data.count(bytes([0xFF, 0xD0 + i])) for i in range(8)) > 40
    assert native.jpeg_info(files[0]) == (756, 1008, 3, 1)
