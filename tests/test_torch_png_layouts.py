"""``utils/images.py::decode_png`` on every PNG layout libpng reads, against libpng and PIL.

Grey at 1, 2 and 4 bits expands to 0-255 and palette images at 1, 2 and 4
bits look their indices up, as ``yanerf_tpu``'s loader asks libpng to
(``png_set_expand_gray_1_2_4_to_8``, ``png_set_palette_to_rgb``);
Adam7-interlaced images of every colour type are de-interlaced, also at
sizes that leave some of the seven passes empty (1x1, 3x5). PIL writes no
Adam7 file, so the tests write every PNG here with a small zlib encoder of
their own: pixels packed from the high bits down, each scanline (of the
image, or of each pass) filtered by a filter type that cycles through the
five. Each decode is ``np.array_equal`` to ``yanerf_tpu.native.decode_image``
(libpng) and to PIL.
"""

import io
import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from yanerf_tpu import native as jax_native
from yanerf_tpu_torch import native
from yanerf_tpu_torch.utils.images import decode_png

ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else b if pb <= pc else c


def _scanlines(samples: np.ndarray, depth: int, first_filter: int) -> bytes:
    """``samples`` ``(h, w, c)`` as filtered scanlines; row ``r`` takes filter type ``(first_filter + r) % 5``."""
    h, w, c = samples.shape
    if depth == 16:
        rows = samples.astype(">u2").reshape(h, -1).view(np.uint8).reshape(h, -1)
    elif depth == 8:
        rows = samples.astype(np.uint8).reshape(h, -1)
    else:  # one channel, packed from the high bits down, the last byte padded with zeros
        per_byte = 8 // depth
        padded = np.zeros((h, -(-w // per_byte) * per_byte), np.uint8)
        padded[:, :w] = samples[..., 0]
        groups = padded.reshape(h, -1, per_byte)
        rows = np.zeros(groups.shape[:2], np.uint8)
        for i in range(per_byte):
            rows |= groups[..., i] << np.uint8(8 - depth * (i + 1))
    bpp = max(1, c * depth // 8)
    out, prev = bytearray(), bytes(rows.shape[1])
    for r in range(h):
        row, ftype = rows[r].tobytes(), (first_filter + r) % 5
        out.append(ftype)
        for i, x in enumerate(row):
            a = row[i - bpp] if i >= bpp else 0
            b, cc = prev[i], (prev[i - bpp] if i >= bpp else 0)
            out.append((x - (0, a, b, (a + b) // 2, _paeth(a, b, cc))[ftype]) & 255)
        prev = row
    return bytes(out)


def _png(samples: np.ndarray, color_type: int, depth: int, interlace: bool, palette=None, trns=None) -> bytes:
    h, w = samples.shape[:2]
    if interlace:
        body = b"".join(_scanlines(samples[y0::dy, x0::dx], depth, i) for i, (x0, y0, dx, dy) in enumerate(ADAM7)
                        if samples[y0::dy, x0::dx].size)  # an empty pass writes nothing
    else:
        body = _scanlines(samples, depth, 0)

    def chunk(tag, data):
        return struct.pack(">I", len(data)) + tag + data + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)

    out = b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color_type, 0, 0, int(interlace)))
    if palette is not None:
        out += chunk(b"PLTE", palette.tobytes())
    if trns is not None:
        out += chunk(b"tRNS", trns)
    return out + chunk(b"IDAT", zlib.compress(body)) + chunk(b"IEND", b"")


def _pil_rgb(data: bytes) -> np.ndarray:
    img = Image.open(io.BytesIO(data))
    if img.mode in ("I", "I;16", "I;16B"):  # 16-bit grey: the high byte
        return np.repeat((np.asarray(img).astype(np.uint32) >> 8).astype(np.uint8)[..., None], 3, axis=-1)
    return np.asarray(img.convert("RGB"))


def _assert_decodes_as_libpng(tmp_path, name: str, data: bytes, expected: np.ndarray) -> None:
    path = tmp_path / f"{name}.png"
    path.write_bytes(data)
    got = decode_png(data)
    assert got.dtype == np.uint8 and got.shape == expected.shape
    np.testing.assert_array_equal(got, expected)
    np.testing.assert_array_equal(native.decode_image(path), jax_native.decode_image(str(path)))
    np.testing.assert_array_equal(got, _pil_rgb(data))


@pytest.mark.parametrize("interlace", [False, True], ids=["plain", "adam7"])
@pytest.mark.parametrize("depth", [1, 2, 4])
def test_grey_and_palette_below_8_bits(tmp_path, depth, interlace):
    rng = np.random.RandomState(depth)
    for h, w in ((9, 13), (1, 1), (3, 5), (8, 17)):
        values = rng.randint(0, 1 << depth, size=(h, w, 1)).astype(np.uint8)
        grey = np.repeat(values * np.uint8(255 // ((1 << depth) - 1)), 3, axis=-1)
        _assert_decodes_as_libpng(tmp_path, f"grey{depth}_{w}x{h}", _png(values, 0, depth, interlace), grey)
        palette = rng.randint(0, 256, size=(1 << depth, 3)).astype(np.uint8)
        data = _png(values, 3, depth, interlace, palette=palette, trns=bytes([0, 128]))
        _assert_decodes_as_libpng(tmp_path, f"palette{depth}_{w}x{h}", data, palette[values[..., 0]])


@pytest.mark.parametrize("hw", [(1, 1), (3, 5), (9, 13), (16, 16)], ids=lambda hw: f"{hw[1]}x{hw[0]}")
def test_adam7_of_every_colour_type(tmp_path, hw):
    rng = np.random.RandomState(hw[0] * 100 + hw[1])
    for color_type, depth in ((2, 8), (6, 8), (0, 8), (4, 8), (3, 8), (2, 16), (0, 16), (6, 16)):
        channels = CHANNELS[color_type]
        if depth == 16:
            samples = rng.randint(0, 65536, size=(*hw, channels)).astype(np.uint16)
            high = (samples >> 8).astype(np.uint8)
        else:
            samples = high = rng.randint(0, 256, size=(*hw, channels)).astype(np.uint8)
        palette = rng.randint(0, 256, size=(256, 3)).astype(np.uint8) if color_type == 3 else None
        if color_type == 3:
            expected = palette[high[..., 0]]
        elif channels <= 2:
            expected = np.repeat(high[..., :1], 3, axis=-1)
        else:
            expected = high[..., :3]
        for interlace in (True, False):
            data = _png(samples, color_type, depth, interlace, palette=palette)
            _assert_decodes_as_libpng(tmp_path, f"t{color_type}_{depth}_{int(interlace)}", data, expected)
            if interlace and hw == (3, 5):
                assert data[28] == 1 and decode_png(data).shape == (3, 5, 3)


def test_invalid_layouts_raise():
    data = _png(np.zeros((2, 2, 3), np.uint8), 2, 8, False)
    bad_depth = data[:24] + bytes([4]) + data[25:]  # RGB at 4 bits is no PNG layout
    with pytest.raises(ValueError, match="colour type 2, bit depth 4"):
        decode_png(bad_depth)
    with pytest.raises(ValueError, match="without PLTE"):
        decode_png(_png(np.zeros((2, 2, 1), np.uint8), 3, 8, False))
