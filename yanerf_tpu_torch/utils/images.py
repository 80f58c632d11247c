"""PNG decoding, PNG and GIF encoding and an area resize, with zlib and numpy alone.

The port depends on no imaging package: a PNG is zlib-compressed filtered
scanlines, a GIF is LZW over a fixed 3-3-2 palette. ``decode_png`` reads
8- and 16-bit grey, grey+alpha, RGB, RGBA and palette images with any of
the five scanline filters (not interlaced), and returns RGB with the alpha
dropped and grey repeated, as ``yanerf_tpu``'s loader does
(``native/src/image_io.cpp``: no compositing; 16-bit keeps the high byte).
JPEGs go through the port's own decoder (``yanerf_tpu_torch/native``);
``load_image_u8`` / ``load_image`` read either format, told apart by the
file's first bytes. ``image_shape`` reads the size from the PNG header or
the JPEG frame header alone, optionally turned by the JPEG's EXIF
orientation as ``cv2.imread(path)`` returns it. ``resize_area`` is
OpenCV's ``INTER_AREA`` downscale, byte for byte; ``resize_linear`` its
``INTER_LINEAR`` resize of float32 images.
"""

from __future__ import annotations

import math
import struct
import zlib
from pathlib import Path
from typing import List, Tuple, Union

import numpy as np

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def to_img(tensor_img) -> np.ndarray:
    """Float image in [0, 1] -> uint8 (a trailing single channel is dropped)."""
    arr = np.asarray(tensor_img)
    if arr.ndim == 3 and arr.shape[-1] == 1:
        arr = arr[..., 0]
    return np.clip(arr * 255.0, 0, 255).astype(np.uint8)


def _chunk(tag: bytes, data: bytes) -> bytes:
    return struct.pack(">I", len(data)) + tag + data + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)


def png_bytes(img: np.ndarray) -> bytes:
    """Encode an ``(H, W)`` grey or ``(H, W, 3)`` RGB uint8 image as PNG."""
    img = np.ascontiguousarray(img, dtype=np.uint8)
    if img.ndim not in (2, 3) or (img.ndim == 3 and img.shape[2] != 3):
        raise ValueError(f"expected (H, W) or (H, W, 3), got {img.shape}")
    h, w = img.shape[:2]
    rows = img.reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1).tobytes()
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2 if img.ndim == 3 else 0, 0, 0, 0)
    return _PNG_SIGNATURE + _chunk(b"IHDR", ihdr) + _chunk(b"IDAT", zlib.compress(raw, 6)) + _chunk(b"IEND", b"")


_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}  # PNG colour type -> samples per pixel


def _paeth(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter(ftypes: np.ndarray, filt: np.ndarray) -> np.ndarray:
    """Undo the scanline filters: ``filt`` is ``(H, W, bytes per pixel)``, ``ftypes`` ``(H,)``."""
    if ftypes.max(initial=0) > 4:
        raise ValueError(f"unknown PNG filter type {int(ftypes.max())}")
    h, w, bpp = filt.shape
    f = filt.astype(np.int64)
    if ftypes.max(initial=0) <= 2:  # None, Sub, Up: one vectorized step per row
        out = np.zeros((h + 1, w, bpp), np.int64)
        for r in range(h):
            t = ftypes[r]
            out[r + 1] = f[r] if t == 0 else np.cumsum(f[r], axis=0) if t == 1 else f[r] + out[r]
            out[r + 1] &= 255
        return out[1:].astype(np.uint8)
    # Average and Paeth depend on the left, upper and upper-left pixels:
    # decode one anti-diagonal (r + x = d) at a time, all rows at once
    out = np.zeros((h + 1, w + 1, bpp), np.int64)  # a zero row above and a zero column left
    for d in range(h + w - 1):
        r = np.arange(max(0, d - w + 1), min(h - 1, d) + 1)
        x = d - r
        a, b, c = out[r + 1, x], out[r, x + 1], out[r, x]
        t = ftypes[r][:, None]
        pred = np.select([t == 1, t == 2, t == 3, t == 4], [a, b, (a + b) >> 1, _paeth(a, b, c)], 0)
        out[r + 1, x + 1] = (f[r, x] + pred) & 255
    return out[1:, 1:].astype(np.uint8)


def decode_png(data: bytes) -> np.ndarray:
    """Decode PNG bytes to an ``(H, W, 3)`` uint8 RGB image (alpha dropped, grey repeated)."""
    if data[:8] != _PNG_SIGNATURE:
        raise ValueError("not a PNG file")
    pos, idat, palette, header = 8, [], None, None
    while pos + 8 <= len(data):
        length, tag = struct.unpack(">I4s", data[pos : pos + 8])
        body = data[pos + 8 : pos + 8 + length]
        pos += 12 + length
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif tag == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    if header is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, ctype, _, _, interlace = header
    if interlace or ctype not in _CHANNELS or depth not in (8, 16) or (ctype == 3 and depth != 8):
        raise NotImplementedError(f"PNG colour type {ctype}, bit depth {depth}, interlace {interlace}")
    channels = _CHANNELS[ctype]
    bpp = channels * depth // 8
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)[: h * (1 + w * bpp)].reshape(h, 1 + w * bpp)
    px = _unfilter(raw[:, 0], raw[:, 1:].reshape(h, w, bpp))
    if depth == 16:
        px = px.reshape(h, w, channels, 2)[..., 0]  # big-endian samples: keep the high byte
    if ctype == 3:
        return palette[px[..., 0]]
    if ctype in (0, 4):
        return np.repeat(px[..., :1], 3, axis=-1)
    return np.ascontiguousarray(px[..., :3])


def png_header_shape(path: Union[str, Path]) -> Tuple[int, int, int]:
    """``(H, W, 3)`` of a PNG file, from its IHDR chunk."""
    with open(path, "rb") as fp:
        data = fp.read(24)
    if data[:8] != _PNG_SIGNATURE or data[12:16] != b"IHDR":
        raise ValueError(f"{path}: not a PNG file")
    w, h = struct.unpack(">II", data[16:24])
    return h, w, 3


def image_shape(path: Union[str, Path], exif_orientation: bool = False) -> Tuple[int, int, int]:
    """``(H, W, 3)`` of a PNG or JPEG file from its header: the shape ``load_image`` returns.

    With ``exif_orientation`` a JPEG whose EXIF orientation is 5-8 (a
    quarter turn) gives ``(W, H, 3)``, the shape ``cv2.imread(path)``
    (``IMREAD_COLOR``, which applies the tag) returns.
    """
    from .. import native

    if native.image_format(path) == "png":
        return png_header_shape(path)
    h, w, _, orientation = native.jpeg_info(path)
    if exif_orientation and orientation >= 5:
        h, w = w, h
    return h, w, 3


def load_image_u8(path: Union[str, Path]) -> np.ndarray:
    """A PNG or JPEG file as uint8 RGB, ``(H, W, 3)`` (no EXIF rotation, as ``cv2.IMREAD_UNCHANGED``)."""
    from .. import native

    return native.decode_image_u8(path)


def load_image(path: Union[str, Path]) -> np.ndarray:
    """A PNG or JPEG file as float32 RGB in [0, 1], ``(H, W, 3)``."""
    return load_image_u8(path).astype(np.float32) / np.float32(255.0)


def _area_taps(ssize: int, dsize: int) -> Tuple[np.ndarray, np.ndarray]:
    """OpenCV's area table (``computeResizeAreaTab``): per output pixel its source pixels and float32 weights,
    in OpenCV's order, zero weights padding the rows to one length."""
    scale = ssize / dsize
    rows = []
    for dx in range(dsize):
        fsx1 = dx * scale
        fsx2 = fsx1 + scale
        cell = min(scale, ssize - fsx1)
        sx2 = min(math.floor(fsx2), ssize - 1)
        sx1 = min(math.ceil(fsx1), sx2)
        taps = []
        if sx1 - fsx1 > 1e-3:
            taps.append((sx1 - 1, (sx1 - fsx1) / cell))
        taps.extend((sx, 1.0 / cell) for sx in range(sx1, sx2))
        if fsx2 - sx2 > 1e-3:
            taps.append((sx2, min(min(fsx2 - sx2, 1.0), cell) / cell))
        rows.append(taps)
    width = max(len(taps) for taps in rows)
    index, weight = np.zeros((dsize, width), np.int64), np.zeros((dsize, width), np.float32)
    for d, taps in enumerate(rows):
        index[d, : len(taps)] = [t[0] for t in taps]
        weight[d, : len(taps)] = [t[1] for t in taps]
    return index, weight


def resize_area(img: np.ndarray, dsize: Tuple[int, int]) -> np.ndarray:
    """Downscale a uint8 ``(H, W[, C])`` image to ``dsize = (width, height)`` as ``cv2.INTER_AREA`` does.

    Integer factors take OpenCV's fast path: the box sum, rounded half up
    for 2x2 (``(s + 2) >> 2``), else ``float32(s) * float32(1 / area)``
    rounded half to even. Other sizes take its general path: per output
    pixel the covered source pixels with fractional float32 weights, summed
    in OpenCV's order (along x, then along y), rounded half to even.
    """
    h, w = img.shape[:2]
    dw, dh = dsize
    if dw > w or dh > h:
        raise ValueError(f"resize_area downscales only: {w}x{h} -> {dw}x{dh}")
    fx, fy = w / dw, h / dh
    if fx == int(fx) and fy == int(fy):
        fx, fy = int(fx), int(fy)
        sums = img.reshape(dh, fy, dw, fx, *img.shape[2:]).astype(np.int64).sum(axis=(1, 3))
        if fx == fy == 2:
            return ((sums + 2) >> 2).astype(np.uint8)
        return np.clip(np.rint(sums.astype(np.float32) * np.float32(1.0 / (fx * fy))), 0, 255).astype(np.uint8)
    src = img.astype(np.float32)
    trail = (1,) * (img.ndim - 2)
    x_index, x_weight = _area_taps(w, dw)
    rows = np.zeros((h, dw, *img.shape[2:]), np.float32)
    for j in range(x_index.shape[1]):
        rows = rows + src[:, x_index[:, j]] * x_weight[:, j].reshape(1, dw, *trail)
    y_index, y_weight = _area_taps(h, dh)
    out = y_weight[:, 0].reshape(dh, 1, *trail) * rows[y_index[:, 0]]
    for j in range(1, y_index.shape[1]):
        out = out + y_weight[:, j].reshape(dh, 1, *trail) * rows[y_index[:, j]]
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)


def _linear_taps(ssize: int, dsize: int) -> Tuple[np.ndarray, np.ndarray]:
    """OpenCV's linear table: per output pixel the first source pixel (unclamped) and the float32 weight of the
    next, from the pixel centres ``(d + 0.5) * scale - 0.5``, in double."""
    scale = 1.0 / (dsize / ssize)
    f = (np.arange(dsize) + 0.5) * scale - 0.5
    s = np.floor(f)
    return s.astype(np.int64), (f - s).astype(np.float32)


def resize_linear(img: np.ndarray, dsize: Tuple[int, int]) -> np.ndarray:
    """Resize a float ``(H, W[, C])`` image to ``dsize = (width, height)`` as ``cv2.INTER_LINEAR`` does, in float32.

    Per output pixel the two nearest source pixels along x, then along y,
    weighted by the distance of the pixel centres; along x a tap left of
    the first or right of the last source pixel takes that pixel alone,
    along y the rows are clamped to the image (OpenCV's table and border).
    An exact 2x downscale is OpenCV's area average, as ``cv2.resize``
    switches to it there.
    """
    src = np.asarray(img, dtype=np.float32)
    h, w = src.shape[:2]
    dw, dh = dsize
    if (dw, dh) == (w, h):
        return src.copy()
    if (w, h) == (2 * dw, 2 * dh):
        return src.reshape(dh, 2, dw, 2, *src.shape[2:]).sum(axis=(1, 3), dtype=np.float32) * np.float32(0.25)
    trail = (1,) * (src.ndim - 2)
    sx, fx = _linear_taps(w, dw)
    edge = (sx < 0) | (sx >= w - 1)
    fx[edge] = 0.0
    sx = np.clip(sx, 0, w - 1)
    ax0, ax1 = (np.float32(1.0) - fx).reshape(1, dw, *trail), fx.reshape(1, dw, *trail)
    rows = src[:, sx] * ax0 + src[:, np.minimum(sx + 1, w - 1)] * ax1
    sy, fy = _linear_taps(h, dh)
    ay0, ay1 = (np.float32(1.0) - fy).reshape(dh, 1, *trail), fy.reshape(dh, 1, *trail)
    return rows[np.clip(sy, 0, h - 1)] * ay0 + rows[np.clip(sy + 1, 0, h - 1)] * ay1


def _palette_332() -> bytes:
    i = np.arange(256)
    pal = np.stack([((i >> 5) & 7) * 255 // 7, ((i >> 2) & 7) * 255 // 7, (i & 3) * 255 // 3], axis=1)
    return pal.astype(np.uint8).tobytes()


def _lzw(indices: bytes, min_code_size: int = 8) -> bytes:
    clear, eoi = 1 << min_code_size, (1 << min_code_size) + 1
    out = bytearray()
    bits = nbits = 0
    code_size = min_code_size + 1

    def emit(code: int) -> None:
        nonlocal bits, nbits
        bits |= code << nbits
        nbits += code_size
        while nbits >= 8:
            out.append(bits & 0xFF)
            bits >>= 8
            nbits -= 8

    table = {bytes([i]): i for i in range(clear)}
    next_code = eoi + 1
    emit(clear)
    w = b""
    for ch in indices:
        wc = w + bytes([ch])
        if wc in table:
            w = wc
            continue
        emit(table[w])
        if next_code < 4096:
            table[wc] = next_code
            if next_code == (1 << code_size) and code_size < 12:
                code_size += 1
            next_code += 1
        else:
            emit(clear)
            table = {bytes([i]): i for i in range(clear)}
            next_code = eoi + 1
            code_size = min_code_size + 1
        w = bytes([ch])
    if w:
        emit(table[w])
    emit(eoi)
    if nbits:
        out.append(bits & 0xFF)
    return bytes(out)


def gif_bytes(frames_u8: List[np.ndarray], fps: float) -> bytes:
    """Encode ``(H, W, 3)`` uint8 frames as a looping animated GIF (3-3-2 palette)."""
    h, w = frames_u8[0].shape[:2]
    delay = int(round(100 / max(fps, 0.1)))
    parts = [
        b"GIF89a",
        struct.pack("<HHBBB", w, h, 0xF7, 0, 0),
        _palette_332(),
        b"\x21\xFF\x0BNETSCAPE2.0\x03\x01\x00\x00\x00",
    ]
    for frame in frames_u8:
        f = frame.astype(np.uint16)
        idx = ((f[..., 0] >> 5) << 5) | ((f[..., 1] >> 5) << 2) | (f[..., 2] >> 6)
        data = _lzw(idx.astype(np.uint8).tobytes())
        parts.append(b"\x21\xF9\x04\x00" + struct.pack("<H", delay) + b"\x00\x00")
        parts.append(b"\x2C" + struct.pack("<HHHHB", 0, 0, w, h, 0) + b"\x08")
        parts.extend(bytes([len(data[i : i + 255])]) + data[i : i + 255] for i in range(0, len(data), 255))
        parts.append(b"\x00")
    parts.append(b"\x3B")
    return b"".join(parts)
