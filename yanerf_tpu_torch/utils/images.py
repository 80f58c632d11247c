"""PNG and GIF encoding with the standard library alone.

The serving path depends on no imaging package: PNG is zlib-compressed
scanlines, GIF is LZW over a fixed 3-3-2 palette.
"""

from __future__ import annotations

import struct
import zlib
from typing import List

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
