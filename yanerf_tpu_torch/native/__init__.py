"""Native host image decoding: PNG and JPEG to float32 RGB in [0, 1].

Counterpart of ``yanerf_tpu/native``, with the same functions and
contracts: ``available()``, ``image_dims(path)`` -> ``(H, W)``,
``decode_image(path)`` -> ``(H, W, 3)`` float32 and
``decode_batch(paths, n_threads)`` -> ``(N, H, W, 3)`` for same-sized
images. The format is read from the file's first bytes, not its name.

* JPEG goes through ``src/jpeg.cpp``, a baseline decoder written for the
  port that links no imaging library and reproduces libjpeg-turbo's
  default decode (integer IDCT, fancy upsampling, its YCbCr tables) byte
  for byte. It is built with ``g++ -O3 -shared -fPIC -std=c++17`` at first
  use into ``yanerf_tpu_torch/_build/`` (cached by content) and bound with
  ctypes; ``decode_batch`` decodes on ``std::thread`` s, outside the GIL.
  Progressive, arithmetic-coded, 12-bit and CMYK files raise
  ``NotImplementedError`` naming the file and the frame type.
* PNG goes through the numpy decoder ``utils/images.py::decode_png``; zlib
  releases the GIL, so ``decode_batch`` runs PNGs on a thread pool.

A build failure raises ``RuntimeError`` with the compiler's report; there
is no other decoder to fall back to. ``available()`` says whether the
library builds and loads here.
"""

from __future__ import annotations

import ctypes
import os
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Sequence, Tuple, Union

import numpy as np

from ..ops.kernels._build import HostLibrary

PathLike = Union[str, Path]
_PNG_MAGIC = b"\x89PNG\r\n\x1a\n"
_JPEG_MAGIC = b"\xff\xd8\xff"
_ERR_LEN = 512
_UNSUPPORTED = -5
_ERRORS = {-1: "cannot open", -2: "not a JPEG", -3: "corrupt JPEG data", -4: "size mismatch", -5: "unsupported JPEG"}


def _bind(lib: ctypes.CDLL) -> None:
    c_int_p = ctypes.POINTER(ctypes.c_int)
    lib.yt_jpeg_info.argtypes = [ctypes.c_char_p, c_int_p, c_int_p, c_int_p, c_int_p, ctypes.c_char_p, ctypes.c_int]
    lib.yt_jpeg_info.restype = ctypes.c_int
    lib.yt_jpeg_decode.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int, ctypes.c_char_p, ctypes.c_int,
    ]
    lib.yt_jpeg_decode.restype = ctypes.c_int
    lib.yt_jpeg_decode_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, c_int_p, ctypes.c_char_p, ctypes.c_int,
    ]
    lib.yt_jpeg_decode_batch.restype = ctypes.c_int


LIBRARY = HostLibrary(Path(__file__).resolve().parent / "src" / "jpeg.cpp", _bind)


def available() -> bool:
    """Whether the JPEG library builds (or is cached) and loads on this machine."""
    try:
        LIBRARY.library()
    except (RuntimeError, OSError):
        return False
    return True


def _raise(path: PathLike, rc: int, err: bytes) -> None:
    msg = f"{path}: {err.decode(errors='replace') or _ERRORS.get(rc, 'error')} ({rc})"
    if rc == _UNSUPPORTED:
        raise NotImplementedError(msg)
    raise IOError(msg)


def image_format(path: PathLike) -> str:
    """``"png"`` or ``"jpeg"``, from the file's first bytes."""
    with open(path, "rb") as fp:
        head = fp.read(8)
    if head == _PNG_MAGIC:
        return "png"
    if head[:3] == _JPEG_MAGIC:
        return "jpeg"
    raise IOError(f"{path}: neither a PNG nor a JPEG file")


def jpeg_info(path: PathLike) -> Tuple[int, int, int, int]:
    """``(H, W, components, EXIF orientation)`` of a JPEG, from its headers (orientation 1 when absent)."""
    h, w, nc, orient = (ctypes.c_int() for _ in range(4))
    err = ctypes.create_string_buffer(_ERR_LEN)
    rc = LIBRARY.library().yt_jpeg_info(
        str(path).encode(), ctypes.byref(h), ctypes.byref(w), ctypes.byref(nc), ctypes.byref(orient), err, _ERR_LEN
    )
    if rc != 0:
        _raise(path, rc, err.value)
    return h.value, w.value, nc.value, orient.value


def image_dims(path: PathLike) -> Tuple[int, int]:
    """``(H, W)`` of a PNG or JPEG, from its header."""
    if image_format(path) == "png":
        from ..utils.images import png_header_shape

        return png_header_shape(path)[:2]
    return jpeg_info(path)[:2]


def decode_image_u8(path: PathLike) -> np.ndarray:
    """A PNG or JPEG as uint8 RGB, ``(H, W, 3)`` (alpha dropped, grey repeated; no EXIF rotation)."""
    if image_format(path) == "png":
        from ..utils.images import decode_png

        with open(path, "rb") as fp:
            return decode_png(fp.read())
    h, w = jpeg_info(path)[:2]
    out = np.empty((h, w, 3), np.uint8)
    err = ctypes.create_string_buffer(_ERR_LEN)
    rc = LIBRARY.library().yt_jpeg_decode(
        str(path).encode(), out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), h, w, err, _ERR_LEN
    )
    if rc != 0:
        _raise(path, rc, err.value)
    return out


def decode_image(path: PathLike) -> np.ndarray:
    """A PNG or JPEG as float32 RGB in [0, 1], ``(H, W, 3)``."""
    return decode_image_u8(path).astype(np.float32) / np.float32(255.0)


def decode_batch(paths: Sequence[PathLike], n_threads: int = 0) -> np.ndarray:
    """Decode same-sized images in parallel -> ``(N, H, W, 3)`` float32; JPEGs on C++ threads, PNGs on a pool."""
    if not paths:
        raise ValueError("empty batch")
    n_threads = n_threads if n_threads > 0 else (os.cpu_count() or 1)
    h, w = image_dims(paths[0])
    out = np.empty((len(paths), h, w, 3), np.float32)
    kinds = [image_format(p) for p in paths]
    jpegs = [i for i, k in enumerate(kinds) if k == "jpeg"]
    pngs = [i for i, k in enumerate(kinds) if k == "png"]
    if jpegs:
        buf = np.empty((len(jpegs), h, w, 3), np.float32)
        names = (ctypes.c_char_p * len(jpegs))(*[str(paths[i]).encode() for i in jpegs])
        status = (ctypes.c_int * len(jpegs))()
        err = ctypes.create_string_buffer(_ERR_LEN)
        rc = LIBRARY.library().yt_jpeg_decode_batch(
            names, len(jpegs), buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), h, w, n_threads, status, err, _ERR_LEN
        )
        if rc != 0:
            _raise(paths[jpegs[[s != 0 for s in status].index(True)]], rc, err.value)
        out[jpegs] = buf

    def one_png(i: int) -> None:
        img = decode_image(paths[i])
        if img.shape != (h, w, 3):
            raise IOError(f"{paths[i]}: size {img.shape[1]}x{img.shape[0]}, expected {w}x{h}")
        out[i] = img

    if pngs:
        with ThreadPoolExecutor(max_workers=min(n_threads, len(pngs))) as pool:
            list(pool.map(one_png, pngs))
    return out
