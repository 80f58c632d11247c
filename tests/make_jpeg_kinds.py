"""Write ``tests/data/jpeg_kinds/``: small JPEGs of the kinds PIL cannot write, and what the JAX loaders make of them.

The files (each 160x120 or smaller):

* arithmetic-coded sequential files (SOF9) in grey, 4:4:4, 4:2:2 and
  4:2:0, one with a restart marker every MCU row and one with DAC
  conditioning other than the defaults (``arith_dc_L/U``, ``arith_ac_K``);
* an arithmetic-coded progressive file (SOF10, ``jpeg_simple_progression``),
  the same file cut at a scan boundary, and a SOF9 file cut mid-scan;
* lossless files (SOF3) from the pure-Python writer ``lossless_jpeg`` below,
  for every predictor 1-7 at point transform 0 and 2, in grey and with
  three components named 'R', 'G', 'B', with a restart interval; named 1,
  2, 3 (RGB too: libjpeg-turbo 3.x takes a lossless frame without a JFIF
  or Adobe marker for RGB); with a JFIF marker (YCbCr, which libjpeg-turbo
  refuses to convert in a lossless frame); the first component sampled
  2x2 and 2x1 (the others replicated, no fancy upsampling); and 12- and
  16-bit files;
* four-component files: CMYK with its Adobe marker, YCCK, and CMYK with
  its APP14 segment stripped.

The arithmetic and four-component files come from ``jpeg_kinds_writer.c``,
compiled here with ``gcc ... -ljpeg`` against the system libjpeg(-turbo).
``digests.json`` holds under ``files``, for every file, the sha256 of the
float32 array of ``yanerf_tpu.datasets.utils.load_image`` (the JAX
package's decode, with its PIL fallback: ``load_image`` in the port matches
it) and of the RGB uint8 array of ``cv2.imread(path, cv2.IMREAD_UNCHANGED)``
(what the JAX ``LLFFDataset._minify`` reads: ``load_image_u8`` matches it),
or the name of the exception ``load_image`` raised (``null`` where cv2
returned nothing). Under ``port`` are the two truncated files where the
port follows another libjpeg-turbo build than the JAX call's on this
machine, with both digests and the reason.

    JAX_PLATFORMS=cpu python tests/make_jpeg_kinds.py [--out_dir DIR]

Needs ``jpeglib.h`` and ``-ljpeg`` (libjpeg-turbo's development files),
gcc, PIL, cv2 and the JAX package (run it where they are installed).
"""

from __future__ import annotations

import argparse
import hashlib
import heapq
import json
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
WRITER = Path(__file__).resolve().parent / "jpeg_kinds_writer.c"
HEIGHT, WIDTH = 120, 160


def sha256(arr: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(arr).tobytes()).hexdigest()


def picture(h: int, w: int, seed: int = 0) -> np.ndarray:
    """Smooth gradients plus noise, ``(h, w, 3)`` uint8: every frequency and both chroma channels carry signal."""
    y, x = np.mgrid[:h, :w]
    rgb = np.stack([np.sin(x / 7.0) * 100 + 120, np.cos(y / 5.0) * 90 + 120, (x * 3 + y * 5) % 255], -1)
    rgb = rgb + np.random.RandomState(seed).normal(0, 20, rgb.shape)
    return np.clip(rgb, 0, 255).astype(np.uint8)


def cmyk_picture(h: int, w: int, seed: int = 0) -> np.ndarray:
    """``(h, w, 4)`` uint8 ink amounts: the picture's complement in C, M, Y and a smooth K."""
    rgb = picture(h, w, seed)
    y, x = np.mgrid[:h, :w]
    k = (np.sin(x / 11.0 + y / 13.0) * 60 + 70).astype(np.uint8)
    return np.concatenate([255 - rgb, k[..., None]], -1)


# ------------------------------------------------------------- libjpeg ----

def build_writer(out_dir: Path) -> Path:
    """Compile ``jpeg_kinds_writer.c`` against the system libjpeg into ``out_dir``."""
    exe = Path(out_dir) / "jpeg_kinds_writer"
    subprocess.run(["gcc", "-O2", str(WRITER), "-ljpeg", "-o", str(exe)], check=True)
    return exe


def libjpeg_file(writer: Path, path: Path, pixels: np.ndarray, **options) -> Path:
    """Write ``pixels`` (``(h, w)`` grey, ``(h, w, 3)`` RGB or ``(h, w, 4)`` CMYK) with the writer's options."""
    pixels = np.ascontiguousarray(pixels, np.uint8)
    h, w = pixels.shape[:2]
    nc = 1 if pixels.ndim == 2 else pixels.shape[2]
    raw = Path(str(path) + ".raw")
    raw.write_bytes(pixels.tobytes())
    try:
        subprocess.run([str(writer), str(raw), str(w), str(h), str(nc), str(path),
                        *[f"{k}={int(v)}" for k, v in options.items()]], check=True)
    finally:
        raw.unlink()
    return Path(path)


def scan_starts(data: bytes):
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


def without_segment(data: bytes, marker: int) -> bytes:
    """``data`` without its marker segments of type ``marker`` (up to the first scan)."""
    out, i = bytearray(data[:2]), 2
    while data[i + 1] != 0xDA:
        n = int.from_bytes(data[i + 2:i + 4], "big")
        if data[i + 1] != marker:
            out += data[i:i + 2 + n]
        i += 2 + n
    return bytes(out + data[i:])


# ------------------------------------------------------------ lossless ----

def _predict(psv: int, ra: int, rb: int, rc: int) -> int:
    """T.81 Table H.1's predictors on the reconstructed neighbours (left, above, above-left)."""
    return (0, ra, rb, rc, ra + rb - rc, ra + ((rb - rc) >> 1), rb + ((ra - rc) >> 1), (ra + rb) >> 1)[psv]


def _huffman_lengths(freq):
    """Code lengths (at most 16 bits) for the 17 difference categories, with no all-ones code: a reserved
    dummy symbol takes the last code of the longest length, as libjpeg's jpeg_gen_optimal_table does."""
    weights = [f + 1 for f in freq] + [1]  # every category codable; index 17 is the reserved code point
    heap = [(wt, i, [i]) for i, wt in enumerate(weights)]
    heapq.heapify(heap)
    lengths = [0] * len(weights)
    tie = len(weights)
    while len(heap) > 1:
        w1, _, s1 = heapq.heappop(heap)
        w2, _, s2 = heapq.heappop(heap)
        for s in s1 + s2:
            lengths[s] += 1
        heapq.heappush(heap, (w1 + w2, tie, s1 + s2))
        tie += 1
    if max(lengths) > 16:
        return [5] * 18
    longest = lengths.index(max(lengths))
    lengths[longest], lengths[17] = lengths[17], lengths[longest]  # the dummy among the longest codes
    return lengths


def lossless_jpeg(samples: np.ndarray, psv: int = 1, pt: int = 0, precision: int = 8, ids=(1, 2, 3, 4),
                  restart_rows: int = 0, sampling=(1, 1), jfif: bool = False, adobe=None) -> bytes:
    """A lossless JPEG (SOF3, T.81 Annex H) of ``samples``: ``(h, w)`` grey, ``(h, w, 3)`` or ``(h, w, 4)``
    (CMYK; with ``adobe`` an APP14 segment of that transform), one interleaved
    Huffman-coded scan with predictor ``psv`` (1-7) and point transform ``pt``. ``sampling`` is the first
    component's (h, v) factors (the others keep every ``h``-th column and ``v``-th row of theirs; the image's
    size a multiple of them), ``restart_rows`` puts a restart marker after every that many MCU rows (each
    component's prediction starts over as on its first row), ``jfif`` writes a JFIF APP0 segment. Decoded,
    the file gives ``(samples >> pt) << pt`` where nothing is subsampled."""
    samples = np.asarray(samples)
    h, w = samples.shape[:2]
    nc = 1 if samples.ndim == 2 else samples.shape[2]
    hv = [tuple(sampling)] + [(1, 1)] * (nc - 1) if nc >= 3 else [(1, 1)]
    hmax, vmax = max(f[0] for f in hv), max(f[1] for f in hv)
    assert h % vmax == 0 and w % hmax == 0, "the writer pads no MCU"
    full = samples.reshape(h, w, nc).astype(np.int64) >> pt
    planes = [full[::vmax // fv, ::hmax // fh, c] for c, (fh, fv) in enumerate(hv)]
    initial = 1 << (precision - pt - 1)
    diffs = []
    for c, p in enumerate(planes):
        fv = hv[c][1]
        d = np.zeros_like(p)
        for y in range(p.shape[0]):
            first = y == 0 or (restart_rows and y % (restart_rows * fv) == 0)
            for x in range(p.shape[1]):
                if x == 0:
                    pred = initial if first else p[y - 1, 0]
                elif first:
                    pred = p[y, x - 1]
                else:
                    pred = _predict(psv, p[y, x - 1], p[y - 1, x], p[y - 1, x - 1])
                v = (p[y, x] - pred) & 0xFFFF
                d[y, x] = v - 0x10000 if v >= 0x8000 else v
        diffs.append(d)

    def category(d):
        return np.where(d == -0x8000, 16, np.ceil(np.log2(np.abs(d) + 1)).astype(np.int64))

    freq = sum(np.bincount(category(d).ravel(), minlength=17) for d in diffs)
    lengths = _huffman_lengths(freq.tolist())
    order = sorted(range(18), key=lambda s: (lengths[s], s == 17, s))
    codes, code, prev = {}, 0, lengths[order[0]]
    for s in order:
        code <<= lengths[s] - prev
        prev = lengths[s]
        codes[s] = (code, lengths[s])
        code += 1
    counts = [sum(1 for s in range(17) if lengths[s] == n) for n in range(1, 17)]
    symbols = [s for s in order if s != 17]

    def segment(marker: int, body: bytes) -> bytes:
        return bytes([0xFF, marker]) + (len(body) + 2).to_bytes(2, "big") + body

    cid = [ids[c] for c in range(nc)] if nc >= 3 else [1]
    out = bytearray(b"\xff\xd8")
    if jfif:
        out += segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
    if adobe is not None:
        out += segment(0xEE, b"Adobe\x00\x64\x00\x00\x00\x00" + bytes([adobe]))
    sof = bytes([precision]) + h.to_bytes(2, "big") + w.to_bytes(2, "big") + bytes([nc])
    for c in range(nc):
        sof += bytes([cid[c], hv[c][0] << 4 | hv[c][1], 0])
    out += segment(0xC3, sof)
    out += segment(0xC4, bytes([0x00]) + bytes(counts) + bytes(symbols))
    mcux, mcuy = w // hmax, h // vmax
    if restart_rows:
        out += segment(0xDD, (restart_rows * mcux).to_bytes(2, "big"))
    out += segment(0xDA, bytes([nc]) + b"".join(bytes([cid[c], 0x00]) for c in range(nc)) + bytes([psv, 0, pt]))
    acc = nbits = 0
    data = bytearray()

    def flush_bits(final: bool) -> None:
        nonlocal acc, nbits
        if final and nbits % 8:
            pad = 8 - nbits % 8
            acc, nbits = (acc << pad) | ((1 << pad) - 1), nbits + pad
        while nbits >= 8:
            byte = (acc >> (nbits - 8)) & 0xFF
            data.append(byte)
            if byte == 0xFF:
                data.append(0)
            nbits -= 8
        acc &= (1 << nbits) - 1

    rst = 0
    for my in range(mcuy):
        if restart_rows and my and my % restart_rows == 0:
            flush_bits(True)
            data.extend([0xFF, 0xD0 + rst])
            rst = (rst + 1) % 8
        for mx in range(mcux):
            for c, (fh, fv) in enumerate(hv):
                for y in range(my * fv, my * fv + fv):
                    for x in range(mx * fh, mx * fh + fh):
                        d = int(diffs[c][y, x])
                        s = 16 if d == -0x8000 else abs(d).bit_length()
                        code, n = codes[s]
                        acc, nbits = (acc << n) | code, nbits + n
                        if 0 < s < 16:
                            acc, nbits = (acc << s) | ((d if d > 0 else d + (1 << s) - 1) & ((1 << s) - 1)), nbits + s
            flush_bits(False)
    flush_bits(True)
    out += data + b"\xff\xd9"
    return bytes(out)


# ---------------------------------------------------------------- files ----

def write_files(out: Path, writer: Path) -> list:
    """Every fixture into ``out``; returns their paths."""
    pic = picture(HEIGHT, WIDTH, seed=1)
    files = []

    def lib(name, pixels, **options):
        files.append(libjpeg_file(writer, out / name, pixels, **options))
        return files[-1]

    lib("arith_grey.jpg", pic[..., 1], sampling=444)
    lib("arith_444.jpg", pic, sampling=444, quality=85)
    lib("arith_422.jpg", pic, sampling=422, quality=75)
    lib("arith_420.jpg", pic, sampling=420, quality=95)
    lib("arith_420_restart.jpg", picture(117, 157, seed=2), sampling=420, restart_rows=1)
    lib("arith_dac.jpg", pic, sampling=420, dc_L=2, dc_U=6, ac_K=12)
    prog = lib("arith_progressive.jpg", pic, sampling=420, progressive=True, restart_rows=2)
    data = prog.read_bytes()
    starts = scan_starts(data)
    (out / "arith_progressive_cut.jpg").write_bytes(data[:starts[6]] + b"\xff\xd9")  # DC refinement not yet read
    files.append(out / "arith_progressive_cut.jpg")
    seq = (out / "arith_420.jpg").read_bytes()
    (out / "arith_cut_mid_scan.jpg").write_bytes(seq[:len(seq) * 3 // 5])
    files.append(out / "arith_cut_mid_scan.jpg")

    small = picture(48, 64, seed=3)
    for psv in range(1, 8):
        for pt in (0, 2):
            path = out / f"lossless_rgb_p{psv}_t{pt}.jpg"
            path.write_bytes(lossless_jpeg(small, psv, pt, ids=b"RGB", restart_rows=5 if psv == 4 else 0))
            files.append(path)
    for psv in (1, 6):
        path = out / f"lossless_grey_p{psv}.jpg"
        path.write_bytes(lossless_jpeg(small[..., 0], psv, 1, restart_rows=7))
        files.append(path)
    for name, options in (("lossless_ids_123.jpg", {}), ("lossless_jfif.jpg", dict(jfif=True)),
                          ("lossless_420.jpg", dict(ids=b"RGB", sampling=(2, 2), restart_rows=3)),
                          ("lossless_422.jpg", dict(psv=7, ids=b"RGB", sampling=(2, 1)))):
        (out / name).write_bytes(lossless_jpeg(small, **options))
        files.append(out / name)
    for bits in (12, 16):
        path = out / f"lossless_{bits}bit.jpg"
        path.write_bytes(lossless_jpeg(small[..., 0].astype(np.int64) << (bits - 8), 1, 0, precision=bits))
        files.append(path)

    ink = cmyk_picture(HEIGHT, WIDTH, seed=4)
    lib("cmyk_adobe.jpg", ink, sampling=444, arith=0, quality=80)
    lib("ycck.jpg", ink, sampling=420, arith=0, ycck=True)
    lib("ycck_arith_progressive.jpg", ink, sampling=420, ycck=True, progressive=True)
    stripped = out / "cmyk_no_adobe.jpg"
    stripped.write_bytes(without_segment((out / "cmyk_adobe.jpg").read_bytes(), 0xEE))
    files.append(stripped)
    return files


def _rgb(bgr: np.ndarray) -> np.ndarray:
    return np.repeat(bgr[..., None], 3, -1) if bgr.ndim == 2 else np.ascontiguousarray(bgr[..., ::-1])


def _digest(arr) -> dict:
    return {"sha256": sha256(arr), "shape": list(arr.shape)}


def jax_reads(path: Path) -> dict:
    """What the JAX loaders make of ``path``: ``load_image``'s float32 array and ``cv2.imread``'s RGB uint8
    array (sha256 and shape), or the name of the exception ``load_image`` raised / ``None`` from cv2."""
    import cv2

    from yanerf_tpu.datasets.utils import load_image

    entry = {}
    try:
        entry["load_image"] = _digest(load_image(path))
    except Exception as e:  # noqa: BLE001 -- the refusal is what is recorded
        entry["load_image"] = {"raises": type(e).__name__}
    bgr = cv2.imread(str(path), cv2.IMREAD_UNCHANGED)
    entry["imread"] = None if bgr is None else _digest(_rgb(bgr))
    return entry


def jax_load_image_without_simd(path: Path) -> np.ndarray:
    """``load_image`` in a fresh process with libjpeg-turbo's SIMD off (``JSIMD_FORCENONE=1``): its C IDCT."""
    import os

    code = ("import sys, numpy as np; from yanerf_tpu.datasets.utils import load_image; "
            "np.save(sys.argv[2], load_image(sys.argv[1]))")
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "img.npy"
        env = dict(os.environ, JSIMD_FORCENONE="1", JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO))
        subprocess.run([sys.executable, "-c", code, str(path), str(out)], check=True, env=env)
        return np.load(out)


def port_expectations(out: Path) -> dict:
    """The two files where the port holds to another libjpeg-turbo build than the JAX call's here, and why."""
    import cv2

    cut = out / "arith_progressive_cut.jpg"
    smoothed = _rgb(cv2.imread(str(cut), cv2.IMREAD_UNCHANGED))
    mid = jax_load_image_without_simd(out / "arith_cut_mid_scan.jpg")
    mid_u8 = np.rint(mid * 255.0).astype(np.uint8)
    return {
        cut.name: {
            "load_image": _digest(smoothed.astype(np.float32) / np.float32(255.0)), "imread": _digest(smoothed),
            "why": "cut short, so block-smoothed: the port smooths as libjpeg-turbo 3.x (cv2, PIL); the JAX "
                   "native decoder links the system libjpeg-turbo 2.1.x, whose smoothing differs by 1 level",
        },
        "arith_cut_mid_scan.jpg": {
            "load_image": _digest(mid), "imread": _digest(mid_u8),
            "why": "the zeros fed after the cut decode to coefficients far out of range; the port's IDCT is "
                   "libjpeg-turbo's C one (JSIMD_FORCENONE=1), whose SIMD IDCT overflows 16-bit lanes there",
        },
    }


def main(argv=None) -> Path:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out_dir", default=str(REPO / "tests" / "data" / "jpeg_kinds"))
    args = ap.parse_args(argv)
    out = Path(args.out_dir)
    sys.path.insert(0, str(REPO))
    import jax

    jax.config.update("jax_platforms", "cpu")
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    with tempfile.TemporaryDirectory() as tmp:
        files = write_files(out, build_writer(Path(tmp)))
    digests = {"files": {f.name: jax_reads(f) for f in sorted(files)}, "port": port_expectations(out)}
    (out / "digests.json").write_text(json.dumps(digests, indent=1, sort_keys=True) + "\n")
    total = sum(p.stat().st_size for p in out.iterdir())
    print(f"wrote {out}: {len(files)} files, {total} bytes")
    return out


if __name__ == "__main__":
    main()
