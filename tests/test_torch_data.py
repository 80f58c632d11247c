"""The port's data path against PIL and yanerf_tpu, on the CPU.

  * ``decode_png`` (zlib + numpy) against PIL on PNGs written row by row
    with each of the five scanline filters, for grey, grey+alpha, RGB, RGBA,
    palette and 16-bit images: the same bytes (alpha dropped, grey
    repeated, 16-bit samples cut to their high byte), as the JAX package's
    loader returns them;
  * ``BlenderDataset`` against the JAX package's on a written scene: the
    same poses, focal and images, bit for bit;
  * ``DeviceCachedLoader`` with ``quantize_images``: the uint8 cache
    decodes to exactly the float32 images the loader gives, and to what the
    JAX package's cache decodes.
"""

import io
import struct
import zlib

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from yanerf_tpu.datasets import blender as jax_blender
from yanerf_tpu.datasets import loader as jax_loader
from yanerf_tpu_torch.datasets import (
    BlenderDataset,
    DataLoader,
    DeviceCachedLoader,
    ShardedEpochSampler,
    decode_cached_field,
    stack_batch,
)
from yanerf_tpu_torch.synth_scene import write_scene
from yanerf_tpu_torch.utils.images import decode_png, png_bytes

COLOR_TYPES = {"L": 0, "RGB": 2, "P": 3, "LA": 4, "RGBA": 6}


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else b if pb <= pc else c


def _filter_row(ftype: int, row: bytes, prev: bytes, bpp: int) -> bytes:
    out = bytearray()
    for i, x in enumerate(row):
        a = row[i - bpp] if i >= bpp else 0
        b = prev[i]
        c = prev[i - bpp] if i >= bpp else 0
        pred = (0, a, b, (a + b) // 2, _paeth(a, b, c))[ftype]
        out.append((x - pred) & 255)
    return bytes(out)


def _encode(samples: np.ndarray, color_type: int, filters, depth: int = 8, palette=None) -> bytes:
    """A PNG of ``samples`` ``(H, W, C)`` with row ``r`` filtered by ``filters[r % len(filters)]``."""
    h, w, c = samples.shape
    raw_rows = samples.astype(">u2" if depth == 16 else np.uint8).reshape(h, -1).view(np.uint8).reshape(h, -1)
    bpp = c * depth // 8
    prev = bytes(raw_rows.shape[1])
    body = bytearray()
    for r in range(h):
        row = raw_rows[r].tobytes()
        ftype = filters[r % len(filters)]
        body += bytes([ftype]) + _filter_row(ftype, row, prev, bpp)
        prev = row

    def chunk(tag, data):
        return struct.pack(">I", len(data)) + tag + data + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)

    ihdr = struct.pack(">IIBBBBB", w, h, depth, color_type, 0, 0, 0)
    out = b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
    if palette is not None:
        out += chunk(b"PLTE", palette.tobytes())
    # two IDAT chunks: the decoder must join them
    z = zlib.compress(bytes(body))
    return out + chunk(b"IDAT", z[: len(z) // 2]) + chunk(b"IDAT", z[len(z) // 2 :]) + chunk(b"IEND", b"")


def _pil_rgb(data: bytes, high_byte: bool = False) -> np.ndarray:
    img = Image.open(io.BytesIO(data))
    img.load()
    arr = np.asarray(img)
    if img.mode == "P":
        arr = np.asarray(img.convert("RGB"))
    if high_byte:
        arr = (arr.astype(np.uint32) >> 8).astype(np.uint8)
    if arr.ndim == 2:
        arr = arr[..., None]
    if arr.shape[-1] in (1, 2):
        return np.repeat(arr[..., :1], 3, axis=-1)
    return arr[..., :3]


@pytest.mark.parametrize("mode", ["RGB", "RGBA", "L", "LA"])
@pytest.mark.parametrize("filters", [(0,), (1,), (2,), (3,), (4,), (0, 1, 2, 3, 4)])
def test_decode_png_matches_pil(mode, filters):
    rng = np.random.RandomState(len(mode) * 10 + len(filters))
    channels = {"L": 1, "LA": 2, "RGB": 3, "RGBA": 4}[mode]
    # a smooth gradient plus noise, so that every filter sees both runs and jumps
    yy, xx = np.mgrid[0:13, 0:17]
    base = (yy * 9 + xx * 5)[..., None] + rng.randint(0, 40, size=(13, 17, channels))
    samples = (base % 256).astype(np.uint8)
    data = _encode(samples, COLOR_TYPES[mode], filters)
    got = decode_png(data)
    assert got.dtype == np.uint8 and got.shape == (13, 17, 3)
    np.testing.assert_array_equal(got, _pil_rgb(data))


def test_decode_png_palette_and_16_bit_match_pil():
    rng = np.random.RandomState(0)
    palette = rng.randint(0, 256, size=(16, 3)).astype(np.uint8)
    index = rng.randint(0, 16, size=(9, 11, 1)).astype(np.uint8)
    data = _encode(index, 3, (4, 1, 3), palette=palette)
    np.testing.assert_array_equal(decode_png(data), _pil_rgb(data))

    wide = rng.randint(0, 65536, size=(7, 5, 3)).astype(np.uint16)
    data = _encode(wide, 2, (0, 1, 2, 3, 4), depth=16)
    np.testing.assert_array_equal(decode_png(data), (wide >> 8).astype(np.uint8))


def test_png_bytes_round_trips_and_pil_reads_it():
    img = np.random.RandomState(1).randint(0, 256, size=(10, 6, 3)).astype(np.uint8)
    data = png_bytes(img)
    np.testing.assert_array_equal(decode_png(data), img)
    np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(data))), img)
    rgba = np.concatenate([img, np.full((10, 6, 1), 7, np.uint8)], axis=-1)
    buf = io.BytesIO()
    Image.fromarray(rgba, "RGBA").save(buf, format="PNG")
    np.testing.assert_array_equal(decode_png(buf.getvalue()), img)


def test_decode_png_refuses_what_it_does_not_read():
    with pytest.raises(ValueError, match="not a PNG"):
        decode_png(b"GIF89a")
    buf = io.BytesIO()
    Image.fromarray(np.zeros((4, 4, 3), np.uint8)).save(buf, format="PNG", interlace=1)
    data = buf.getvalue()
    np.testing.assert_array_equal(decode_png(data), np.zeros((4, 4, 3), np.uint8))  # Adam7 or not, it reads
    with pytest.raises(ValueError, match="colour type 2, bit depth 4"):  # RGB at 4 bits is no PNG layout
        decode_png(data[:24] + bytes([4]) + data[25:])


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    return write_scene(tmp_path_factory.mktemp("scene"), hw=12, n_train=3, n_val=4, n_test=2, n_spheres=3, seed=2)


@pytest.mark.parametrize("split,test_skip", [("train", 8), ("val", 2), ("test", 1)])
def test_blender_dataset_matches_jax(scene, split, test_skip):
    ref = jax_blender.BlenderDataset(scene, split, test_skip=test_skip)
    got = BlenderDataset(scene, split, test_skip=test_skip)
    assert len(got) == len(ref) and (got.H, got.W) == (ref.H, ref.W) == (12, 12)
    assert got.focal == ref.focal
    for i in range(len(ref)):
        for a, b in zip(got[i], ref[i]):
            assert a.dtype == b.dtype == np.float32
            np.testing.assert_array_equal(a, b)
    assert got.data_wrapper._fields == ref.data_wrapper._fields


def test_blender_scale_down_is_refused(scene):
    """A factor that is not a number > 0 is refused with the JAX package's TypeError; a valid one resizes
    (tests/test_torch_debug.py holds the resize to the JAX dataset)."""
    for bad in ("2", 0, -1.5, None):
        with pytest.raises(TypeError, match="Invalid scale_down"):
            BlenderDataset(scene, "train", scale_down=bad)
    full, half = BlenderDataset(scene, "train"), BlenderDataset(scene, "train", scale_down=2)
    assert (half.H, half.W) == (full.H // 2, full.W // 2) and half.focal == full.focal / 2
    assert half[0][2].shape == (full.H // 2, full.W // 2, 3) and half[0][2].dtype == np.float32


def test_device_cached_loader_decodes_bit_for_bit(scene):
    dataset = BlenderDataset(scene, "val", test_skip=1)
    sampler = ShardedEpochSampler(len(dataset), shuffle=True, seed=3)
    loader = DataLoader(dataset, sampler, batch_size=2, is_train=True)
    cached = DeviceCachedLoader(loader, "cpu", quantize_images=True)
    sampler.set_epoch(1)
    plain = list(loader)
    got = list(cached)
    assert len(got) == len(plain) == 2
    assert cached._arrays[2].dtype == torch.uint8, "the images are cached as uint8"
    for batch_got, batch_ref in zip(got, plain):
        for a, b in zip(batch_got, batch_ref):
            assert a.dtype == torch.float32
            np.testing.assert_array_equal(a.numpy(), b)

    jax_ds = jax_blender.BlenderDataset(scene, "val", test_skip=1)
    jax_cached = jax_loader.DeviceCachedLoader(
        jax_loader.DataLoader(jax_ds, jax_loader.ShardedEpochSampler(len(jax_ds), shuffle=True, world_size=1, rank=0, seed=3),
                              batch_size=2, is_train=True, num_workers=0),
        quantize_images=True,
    )
    jax_cached.sampler.set_epoch(1)
    for batch_got, batch_ref in zip(got, jax_cached):
        for a, b in zip(batch_got, batch_ref):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))

    u8 = np.arange(256, dtype=np.uint8).reshape(16, 16, 1)
    table = decode_cached_field(torch.from_numpy(u8)).numpy()
    np.testing.assert_array_equal(table, u8.astype(np.float32) / 255.0)
    np.testing.assert_array_equal(table, np.asarray(jax_loader.decode_cached_field(jax.numpy.asarray(u8))))


def test_stack_batch_and_sampler_follow_the_jax_package():
    items = [(np.ones(2, np.float32) * i, 0.5 * i, 3, "a", None) for i in range(3)]
    got, ref = stack_batch(items), jax_loader.stack_batch(items)
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        if isinstance(b, np.ndarray):
            np.testing.assert_array_equal(a, b)
        else:
            assert a == b
    ours = ShardedEpochSampler(10, shuffle=True, seed=4)
    theirs = jax_loader.ShardedEpochSampler(10, shuffle=True, world_size=1, rank=0, seed=4)
    for epoch in (0, 5):
        ours.set_epoch(epoch)
        theirs.set_epoch(epoch)
        np.testing.assert_array_equal(ours.indices(), theirs.indices())
