"""Write ``tests/data/llff_jpeg/``: a small LLFF capture of baseline JPEGs, and the JAX package's digests of it.

The procedural forward-facing scene of ``yanerf_tpu_torch/synth_llff.py``
(12 views at 1008x756), each view saved by PIL as a baseline 4:2:0 JPEG at
quality 90 with a restart marker after every MCU row, as phone cameras
write them, plus ``poses_bounds.npy``. With ``--progressive`` the views are
progressive JPEGs instead (PIL's 10-scan script, otherwise the same
settings), as photo apps and exporters re-save captures, into
``tests/data/llff_jpeg_progressive/``. ``digests.json`` holds the sha256 of
what ``yanerf_tpu`` makes of the files: the float32 ``(H, W, 3)`` array of
``yanerf_tpu.native.decode_image`` for every view, and the uint8 RGB array
of each PNG that the JAX ``LLFFDataset._minify`` writes at factor 2
(504x378, the size of ``configs/nerf/fern.yml``). The port's tests and
``chip_smoke.py`` hold the port's decoder and ``_minify`` to these digests.

    JAX_PLATFORMS=cpu python tests/make_llff_jpeg_capture.py [--progressive] [--out_dir DIR]

Needs PIL, cv2 and the JAX package (run it where they are installed).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import shutil
import sys
import tempfile
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
N_VIEWS = 12
HEIGHT, WIDTH = 756, 1008
MINIFY_FACTOR = 2


def sha256(arr: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(arr).tobytes()).hexdigest()


def main(argv=None) -> Path:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--progressive", action="store_true", help="write progressive JPEGs (SOF2)")
    ap.add_argument("--out_dir", default=None,
                    help="default tests/data/llff_jpeg, or tests/data/llff_jpeg_progressive with --progressive")
    args = ap.parse_args(argv)
    default = "llff_jpeg_progressive" if args.progressive else "llff_jpeg"
    out = Path(args.out_dir or REPO / "tests" / "data" / default)
    sys.path.insert(0, str(REPO))
    import cv2
    import jax
    from PIL import Image

    jax.config.update("jax_platforms", "cpu")
    from yanerf_tpu import native
    from yanerf_tpu.datasets.llff import LLFFDataset
    from yanerf_tpu_torch.synth_llff import write_llff_scene
    from yanerf_tpu_torch.utils.images import decode_png

    shutil.rmtree(out, ignore_errors=True)
    (out / "images").mkdir(parents=True)
    with tempfile.TemporaryDirectory() as tmp:
        scene = write_llff_scene(Path(tmp) / "png", height=HEIGHT, width=WIDTH, n_images=N_VIEWS)
        shutil.copy(scene / "poses_bounds.npy", out / "poses_bounds.npy")
        for png in sorted((scene / "images").glob("*.png")):
            rgb = decode_png(png.read_bytes())
            Image.fromarray(rgb).save(out / "images" / f"{png.stem.upper()}.JPG", "JPEG", quality=90, subsampling=2,
                                      restart_marker_rows=1, progressive=args.progressive)

    digests = {"decode": {}, "minify": {}}
    for jpg in sorted((out / "images").iterdir()):
        digests["decode"][jpg.name] = sha256(native.decode_image(str(jpg)))
    with tempfile.TemporaryDirectory() as tmp:
        copy = Path(tmp) / "capture"
        shutil.copytree(out, copy)
        LLFFDataset._minify(str(copy), factors=[MINIFY_FACTOR])
        for png in sorted((copy / f"images_{MINIFY_FACTOR}").iterdir()):
            bgr = cv2.imread(str(png), cv2.IMREAD_UNCHANGED)
            digests["minify"][png.name] = sha256(np.ascontiguousarray(bgr[..., ::-1]))
    digests["minify_dir"] = f"images_{MINIFY_FACTOR}"
    (out / "digests.json").write_text(json.dumps(digests, indent=1, sort_keys=True) + "\n")
    total = sum(p.stat().st_size for p in out.rglob("*") if p.is_file())
    print(f"wrote {out}: {N_VIEWS} views, {total} bytes")
    return out


if __name__ == "__main__":
    main()
