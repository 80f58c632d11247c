"""Write K procedural Blender-format scenes for latent-conditioned training.

The port's own copy of ``scripts/make_synth_multiscene.py``: scene ``k`` is
an independent draw of ``synth_scene.py``'s spheres from the seed ``seed *
1000 + k``, rendered from one camera stream shared by every scene (seed
``seed + 777``: the viewpoints carry no scene identity, only the content
differs), and written to ``out_dir/scene_{k}/`` in the single-scene layout,
so ``MultiSceneBlenderDataset`` concatenates them and ``BlenderDataset``
reads any one of them.

    python -m yanerf_tpu_torch.synth_multiscene --out_dir /tmp/multiscene --n_scenes 4 --hw 128
"""

from __future__ import annotations

import argparse
import json
import os
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

from .synth_scene import CAMERA_ANGLE_X, look_at_blender, make_scene, render
from .utils.images import png_bytes


def write_multiscene(out_dir, n_scenes: int = 4, hw: int = 128, n_train: int = 30, n_val: int = 4, n_test: int = 4,
                     n_spheres: int = 5, radius: float = 4.0, seed: int = 0, bg: float = 0.9) -> Path:
    """Write ``n_scenes`` scenes under ``out_dir``; returns it.

    The frames are rendered and encoded on a thread pool after every
    camera is drawn in order: the files do not depend on the pool.
    """
    out_root = Path(out_dir)
    focal = 0.5 * hw / np.tan(0.5 * CAMERA_ANGLE_X)
    jobs = []
    for k in range(n_scenes):
        out = out_root / f"scene_{k}"
        out.mkdir(parents=True, exist_ok=True)
        centers, radii, albedos = make_scene(np.random.RandomState(seed * 1000 + k), n_spheres)
        cam_rng = np.random.RandomState(seed + 777)
        for split, count in (("train", n_train), ("val", n_val), ("test", n_test)):
            frames = []
            for i in range(count):
                u = cam_rng.uniform(0, 2 * np.pi)
                elev = cam_rng.uniform(np.deg2rad(15), np.deg2rad(70))
                position = radius * np.array([np.cos(u) * np.cos(elev), np.sin(u) * np.cos(elev), np.sin(elev)])
                c2w = look_at_blender(position, np.array([0.0, 0.0, 0.3]))
                name = f"r_{split}_{i}"
                jobs.append((out / f"{name}.png", c2w, (centers, radii, albedos)))
                frames.append({"file_path": f"./{name}", "transform_matrix": c2w.tolist()})
            (out / f"transforms_{split}.json").write_text(
                json.dumps({"camera_angle_x": CAMERA_ANGLE_X, "frames": frames})
            )

    def write(path: Path, c2w: np.ndarray, scene) -> None:
        img = render(c2w, hw, focal, *scene, bg=bg)
        path.write_bytes(png_bytes((img * 255).astype(np.uint8)))

    with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as pool:
        for done in [pool.submit(write, *job) for job in jobs]:
            done.result()
    return out_root


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out_dir", required=True)
    ap.add_argument("--n_scenes", type=int, default=4)
    ap.add_argument("--hw", type=int, default=128)
    ap.add_argument("--n_train", type=int, default=30)
    ap.add_argument("--n_val", type=int, default=4)
    ap.add_argument("--n_test", type=int, default=4)
    ap.add_argument("--n_spheres", type=int, default=5)
    ap.add_argument("--radius", type=float, default=4.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--bg", type=float, default=0.9,
                    help="background intensity; bright, so that predicting the background everywhere costs a "
                         "conditioned and an unconditioned model alike")
    args = ap.parse_args(argv)
    write_multiscene(args.out_dir, args.n_scenes, args.hw, args.n_train, args.n_val, args.n_test, args.n_spheres,
                     args.radius, args.seed, args.bg)
    for k in range(args.n_scenes):
        print(f"scene_{k}: {args.n_train}/{args.n_val}/{args.n_test} frames @ {args.hw}px")
    print(f"multi-scene dataset written to {args.out_dir}")


if __name__ == "__main__":
    main()
