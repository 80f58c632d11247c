"""Write a procedural NeRF-synthetic (Blender-format) scene.

The port's own copy of ``scripts/make_synth_scene.py``: Lambertian spheres
ray-traced in numpy from cameras on the upper hemisphere, written as
``transforms_{train,val,test}.json`` plus PNGs (``utils/images.py``), the
layout ``BlenderDataset`` reads. The renderer uses the loader's z/y-flip
calibration and the pinhole unprojection of ``ops/rays.py``, so the images
agree with the rays cast in training.

    python -m yanerf_tpu_torch.synth_scene --out_dir /tmp/synth800 --hw 800 --n_train 100
"""

from __future__ import annotations

import argparse
import json
import os
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

from .utils.images import png_bytes

CAMERA_ANGLE_X = 0.6911112070083618  # the lego intrinsic


def look_at_blender(position: np.ndarray, target: np.ndarray) -> np.ndarray:
    """Camera-to-world in the Blender/OpenGL convention (-z forward, y up)."""
    forward = (target - position) / np.linalg.norm(target - position)
    z_axis = -forward
    x_axis = np.cross(np.array([0.0, 0.0, 1.0]), z_axis)
    n = np.linalg.norm(x_axis)
    x_axis = np.array([1.0, 0.0, 0.0]) if n < 1e-6 else x_axis / n
    y_axis = np.cross(z_axis, x_axis)
    c2w = np.eye(4)
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = x_axis, y_axis, z_axis, position
    return c2w


def make_scene(rng: np.random.RandomState, n_spheres: int = 6):
    """Random shaded spheres inside the unit-ish ball (lego-scale scene)."""
    centers, radii, albedos = [], [], []
    for _ in range(n_spheres):
        centers.append(rng.uniform(-0.8, 0.8, size=3) * np.array([1.0, 1.0, 0.6]) + np.array([0, 0, 0.3]))
        radii.append(rng.uniform(0.18, 0.45))
        albedos.append(rng.uniform(0.25, 1.0, size=3))
    return np.asarray(centers), np.asarray(radii), np.asarray(albedos)


def render(c2w_blender, hw: int, focal: float, centers, radii, albedos, bg: float = 0.0) -> np.ndarray:
    """Trace primary rays against the spheres; two-light Lambertian shading; ``(hw, hw, 3)`` in [0, 1]."""
    pose = c2w_blender @ np.diag([1.0, -1.0, -1.0, 1.0])
    rot, origin = pose[:3, :3], pose[:3, 3]
    ys, xs = np.meshgrid(np.arange(hw, dtype=np.float64), np.arange(hw, dtype=np.float64), indexing="ij")
    dirs = np.stack([(xs - hw * 0.5) / focal, (ys - hw * 0.5) / focal, np.ones_like(xs)], axis=-1) @ rot.T
    dnorm = dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)
    t_best = np.full((hw, hw), np.inf)
    color = np.full((hw, hw, 3), bg)
    lights = [
        (np.array([0.4, 0.3, 0.85]) / np.linalg.norm([0.4, 0.3, 0.85]), 0.9),
        (np.array([-0.6, -0.2, 0.5]) / np.linalg.norm([-0.6, -0.2, 0.5]), 0.45),
    ]
    for c, r, a in zip(centers, radii, albedos):
        oc = origin - c
        b = np.sum(dnorm * oc, axis=-1)
        disc = b * b - (np.dot(oc, oc) - r * r)
        t = -b - np.sqrt(np.maximum(disc, 0.0))
        valid = (disc > 0) & (t > 1e-3) & (t < t_best)
        normal = (origin + t[..., None] * dnorm - c) / r
        shade = np.full((hw, hw), 0.12)  # ambient
        for ldir, lw in lights:
            shade = shade + lw * np.maximum(normal @ ldir, 0.0)
        color = np.where(valid[..., None], np.clip(shade[..., None] * a, 0.0, 1.0), color)
        t_best = np.where(valid, t, t_best)
    return color


def write_scene(out_dir, hw: int = 800, n_train: int = 100, n_val: int = 8, n_test: int = 8, n_spheres: int = 6,
                radius: float = 4.0, seed: int = 0, bg: float = 0.0) -> Path:
    """Write the scene's three splits under ``out_dir``; returns it.

    The cameras are drawn in order from one generator, then the frames are
    rendered and encoded on a thread pool (numpy and zlib release the
    interpreter lock): the files do not depend on the pool.
    """
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    rng = np.random.RandomState(seed)
    centers, radii, albedos = make_scene(rng, n_spheres)
    focal = 0.5 * hw / np.tan(0.5 * CAMERA_ANGLE_X)
    frames = {}
    for split, count in (("train", n_train), ("val", n_val), ("test", n_test)):
        for i in range(count):
            u = rng.uniform(0, 2 * np.pi)
            elev = rng.uniform(np.deg2rad(15), np.deg2rad(70))
            position = radius * np.array([np.cos(u) * np.cos(elev), np.sin(u) * np.cos(elev), np.sin(elev)])
            frames.setdefault(split, []).append((f"r_{split}_{i}", look_at_blender(position, np.array([0.0, 0.0, 0.3]))))

    def write(name: str, c2w: np.ndarray) -> None:
        img = render(c2w, hw, focal, centers, radii, albedos, bg=bg)
        (out / f"{name}.png").write_bytes(png_bytes((img * 255).astype(np.uint8)))

    with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as pool:
        for done in [pool.submit(write, name, c2w) for split in frames.values() for name, c2w in split]:
            done.result()
    for split in ("train", "val", "test"):
        entries = [{"file_path": f"./{name}", "transform_matrix": c2w.tolist()} for name, c2w in frames.get(split, [])]
        (out / f"transforms_{split}.json").write_text(json.dumps({"camera_angle_x": CAMERA_ANGLE_X, "frames": entries}))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out_dir", required=True)
    ap.add_argument("--hw", type=int, default=800)
    ap.add_argument("--n_train", type=int, default=100)
    ap.add_argument("--n_val", type=int, default=8)
    ap.add_argument("--n_test", type=int, default=8)
    ap.add_argument("--n_spheres", type=int, default=6)
    ap.add_argument("--radius", type=float, default=4.0, help="camera orbit radius")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--bg", type=float, default=0.0, help="background intensity (1.0 = white)")
    args = ap.parse_args(argv)
    out = write_scene(args.out_dir, args.hw, args.n_train, args.n_val, args.n_test, args.n_spheres, args.radius,
                      args.seed, args.bg)
    print(f"scene written to {out}")


if __name__ == "__main__":
    main()
