"""Write a procedural LLFF-format scene: forward-facing, or a 360 orbit with optional distant spheres.

The port's own copy of ``scripts/make_synth_llff.py``: the spheres of
``synth_scene.py::make_scene`` ray-traced in numpy from a forward-facing
cluster of cameras (``--mode forward``) or from cameras around the scene
(``--mode orbit``; ``--distant_spheres N`` adds N large spheres 15-40 or
``--distant_min``-``--distant_max`` units away, an unbounded scene), and
written as ``images/imageNNN.png`` (``utils/images.py``) plus
``poses_bounds.npy``, the layout ``LLFFDataset`` reads: per image the 3x5
``[-up, right, back | position | (h, w, focal)]`` matrix (LLFF's ``[down,
right, back]`` columns) and near/far bounds from the spheres along the
view axis. On one seed it writes the script's scene: the same
``poses_bounds.npy`` and the same decoded pixels.

    python -m yanerf_tpu_torch.synth_llff --out_dir /tmp/synth_llff
    python -m yanerf_tpu_torch.synth_llff --out_dir /tmp/synth_llff_360far --mode orbit \\
        --distant_spheres 16 --distant_min 80 --distant_max 200
"""

from __future__ import annotations

import argparse
import os
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

from .synth_scene import CAMERA_ANGLE_X, look_at_blender, make_scene
from .utils.images import png_bytes


def render_hw(c2w_blender, h, w, focal, centers, radii, albedos):
    """Trace an ``(h, w)`` view of the spheres, two-light Lambertian shading, black background; in [0, 1]."""
    calib = np.diag([1.0, -1.0, -1.0, 1.0])
    pose = c2w_blender @ calib
    rot, origin = pose[:3, :3], pose[:3, 3]

    ys, xs = np.meshgrid(np.arange(h, dtype=np.float64), np.arange(w, dtype=np.float64), indexing="ij")
    dirs_cam = np.stack([(xs - w * 0.5) / focal, (ys - h * 0.5) / focal, np.ones_like(xs)], axis=-1)
    dirs = dirs_cam @ rot.T
    dnorm = dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)

    t_best = np.full((h, w), np.inf)
    color = np.zeros((h, w, 3))
    lights = [
        (np.array([0.4, 0.3, 0.85]) / np.linalg.norm([0.4, 0.3, 0.85]), 0.9),
        (np.array([-0.6, -0.2, 0.5]) / np.linalg.norm([-0.6, -0.2, 0.5]), 0.45),
    ]
    for c, r, a in zip(centers, radii, albedos):
        oc = origin - c
        b = np.sum(dnorm * oc, axis=-1)
        disc = b * b - (np.dot(oc, oc) - r * r)
        hit = disc > 0
        t = -b - np.sqrt(np.maximum(disc, 0.0))
        valid = hit & (t > 1e-3) & (t < t_best)
        p = origin + t[..., None] * dnorm
        normal = (p - c) / r
        shade = np.full((h, w), 0.12)
        for ldir, lw in lights:
            shade = shade + lw * np.maximum(np.einsum("hwc,c->hw", normal, ldir), 0.0)
        contrib = np.clip(shade[..., None] * a, 0.0, 1.0)
        color = np.where(valid[..., None], contrib, color)
        t_best = np.where(valid, t, t_best)
    return color


def write_llff_scene(out_dir, height: int = 378, width: int = 504, n_images: int = 40, n_spheres: int = 6,
                     mode: str = "forward", distant_spheres: int = 0, distant_min: float = 15.0,
                     distant_max: float = 40.0, distance: float = 4.0, seed: int = 0) -> Path:
    """Write the scene under ``out_dir``; returns it.

    The spheres and cameras are drawn in the script's order from one
    generator, then the views are rendered and encoded on a thread pool
    (numpy and zlib release the interpreter lock): the files do not depend
    on the pool.
    """
    if mode not in ("forward", "orbit"):
        raise ValueError(f"mode must be 'forward' or 'orbit', got {mode!r}")
    out = Path(out_dir)
    (out / "images").mkdir(parents=True, exist_ok=True)
    rng = np.random.RandomState(seed)
    centers, radii, albedos = make_scene(rng, n_spheres)
    if distant_spheres:
        far_c, far_r, far_a = [], [], []
        for k in range(distant_spheres):
            u = 2 * np.pi * (k + 0.35) / distant_spheres
            dist = rng.uniform(distant_min, distant_max)
            elev = np.deg2rad(rng.uniform(-10.0, 25.0))
            far_c.append(dist * np.array([np.cos(u) * np.cos(elev), np.sin(u) * np.cos(elev), np.sin(elev)]))
            far_r.append(dist * rng.uniform(0.1, 0.2))  # roughly constant angular size
            far_a.append(rng.uniform(0.3, 1.0, size=3))
        centers = np.concatenate([centers, np.asarray(far_c)])
        radii = np.concatenate([radii, np.asarray(far_r)])
        albedos = np.concatenate([albedos, np.asarray(far_a)])

    focal = 0.5 * width / np.tan(0.5 * CAMERA_ANGLE_X)
    scene_center = np.array([0.0, 0.0, 0.3])

    cameras, rows = [], []
    for i in range(n_images):
        if mode == "orbit":
            u = 2 * np.pi * i / n_images + rng.uniform(-0.05, 0.05)
            elev = np.deg2rad(rng.uniform(5.0, 35.0))
            r = distance + rng.uniform(-0.25, 0.25)
            position = scene_center + r * np.array([np.cos(u) * np.cos(elev), np.sin(u) * np.cos(elev), np.sin(elev)])
            target = scene_center + np.r_[rng.uniform(-0.1, 0.1, size=2), rng.uniform(-0.1, 0.1)]
        else:
            # a forward-facing cluster viewing along +y, small lateral and depth jitter
            offset = rng.uniform(-0.6, 0.6, size=2)
            depth = distance + rng.uniform(-0.25, 0.25)
            position = np.array([offset[0], -depth, scene_center[2] + offset[1] * 0.5])
            target = scene_center + np.r_[rng.uniform(-0.1, 0.1), 0.0, rng.uniform(-0.1, 0.1)]
        c2w = look_at_blender(position, target)
        cameras.append(c2w)

        # per-image metric bounds from the spheres along the view axis
        forward = -c2w[:3, 2]
        t_centers = (centers - position) @ forward
        near = max(0.5, float((t_centers - radii).min()) * 0.9)
        far = float((t_centers + radii).max()) * 1.2
        if distant_spheres:
            # the near bound tracks the central content only (a distant sphere may be behind the camera)
            t_near_candidates = t_centers[:n_spheres] - radii[:n_spheres]
            near = max(0.5, float(t_near_candidates.min()) * 0.9)

        right, up, back = c2w[:3, 0], c2w[:3, 1], c2w[:3, 2]
        stored_rot = np.stack([-up, right, back], axis=1)  # columns [down, right, back]
        hwf = np.array([height, width, focal])
        mat35 = np.concatenate([stored_rot, position[:, None], hwf[:, None]], axis=1)  # (3, 5)
        rows.append(np.concatenate([mat35.reshape(-1), [near, far]]))

    def write(i: int, c2w: np.ndarray) -> None:
        img = render_hw(c2w, height, width, focal, centers, radii, albedos)
        (out / "images" / f"image{i:03d}.png").write_bytes(png_bytes((img * 255).astype(np.uint8)))

    with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as pool:
        for done in [pool.submit(write, i, c2w) for i, c2w in enumerate(cameras)]:
            done.result()
    np.save(out / "poses_bounds.npy", np.asarray(rows))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out_dir", required=True)
    ap.add_argument("--height", type=int, default=378)
    ap.add_argument("--width", type=int, default=504)
    ap.add_argument("--n_images", type=int, default=40)
    ap.add_argument("--n_spheres", type=int, default=6)
    ap.add_argument("--mode", choices=["forward", "orbit"], default="forward",
                    help="forward: an LLFF forward-facing cluster; orbit: a 360 capture for the spherify path")
    ap.add_argument("--distant_spheres", type=int, default=0,
                    help="add N large background spheres (an unbounded scene)")
    ap.add_argument("--distant_min", type=float, default=15.0)
    ap.add_argument("--distant_max", type=float, default=40.0)
    ap.add_argument("--distance", type=float, default=4.0, help="camera plane distance")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    out = write_llff_scene(args.out_dir, args.height, args.width, args.n_images, args.n_spheres, args.mode,
                           args.distant_spheres, args.distant_min, args.distant_max, args.distance, args.seed)
    print(f"LLFF scene written to {out}: {args.n_images} images @ {args.width}x{args.height}")


if __name__ == "__main__":
    main()
