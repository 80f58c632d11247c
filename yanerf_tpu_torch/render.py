"""Render a camera trajectory from a trained checkpoint.

    python -m yanerf_tpu_torch.render --config configs/nerf/lego_proposal.yml \\
        --checkpoint results/.../ckpts/ckpts_-001 --output_dir renders/ [--trajectory test] [--gif]

Counterpart of ``scripts/render.py``: the dataset's generated render path
(an LLFF spiral or spherified circle; other datasets fall back to the test
split's cameras, with a warning) or the test split's cameras, one frame at
a time, written as ``rgb/NNNNN.png`` and ``depth/NNNNN.png``
(``utils/images.png_bytes``; ``--gif`` also writes ``rgb.gif``), and the
frames per second after the first frame. ``--checkpoint`` takes a
checkpoint of the port's runner, an ``.npz`` of the JAX param tree or the
reference's torch weights (``.pth``).
``--device cuda`` is the default and raises without a GPU.
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path

import numpy as np
import torch

from .utils.config import Config, DictAction


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--config", required=True)
    parser.add_argument("--checkpoint", required=True)
    parser.add_argument("--output_dir", default="renders")
    parser.add_argument("--trajectory", choices=["render_path", "test"], default="render_path")
    parser.add_argument("--n_frames", type=int, default=None)
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    parser.add_argument("--gif", action="store_true", help="also write rgb.gif")
    parser.add_argument("--gif_fps", type=float, default=15.0)
    parser.add_argument("--cfg_options", nargs="+", action=DictAction)
    args = parser.parse_args(argv)

    cfg = Config.fromfile(args.config)
    if args.cfg_options is not None:
        cfg.merge_from_dict(args.cfg_options)

    from .datasets import CAM_CALIBRATION, DATASETS
    from .ops.structures import EvaluationMode
    from .serve import load_pipeline
    from .utils.images import gif_bytes, png_bytes, to_img

    pipeline = load_pipeline(cfg, args.checkpoint, args.device)
    device = pipeline.device

    # trajectory cameras
    test_ds = DATASETS.build(cfg.datasets[-1])
    if args.trajectory == "render_path" and hasattr(test_ds, "render_poses"):
        raw = test_ds.render_poses  # (N, 3, 5) pose|hwf
        poses = np.asarray([p[:, :4] @ CAM_CALIBRATION for p in raw], dtype=np.float32)
        focals = np.asarray([[p[2, 4]] for p in raw], dtype=np.float32)
        bounds = [(None, None)] * len(poses)
        if hasattr(test_ds, "bds"):
            lo, hi = float(test_ds.bds.min()), float(test_ds.bds.max())
            bounds = [(lo, hi)] * len(poses)
    else:
        if args.trajectory == "render_path":
            print(f"WARNING: {type(test_ds).__name__} has no render_poses (LLFF spiral/spherify paths only); "
                  "falling back to the test split's cameras", flush=True)
        items = [test_ds[i] for i in range(len(test_ds))]
        poses = np.stack([it[0][:3, :4] if it[0].shape[0] == 4 else it[0] for it in items])
        focals = np.stack([it[1] for it in items])
        bounds = [(float(it[3][0]), float(it[4][0])) if len(it) >= 5 else (None, None) for it in items]
    if args.n_frames:
        poses, focals, bounds = poses[: args.n_frames], focals[: args.n_frames], bounds[: args.n_frames]

    out_dir = Path(args.output_dir)
    (out_dir / "rgb").mkdir(parents=True, exist_ok=True)
    (out_dir / "depth").mkdir(parents=True, exist_ok=True)
    gif_frames = []
    t_start = time.perf_counter()
    for i, (pose, focal, (lo, hi)) in enumerate(zip(poses, focals, bounds)):
        with torch.inference_mode():
            preds = pipeline(
                poses=torch.as_tensor(pose, device=device)[None],
                focal_lengths=torch.as_tensor(focal, device=device)[None],
                min_depth=lo, max_depth=hi, evaluation_mode=EvaluationMode.EVALUATION,
                generator=torch.Generator(device=device).manual_seed(i),
            )
            frame = preds["rendered_images"][0].cpu().numpy()
            depth = preds["rendered_depths"][0].cpu().numpy()
        rgb = to_img(frame)
        depth = depth / max(float(depth.max()), 1e-6)
        (out_dir / "rgb" / f"{i:05d}.png").write_bytes(png_bytes(rgb))
        (out_dir / "depth" / f"{i:05d}.png").write_bytes(png_bytes(to_img(depth)))
        if args.gif:
            gif_frames.append(rgb)
        if i == 0:
            t_start = time.perf_counter()  # the first frame builds the kernels
    n_timed = max(1, len(poses) - 1)
    fps = n_timed / (time.perf_counter() - t_start)
    print(f"rendered {len(poses)} frames to {out_dir} ({fps:.3f} fps after the first frame)")
    if args.gif and gif_frames:
        (out_dir / "rgb.gif").write_bytes(gif_bytes(gif_frames, args.gif_fps))
        print(f"wrote {out_dir / 'rgb.gif'} ({len(gif_frames)} frames @ {args.gif_fps:g} fps)")
    return dict(frames=len(poses), fps=fps, output_dir=out_dir)


if __name__ == "__main__":
    main()
