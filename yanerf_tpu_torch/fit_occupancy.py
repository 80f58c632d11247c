"""Fit an occupancy grid from a trained model's density field.

    python -m yanerf_tpu_torch.fit_occupancy --config configs/nerf/lego_proposal.yml \\
        --checkpoint results/.../ckpts/ckpts_-001 --threshold 5 --out results/.../occupancy.npz

Counterpart of ``scripts/fit_occupancy.py``: the final-pass model's density
on a lattice (``ops/mesh.py::evaluate_density_grid``, one model call per
chunk; K1 with ``--cfg_options pipeline.model.2.use_pallas=True``),
thresholded and dilated into a binary grid (``ops/occupancy.py``) and saved
as ``.npz``, the file ``pipeline.ray_sampler.occupancy_grid`` names for
per-ray empty-space skipping at eval. ``--checkpoint`` takes a checkpoint of
the port's runner or an ``.npz`` of the JAX param tree; ``--device cuda`` is
the default and raises without a GPU.
"""

from __future__ import annotations

import argparse

from .utils.config import Config, DictAction


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--config", required=True)
    parser.add_argument("--checkpoint", default=None)
    parser.add_argument("--out", required=True, help="output .npz path")
    parser.add_argument("--resolution", type=int, default=128)
    parser.add_argument("--bounds", type=float, nargs=2, default=(-2.0, 2.0),
                        help="lo hi of the probed cube (must contain the scene)")
    parser.add_argument("--threshold", type=float, default=5.0, help="occupancy density cutoff (sigma units)")
    parser.add_argument("--dilate", type=int, default=1, help="binary dilation radius in voxels (safety margin)")
    parser.add_argument("--chunk", type=int, default=65536)
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    parser.add_argument("--cfg_options", nargs="+", action=DictAction)
    args = parser.parse_args(argv)

    from .ops.mesh import evaluate_density_grid
    from .ops.occupancy import build_occupancy_grid, occupancy_fraction, save_occupancy
    from .serve import load_pipeline

    config = Config.fromfile(args.config)
    if args.cfg_options:
        config.merge_from_dict(args.cfg_options)
    pipeline = load_pipeline(config, args.checkpoint, args.device, seed=config.runner.get("seed", 0))
    model = pipeline.implicit_functions[-1]

    print(f"evaluating density on a {args.resolution}^3 lattice (bounds {args.bounds})...", flush=True)
    grid = evaluate_density_grid(model, resolution=args.resolution, bounds=tuple(args.bounds), chunk=args.chunk)
    occ = build_occupancy_grid(grid, tuple(args.bounds), args.threshold, dilate=args.dilate)
    frac = occupancy_fraction(occ)
    if frac == 0.0:
        raise SystemExit(
            f"no density above threshold {args.threshold} (grid max {grid.max():.3f}) — "
            "lower --threshold or check the checkpoint"
        )
    save_occupancy(args.out, occ, args.threshold)
    print(f"occupied (dilated) voxel fraction: {frac * 100:.2f}% above sigma {args.threshold}")
    print(f"wrote {args.out} ({args.resolution}^3 uint8)")
    print("enable in a config:  ray_sampler: {{ occupancy_grid: {} }}".format(args.out))
    print("or on the CLI:       --cfg_options pipeline.ray_sampler.occupancy_grid='{}'".format(args.out))
    return dict(grid=grid, occupancy=occ, fraction=frac)


if __name__ == "__main__":
    main()
