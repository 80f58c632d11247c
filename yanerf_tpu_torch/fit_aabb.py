"""Fit a scene content box from a trained model's density field.

    python -m yanerf_tpu_torch.fit_aabb --config configs/nerf/lego_proposal.yml \\
        --checkpoint results/.../ckpts/ckpts_-001 --threshold 5

Counterpart of ``scripts/fit_aabb.py``: the final-pass model's density on a
lattice (``ops/mesh.py::evaluate_density_grid``) and the tight box of the
occupied region (``fit_scene_aabb``), printed for
``pipeline.ray_sampler.scene_aabb`` (per-ray depth tightening by the slab
test). ``--checkpoint`` takes a checkpoint of the port's runner, an
``.npz`` of the JAX param tree or a reference-layout ``.pth``; ``--device
cuda`` is the default and raises without a GPU.
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from .utils.config import Config, DictAction


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--config", required=True)
    parser.add_argument("--checkpoint", default=None)
    parser.add_argument("--resolution", type=int, default=128)
    parser.add_argument("--bounds", type=float, nargs=2, default=(-2.0, 2.0),
                        help="lo hi of the probed cube (must contain the scene)")
    parser.add_argument("--threshold", type=float, default=5.0, help="occupancy density cutoff (sigma units)")
    parser.add_argument("--margin", type=float, default=0.05)
    parser.add_argument("--chunk", type=int, default=65536)
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    parser.add_argument("--cfg_options", nargs="+", action=DictAction)
    args = parser.parse_args(argv)

    from .ops.mesh import evaluate_density_grid, fit_scene_aabb
    from .serve import load_pipeline

    config = Config.fromfile(args.config)
    if args.cfg_options:
        config.merge_from_dict(args.cfg_options)
    pipeline = load_pipeline(config, args.checkpoint, args.device, seed=config.runner.get("seed", 0))
    model = pipeline.implicit_functions[-1]

    print(f"evaluating density on a {args.resolution}^3 lattice (bounds {args.bounds})...", flush=True)
    grid = evaluate_density_grid(model, resolution=args.resolution, bounds=tuple(args.bounds), chunk=args.chunk)
    aabb = fit_scene_aabb(grid, tuple(args.bounds), args.threshold, margin=args.margin)
    touches = (grid > args.threshold) & ~np.pad(np.ones(tuple(s - 2 for s in grid.shape), bool), 1,
                                                 constant_values=False)
    if touches.any():
        print("WARNING: occupied density touches the probe boundary — the scene may extend beyond --bounds; "
              "re-run with a larger cube.", flush=True)
    flat = [round(float(v), 4) for v in aabb.reshape(-1)]
    occ_frac = float((grid > args.threshold).mean())
    box_vol = float((aabb[1] - aabb[0]).prod())
    probe_vol = (args.bounds[1] - args.bounds[0]) ** 3
    print(f"occupied lattice fraction: {occ_frac * 100:.2f}% above sigma {args.threshold}")
    print(f"aabb: {flat}  (box/probe volume: {box_vol / probe_vol * 100:.1f}%)")
    print("paste into a config:   ray_sampler: {{ scene_aabb: {} }}".format(flat))
    print("or on the CLI:         --cfg_options pipeline.ray_sampler.scene_aabb='{}'".format(json.dumps(flat)))
    return dict(grid=grid, aabb=aabb)


if __name__ == "__main__":
    main()
