"""Extract a polygon mesh from a trained model's density field.

    python -m yanerf_tpu_torch.extract_mesh --config configs/nerf/lego_proposal.yml \\
        --checkpoint results/.../ckpts/ckpts_-001 --out lego.obj --resolution 256 --iso 25 --bounds -1.5 1.5

Counterpart of ``scripts/extract_mesh.py``: the final-pass model's density
on a lattice (``ops/mesh.py::evaluate_density_grid``), surface nets on the
host, an OBJ; with ``--vertex_colors`` the color head at each vertex, seen
along ``-normal``. The iso value is in activated-density units (sigma);
sweep with ``--resolution 64`` first. ``--checkpoint`` takes a checkpoint of
the port's runner, an ``.npz`` of the JAX param tree or a reference-layout
``.pth``; ``--device cuda`` is the default and raises without a GPU.
"""

from __future__ import annotations

import argparse

from .utils.config import Config, DictAction


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--config", required=True)
    parser.add_argument("--checkpoint", default=None)
    parser.add_argument("--out", default="mesh.obj")
    parser.add_argument("--resolution", type=int, default=256)
    parser.add_argument("--iso", type=float, default=25.0)
    parser.add_argument("--bounds", type=float, nargs=2, default=(-1.5, 1.5),
                        help="lo hi of the sampled cube in model coordinates")
    parser.add_argument("--chunk", type=int, default=65536)
    parser.add_argument("--vertex_colors", action="store_true",
                        help="query the color head at each vertex (view = -normal) and write a colored OBJ")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    parser.add_argument("--cfg_options", nargs="+", action=DictAction)
    args = parser.parse_args(argv)

    from .ops.mesh import evaluate_density_grid, evaluate_vertex_colors, save_obj, surface_nets, vertex_normals
    from .serve import load_pipeline

    config = Config.fromfile(args.config)
    if args.cfg_options:
        config.merge_from_dict(args.cfg_options)
    pipeline = load_pipeline(config, args.checkpoint, args.device, seed=config.runner.get("seed", 0))
    # the final pass is the full-quality model (coarse / proposal passes are sampling guides)
    model = pipeline.implicit_functions[-1]

    print(f"evaluating density on a {args.resolution}^3 lattice (bounds {args.bounds})...", flush=True)
    grid = evaluate_density_grid(model, resolution=args.resolution, bounds=tuple(args.bounds), chunk=args.chunk)
    print(
        f"density: min {grid.min():.3f} max {grid.max():.3f} "
        f"({(grid > args.iso).mean() * 100:.2f}% of lattice above iso {args.iso})",
        flush=True,
    )
    lo, hi = args.bounds
    spacing = (hi - lo) / (args.resolution - 1)
    verts, faces = surface_nets(grid, iso=args.iso, origin=(lo, lo, lo), spacing=(spacing,) * 3)
    if len(verts) == 0:
        print(f"WARNING: iso {args.iso} does not intersect the field — empty mesh written")
    colors = None
    if args.vertex_colors and len(verts):
        print("querying vertex colors (view = -normal)...", flush=True)
        colors = evaluate_vertex_colors(model, verts, vertex_normals(verts, faces), chunk=args.chunk)
    save_obj(args.out, verts, faces, colors=colors)
    kind = "colored vertices" if colors is not None else "vertices"
    print(f"wrote {args.out}: {len(verts)} {kind}, {len(faces)} quads")
    return dict(grid=grid, verts=verts, faces=faces, colors=colors)


if __name__ == "__main__":
    main()
