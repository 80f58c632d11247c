"""Operations and bytes of the hash-grid configuration, counted from its widths: the encoding's kernels (K4 forward,
K5 the tables' gradient) per launch, and the models' FLOPs per step.

Frozen here, as ``counts/nerf.py``, so that a change to the program cannot
move a roofline. The kernels' least time is their bytes' (the operations,
two per multiply-add of the trilinear blend, take under a hundredth of it
at any peak), and only bytes that must cross HBM are counted: the points'
coordinates, the features or their cotangents, and every table (or its
gradient) once. The random row reads beyond that, which the L2 serves in
part, are not counted, so the least time is a true lower bound.

The models' FLOPs are those of the two small MLPs: the forward, every
weight's gradient, and the gradient of every layer input that depends on a
parameter. The encoding depends on the tables, so the density MLP's first
layer takes its input gradient; the direction's embedding does not, so the
color MLP's first layer takes none for those rows. The blend is not
counted, as ``counts/nerf.py`` leaves out the embedding.
"""

from __future__ import annotations

from typing import Dict

from h100bench.counts.nerf import points_per_ray
from h100bench.inputs import model_list
from h100bench.reference.hash_grid import table_rows


def mlp_macs(cfg: dict) -> Dict[str, int]:
    """Multiply-adds per point of the density and color MLPs: ``forward``, ``weight_grads``, ``input_grads``."""
    levels, f = int(cfg.get("n_levels", 16)), int(cfg.get("n_features_per_level", 2))
    hidden, geo = int(cfg.get("hidden_dim", 64)), int(cfg.get("geo_feature_dim", 15))
    emb_dir = 3 * (2 * int(cfg.get("n_harmonic_functions_dir", 4)) + int(cfg.get("harmonic_functions_dir_append_intput", True)))
    n_color = int(cfg.get("n_color_layers", 2))
    density = levels * f * hidden + hidden * (1 + geo)
    color = (geo + emb_dir) * hidden + (n_color - 1) * hidden * hidden + hidden * int(cfg.get("color_dim", 3))
    forward = density + color
    return {"forward": forward, "weight_grads": forward, "input_grads": forward - emb_dir * hidden}


def table_bytes(cfg: dict) -> int:
    """Every level's table in float32."""
    return 4 * int(cfg.get("n_features_per_level", 2)) * sum(table_rows(cfg))


def encoding_work(cfg: dict, n_points: int):
    """``(operations, bytes)`` of one K4 or one K5 launch: the points in, the ``(n, L F)`` float32 features out (K4)
    or their cotangents in (K5), every table read (K4) or its gradient written (K5) once."""
    levels, f = int(cfg.get("n_levels", 16)), int(cfg.get("n_features_per_level", 2))
    ops = 2 * 8 * f * levels * n_points
    return ops, n_points * (3 * 4 + levels * f * 4) + table_bytes(cfg)


def step_work(config: dict) -> dict:
    """What one train step needs: each model's K4 (``hash_fwd``) and K5 (``hash_bwd``) launch as ``(operations,
    bytes)``, and the MLPs' operations (forward, weight and input gradients)."""
    rays = int(config["pipeline"]["ray_sampler"]["n_rays_per_image_sampled_from_mask"])
    work = {"hash_fwd": [], "hash_bwd": [], "model_flops": 0.0}
    for cfg, pts in zip(model_list(config), points_per_ray(config, True)):
        m = mlp_macs(cfg)
        work["model_flops"] += 2.0 * (m["forward"] + m["weight_grads"] + m["input_grads"]) * pts * rays
        work["hash_fwd"].append(encoding_work(cfg, pts * rays))
        work["hash_bwd"].append(encoding_work(cfg, pts * rays))
    return work
