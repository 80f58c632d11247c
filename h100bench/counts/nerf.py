"""Operations and bytes of the configurations' models, counted from their widths, and the card's peaks.

Frozen here so that a change to the program cannot move a roofline. Two
operations per multiply-add; the sine / cosine embedding, activations and
compositing are not counted. The backward counts the work a backward
needs, whatever a kernel does: every weight's gradient (one product of
the layer's shape) and the gradient of every layer input that depends on
a weight (none for the embedding, which holds no parameter: not for the
first layer, not for the embedding half of the skip layer, not for the
direction half of the first color layer). A kernel that recomputes its
forward is held to the same count.
"""

from __future__ import annotations

from typing import Dict

PEAK_BF16_FLOPS = 989e12  # one H100 SXM, dense bfloat16, tensor cores (NVIDIA data sheet, 700 W)
PEAK_BYTES_PER_S = 3.35e12  # its HBM3


def embedding_dims(cfg: dict):
    kx = 3 * (2 * int(cfg.get("n_harmonic_functions_xyz", 10)) + int(cfg.get("harmonic_functions_xyz_append_intput", True)))
    kd = 3 * (2 * int(cfg.get("n_harmonic_functions_dir", 4)) + int(cfg.get("harmonic_functions_dir_append_intput", True)))
    return kx, kd


def nerf_mlp_macs(cfg: dict) -> Dict[str, int]:
    """Multiply-adds per point of a NeRF MLP: ``forward``, ``weight_grads``, ``input_grads``."""
    kx, kd = embedding_dims(cfg)
    h, hd, n = int(cfg["n_hidden_neurons_xyz"]), int(cfg["n_hidden_neurons_dir"]), int(cfg["n_layers"])
    n_skips = len([s for s in cfg["input_skips"] if 0 < s < n])
    extra = n // 4 if cfg.get("nerf_paper_v1", False) else 0
    color = int(cfg.get("color_dim", 3))
    forward = kx * h + (n - 1) * h * h + n_skips * kx * h + h * (h + 1) + (h + kd) * hd + extra * hd * hd + hd * color
    return {"forward": forward, "weight_grads": forward, "input_grads": forward - (1 + n_skips) * kx * h - kd * hd}


def proposal_mlp_macs(cfg: dict) -> Dict[str, int]:
    """Multiply-adds per point of a density-only proposal MLP."""
    kx, _ = embedding_dims(cfg)
    h, n = int(cfg.get("hidden_dim", 128)), int(cfg.get("n_layers", 4))
    forward = kx * h + (n - 1) * h * h + h
    return {"forward": forward, "weight_grads": forward, "input_grads": forward - kx * h}


def macs(cfg: dict) -> Dict[str, int]:
    return nerf_mlp_macs(cfg) if cfg["type"] == "NeRFMLP" else proposal_mlp_macs(cfg)


def nerf_mlp_parameters(cfg: dict):
    """``(weights, biases)``: the NeRF MLP's parameter counts at its own widths (each weight is one multiply-add
    of the forward per point)."""
    h, hd, n = int(cfg["n_hidden_neurons_xyz"]), int(cfg["n_hidden_neurons_dir"]), int(cfg["n_layers"])
    extra = n // 4 if cfg.get("nerf_paper_v1", False) else 0
    return nerf_mlp_macs(cfg)["forward"], n * h + h + 1 + hd * (1 + extra) + int(cfg.get("color_dim", 3))


def nerf_mlp_weight_bytes(cfg: dict) -> int:
    """The NeRF MLP's weights in bfloat16 and biases in float32."""
    weights, biases = nerf_mlp_parameters(cfg)
    return 2 * weights + 4 * biases


def k1_work(cfg: dict, n_points: int, n_rays: int):
    """``(operations, bytes)`` of one NeRF MLP forward launch: points and directions in, density and color out,
    the weights read once."""
    ops = 2 * nerf_mlp_macs(cfg)["forward"] * n_points
    io = n_points * 3 * 4 + n_rays * 3 * 4 + n_points * (1 + int(cfg.get("color_dim", 3))) * 4
    return ops, io + nerf_mlp_weight_bytes(cfg)


def k3_work(cfg: dict, n_points: int, n_rays: int):
    """``(operations, bytes)`` of one NeRF MLP backward launch: weight and input gradients, no recomputed forward;
    points, directions and output cotangents in, weights in, float32 weight gradients out."""
    m = nerf_mlp_macs(cfg)
    ops = 2 * (m["weight_grads"] + m["input_grads"]) * n_points
    io = n_points * 3 * 4 + n_rays * 3 * 4 + n_points * (1 + int(cfg.get("color_dim", 3))) * 4
    return ops, io + nerf_mlp_weight_bytes(cfg) + 4 * sum(nerf_mlp_parameters(cfg))


def least_seconds(ops: float, io_bytes: float) -> float:
    """The least time the card could take: the larger of the operations' and the bytes' times at peak."""
    return max(ops / PEAK_BF16_FLOPS, io_bytes / PEAK_BYTES_PER_S)


def _models(config: dict):
    pipe = config["pipeline"]
    models = pipe["model"]
    return list(models) if isinstance(models, list) else [models] * int(pipe["num_passes"])


def points_per_ray(config: dict, training: bool):
    """The points each model evaluates per ray, in pass order."""
    pipe = config["pipeline"]
    mode = "training" if training else "evaluation"
    n0, r = int(pipe["ray_sampler"]["n_pts_per_ray_" + mode]), pipe["renderer"]
    models = _models(config)
    if r["type"].startswith("Proposal"):
        return [n0] + [int(n) for n in r["n_pts_per_ray_intermediate_" + mode]] + [int(r["n_pts_per_ray_final_" + mode])]
    fine = int(r.get("n_pts_per_ray_fine_" + mode, 64))
    append = r.get("append_coarse_samples_to_fine", True)
    return [n0 + k * fine if append else (fine if k else n0) for k in range(len(models))]


def step_work(config: dict) -> dict:
    """What one train step needs: the NeRF MLPs' forward (``k1``) and backward (``k3``) launches as ``(operations,
    bytes)``, and the models' operations (forward, weight and input gradients)."""
    rays = int(config["pipeline"]["ray_sampler"]["n_rays_per_image_sampled_from_mask"])
    work = {"k1": [], "k3": [], "model_flops": 0.0}
    for cfg, pts in zip(_models(config), points_per_ray(config, True)):
        m = macs(cfg)
        work["model_flops"] += 2.0 * (m["forward"] + m["weight_grads"] + m["input_grads"]) * pts * rays
        if cfg["type"] == "NeRFMLP":
            work["k1"].append(k1_work(cfg, pts * rays, rays))
            work["k3"].append(k3_work(cfg, pts * rays, rays))
    return work


def frame_work(config: dict) -> dict:
    """What one full frame needs: the NeRF MLPs' forward launches, one per chunk and model at the chunk's own
    rays (the padding of the last chunk left out), and the models' forward operations."""
    pipe = config["pipeline"]
    rays = int(pipe["ray_sampler"]["image_height"]) * int(pipe["ray_sampler"]["image_width"])
    pts = points_per_ray(config, False)
    n_chunks = -(-rays * pts[0] // int(pipe["chunk_size_grid"]))
    chunk = -(-rays // n_chunks)
    chunk_rays = [min(chunk, rays - i * chunk) for i in range(n_chunks)]
    work = {"k1": [], "model_flops": 0.0}
    for cfg, p in zip(_models(config), pts):
        work["model_flops"] += 2.0 * macs(cfg)["forward"] * p * rays
        if cfg["type"] == "NeRFMLP":
            work["k1"] += [k1_work(cfg, p * r, r) for r in chunk_rays]
    return work
