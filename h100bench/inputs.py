"""What the benchmark makes from ``--seed``: the sub-seeds, the weights, the procedural scene and the cameras.

Everything is made on the run's device in a few large calls. The same
seed gives the same weights, scene and cameras; the program and the
reference are both handed them.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch

CAM_CALIBRATION = np.diag(np.array([1.0, -1.0, -1.0, 1.0], dtype=np.float32))  # Blender camera -> world

# The weights are the models' published initialisation but for two changes, which condition the check: every
# density bias starts at DENSITY_BIAS, and the rows of the first and skip layers that read the points' embedding at
# frequency 2^k are scaled by FREQUENCY_DECAY ** k, a field that varies mostly at low frequencies, as a trained one
# does. At the plain initialisation every frequency weighs alike, so densities and colours change on a 1/512 length
# scale and relu zeroes half the densities; the resampled depths of a frame or a step then carry rounding beyond the
# check's linear range, and bfloat16 cannot be told from float8. The conditioning leaves the top frequency a weight
# of 1/512: a kernel that drops it moves frames and steps by less than bfloat16 rounding does, but so it does at any
# decay up to 1, the plain initialisation (PERF.md); what the kernels' embedding computes is their own tests' to hold.
DENSITY_BIAS = 1.0
FREQUENCY_DECAY = 0.5


def sub_seeds(seed: int) -> Dict[str, int]:
    """Independent 31-bit seeds for each input, drawn from ``seed`` (any whole number)."""
    words = np.random.SeedSequence(int(seed)).generate_state(4)
    return {name: int(w) & 0x7FFFFFFF for name, w in zip(("weights", "scene", "runner", "cameras"), words)}


def model_list(config: dict) -> List[dict]:
    models = config["pipeline"]["model"]
    return list(models) if isinstance(models, list) else [models] * int(config["pipeline"]["num_passes"])


def leaves(config: dict) -> List[Tuple[str, Tuple[int, ...], float]]:
    """Every weight of the configuration's models: ``(name, shape, bound)``, drawn ``U(-bound, bound)``.

    The bounds are the models' published initialisation: Xavier-uniform
    weights and ``1 / sqrt(fan_in)`` biases for the trunks, zero density
    biases, PyTorch's default for the color head.
    """
    out = []

    def layer(name: str, fan_in: int, fan_out: int, xavier: bool = True, zero_bias: bool = False) -> None:
        bound = math.sqrt(6.0 / (fan_in + fan_out)) if xavier else 1.0 / math.sqrt(fan_in)
        out.append((name + ".w", (fan_in, fan_out), bound))
        out.append((name + ".b", (fan_out,), 0.0 if zero_bias else 1.0 / math.sqrt(fan_in)))

    for i, cfg in enumerate(model_list(config)):
        p = f"implicit_functions.{i}."
        emb = 3 * (2 * int(cfg.get("n_harmonic_functions_xyz", 10)) + int(cfg.get("harmonic_functions_xyz_append_intput", True)))
        if cfg["type"] == "ProposalMLP":
            h = int(cfg.get("hidden_dim", 128))
            for li in range(int(cfg.get("n_layers", 4))):
                layer(f"{p}mlp.{li}", emb if li == 0 else h, h)
            layer(p + "density_layer", h, 1, zero_bias=True)
        elif cfg["type"] == "NeRFMLP":
            if int(cfg.get("latent_dim", 0)) or not cfg.get("input_xyz", True) or not cfg.get("input_dir", True):
                raise ValueError("the benchmark's NeRFMLP takes points and directions and no latent code")
            h, hd = int(cfg["n_hidden_neurons_xyz"]), int(cfg["n_hidden_neurons_dir"])
            emb_dir = 3 * (2 * int(cfg["n_harmonic_functions_dir"]) + int(cfg["harmonic_functions_dir_append_intput"]))
            for li in range(int(cfg["n_layers"])):
                fan_in = emb if li == 0 else h + (emb if li in cfg["input_skips"] else 0)
                layer(f"{p}xyz_encoder.mlp.{li}", fan_in, h)
            layer(p + "intermediate_linear", h, h)
            layer(p + "density_layer", h, 1, zero_bias=True)
            extra = int(cfg["n_layers"]) // 4 if cfg.get("nerf_paper_v1", False) else 0
            dims = [h + emb_dir] + [hd] * (extra + 1) + [int(cfg.get("color_dim", 3))]
            for j in range(len(dims) - 1):
                layer(f"{p}color_layer.{j}", dims[j], dims[j + 1], xavier=False)
        else:
            raise ValueError(f"model type {cfg['type']!r} has no reference")
    return out


def frequency_scale(config: dict, frequency_decay: float, device) -> Dict[str, torch.Tensor]:
    """Per weight that reads the points' embedding (the first layer, the skip layer's embedding rows), a factor
    ``frequency_decay ** k`` on the rows of the embedding's frequency ``2^k`` (1 on the raw coordinates)."""
    out = {}
    for i, cfg in enumerate(model_list(config)):
        n = int(cfg.get("n_harmonic_functions_xyz", 10))
        rows = torch.tensor([frequency_decay ** k for k in range(n)], device=device).repeat(6)
        if cfg.get("harmonic_functions_xyz_append_intput", True):
            rows = torch.cat([rows, torch.ones(3, device=device)])
        p = f"implicit_functions.{i}."
        if cfg["type"] == "ProposalMLP":
            out[p + "mlp.0.w"] = rows
        else:
            out[p + "xyz_encoder.mlp.0.w"] = rows
            for skip in cfg["input_skips"]:
                if 0 < skip < int(cfg["n_layers"]):
                    h = int(cfg["n_hidden_neurons_xyz"])
                    out[f"{p}xyz_encoder.mlp.{skip}.w"] = torch.cat([torch.ones(h, device=device), rows])
    return out


def make_weights(config: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The configuration's weights, float32 on ``device``: one uniform draw for all of them, cut and scaled; every
    density layer's bias starts at ``DENSITY_BIAS``, and the rows reading the points' embedding at frequency
    ``2^k`` are scaled by ``FREQUENCY_DECAY ** k`` (``frequency_scale``)."""
    spec = leaves(config)
    sizes = [math.prod(shape) for _, shape, _ in spec]
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.rand(sum(sizes), generator=gen, device=device) * 2.0 - 1.0
    rows = frequency_scale(config, FREQUENCY_DECAY, device)
    out, start = {}, 0
    for (name, shape, bound), n in zip(spec, sizes):
        out[name] = (flat[start:start + n] * bound).reshape(shape)
        if name.endswith("density_layer.b"):
            out[name] += DENSITY_BIAS
        if name in rows:
            out[name] *= rows[name][:, None]
        start += n
    return out


def look_at(position: np.ndarray, target: np.ndarray) -> np.ndarray:
    """Camera-to-world in the Blender convention (-z forward, y up), as the Blender datasets store it."""
    forward = (target - position) / np.linalg.norm(target - position)
    z_axis = -forward
    x_axis = np.cross(np.array([0.0, 0.0, 1.0]), z_axis)
    n = np.linalg.norm(x_axis)
    x_axis = np.array([1.0, 0.0, 0.0]) if n < 1e-6 else x_axis / n
    c2w = np.eye(4)
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = x_axis, np.cross(z_axis, x_axis), z_axis, position
    return c2w


def orbit_poses(rng: np.random.RandomState, count: int, radius: float, elevation_deg, target) -> np.ndarray:
    """``(count, 4, 4)`` world camera-to-worlds (calibrated) on a sphere, azimuth uniform, elevation in range."""
    out = []
    lo, hi = np.deg2rad(elevation_deg[0]), np.deg2rad(elevation_deg[1])
    for _ in range(count):
        u, elev = rng.uniform(0, 2 * np.pi), rng.uniform(lo, hi)
        position = radius * np.array([np.cos(u) * np.cos(elev), np.sin(u) * np.cos(elev), np.sin(elev)])
        out.append(look_at(position, np.asarray(target, np.float64)) @ CAM_CALIBRATION)
    return np.asarray(out, np.float32)


def focal_length(traffic: dict) -> float:
    return float(0.5 * traffic["width"] / np.tan(0.5 * float(traffic["camera_angle_x"])))


def make_scene(traffic: dict, seed: int, device) -> Tuple[np.ndarray, torch.Tensor]:
    """The training views of a procedural Blender-format scene: ``(poses (N, 4, 4) float32, images (N, H, W, 3)
    uint8 on device)``.

    Lambertian spheres inside the lego-sized box, two lights, a black
    background, ray-traced on the device at the cameras' pixels, each
    frame's intensities rounded to 8 bits as a PNG holds them.
    """
    rng = np.random.RandomState(seed)
    n = int(traffic["spheres"])
    centers = rng.uniform(-0.8, 0.8, size=(n, 3)) * np.array([1.0, 1.0, 0.6]) + np.array([0.0, 0.0, 0.3])
    radii, albedos = rng.uniform(0.18, 0.45, size=n), rng.uniform(0.25, 1.0, size=(n, 3))
    poses = orbit_poses(rng, int(traffic["views"]), float(traffic["radius"]), traffic["elevation_deg"],
                        traffic["target"])
    h, w, focal = int(traffic["height"]), int(traffic["width"]), focal_length(traffic)
    as_t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)  # noqa: E731
    centers, radii, albedos = as_t(centers), as_t(radii), as_t(albedos)
    lights = [(as_t(np.array(d) / np.linalg.norm(d)), wt) for d, wt in (([0.4, 0.3, 0.85], 0.9), ([-0.6, -0.2, 0.5], 0.45))]
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=device),
                            torch.arange(w, dtype=torch.float32, device=device), indexing="ij")
    cam = torch.stack([(xs - w * 0.5) / focal, (ys - h * 0.5) / focal, torch.ones_like(xs)], dim=-1)
    images = torch.empty((len(poses), h, w, 3), dtype=torch.uint8, device=device)
    for i, pose in enumerate(as_t(poses)):
        d = cam @ pose[:3, :3].T
        d = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)
        origin = pose[:3, 3]
        t_best = torch.full((h, w), float("inf"), device=device)
        color = torch.zeros((h, w, 3), device=device)
        for c, r, a in zip(centers, radii, albedos):
            oc = origin - c
            b = d @ oc
            disc = b * b - (oc @ oc - r * r)
            t = -b - torch.sqrt(torch.clamp(disc, min=0.0))
            hit = (disc > 0) & (t > 1e-3) & (t < t_best)
            normal = (origin + t[..., None] * d - c) / r
            shade = 0.12 + sum(wt * torch.clamp(normal @ ld, min=0.0) for ld, wt in lights)
            color = torch.where(hit[..., None], torch.clamp(shade[..., None] * a, 0.0, 1.0), color)
            t_best = torch.where(hit, t, t_best)
        images[i] = torch.round(color * 255.0).to(torch.uint8)
    return poses, images
