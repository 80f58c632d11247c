"""Plain PyTorch reference of the benchmark's hash-grid configuration: the multiresolution hash encoding and its two
small MLPs, over ``reference/nerf.py``'s rays, draws, compositing, objective and learning rates.

Written from Mueller, Evans, Schied and Keller, "Instant Neural Graphics
Primitives with a Multiresolution Hash Encoding" (SIGGRAPH 2022,
arXiv:2201.05989, section 3), in float32 with TF32 off, importing nothing of
the program. Per level ``l`` of ``L``:
  * the resolution ``N_l = floor(N_min * b^l)``, ``b = exp((ln N_max - ln N_min)
    / (L - 1))`` (eq. 2, 3), in float64;
  * the point, mapped from the scene's box ``[-B, B]^3`` into ``[0, 1]^3``
    (clamped), scaled by ``N_l``: its cell's 8 corners, clamped to the grid;
  * each corner's row: the dense grid index while ``(N_l + 1)^3`` rows fit
    the table of ``T`` rows, the spatial hash ``(x * 1 XOR y * 2654435761 XOR
    z * 805459861) mod T`` (eq. 4, in 32 bits) above;
  * the corners' ``F``-wide rows blended by the trilinear weights.
The levels' features, concatenated, go through the density MLP (one hidden
ReLU layer; its first output the raw density, the rest the geometry
features) and the color MLP (over those and the direction's embedding; ReLU
hidden layers, a sigmoid out).

The configuration as it is run departs from the paper, and the reference
follows the configuration:
  * the direction is embedded harmonically (4 frequencies and the input), not
    in degree-4 spherical harmonics;
  * the density is the renderer's activation of the raw output (ReLU plus a
    bias, ``reference.nerf.composite_weights``), not ``exp``;
  * two models, coarse and fine, by lego.yml's two-pass schedule, not one
    model behind occupancy-grid marching;
  * 8,192 rays of 64 + 192 points a step, not 2^18 samples;
  * the program's MLPs compute in bfloat16 and its tables in float32, where
    tiny-cuda-nn computes in float16.

``precision="fp8"`` is the control, as in ``reference/nerf.py``: the MLPs'
products take float8 operands (the encoding among them) and round their
outputs to float8.
"""

from __future__ import annotations

import math
from typing import List

import numpy as np
import torch

from h100bench.reference import nerf
from h100bench.reference.nerf import Params

PRIMES = (1, 2654435761, 805459861)


def resolutions(cfg: dict) -> List[int]:
    """``N_l`` of every level, in float64."""
    n, lo, hi = int(cfg.get("n_levels", 16)), int(cfg.get("base_resolution", 16)), int(cfg.get("max_resolution", 2048))
    if n == 1:
        return [lo]
    growth = float(np.exp((np.log(hi) - np.log(lo)) / (n - 1)))
    return [int(np.floor(lo * growth ** level)) for level in range(n)]


def table_rows(cfg: dict) -> List[int]:
    """Rows of every level's table: the dense grid's while it fits ``T``, ``T`` above."""
    t = 1 << int(cfg.get("table_size_log2", 19))
    return [min((res + 1) ** 3, t) for res in resolutions(cfg)]


def encode(cfg: dict, tables: List[torch.Tensor], points: torch.Tensor) -> torch.Tensor:
    """World points ``(..., 3)`` -> the concatenated features ``(..., L * F)``."""
    bound = float(cfg.get("scene_bound", 1.5))
    x = torch.clamp((points.reshape(-1, 3) + bound) / (2.0 * bound), 0.0, 1.0)
    feats = []
    for res, rows, table in zip(resolutions(cfg), table_rows(cfg), tables):
        scaled = x * res
        cell = torch.floor(scaled)
        frac = scaled - cell
        cell = cell.long()
        level = torch.zeros(x.shape[0], table.shape[1], device=x.device)
        for corner in range(8):
            bits = torch.tensor([(corner >> 2) & 1, (corner >> 1) & 1, corner & 1], device=x.device)
            q = torch.clamp(cell + bits, 0, res)
            if (res + 1) ** 3 <= rows:
                row = (q[:, 0] * (res + 1) + q[:, 1]) * (res + 1) + q[:, 2]
            else:
                row = ((q[:, 0] * PRIMES[0]) ^ (q[:, 1] * PRIMES[1]) ^ (q[:, 2] * PRIMES[2])) & 0xFFFFFFFF
                row = row % rows
            w = torch.prod(torch.where(bits.bool(), frac, 1.0 - frac), dim=-1)
            level = level + w[:, None] * table[row]
        feats.append(level)
    return torch.cat(feats, dim=-1).reshape(*points.shape[:-1], -1)


class Model(nerf.Model):
    """The hash grid's encoding and MLPs over the weights, by the program's parameter names."""

    def nerf(self, p: Params, i: int, points: torch.Tensor, directions: torch.Tensor):
        """Raw densities ``(..., P, 1)`` and colors ``(..., P, 3)`` of model ``i``; ``directions`` per ray."""
        cfg, prefix = self.models[i], f"implicit_functions.{i}."
        if cfg.get("contract_coords", False) or not cfg.get("input_dir", True):
            raise ValueError("the reference's hash grid takes points in the box and directions")
        tables = [p[f"{prefix}tables.{level}"] for level in range(int(cfg.get("n_levels", 16)))]
        enc = encode(cfg, tables, points)
        h = torch.relu(self.linear(p, prefix + "density_mlp.0", enc))
        geo = self.linear(p, prefix + "density_mlp.1", h)
        unit = directions / torch.clamp(torch.linalg.vector_norm(directions, dim=-1, keepdim=True), min=1e-12)
        dir_emb = nerf.harmonic(unit, int(cfg.get("n_harmonic_functions_dir", 4)),
                                cfg.get("harmonic_functions_dir_append_intput", True))
        x = torch.cat([geo[..., 1:], dir_emb[..., None, :].expand(*geo.shape[:-1], dir_emb.shape[-1])], dim=-1)
        n_color = int(cfg.get("n_color_layers", 2)) + 1
        for j in range(n_color - 1):
            x = torch.relu(self.linear(p, f"{prefix}color_mlp.{j}", x))
        return geo[..., :1], torch.sigmoid(self.linear(p, f"{prefix}color_mlp.{n_color - 1}", x))


class Renderer(nerf.Renderer):
    """``reference.nerf.Renderer`` (rays, draws, two passes, objective) over the hash grid's ``Model``."""

    def __init__(self, config: dict, precision: str = "float32") -> None:
        super().__init__(config, precision)
        if self.proposal:
            raise ValueError("the reference's hash grid runs the two-pass renderer only")
        self.model = Model(config, precision)


def train(config: dict, params: Params, poses: torch.Tensor, focal: float, images: torch.Tensor, seed: int,
          steps: int, precision: str = "float32"):
    """``reference.nerf.train`` with the hash grid's renderer: ``steps`` Adam updates from ``params``; returns
    ``(losses, first_grads, params_after)``."""
    runner = config["runner"]
    if float(runner.get("weight_decay", 0.0) or 0.0) != 0.0 or runner.get("lr_param_groups"):
        raise ValueError("the reference's Adam has no weight decay and one param group")
    renderer = Renderer(config, precision)
    p = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
    m = {k: torch.zeros_like(v) for k, v in p.items()}
    v2 = {k: torch.zeros_like(v) for k, v in p.items()}
    b1, b2, eps = 0.9, 0.999, 1e-8
    order = nerf.image_order(seed, images.shape[0])
    losses, first = [], None
    for step in range(steps):
        i = int(order[step])
        image = images[i].float() / 255.0 if images.dtype == torch.uint8 else images[i]
        loss = renderer.objective(p, poses[i, :3, :4], focal, image, renderer.draws(seed, step, images.device))
        grads = torch.autograd.grad(loss, list(p.values()))
        losses.append(float(loss.detach()))
        if first is None:
            first = {k: g.detach().clone() for k, g in zip(p, grads)}
        lr, t = nerf.learning_rate(runner, step), step + 1
        with torch.no_grad():
            for (k, leaf), g in zip(p.items(), grads):
                m[k].mul_(b1).add_(g, alpha=1 - b1)
                v2[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                denom = (v2[k].sqrt() / math.sqrt(1 - b2 ** t)).add_(eps)
                leaf.addcdiv_(m[k], denom, value=-lr / (1 - b1 ** t))
    return losses, first, {k: v.detach() for k, v in p.items()}
