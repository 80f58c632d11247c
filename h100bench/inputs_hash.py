"""The hash-grid configuration's weights from ``--seed``: the tables and the two small MLPs of every model.

The scene, the cameras and the sub-seeds are ``inputs.py``'s. The weights
are the published initialisation but for the conditioning below, which
``inputs.py``'s note on the NeRF MLP explains for that model:
  * level ``l``'s table is drawn ``U(-a_l, a_l)`` with ``a_l = max(1e-4,
    TABLE_SCALE * TABLE_DECAY ** l)``: the paper's ``U(-1e-4, 1e-4)`` would
    make the features four orders below the MLPs' biases, so that the field
    would be the biases' constant and the encoding would carry nothing of
    it: a kernel that read the wrong rows, or none, would move the check
    by less than rounding does. Larger tables at the coarser levels make a
    field that varies mostly at low frequencies, as a trained one does; at
    every level the rows still reach the output (a level left out moves the
    loss, and its table's gradient goes to zero);
  * the density output's bias starts at ``DENSITY_BIAS``: without it relu
    zeroes about half the raw densities, and the rays' weights, which the
    fine pass resamples from, carry rounding beyond the check's linear
    range, so that bfloat16 cannot be told from float8.
The MLPs are at the port's initialisation (``torch.nn.Linear``'s,
``U(+-1/sqrt(fan_in))`` for weights and biases).
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

from h100bench.inputs import model_list
from h100bench.reference.hash_grid import table_rows

TABLE_INIT = 1e-4
TABLE_SCALE = 8.0
TABLE_DECAY = 0.6
DENSITY_BIAS = 1.0


def table_bound(level: int) -> float:
    return max(TABLE_INIT, TABLE_SCALE * TABLE_DECAY ** level)


def leaves(config: dict) -> List[Tuple[str, Tuple[int, ...], float]]:
    """Every weight of the configuration's hash-grid models: ``(name, shape, bound)``, drawn ``U(-bound, bound)``."""
    out = []

    def layer(name: str, fan_in: int, fan_out: int) -> None:
        bound = 1.0 / math.sqrt(fan_in)
        out.extend([(name + ".w", (fan_in, fan_out), bound), (name + ".b", (fan_out,), bound)])

    for i, cfg in enumerate(model_list(config)):
        if cfg["type"] != "HashGridNeRF":
            raise ValueError(f"model type {cfg['type']!r}: inputs_hash makes the hash grid's weights only")
        p, f = f"implicit_functions.{i}.", int(cfg.get("n_features_per_level", 2))
        for level, rows in enumerate(table_rows(cfg)):
            out.append((f"{p}tables.{level}", (rows, f), table_bound(level)))
        hidden, geo = int(cfg.get("hidden_dim", 64)), int(cfg.get("geo_feature_dim", 15))
        layer(p + "density_mlp.0", int(cfg.get("n_levels", 16)) * f, hidden)
        layer(p + "density_mlp.1", hidden, 1 + geo)
        n_dir = int(cfg.get("n_harmonic_functions_dir", 4))
        emb_dir = 3 * (2 * n_dir + int(cfg.get("harmonic_functions_dir_append_intput", True)))
        dims = [geo + emb_dir] + [hidden] * int(cfg.get("n_color_layers", 2)) + [int(cfg.get("color_dim", 3))]
        for j in range(len(dims) - 1):
            layer(f"{p}color_mlp.{j}", dims[j], dims[j + 1])
    return out


def make_weights(config: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The weights, float32 on ``device``: one uniform draw for all of them, cut and scaled; the density output's
    bias raised by ``DENSITY_BIAS``."""
    spec = leaves(config)
    sizes = [math.prod(shape) for _, shape, _ in spec]
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.rand(sum(sizes), generator=gen, device=device) * 2.0 - 1.0
    out, start = {}, 0
    for (name, shape, bound), n in zip(spec, sizes):
        out[name] = (flat[start:start + n] * bound).reshape(shape)
        if name.endswith("density_mlp.1.b"):
            out[name][0] += DENSITY_BIAS
        start += n
    return out
