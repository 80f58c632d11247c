"""The weight bridge between the JAX package's param trees and the port's modules.

A JAX ``pipeline.init`` tree is nested dicts and lists of arrays, e.g.
``{"implicit_functions": [{"mlp": [{"w": ..., "b": ...}, ...], ...}, ...],
"feature_extractors": []}``. Flattened to dotted keys
(``implicit_functions.2.xyz_encoder.mlp.0.w``) it is exactly the port's
``state_dict``: the port keeps the JAX ``(in, out)`` weight layout
(``models/layers.py``), so nothing is transposed. Loading is strict: a
missing or extra key, or a shape mismatch, raises.

A serving checkpoint for the port is an ``.npz`` of that flattened tree
(``np.savez(path, **flatten_tree(params))`` on the JAX side).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Union

import numpy as np
import torch
import torch.nn as nn


def flatten_tree(tree: Any, prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested dicts/lists of arrays -> ``{dotted.key: array}``."""
    if isinstance(tree, Mapping):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: np.asarray(tree)}
    flat: Dict[str, np.ndarray] = {}
    for k, v in items:
        flat.update(flatten_tree(v, f"{prefix}.{k}" if prefix else str(k)))
    return flat


def unflatten_tree(flat: Mapping[str, np.ndarray]) -> Dict[str, Any]:
    """``{dotted.key: array}`` -> nested dicts, with integer segments as lists."""
    root: Dict[str, Any] = {}
    for dotted, value in flat.items():
        parts = dotted.split(".")
        node = root
        for part, nxt in zip(parts[:-1], parts[1:]):
            node = node.setdefault(part, {})
        node[parts[-1]] = value

    def listify(node):
        if not isinstance(node, dict):
            return node
        node = {k: listify(v) for k, v in node.items()}
        if node and all(k.isdigit() for k in node):
            return [node[str(i)] for i in range(len(node))]
        return node

    return listify(root)


def _is_flat(tree: Any) -> bool:
    return isinstance(tree, Mapping) and all(not isinstance(v, (Mapping, list, tuple)) for v in tree.values())


def load_jax_params(module: nn.Module, tree: Union[Mapping[str, Any], Any]) -> nn.Module:
    """Fill ``module``'s parameters from a JAX param tree (nested or flattened).

    Raises ``KeyError`` on a missing or extra key and ``ValueError`` on a
    shape mismatch; nothing is written unless every key and shape matches.
    """
    flat = dict(tree) if _is_flat(tree) else flatten_tree(tree)
    params = dict(module.named_parameters())
    missing = sorted(set(params) - set(flat))
    extra = sorted(set(flat) - set(params))
    if missing or extra:
        raise KeyError(f"param tree does not match the module: missing {missing}, extra {extra}")
    for key, p in params.items():
        shape = tuple(np.shape(flat[key]))
        if shape != tuple(p.shape):
            raise ValueError(f"{key}: the tree has shape {shape}, the module {tuple(p.shape)}")
    with torch.no_grad():
        for key, p in params.items():
            p.copy_(torch.as_tensor(np.array(flat[key]), dtype=p.dtype))
    return module


def export_jax_params(module: nn.Module) -> Dict[str, Any]:
    """The reverse direction: the module's parameters as a nested JAX-style tree of numpy arrays."""
    flat = {k: p.detach().cpu().numpy() for k, p in module.named_parameters()}
    tree = unflatten_tree(flat)
    if isinstance(getattr(module, "feature_extractors", None), nn.ModuleList):
        tree.setdefault("feature_extractors", [])
    return tree
