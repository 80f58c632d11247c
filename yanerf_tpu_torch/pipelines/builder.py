"""Registries of the pipeline stages, the config keys of the NeRF-MLP kernel switches, and the hash grid's kernels."""

from typing import Any, List

from ..utils.registry import Registry

PIPELINES = Registry("pipelines")
RAY_SAMPLERS = Registry("ray_samplers")
RENDERERS = Registry("renderers")
FEATURE_EXTRACTORS = Registry("feature_extractors")


def _models(cfg) -> dict:
    """The models of ``cfg.pipeline.model`` by their dotted keys: ``pipeline.model`` (one dict, every pass) or
    ``.<i>``."""
    model = cfg.pipeline.model
    if isinstance(model, dict):
        return {"pipeline.model": model}
    return {f"pipeline.model.{i}": m for i, m in enumerate(model)}


def nerf_mlp_keys(cfg) -> List[str]:
    """Dotted keys of the NeRFMLPs of ``cfg.pipeline.model``: ``pipeline.model`` (one dict, every pass) or ``.<i>``.

    Only ``type: NeRFMLP`` has the fused kernels (``MipNeRFMLP`` refuses
    them); a config without one has no keys.
    """
    return [key for key, m in _models(cfg).items() if m["type"] == "NeRFMLP"]


def hash_grid_kernels(cfg) -> List[str]:
    """K4 and K5, the kernels a HashGridNeRF of ``cfg`` trains on on the card (K4 alone in a frame); none without
    one. No key selects them: the device does."""
    hash_grids = any(m["type"] == "HashGridNeRF" for m in _models(cfg).values())
    return ["hash_encode_fwd", "hash_encode_bwd"] if hash_grids else []


def set_nerf_mlp_option(cfg, key: str, value: Any) -> List[str]:
    """Set ``key`` on every NeRFMLP of ``cfg`` (the kernel switches ``use_pallas`` / ``use_pallas_train``).

    Returns the dotted keys it set: none when the config has no NeRFMLP,
    whose models then run their own eager paths.
    """
    keys = [f"{prefix}.{key}" for prefix in nerf_mlp_keys(cfg)]
    cfg.merge_from_dict({k: value for k in keys})
    return keys
