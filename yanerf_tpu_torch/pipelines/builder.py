"""Registries of the pipeline stages, and the config keys of the NeRF-MLP kernel switches."""

from typing import Any, List

from ..utils.registry import Registry

PIPELINES = Registry("pipelines")
RAY_SAMPLERS = Registry("ray_samplers")
RENDERERS = Registry("renderers")
FEATURE_EXTRACTORS = Registry("feature_extractors")


def nerf_mlp_keys(cfg) -> List[str]:
    """Dotted keys of the NeRFMLPs of ``cfg.pipeline.model``: ``pipeline.model`` (one dict, every pass) or ``.<i>``.

    Only ``type: NeRFMLP`` has the fused kernels (``MipNeRFMLP`` refuses
    them); a config without one has no keys.
    """
    model = cfg.pipeline.model
    if isinstance(model, dict):
        models = {"pipeline.model": model}
    else:
        models = {f"pipeline.model.{i}": m for i, m in enumerate(model)}
    return [key for key, m in models.items() if m["type"] == "NeRFMLP"]


def set_nerf_mlp_option(cfg, key: str, value: Any) -> List[str]:
    """Set ``key`` on every NeRFMLP of ``cfg`` (the kernel switches ``use_pallas`` / ``use_pallas_train``).

    Returns the dotted keys it set: none when the config has no NeRFMLP,
    whose models then run their own eager paths.
    """
    keys = [f"{prefix}.{key}" for prefix in nerf_mlp_keys(cfg)]
    cfg.merge_from_dict({k: value for k in keys})
    return keys
