"""Pipeline stages of the port: ray sampler, renderer, feature extractors, NeRFPipeline."""

from __future__ import annotations

from .builder import FEATURE_EXTRACTORS, PIPELINES, RAY_SAMPLERS, RENDERERS, nerf_mlp_keys, set_nerf_mlp_option
from .feature_extractors import IdentityMapper, LearnedSceneEmbedding
from .nerf_pipeline import NeRFPipeline
from .ray_sampler import RaySampler
from .renderer import MultipassEmissionAbsorpsionRenderer, ProposalEmissionAbsorpsionRenderer, refine_ray_points

__all__ = [
    "FEATURE_EXTRACTORS",
    "PIPELINES",
    "RAY_SAMPLERS",
    "RENDERERS",
    "IdentityMapper",
    "LearnedSceneEmbedding",
    "MultipassEmissionAbsorpsionRenderer",
    "NeRFPipeline",
    "ProposalEmissionAbsorpsionRenderer",
    "RaySampler",
    "nerf_mlp_keys",
    "refine_ray_points",
    "set_nerf_mlp_option",
]
