"""Pipeline stages of the port: ray sampler, renderer, feature extractors, NeRFPipeline."""

from __future__ import annotations

from ..utils.registry import register_not_ported
from .builder import FEATURE_EXTRACTORS, PIPELINES, RAY_SAMPLERS, RENDERERS
from .feature_extractors import IdentityMapper
from .nerf_pipeline import NeRFPipeline
from .ray_sampler import RaySampler
from .renderer import ProposalEmissionAbsorpsionRenderer, refine_ray_points

register_not_ported(RENDERERS, ("MultipassEmissionAbsorpsionRenderer",))
register_not_ported(FEATURE_EXTRACTORS, ("LearnedSceneEmbedding",))

__all__ = [
    "FEATURE_EXTRACTORS",
    "PIPELINES",
    "RAY_SAMPLERS",
    "RENDERERS",
    "IdentityMapper",
    "NeRFPipeline",
    "ProposalEmissionAbsorpsionRenderer",
    "RaySampler",
    "refine_ray_points",
]
