"""Registries of the pipeline stages."""

from ..utils.registry import Registry

PIPELINES = Registry("pipelines")
RAY_SAMPLERS = Registry("ray_samplers")
RENDERERS = Registry("renderers")
FEATURE_EXTRACTORS = Registry("feature_extractors")
