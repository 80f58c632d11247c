"""The model registry."""

from ..utils.registry import Registry

MODELS = Registry("models")
