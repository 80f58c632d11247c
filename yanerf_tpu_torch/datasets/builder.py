"""The dataset registry."""

from ..utils.registry import Registry

DATASETS = Registry("datasets")
