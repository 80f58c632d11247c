"""Datasets and loaders of the port."""

from ..utils.registry import register_not_ported
from .blender import CAM_CALIBRATION, BlenderDataset, BlenderDatasetWrapper
from .builder import DATASETS
from .loader import (
    DataLoader,
    DeviceCachedLoader,
    ShardedEpochSampler,
    create_loader,
    create_sampler,
    decode_cached_field,
    stack_batch,
)

register_not_ported(DATASETS, ("LLFFDataset", "MultiSceneBlenderDataset"))

__all__ = [
    "CAM_CALIBRATION",
    "DATASETS",
    "BlenderDataset",
    "BlenderDatasetWrapper",
    "DataLoader",
    "DeviceCachedLoader",
    "ShardedEpochSampler",
    "create_loader",
    "create_sampler",
    "decode_cached_field",
    "stack_batch",
]
