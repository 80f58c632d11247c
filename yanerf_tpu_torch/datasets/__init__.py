"""Datasets and loaders of the port."""

from .blender import CAM_CALIBRATION, BlenderDataset, BlenderDatasetWrapper
from .builder import DATASETS
from .llff import LLFFDataset, LLFFDatasetWrapper
from .loader import (
    DataLoader,
    DeviceCachedLoader,
    ShardedEpochSampler,
    create_loader,
    create_sampler,
    decode_cached_field,
    stack_batch,
)
from .multiscene import MultiSceneBlenderDataset, MultiSceneBlenderWrapper

__all__ = [
    "CAM_CALIBRATION",
    "DATASETS",
    "BlenderDataset",
    "BlenderDatasetWrapper",
    "DataLoader",
    "DeviceCachedLoader",
    "LLFFDataset",
    "LLFFDatasetWrapper",
    "MultiSceneBlenderDataset",
    "MultiSceneBlenderWrapper",
    "ShardedEpochSampler",
    "create_loader",
    "create_sampler",
    "decode_cached_field",
    "stack_batch",
]
