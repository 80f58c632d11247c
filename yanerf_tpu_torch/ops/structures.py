"""Core value types shared across the compute path.

Counterpart of ``yanerf_tpu/ops/structures.py``: the same enums and
``RayBundle``; ``RendererOutput`` is a plain dataclass (PyTorch needs no
pytree registration).
"""

from __future__ import annotations

import dataclasses
from enum import Enum
from typing import Any, Dict, NamedTuple, Optional

import torch


class EvaluationMode(Enum):
    TRAINING = "training"
    EVALUATION = "evaluation"


class RenderSamplingMode(Enum):
    MASK_SAMPLE = "mask_sample"
    FULL_GRID = "full_grid"


class RayBundle(NamedTuple):
    """A bundle of rays: origins/directions (..., 3), lengths (..., P), xys (..., 2)."""

    origins: torch.Tensor
    directions: torch.Tensor
    lengths: torch.Tensor
    xys: torch.Tensor


@dataclasses.dataclass
class RendererOutput:
    """Output of a renderer pass; ``prev_stage`` chains coarse passes.

    Args:
        features: rendered features (usually RGB), ``(B, ..., C)``.
        depths: ray-termination depth map, ``(B, ..., 1)``.
        alpha_masks: rendered opacity in [0, 1], ``(B, ..., 1)``.
        prev_stage: output of the previous (coarser) pass, if any.
        aux: implementation-specific extras (e.g. marching weights).
    """

    features: torch.Tensor
    depths: torch.Tensor
    alpha_masks: torch.Tensor
    prev_stage: Optional["RendererOutput"] = None
    aux: Dict[str, Any] = dataclasses.field(default_factory=dict)
