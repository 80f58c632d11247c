"""Feature extractor stage (counterpart of ``yanerf_tpu/pipelines/feature_extractors.py``)."""

from __future__ import annotations

from typing import Any, Dict

import torch.nn as nn

from .builder import FEATURE_EXTRACTORS


@FEATURE_EXTRACTORS.register_module()
class IdentityMapper(nn.Module):
    """Pass extra batch kwargs through unchanged."""

    def __init__(self, generator=None) -> None:
        super().__init__()

    def forward(self, **kwargs) -> Dict[str, Any]:
        return kwargs
