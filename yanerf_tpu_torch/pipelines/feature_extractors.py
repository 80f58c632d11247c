"""Feature extractor stage (counterpart of ``yanerf_tpu/pipelines/feature_extractors.py``).

An extractor maps the batch's extra keyword arguments to a dict of
conditioning tensors; the pipeline stacks the tensor outputs of several
extractors on dim 1 (``NeRFPipeline.extract_features``).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn as nn

from .builder import FEATURE_EXTRACTORS


@FEATURE_EXTRACTORS.register_module()
class IdentityMapper(nn.Module):
    """Pass extra batch kwargs through unchanged."""

    def __init__(self, generator=None) -> None:
        super().__init__()

    def forward(self, **kwargs) -> Dict[str, Any]:
        return kwargs


@FEATURE_EXTRACTORS.register_module()
class LearnedSceneEmbedding(nn.Module):
    """Trainable per-scene latent codes gathered by the batch's ``scene_id``.

    The auto-decoder pattern: ``codes`` is an ``(n_scenes, latent_dim)``
    parameter, drawn from N(0, ``init_scale``^2), trained with the models;
    ``forward(scene_id=...)`` returns ``{"global_codes": codes[scene_id]}``,
    which the models concatenate onto their embeddings. The gather is one
    ``index_select`` on the device index: no host value, no range check, so
    a captured train step runs it.
    """

    def __init__(self, n_scenes: int, latent_dim: int, init_scale: float = 0.01,
                 generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        if n_scenes <= 0 or latent_dim <= 0:
            raise ValueError(f"n_scenes and latent_dim must be positive, got {n_scenes}, {latent_dim}")
        self.n_scenes = int(n_scenes)
        self.latent_dim = int(latent_dim)
        self.init_scale = float(init_scale)
        codes = torch.randn((self.n_scenes, self.latent_dim), generator=generator, dtype=torch.float32)
        self.codes = nn.Parameter(self.init_scale * codes)

    def forward(self, scene_id: Optional[torch.Tensor] = None, **kwargs) -> Dict[str, Any]:
        if scene_id is None:
            raise ValueError(
                "LearnedSceneEmbedding requires a scene_id batch kwarg "
                "(e.g. from MultiSceneBlenderDataset)"
            )
        idx = torch.as_tensor(scene_id, device=self.codes.device).reshape(-1)  # (B,)
        return {"global_codes": self.codes.index_select(0, idx)}
