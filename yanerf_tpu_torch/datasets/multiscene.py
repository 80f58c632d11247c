"""Multi-scene Blender dataset: concatenated scenes and a per-item ``scene_id``.

Counterpart of ``yanerf_tpu/datasets/multiscene.py``, the data of latent
conditioning: each item is a Blender frame plus the integer ``scene_id``
that ``LearnedSceneEmbedding`` maps to its row of trainable codes.
``base_dir/scene_{k}/`` are Blender-format scenes (``synth_multiscene.py``),
each loadable on its own by ``BlenderDataset``; they are concatenated in
numeric order and may differ in length.
"""

from __future__ import annotations

from pathlib import Path
from typing import Callable, NamedTuple, Tuple

import numpy as np

from .blender import BlenderDataset
from .builder import DATASETS


class MultiSceneBlenderWrapper(NamedTuple):
    poses: np.ndarray
    focal_lengths: np.ndarray
    image_rgb: np.ndarray
    scene_id: np.ndarray


@DATASETS.register_module()
class MultiSceneBlenderDataset:
    data_wrapper: Callable = MultiSceneBlenderWrapper

    def __init__(self, base_dir, split, scale_down=1, test_skip=8, n_scenes=None, debug=False):
        base = Path(base_dir)
        scene_dirs = sorted((p for p in base.glob("scene_*") if p.is_dir()), key=lambda p: int(p.name.split("_", 1)[1]))
        if n_scenes is not None:
            scene_dirs = scene_dirs[: int(n_scenes)]
        if not scene_dirs:
            raise FileNotFoundError(f"No scene_* subdirectories under {base_dir}")
        self.scenes = [
            BlenderDataset(str(d), split, scale_down=scale_down, test_skip=test_skip, debug=debug) for d in scene_dirs
        ]
        self.n_scenes = len(self.scenes)
        # flat index -> (scene, local index); scenes may have unequal lengths
        self._index = [(s, i) for s, scene in enumerate(self.scenes) for i in range(len(scene))]

    def __getitem__(self, index: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        s, i = self._index[index]
        pose, focal, image = self.scenes[s][i]
        return pose, focal, image, np.asarray(s, dtype=np.int32)

    def __len__(self) -> int:
        return len(self._index)
