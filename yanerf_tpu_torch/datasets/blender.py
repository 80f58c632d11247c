"""NeRF-synthetic (Blender) dataset.

Counterpart of ``yanerf_tpu/datasets/blender.py``: reads
``transforms_{split}.json``; the focal length from ``camera_angle_x``
(``0.5 * W / tan(0.5 * angle)``); val/test keep every ``test_skip``-th
frame; camera-to-world poses right-multiplied by the z/y-flip calibration.
Items are ``(pose 4x4, focal (1,), image (H, W, 3) in [0, 1])``, all
float32, and ``data_wrapper`` names the pipeline's keyword arguments. PNGs
are decoded by ``utils/images.py``. ``scale_down`` (32 with ``debug``)
divides the size and the focal length, and the images are resized as
``cv2.INTER_LINEAR`` resizes them (``utils/images.resize_linear``).
"""

from __future__ import annotations

import json
import logging
from pathlib import Path
from typing import Callable, NamedTuple, Tuple

import numpy as np

from ..utils.images import load_image, resize_linear
from .builder import DATASETS

logger = logging.getLogger(__name__)

# Flip y/z axes: OpenGL-style camera (z into screen) -> world (z out).
CAM_CALIBRATION = np.diag(np.array([1.0, -1.0, -1.0, 1.0], dtype=np.float32))


class BlenderDatasetWrapper(NamedTuple):
    poses: np.ndarray
    focal_lengths: np.ndarray
    image_rgb: np.ndarray


@DATASETS.register_module()
class BlenderDataset:
    data_wrapper: Callable = BlenderDatasetWrapper

    def __init__(self, base_dir, split, scale_down=1, test_skip=8, debug=False):
        if split not in ("train", "val", "test"):
            raise ValueError(f"Invalid split: {split}.")
        self.base_dir = Path(base_dir)
        self.split = split
        with open(self.base_dir / f"transforms_{split}.json") as fp:
            meta = json.load(fp)
        self.frames = meta["frames"]
        if split in ("val", "test"):
            logger.info(f"test_skip = {test_skip}")
            self.frames = self.frames[::test_skip]
        first_img = load_image(self.base_dir / f"{self.frames[0]['file_path']}.png")
        height, width = first_img.shape[:2]
        focal = 0.5 * width / np.tan(0.5 * float(meta["camera_angle_x"]))
        if debug:
            scale_down = 32
            logger.info(f"[DEBUG] scale_down {height}x{width} -> {height // scale_down}x{width // scale_down}")
        # isinstance first (a str would fail the comparison itself); 0 is as invalid as a negative factor
        if not isinstance(scale_down, (int, float)) or scale_down <= 0:
            raise TypeError(f"Invalid scale_down: {scale_down!r} (want a number > 0).")
        self.H = int(height // scale_down)
        self.W = int(width // scale_down)
        self.focal = focal / scale_down
        self.scale_down = scale_down

    def __getitem__(self, index: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        frame = self.frames[index]
        pose = np.asarray(frame["transform_matrix"], dtype=np.float32) @ CAM_CALIBRATION
        image = load_image(self.base_dir / f"{frame['file_path']}.png")
        if self.scale_down != 1:
            image = resize_linear(image, (self.W, self.H))
        return pose, np.asarray([self.focal], dtype=np.float32), image.astype(np.float32)

    def __len__(self) -> int:
        return len(self.frames)
