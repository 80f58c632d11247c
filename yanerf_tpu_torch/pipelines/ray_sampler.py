"""Camera -> RayBundle sampling stage.

Counterpart of ``yanerf_tpu/pipelines/ray_sampler.py``: the full-grid
EVALUATION half (every pixel, metric depths between the bounds) and the
Monte-Carlo TRAINING half with ``pixel_replacement`` and no mask (uniform
pixel indices drawn with replacement, stratified depth jitter). The pixel
indices and the jitter draws are optional inputs (``pixel_idx``,
``strata_u``), else drawn from ``generator``. Sampling without replacement,
masks and sampling-probability masks, NDC, ``scene_aabb``, occupancy
grids, disparity spacing and scene-extent bounds raise
``NotImplementedError`` until later slices.

As in the reference, the principal point comes from the constructor's
``image_width/height`` even when a call overrides the grid size.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from ..ops.rays import get_xy_grid, xy_to_ray_bundle
from ..ops.sampling import uniform_sample_with_replacement
from ..ops.structures import EvaluationMode, RayBundle, RenderSamplingMode
from .builder import RAY_SAMPLERS


class _RaySampler:
    """One sampling configuration (the train/eval halves of ``RaySampler``)."""

    def __init__(
        self,
        *,
        image_width: int,
        image_height: int,
        n_pts_per_ray: int,
        min_depth: float,
        max_depth: float,
        n_rays_per_image: Optional[int] = None,
        stratified_sampling: bool = False,
        pixel_replacement: bool = False,
    ) -> None:
        self.image_width = image_width
        self.image_height = image_height
        self.n_pts_per_ray = n_pts_per_ray
        self.min_depth = min_depth
        self.max_depth = max_depth
        self.n_rays_per_image = n_rays_per_image
        self.stratified_sampling = stratified_sampling
        self.pixel_replacement = pixel_replacement

    def __call__(
        self,
        poses: torch.Tensor,
        focal_lengths: torch.Tensor,
        *,
        image_height: Optional[int] = None,
        image_width: Optional[int] = None,
        min_depth=None,
        max_depth=None,
        generator: Optional[torch.Generator] = None,
        pixel_idx: Optional[torch.Tensor] = None,
        strata_u: Optional[torch.Tensor] = None,
    ) -> RayBundle:
        batch_size = poses.shape[0]
        if image_height is None or image_width is None:
            image_height, image_width = self.image_height, self.image_width
        xy_grid = get_xy_grid(image_height, image_width, device=poses.device).expand(
            batch_size, image_height, image_width, 2
        )
        if self.n_rays_per_image is not None:
            if not self.pixel_replacement:
                raise NotImplementedError(
                    "pixel sampling without replacement is not ported yet: set ray_sampler.pixel_replacement=True"
                )
            if pixel_idx is None:
                pixel_idx = uniform_sample_with_replacement(
                    batch_size, image_height * image_width, self.n_rays_per_image, generator, poses.device
                )
            xy_flat = xy_grid.reshape(batch_size, -1, 2)
            xy_grid = torch.gather(xy_flat, 1, pixel_idx.to(torch.int64)[..., None].expand(-1, -1, 2))[:, :, None]
        return xy_to_ray_bundle(
            poses[:, :3, :4],
            self.image_width,
            self.image_height,
            focal_lengths,
            xy_grid,
            min_depth if min_depth is not None else self.min_depth,
            max_depth if max_depth is not None else self.max_depth,
            self.n_pts_per_ray,
            self.stratified_sampling,
            generator=generator,
            strata_u=strata_u,
        )


@RAY_SAMPLERS.register_module()
class RaySampler:
    def __init__(
        self,
        image_width: int = 400,
        image_height: int = 400,
        scene_center: Tuple[float, float, float] = (0.0, 0.0, 0.0),
        scene_extent: float = 0.0,
        sampling_mode_training: str = "mask_sample",
        sampling_mode_evaluation: str = "full_grid",
        n_pts_per_ray_training: int = 64,
        n_pts_per_ray_evaluation: int = 64,
        n_rays_per_image_sampled_from_mask: int = 1024,
        min_depth: float = 0.1,
        max_depth: float = 8.0,
        stratified_point_sampling_training: bool = True,
        stratified_point_sampling_evaluation: bool = False,
        approx_top_k: bool = False,
        pixel_replacement: bool = False,
        use_ndc: bool = False,
        ndc_near: float = 1.0,
        sample_in_disparity: bool = False,
        scene_aabb: Optional[List[float]] = None,
        scene_aabb_eval_only: bool = False,
        occupancy_grid: Optional[str] = None,
        **occupancy_options,
    ) -> None:
        if use_ndc or sample_in_disparity or scene_aabb is not None or occupancy_grid is not None:
            raise NotImplementedError(
                "NDC, disparity spacing, scene_aabb and occupancy grids are not ported yet (ROADMAP.md Queue 1 item 11)"
            )
        if scene_extent > 0.0:
            raise NotImplementedError("scene-extent depth bounds are not ported yet (ROADMAP.md Queue 1 item 2)")
        self.image_width = image_width
        self.image_height = image_height
        self._sampling_mode = {
            EvaluationMode.TRAINING: RenderSamplingMode(sampling_mode_training),
            EvaluationMode.EVALUATION: RenderSamplingMode(sampling_mode_evaluation),
        }
        self._raysamplers = {
            mode: _RaySampler(
                image_width=image_width,
                image_height=image_height,
                n_pts_per_ray=n_pts,
                min_depth=min_depth,
                max_depth=max_depth,
                n_rays_per_image=(
                    n_rays_per_image_sampled_from_mask
                    if self._sampling_mode[mode] == RenderSamplingMode.MASK_SAMPLE
                    else None
                ),
                stratified_sampling=stratified,
                pixel_replacement=pixel_replacement,
            )
            for mode, n_pts, stratified in (
                (EvaluationMode.TRAINING, n_pts_per_ray_training, stratified_point_sampling_training),
                (EvaluationMode.EVALUATION, n_pts_per_ray_evaluation, stratified_point_sampling_evaluation),
            )
        }

    def sampling_mode(self, evaluation_mode: EvaluationMode) -> RenderSamplingMode:
        return self._sampling_mode[evaluation_mode]

    def __call__(
        self,
        poses: torch.Tensor,
        focal_lengths: torch.Tensor,
        evaluation_mode: EvaluationMode,
        *,
        image_height: Optional[int] = None,
        image_width: Optional[int] = None,
        min_depth=None,
        max_depth=None,
        generator: Optional[torch.Generator] = None,
        pixel_idx: Optional[torch.Tensor] = None,
        strata_u: Optional[torch.Tensor] = None,
    ) -> RayBundle:
        """Rays of ``evaluation_mode``; ``pixel_idx`` ``(B, n_rays)`` and ``strata_u`` replace the draws."""
        return self._raysamplers[evaluation_mode](
            poses,
            focal_lengths,
            image_height=image_height,
            image_width=image_width,
            min_depth=min_depth,
            max_depth=max_depth,
            generator=generator,
            pixel_idx=pixel_idx,
            strata_u=strata_u,
        )
