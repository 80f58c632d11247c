"""Camera -> RayBundle sampling stage.

Counterpart of ``yanerf_tpu/pipelines/ray_sampler.py``: the full-grid
EVALUATION half (every pixel) and the Monte-Carlo TRAINING half without a
mask, stratified depth jitter and uniform pixel indices, drawn with
replacement (``pixel_replacement``) or without (the Gumbel top-k over one
weight of 1 per pixel, the exact ``topk``). The pixel indices and the
jitter draws are optional inputs (``pixel_idx``, ``strata_u``), else
drawn from ``generator``. The depth range is the call's bounds (a batch's
per-image ``min_depth`` / ``max_depth``), else the constructor's, else,
with ``scene_extent > 0``, the cameras' distance to ``scene_center`` +-
the extent; depths are spaced in depth or in disparity
(``sample_in_disparity``), tightened per ray to ``scene_aabb`` (in both
modes, or at evaluation only with ``scene_aabb_eval_only``). ``use_ndc``
forces the range to [0, 1] and warps the sampled rays into NDC
(``ndc_near``). An occupancy grid (``occupancy_grid``, the ``.npz`` of
``fit_occupancy.py``) tightens each ray's range further to the occupied
span along it, at evaluation only unless ``occupancy_eval_only`` is off:
the exact march (``occupancy_coarse_factor`` and ``occupancy_block`` both
1, ``occupancy_n_probe`` probes) or, by default, the coarse-to-fine march
on a decimated image (``ops/occupancy.py::OccupancyBoundsSpec``). The grids
reach a device once, at the first call there, and are reused (also by a
captured step). The approximate
top-k (``approx_top_k``), masks and sampling-probability masks raise
``NotImplementedError``.

As in the reference, the principal point comes from the constructor's
``image_width/height`` even when a call overrides the grid size.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from ..ops.occupancy import OccupancyBoundsSpec, coarsen_occupancy, load_occupancy, occupancy_on_device
from ..ops.rays import get_min_max_depth_bounds, get_xy_grid, ndc_ray_bundle, xy_to_ray_bundle
from ..utils import device_constant
from ..ops.sampling import uniform_sample_with_replacement, weighted_sample_without_replacement
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
        approx_top_k: bool = False,
        sample_in_disparity: bool = False,
        scene_aabb: Optional[np.ndarray] = None,
        occupancy=None,
        occupancy_n_probe: int = 128,
    ) -> None:
        self.image_width = image_width
        self.image_height = image_height
        self.n_pts_per_ray = n_pts_per_ray
        self.min_depth = min_depth
        self.max_depth = max_depth
        self.n_rays_per_image = n_rays_per_image
        self.stratified_sampling = stratified_sampling
        self.pixel_replacement = pixel_replacement
        self.approx_top_k = approx_top_k
        self.sample_in_disparity = sample_in_disparity
        self.scene_aabb = scene_aabb
        self.occupancy = occupancy
        self.occupancy_n_probe = occupancy_n_probe
        self._occupancy_on = {}  # device -> the grids there

    def occupancy_on(self, device: torch.device):
        """The occupancy grid or spec with its grids on ``device``, moved there at the first call."""
        if self.occupancy is None:
            return None
        if device not in self._occupancy_on:
            self._occupancy_on[device] = occupancy_on_device(self.occupancy, device)
        return self._occupancy_on[device]

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
            n_pixels = image_height * image_width
            if pixel_idx is None and self.pixel_replacement:
                pixel_idx = uniform_sample_with_replacement(
                    batch_size, n_pixels, self.n_rays_per_image, generator, poses.device
                )
            elif pixel_idx is None:
                weights = torch.ones((batch_size, n_pixels), dtype=torch.float32, device=poses.device)
                pixel_idx = weighted_sample_without_replacement(
                    weights, self.n_rays_per_image, generator, approx=self.approx_top_k
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
            sample_in_disparity=self.sample_in_disparity,
            scene_aabb=self.scene_aabb,
            occupancy=self.occupancy_on(poses.device),
            occupancy_n_probe=self.occupancy_n_probe,
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
        occupancy_n_probe: int = 128,
        occupancy_eval_only: bool = True,
        occupancy_coarse_factor: int = 4,
        occupancy_n_probe_coarse: int = 32,
        occupancy_n_probe_fine: int = 64,
        occupancy_block: int = 2,
    ) -> None:
        if scene_aabb is not None:
            if use_ndc:
                raise ValueError("scene_aabb cannot be combined with use_ndc (NDC depth is not metric)")
            scene_aabb = np.asarray(scene_aabb, np.float32).reshape(2, 3)
            if not (scene_aabb[0] < scene_aabb[1]).all():
                raise ValueError(f"scene_aabb must satisfy min < max per axis, got {scene_aabb.tolist()}")

        self.image_width = image_width
        self.image_height = image_height
        self.scene_center = tuple(scene_center)
        self.scene_extent = scene_extent
        self.use_ndc = use_ndc
        self.ndc_near = ndc_near
        # eval-only by default: the grid holds for the density field it was fitted to
        self.occupancy = None
        if occupancy_grid is not None:
            if use_ndc:
                raise ValueError("occupancy_grid cannot be combined with use_ndc (NDC depth is not metric)")
            grid = load_occupancy(occupancy_grid)
            if int(occupancy_coarse_factor) <= 1 and int(occupancy_block) <= 1:
                self.occupancy = grid  # the exact single-stage march
            else:
                self.occupancy = OccupancyBoundsSpec(
                    grid=grid,
                    coarse=coarsen_occupancy(grid, int(occupancy_coarse_factor)) if int(occupancy_coarse_factor) > 1
                    else None,
                    n_probe=int(occupancy_n_probe_fine),
                    n_probe_coarse=int(occupancy_n_probe_coarse),
                    block=int(occupancy_block),
                )
        self.occupancy_n_probe = int(occupancy_n_probe)
        self.occupancy_eval_only = bool(occupancy_eval_only)
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
                approx_top_k=approx_top_k,
                sample_in_disparity=sample_in_disparity,
                scene_aabb=None if scene_aabb_eval_only and mode == EvaluationMode.TRAINING else scene_aabb,
                occupancy=None if self.occupancy_eval_only and mode == EvaluationMode.TRAINING else self.occupancy,
                occupancy_n_probe=self.occupancy_n_probe,
            )
            for mode, n_pts, stratified in (
                (EvaluationMode.TRAINING, n_pts_per_ray_training, stratified_point_sampling_training),
                (EvaluationMode.EVALUATION, n_pts_per_ray_evaluation, stratified_point_sampling_evaluation),
            )
        }

    def sampling_mode(self, evaluation_mode: EvaluationMode) -> RenderSamplingMode:
        return self._sampling_mode[evaluation_mode]

    def sampler(self, evaluation_mode: EvaluationMode) -> _RaySampler:
        """The sampling configuration of ``evaluation_mode`` (rays per image, points, jitter, pixel draws)."""
        return self._raysamplers[evaluation_mode]

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
        if self.use_ndc:
            # the NDC parameter spans [0, 1] from the near plane to infinity; metric bounds do not apply
            min_depth, max_depth = 0.0, 1.0
        elif min_depth is None and max_depth is None and self.scene_extent > 0.0:
            center = device_constant(("scene_center", self.scene_center), lambda: self.scene_center, poses.dtype,
                                     poses.device)
            min_depth, max_depth = get_min_max_depth_bounds(poses, center, self.scene_extent)
        bundle = self._raysamplers[evaluation_mode](
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
        if self.use_ndc:
            bundle = ndc_ray_bundle(bundle, self.image_width, self.image_height, focal_lengths, near=self.ndc_near)
        return bundle
