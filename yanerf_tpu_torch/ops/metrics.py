"""Per-sample view metrics (reductions happen in the runner).

Counterpart of ``yanerf_tpu/ops/metrics.py``: every loss keeps the batch
dimension, ``(B,)``. The RGB metrics, PSNR, SSIM and the depth metrics
(``eval_depth``: MSE / MAE over the pixels with a positive ground-truth
depth, optionally after the least-squares scale) against ground truth.
SSIM's Gaussian blur is written as a sum of
shifted slices, elementwise float32, so it never takes the card's TF32
convolution path (the JAX package pins that convolution to HIGHEST).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from .sampling import sample_grid

__all__ = [
    "calc_mse", "calc_psnr", "calc_ssim", "estimate_depth_scale_factor", "eval_depth", "huber", "mse2psnr",
    "rgb_metrics", "sample_grid", "view_metrics",
]


def safe_sqrt(x: torch.Tensor, eps: float = 1e-4) -> torch.Tensor:
    return torch.sqrt(torch.clamp(x, min=0.0) + eps)


def huber(dfsq: torch.Tensor, scaling: float = 0.03) -> torch.Tensor:
    """Huber-style robustification of a squared error."""
    return (safe_sqrt(1.0 + dfsq / (scaling * scaling), eps=1e-4) - 1.0) * scaling


def calc_mse(x: torch.Tensor, y: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    if mask is None:
        return torch.mean((x - y) ** 2, dim=-1)
    num = torch.sum(((x - y) ** 2) * mask, dim=-1)
    den = torch.clamp(torch.sum(mask.expand(x.shape), dim=-1), min=1e-5)
    return num / den


def calc_psnr(x: torch.Tensor, y: torch.Tensor, mask: Optional[torch.Tensor] = None, base: float = 1.0) -> torch.Tensor:
    mse = calc_mse(x, y, mask=mask)
    return torch.log10(torch.clamp(mse, min=1e-10)) * (-10.0) + 20.0 * math.log10(base)


def mse2psnr(mse: float, base: float = 1.0) -> float:
    return math.log10(max(1e-10, mse)) * (-10.0) + 20.0 * math.log10(base)


def rgb_metrics(
    images: torch.Tensor,
    images_pred: torch.Tensor,
    loss_reweight_masks: Optional[torch.Tensor] = None,
    huber_scaling: float = 0.03,
) -> Dict[str, torch.Tensor]:
    """Per-sample ``rgb_mse`` and ``rgb_huber`` over flattened pixels."""
    batch_size = images.shape[0]
    differences = (images_pred.reshape(batch_size, -1) - images.reshape(batch_size, -1)) ** 2
    if loss_reweight_masks is not None:
        differences = differences * loss_reweight_masks.reshape(batch_size, -1)
    rgb_squared = torch.mean(differences, dim=-1)
    return {"rgb_huber": huber(rgb_squared, scaling=huber_scaling), "rgb_mse": rgb_squared}


def estimate_depth_scale_factor(
    pred: torch.Tensor, gt: torch.Tensor, mask: torch.Tensor, clamp_thr: float
) -> torch.Tensor:
    """Per sample the scale ``s`` that minimises ``|mask * (gt - s * pred)|^2``, its denominator clamped below."""
    reduce_dims = tuple(range(1, pred.ndim))
    xy = torch.mean(pred * gt * mask, dim=reduce_dims)
    xx = torch.mean(pred * pred * mask, dim=reduce_dims)
    return xy / torch.clamp(xx, min=clamp_thr)


def eval_depth(
    pred: torch.Tensor,
    gt: torch.Tensor,
    crop: int = 1,
    mask: Optional[torch.Tensor] = None,
    get_best_scale: bool = True,
    mask_thr: float = 0.5,
    best_scale_clamp_thr: float = 1e-4,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-sample depth MSE and MAE, ``(B,)`` each, with optional best-scale alignment.

    ``pred`` / ``gt`` are ``(B, *spatial, 1)``; ``crop`` removes a border
    from the first two spatial dims; ``mask`` zeroes the ground truth where
    it is at most ``mask_thr``. Only pixels with a positive ground truth
    count.
    """
    if crop > 0:
        gt = gt[:, crop:-crop, crop:-crop]
        pred = pred[:, crop:-crop, crop:-crop]
        if mask is not None:
            mask = mask[:, crop:-crop, crop:-crop]
    if mask is not None:
        gt = gt * (mask > mask_thr).to(gt.dtype)
    dmask = (gt > 0.0).to(gt.dtype)
    reduce_dims = tuple(range(1, pred.ndim))
    dmask_mass = torch.clamp(torch.sum(dmask, dim=reduce_dims), min=1e-4)
    if get_best_scale:
        scale_best = estimate_depth_scale_factor(pred, gt, dmask, best_scale_clamp_thr)
        pred = pred * scale_best.reshape((-1,) + (1,) * (pred.ndim - 1))
    df = gt - pred
    mse_depth = torch.sum(dmask * (df**2), dim=reduce_dims) / dmask_mass
    abs_depth = torch.sum(dmask * torch.abs(df), dim=reduce_dims) / dmask_mass
    return mse_depth, abs_depth


def calc_ssim(
    x: torch.Tensor,
    y: torch.Tensor,
    max_val: float = 1.0,
    filter_size: int = 11,
    filter_sigma: float = 1.5,
    k1: float = 0.01,
    k2: float = 0.03,
) -> torch.Tensor:
    """Per-sample SSIM over ``(B, H, W, C)`` images (separable Gaussian window, VALID)."""
    hw = filter_size // 2
    offsets = torch.arange(filter_size, dtype=torch.float32) - hw
    kernel = torch.exp(-0.5 * (offsets / filter_sigma) ** 2)
    kernel = (kernel / torch.sum(kernel)).tolist()

    def blur(img):
        h, w = img.shape[1] - 2 * hw, img.shape[2] - 2 * hw
        rows = sum(k * img[:, :, i : i + w] for i, k in enumerate(kernel))
        return sum(k * rows[:, i : i + h] for i, k in enumerate(kernel))

    x32, y32 = x.to(torch.float32), y.to(torch.float32)
    mu_x, mu_y = blur(x32), blur(y32)
    mu_xx, mu_yy, mu_xy = mu_x * mu_x, mu_y * mu_y, mu_x * mu_y
    sigma_xx = blur(x32 * x32) - mu_xx
    sigma_yy = blur(y32 * y32) - mu_yy
    sigma_xy = blur(x32 * y32) - mu_xy
    c1, c2 = (k1 * max_val) ** 2, (k2 * max_val) ** 2
    ssim_map = ((2.0 * mu_xy + c1) * (2.0 * sigma_xy + c2)) / ((mu_xx + mu_yy + c1) * (sigma_xx + sigma_yy + c2))
    return torch.mean(ssim_map, dim=(1, 2, 3))


def view_metrics(
    image_sampling_grid: torch.Tensor,
    images: Optional[torch.Tensor] = None,
    images_pred: Optional[torch.Tensor] = None,
    depths: Optional[torch.Tensor] = None,
    depths_pred: Optional[torch.Tensor] = None,
    loss_reweight_masks: Optional[torch.Tensor] = None,
    keys_prefix: str = "loss_",
) -> Dict[str, torch.Tensor]:
    """Gather the ground truth ``(B, H, W, C)`` at the sampled pixels and compute per-sample losses.

    With depths, ``depth_abs`` is ``eval_depth``'s MAE at the best scale,
    uncropped, as in the JAX package.
    """

    def _maybe_sample(tensor):
        return None if tensor is None else sample_grid(tensor, image_sampling_grid)

    images, depths = _maybe_sample(images), _maybe_sample(depths)
    loss_reweight_masks = _maybe_sample(loss_reweight_masks)
    preds: Dict[str, torch.Tensor] = {}
    if images is not None and images_pred is not None:
        preds.update(rgb_metrics(images, images_pred, loss_reweight_masks))
        # SSIM only on full image grids (FULL_GRID eval); MC samples are (B, N, 1, C)
        if images_pred.ndim == 4 and images_pred.shape[1] >= 11 and images_pred.shape[2] >= 11:
            preds["rgb_ssim"] = calc_ssim(images_pred, images)
    if depths is not None and depths_pred is not None:
        _, abs_depth = eval_depth(depths_pred, depths, get_best_scale=True, mask=None, crop=0)
        preds["depth_abs"] = abs_depth
    if keys_prefix is not None:
        preds = {keys_prefix + k: v for k, v in preds.items()}
    return preds
