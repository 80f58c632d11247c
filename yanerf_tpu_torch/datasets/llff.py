"""LLFF forward-facing / spherified-360 dataset.

Counterpart of ``yanerf_tpu/datasets/llff.py``, with its own copy of the
numpy pose math:
  * ``poses_bounds.npy`` holds per-image 3x5 ``[R | t | hwf]`` matrices in
    LLFF's ``[down, right, back]`` axis order plus near/far depth bounds;
  * the axes are reordered to ``[right, up, back]``, translations and
    bounds rescaled by ``1 / (bds.min() * bd_factor)``;
  * optional recentering about the average camera;
  * ``spherify`` re-orients a 360 capture about the point nearest every
    camera axis and makes a circular render path; otherwise a spiral path
    around the average pose (``path_zflat``: one flat turn);
  * the holdout: every ``test_skip``-th image is val/test, the rest train;
    ``test_skip <= 0`` holds out the view nearest the average pose;
  * items are ``(pose @ CAM_CALIBRATION, focal (1,), image, min_depth (1,),
    max_depth (1,))``: per-image metric bounds the ray sampler reads.

``factor`` / ``width`` / ``height`` read (and first write, when missing)
the ``images_{factor}/`` or ``images_{W}x{H}/`` cache of PNGs, resized
with ``utils/images.py::resize_area``, the JAX package's ``cv2.INTER_AREA``
byte for byte. The sources may be PNG or JPEG (real LLFF and 360 captures
ship ``.JPG``): JPEGs are decoded by the port's own baseline decoder
(``yanerf_tpu_torch/native``), which equals the JAX package's libjpeg
decode. Image shapes come from the file headers, turned by a JPEG's EXIF
orientation as the JAX loader's ``cv2.imread`` returns them; the pixels are
decoded unturned, as its ``cv2.IMREAD_UNCHANGED`` and ``native`` reads are.
"""

from __future__ import annotations

import logging
import os
import os.path as osp
from typing import Callable, NamedTuple, Tuple

import numpy as np

from ..utils.images import image_shape, load_image, load_image_u8, png_bytes, resize_area
from .blender import CAM_CALIBRATION
from .builder import DATASETS

logger = logging.getLogger(__name__)

_IMG_EXTS = ("JPG", "jpg", "png", "jpeg", "PNG")


class LLFFDatasetWrapper(NamedTuple):
    poses: np.ndarray
    focal_lengths: np.ndarray
    image_rgb: np.ndarray
    min_depth: np.ndarray
    max_depth: np.ndarray


def normalize(x: np.ndarray) -> np.ndarray:
    return x / np.linalg.norm(x)


def viewmatrix(z: np.ndarray, up: np.ndarray, pos: np.ndarray) -> np.ndarray:
    vec2 = normalize(z)
    vec0 = normalize(np.cross(up, vec2))
    vec1 = normalize(np.cross(vec2, vec0))
    return np.stack([vec0, vec1, vec2, pos], axis=1)


def poses_avg(poses: np.ndarray) -> np.ndarray:
    hwf = poses[0, :3, -1:]
    center = poses[:, :3, 3].mean(0)
    vec2 = normalize(poses[:, :3, 2].sum(0))
    up = poses[:, :3, 1].sum(0)
    return np.concatenate([viewmatrix(vec2, up, center), hwf], axis=1)


def recenter_poses(poses: np.ndarray) -> np.ndarray:
    """Express all poses relative to the average camera pose."""
    out = poses.copy()
    bottom = np.array([[0, 0, 0, 1.0]], dtype=poses.dtype)
    c2w = np.concatenate([poses_avg(poses)[:3, :4], bottom], axis=0)
    poses_h = np.concatenate([poses[:, :3, :4], np.broadcast_to(bottom, (poses.shape[0], 1, 4))], axis=1)
    out[:, :3, :4] = (np.linalg.inv(c2w) @ poses_h)[:, :3, :4]
    return out


def render_path_spiral(c2w, up, rads, focal, zdelta, zrate, rots, n_views):
    """Spiral of camera poses around the average pose, looking at the focal depth."""
    render_poses = []
    rads = np.array(list(rads) + [1.0])
    hwf = c2w[:, 4:5]
    for theta in np.linspace(0.0, 2.0 * np.pi * rots, int(n_views) + 1)[:-1]:
        c = c2w[:3, :4] @ (np.array([np.cos(theta), -np.sin(theta), -np.sin(theta * zrate), 1.0]) * rads)
        z = normalize(c - c2w[:3, :4] @ np.array([0, 0, -focal, 1.0]))
        render_poses.append(np.concatenate([viewmatrix(z, up, c), hwf], axis=1))
    return render_poses


def spherify_poses(poses: np.ndarray, bds: np.ndarray):
    """Re-orient a 360 capture about the point nearest all camera axes.

    Returns (reset poses, circular render path, rescaled bounds).
    """

    def add_row(p):
        bottom = np.broadcast_to(np.eye(4, dtype=p.dtype)[-1:], (p.shape[0], 1, 4))
        return np.concatenate([p, bottom], axis=1)

    rays_d = poses[:, :3, 2:3]
    rays_o = poses[:, :3, 3:4]

    # the least-squares point nearest every camera's optical axis
    a_i = np.eye(3) - rays_d * np.transpose(rays_d, (0, 2, 1))
    b_i = -a_i @ rays_o
    pt_mindist = np.squeeze(-np.linalg.inv((np.transpose(a_i, (0, 2, 1)) @ a_i).mean(0)) @ b_i.mean(0))

    center = pt_mindist
    up = (poses[:, :3, 3] - center).mean(0)
    vec0 = normalize(up)
    vec1 = normalize(np.cross([0.1, 0.2, 0.3], vec0))
    vec2 = normalize(np.cross(vec0, vec1))
    c2w = np.stack([vec1, vec2, vec0, center], axis=1)

    poses_reset = np.linalg.inv(add_row(c2w[None])) @ add_row(poses[:, :3, :4])

    rad = np.sqrt(np.mean(np.sum(np.square(poses_reset[:, :3, 3]), -1)))
    sc = 1.0 / rad
    poses_reset[:, :3, 3] *= sc
    bds = bds * sc
    rad *= sc

    centroid = np.mean(poses_reset[:, :3, 3], 0)
    zh = centroid[2]
    radcircle = np.sqrt(rad ** 2 - zh ** 2)

    new_poses = []
    for th in np.linspace(0.0, 2.0 * np.pi, 120):
        camorigin = np.array([radcircle * np.cos(th), radcircle * np.sin(th), zh])
        up = np.array([0, 0, -1.0])
        vec2 = normalize(camorigin)
        vec0 = normalize(np.cross(vec2, up))
        vec1 = normalize(np.cross(vec2, vec0))
        new_poses.append(np.stack([vec0, vec1, vec2, camorigin], axis=1))
    new_poses = np.stack(new_poses, 0)

    hwf = poses[0, :3, -1:]
    new_poses = np.concatenate([new_poses, np.broadcast_to(hwf, new_poses[:, :3, -1:].shape)], axis=-1)
    poses_reset = np.concatenate(
        [poses_reset[:, :3, :4], np.broadcast_to(hwf, poses_reset[:, :3, -1:].shape)], axis=-1
    )
    return poses_reset, new_poses, bds


@DATASETS.register_module()
class LLFFDataset:
    data_wrapper: Callable = LLFFDatasetWrapper

    def __init__(self, base_dir, split, test_skip=8, factor=8, recenter=True, bd_factor=0.75, spherify=False,
                 path_zflat=False, debug=False):
        """``debug`` is accepted and unused, as in the reference and the JAX package."""
        if split not in ("train", "val", "test"):
            raise ValueError(f"Invalid split: {split}.")

        poses, bds, imgfiles = self._load_data(base_dir, factor=factor)

        # LLFF axis order [down, right, back] -> [right, up, back]
        poses = np.concatenate([poses[:, 1:2, :], -poses[:, 0:1, :], poses[:, 2:, :]], axis=1)
        poses = np.moveaxis(poses, -1, 0).astype(np.float32)
        bds = np.moveaxis(bds, -1, 0).astype(np.float32)

        sc = 1.0 if bd_factor is None else 1.0 / (bds.min() * bd_factor)
        poses[:, :3, 3] *= sc
        bds = bds * sc

        if recenter:
            poses = recenter_poses(poses)

        if spherify:
            poses, render_poses, bds = spherify_poses(poses, bds)
        else:
            c2w = poses_avg(poses)
            up = normalize(poses[:, :3, 1].sum(0))

            # a focus depth for the spiral path
            close_depth, inf_depth = bds.min() * 0.9, bds.max() * 5.0
            dt = 0.75
            focal = 1.0 / ((1.0 - dt) / close_depth + dt / inf_depth)

            zdelta = close_depth * 0.2
            tt = poses[:, :3, 3]
            rads = np.percentile(np.abs(tt), 90, 0)
            c2w_path = c2w
            n_views, n_rots = 120, 2
            if path_zflat:
                zloc = -close_depth * 0.1
                c2w_path[:3, 3] = c2w_path[:3, 3] + zloc * c2w_path[:3, 2]
                rads[2] = 0.0
                n_rots = 1
                n_views //= 2
            render_poses = render_path_spiral(c2w_path, up, rads, focal, zdelta, zrate=0.5, rots=n_rots,
                                              n_views=n_views)

        self.render_poses = np.asarray(render_poses, dtype=np.float32)

        if test_skip > 0:
            i_test = np.arange(0, len(imgfiles), test_skip)
        else:
            c2w = poses_avg(poses)
            dists = np.sum(np.square(c2w[:3, 3] - poses[:, :3, 3]), -1)
            i_test = np.array([int(np.argmin(dists))])
        logger.info(f"HOLDOUT views: {i_test}")

        poses = poses.astype(np.float32)
        imgfiles = np.asarray(imgfiles)
        if split in ("val", "test"):
            sel = i_test
        else:
            held_out = set(i_test.tolist())
            sel = np.array([i for i in range(len(imgfiles)) if i not in held_out], dtype=np.int64)
            if sel.size == 0:
                raise ValueError(
                    f"LLFF train split is empty: test_skip holds out every one of the {len(imgfiles)} images — "
                    "use test_skip > 1"
                )
        self.poses = poses[sel]
        self.imgfiles = imgfiles[sel]
        self.bds = bds[sel]

    def __getitem__(self, index: int) -> Tuple[np.ndarray, ...]:
        pose_hwf = self.poses[index].astype(np.float32)
        _, _, focal = pose_hwf[:, -1]
        pose = pose_hwf[:, :4] @ CAM_CALIBRATION
        min_depth, max_depth = self.bds[index].astype(np.float32)
        image = load_image(self.imgfiles[index])
        return (
            pose,
            np.asarray([focal], dtype=np.float32),
            image,
            np.asarray([min_depth], dtype=np.float32),
            np.asarray([max_depth], dtype=np.float32),
        )

    def __len__(self) -> int:
        return len(self.imgfiles)

    # -- raw data, the resized copies -------------------------------------------
    @staticmethod
    def _list_images(imgdir: str):
        return [osp.join(imgdir, f) for f in sorted(os.listdir(imgdir)) if f.split(".")[-1] in _IMG_EXTS]

    @classmethod
    def _load_data(cls, basedir, factor=None, width=None, height=None):
        poses_arr = np.load(osp.join(basedir, "poses_bounds.npy"))
        poses = poses_arr[:, :-2].reshape([-1, 3, 5]).transpose([1, 2, 0])
        bds = poses_arr[:, -2:].transpose([1, 0])

        img0 = cls._list_images(osp.join(basedir, "images"))[0]
        sh = image_shape(img0, exif_orientation=True)

        sfx = ""
        if factor is not None and factor != 1:
            sfx = f"_{factor}"
            cls._minify(basedir, factors=[factor])
        elif height is not None:
            factor = sh[0] / float(height)
            width = int(sh[1] / factor)
            cls._minify(basedir, resolutions=[[height, width]])
            sfx = f"_{width}x{height}"
        elif width is not None:
            factor = sh[1] / float(width)
            height = int(sh[0] / factor)
            cls._minify(basedir, resolutions=[[height, width]])
            sfx = f"_{width}x{height}"
        else:
            factor = 1

        imgdir = osp.join(basedir, "images" + sfx)
        if not osp.exists(imgdir):
            raise FileNotFoundError(f"{imgdir} does not exist")

        imgfiles = cls._list_images(imgdir)
        if poses.shape[-1] != len(imgfiles):
            raise RuntimeError(f"Mismatch between imgs {len(imgfiles)} and poses {poses.shape[-1]}")

        sh = image_shape(imgfiles[0], exif_orientation=True)
        poses[:2, 4, :] = np.array(sh[:2]).reshape([2, 1])
        poses[2, 4, :] = poses[2, 4, :] / factor
        return poses, bds, imgfiles

    @classmethod
    def _minify(cls, basedir, factors=(), resolutions=()):
        """Write the resized copies ``images_{factor}/`` / ``images_{W}x{H}/`` that are missing, as PNGs."""
        todo = []
        for r in factors:
            name = f"images_{r}"
            if not osp.exists(osp.join(basedir, name)):
                todo.append((name, r))
        for r in resolutions:
            name = f"images_{r[1]}x{r[0]}"
            if not osp.exists(osp.join(basedir, name)):
                todo.append((name, r))
        if not todo:
            return

        src_files = cls._list_images(osp.join(basedir, "images"))
        for name, r in todo:
            outdir = osp.join(basedir, name)
            logger.info(f"Minifying {r} -> {outdir}")
            os.makedirs(outdir, exist_ok=True)
            for src in src_files:
                img = load_image_u8(src)
                if isinstance(r, int):
                    dsize = (int(round(img.shape[1] / r)), int(round(img.shape[0] / r)))
                else:
                    dsize = (int(r[1]), int(r[0]))
                base = osp.splitext(osp.basename(src))[0]
                with open(osp.join(outdir, base + ".png"), "wb") as fp:
                    fp.write(png_bytes(resize_area(img, dsize)))
            logger.info("Done")
