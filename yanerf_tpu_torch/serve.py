"""HTTP render server of the port: serve a NeRF over REST on one GPU.

Counterpart of ``scripts/serve.py``: loads a config (and optionally a
checkpoint) once, then answers render requests over plain HTTP (stdlib
``http.server``). Renders are serialized behind a lock: the card renders
one frame at a time. In a ``torch.profiler`` trace each request is a
``service.render`` region, its copies to the host ``service.fetch``.

Endpoints:
  GET  /health            liveness + request/latency counters (JSON)
  GET  /spec              resolved serving parameters (JSON)
  POST /render            body: {"pose": 4x4|3x4 camera-to-world,
                                 "focal": float,              (optional)
                                 "min_depth"/"max_depth": float, (optional)
                                 "convention": "blender"|"world",
                                 "output": "rgb"|"depth",
                                 "format": "png"|"json"}
                          -> image/png bytes (or JSON float grid)
  GET  /render?theta=DEG&phi=DEG&radius=R[&focal=F][&output=rgb|depth]
                          orbit camera (Blender convention, z-up)
  GET  /trajectory?n=20&radius=4&phi=-30[&fps=15][&focal=F]
                          full orbit as an animated GIF

Usage:
  python -m yanerf_tpu_torch.serve --config configs/nerf/lego_proposal.yml \\
      --cfg_options pipeline.model.2.use_pallas=True [--checkpoint params.npz]
  curl 'localhost:8765/render?theta=30&phi=-25&radius=4' > frame.png

``--checkpoint`` takes a checkpoint of the port's runner (a run's
``ckpts/ckpts_-001``, the best model, or any ``ckpts_NNNN``), an ``.npz``
of the JAX param tree flattened to dotted keys (``convert.flatten_tree``)
or the reference's own ``.pth`` (``import_torch_checkpoint``); without one
the weights are random, drawn from ``--seed``.
"""

from __future__ import annotations

import argparse
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Tuple, Union
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

from .ops.structures import EvaluationMode
from .utils import resolve_device
from .utils.config import Config, DictAction
from .utils.images import gif_bytes, png_bytes, to_img
from .utils.profiling import annotate

# Flip y/z axes: OpenGL-style camera (z into screen) -> world (z out); the
# Blender dataset's calibration (yanerf_tpu/datasets/blender.py)
CAM_CALIBRATION = np.diag(np.array([1.0, -1.0, -1.0, 1.0], dtype=np.float32))


def _look_at_blender(position: np.ndarray, target: np.ndarray) -> np.ndarray:
    forward = target - position
    forward = forward / np.linalg.norm(forward)
    z_axis = -forward
    up = np.array([0.0, 0.0, 1.0])
    x_axis = np.cross(up, z_axis)
    n = np.linalg.norm(x_axis)
    x_axis = np.array([1.0, 0.0, 0.0]) if n < 1e-6 else x_axis / n
    y_axis = np.cross(z_axis, x_axis)
    c2w = np.eye(4)
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = x_axis, y_axis, z_axis, position
    return c2w


def orbit_pose(theta_deg: float, phi_deg: float, radius: float) -> np.ndarray:
    """Blender-convention camera on a sphere around the origin.

    theta: azimuth around +z (deg); phi: elevation from the xy-plane (deg,
    negative looks down from above like the lego test cameras).
    """
    t, p = np.deg2rad(theta_deg), np.deg2rad(phi_deg)
    position = radius * np.array([np.cos(t) * np.cos(p), np.sin(t) * np.cos(p), -np.sin(p)])
    return _look_at_blender(position, np.zeros(3))


class RenderService:
    """Owns the pipeline and the single-flight render lock."""

    def __init__(self, pipeline, default_focal: float, image_hw, bounds=(None, None)):
        self._pipeline = pipeline
        self._lock = threading.Lock()
        self.device = pipeline.device
        self.default_focal = float(default_focal)
        self.image_hw = tuple(image_hw)  # (H, W)
        self.default_bounds = bounds
        self.focal_source = "blender_synthetic_assumption"
        self.n_renders = 0
        self.total_render_s = 0.0

    def warmup(self):
        """Build the kernels and page in the weights before the first request."""
        pose = (orbit_pose(0.0, -30.0, 4.0) @ CAM_CALIBRATION)[:3, :4].astype(np.float32)
        self.render(pose, self.default_focal)

    @torch.inference_mode()
    def _render_tensors(self, pose_world_3x4: np.ndarray, focal: float, min_depth, max_depth):
        preds = self._pipeline(
            poses=torch.as_tensor(np.asarray(pose_world_3x4, np.float32), device=self.device)[None],
            focal_lengths=torch.tensor([focal], dtype=torch.float32, device=self.device),
            min_depth=min_depth,
            max_depth=max_depth,
            evaluation_mode=EvaluationMode.EVALUATION,
        )
        with annotate("service.fetch"):  # the copies wait for the frame's queued work
            return preds["rendered_images"][0].cpu().numpy(), preds["rendered_depths"][0, ..., 0].cpu().numpy()

    def render(self, pose_world_3x4: np.ndarray, focal: float, min_depth=None, max_depth=None):
        """Serialized render; returns (rgb (H,W,3) f32 in [0,1], depth (H,W))."""
        lo, hi = self.default_bounds
        min_depth = lo if min_depth is None else min_depth
        max_depth = hi if max_depth is None else max_depth
        with self._lock, annotate("service.render"):
            t0 = time.perf_counter()
            rgb, depth = self._render_tensors(pose_world_3x4, focal, min_depth, max_depth)
            self.n_renders += 1
            self.total_render_s += time.perf_counter() - t0
        return rgb, depth

    def render_trajectory(self, n_frames: int, radius: float, phi: float, focal=None):
        """Orbit trajectory, one frame after another."""
        focal = self.default_focal if focal is None else float(focal)
        lo, hi = self.default_bounds
        frames = []
        with self._lock, annotate("service.render"):
            t0 = time.perf_counter()
            for i in range(n_frames):
                pose = (orbit_pose(360.0 * i / n_frames, phi, radius) @ CAM_CALIBRATION)[:3, :4]
                frames.append(self._render_tensors(pose, focal, lo, hi)[0])
            self.n_renders += n_frames
            self.total_render_s += time.perf_counter() - t0
        return frames

    def stats(self):
        """The counters; ``chunk_loop``: the pipeline's chunk loop (``NeRFPipeline.chunk_stats``: frame shapes
        given static buffers, CUDA graphs captured and their seconds, chunks replayed and run eagerly)."""
        n = self.n_renders
        return {
            "status": "ok",
            "renders": n,
            "mean_render_s": round(self.total_render_s / n, 4) if n else None,
            "image_hw": list(self.image_hw),
            "device": str(self.device),
            "chunk_loop": dict(getattr(self._pipeline, "chunk_stats", {})),
        }


def _parse_pose(body: dict) -> np.ndarray:
    pose = np.asarray(body["pose"], dtype=np.float32)
    if pose.shape == (4, 4):
        pose = pose[:3, :4]
    if pose.shape != (3, 4):
        raise ValueError(f"pose must be 3x4 or 4x4, got {pose.shape}")
    if body.get("convention", "blender") == "blender":
        pose = (np.vstack([pose, [0, 0, 0, 1]]) @ CAM_CALIBRATION)[:3, :4]
    return pose


def make_handler(service: RenderService):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # noqa: D102
            pass

        def _send(self, code: int, content_type: str, payload: bytes):
            self.send_response(code)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(payload)))
            self.end_headers()
            self.wfile.write(payload)

        def _send_json(self, obj, code=200):
            self._send(code, "application/json", json.dumps(obj).encode())

        def _reply_render(self, pose_world, focal, output, fmt, min_depth=None, max_depth=None):
            try:
                rgb, depth = service.render(pose_world, focal, min_depth, max_depth)
            except Exception as e:  # a render failure must not drop the connection
                return self._send_json({"error": f"render failed: {e}"}, code=500)
            arr = depth / max(float(depth.max()), 1e-6) if output == "depth" else rgb
            if fmt == "json":
                self._send_json({"shape": list(arr.shape), "data": np.asarray(arr, dtype=float).tolist()})
            else:
                self._send(200, "image/png", png_bytes(to_img(arr)))

        def do_GET(self):  # noqa: N802
            url = urlparse(self.path)
            if url.path == "/health":
                return self._send_json(service.stats())
            if url.path == "/spec":
                return self._send_json(
                    {
                        "image_hw": list(service.image_hw),
                        "default_focal": service.default_focal,
                        "default_focal_source": service.focal_source,
                        "default_bounds": [None if b is None else float(b) for b in service.default_bounds],
                    }
                )
            if url.path == "/render":
                q = {k: v[-1] for k, v in parse_qs(url.query).items()}
                try:
                    pose = orbit_pose(
                        float(q.get("theta", 0.0)), float(q.get("phi", -30.0)), float(q.get("radius", 4.0))
                    )
                    pose_world = _parse_pose({"pose": pose.tolist(), "convention": "blender"})
                    focal = float(q.get("focal", service.default_focal))
                    output = q.get("output", "rgb")
                except (ValueError, KeyError) as e:
                    return self._send_json({"error": str(e)}, code=400)
                return self._reply_render(pose_world, focal, output, q.get("format", "png"))
            if url.path == "/trajectory":
                q = {k: v[-1] for k, v in parse_qs(url.query).items()}
                try:
                    n = max(2, min(int(q.get("n", 20)), 240))
                    radius = float(q.get("radius", 4.0))
                    phi = float(q.get("phi", -30.0))
                    fps = float(q.get("fps", 15.0))
                    focal = float(q["focal"]) if "focal" in q else None
                except ValueError as e:
                    return self._send_json({"error": str(e)}, code=400)
                try:
                    frames = service.render_trajectory(n, radius, phi, focal)
                except Exception as e:
                    return self._send_json({"error": f"render failed: {e}"}, code=500)
                return self._send(200, "image/gif", gif_bytes([to_img(f) for f in frames], fps))
            self._send_json({"error": f"unknown path {url.path}"}, code=404)

        def do_POST(self):  # noqa: N802
            url = urlparse(self.path)
            if url.path != "/render":
                return self._send_json({"error": f"unknown path {url.path}"}, code=404)
            try:
                length = int(self.headers.get("Content-Length", 0))
                body = json.loads(self.rfile.read(length) or b"{}")
                pose_world = _parse_pose(body)
                focal = float(body.get("focal", service.default_focal))
                output = body.get("output", "rgb")
                fmt = body.get("format", "png")
                lo = body.get("min_depth")
                hi = body.get("max_depth")
            except (ValueError, KeyError, json.JSONDecodeError) as e:
                return self._send_json({"error": str(e)}, code=400)
            self._reply_render(pose_world, focal, output, fmt, lo, hi)

    return Handler


def create_server(service: RenderService, host: str = "127.0.0.1", port: int = 0):
    """Bind a ThreadingHTTPServer (port=0 -> ephemeral, for tests)."""
    return ThreadingHTTPServer((host, port), make_handler(service))


def _default_focal(cfg) -> Tuple[float, str]:
    rs = cfg.pipeline.ray_sampler
    serve_cfg = cfg.get("serve", {}) or {}
    if serve_cfg.get("default_focal"):
        return float(serve_cfg["default_focal"]), "config:serve.default_focal"
    for ds_key in ("data", "dataset", "datasets"):
        ds = cfg.get(ds_key)
        if isinstance(ds, (list, tuple)):
            ds = ds[0] if ds else None
        if ds and ds.get("camera_angle_x"):
            focal = rs.image_width / (2.0 * np.tan(float(ds["camera_angle_x"]) / 2.0))
            return focal, f"config:{ds_key}.camera_angle_x"
    return rs.image_width / (2.0 * np.tan(0.6911112070083618 / 2.0)), "blender_synthetic_assumption"


def load_pipeline(cfg, checkpoint: Optional[str] = None, device: Union[str, torch.device] = "cuda", seed: int = 0):
    """The pipeline of ``cfg`` on ``device`` in eval mode, its weights from ``checkpoint`` or drawn from ``seed``.

    ``checkpoint``: a checkpoint of the port's runner, an ``.npz`` of the
    JAX param tree flattened to dotted keys, or a reference-layout ``.pth``
    (its NeRFMLP weights; what it lacks keeps the seed's values, as the
    JAX importer leaves it). The serving, the export and the density tools
    (``fit_occupancy``, ``fit_aabb``, ``extract_mesh``, ``render``) load
    their weights here.
    """
    from .convert import load_jax_params
    from .pipelines import PIPELINES

    device = resolve_device(device)
    generator = torch.Generator().manual_seed(seed)
    pipeline = PIPELINES.build(cfg.pipeline, generator=generator, device=device)
    pipeline.eval()
    if checkpoint and str(checkpoint).endswith(".npz"):
        with np.load(checkpoint) as ckpt:
            load_jax_params(pipeline, {k: ckpt[k] for k in ckpt.files})
    elif checkpoint and str(checkpoint).endswith(".pth"):
        from .runners.checkpoints import import_torch_checkpoint

        import_torch_checkpoint(checkpoint, pipeline)
    elif checkpoint:
        from .runners.checkpoints import checkpoint_params_tree

        load_jax_params(pipeline, checkpoint_params_tree(checkpoint))
    return pipeline


def service_from_config(
    cfg,
    checkpoint: Optional[str] = None,
    device: Union[str, torch.device] = "cuda",
    seed: int = 0,
) -> RenderService:
    """Build the pipeline of ``cfg`` on ``device`` (weights from ``checkpoint`` or ``seed``)."""
    pipeline = load_pipeline(cfg, checkpoint, device, seed)
    rs = cfg.pipeline.ray_sampler
    default_focal, focal_source = _default_focal(cfg)
    service = RenderService(
        pipeline, default_focal, (rs.image_height, rs.image_width), (rs.get("min_depth"), rs.get("max_depth"))
    )
    service.focal_source = focal_source
    return service


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--config", required=True)
    parser.add_argument("--checkpoint", default=None,
                        help="a checkpoint of the port's runner (<run>/ckpts/ckpts_-001), an .npz of the JAX param "
                        "tree or a reference-layout .pth")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8765)
    parser.add_argument("--device", default="cuda", help="torch device; cuda without a GPU raises")
    parser.add_argument("--seed", type=int, default=0, help="seed of the random weights when no checkpoint")
    parser.add_argument("--no_warmup", action="store_true")
    parser.add_argument("--cfg_options", nargs="+", action=DictAction)
    args = parser.parse_args(argv)

    cfg = Config.fromfile(args.config)
    if args.cfg_options is not None:
        cfg.merge_from_dict(args.cfg_options)

    service = service_from_config(cfg, args.checkpoint, args.device, args.seed)
    if not args.no_warmup:
        t0 = time.perf_counter()
        service.warmup()
        print(f"warmup render (kernel build included): {time.perf_counter() - t0:.1f}s")

    server = create_server(service, args.host, args.port)
    print(f"serving on http://{args.host}:{server.server_address[1]}  (ctrl-c to stop)")
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        server.shutdown()
    finally:
        server.server_close()


if __name__ == "__main__":
    main()
