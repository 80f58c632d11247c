"""Traffic kind ``frames``: one caller rendering full frames back to back through the render service.

A closed loop of one client with one request in flight, as a viewer
orbiting a scene sends them: each request is a camera on the orbit
(azimuth uniform, elevation in ``elevation_deg``, at ``radius``, looking at
``target``), drawn from the seed, ``poses`` of them in turn, at the
traffic's intrinsic; the answer is the frame's rgb and depth arrays on the
host (``serve.RenderService.render``). Set-up builds the service and
renders its warm-up frame. ``frame_ms`` is the window's milliseconds over
the frames completed in it. The traced stretch renders ``trace_frames``
frames. The check renders ``check_frames`` of the window's frames, drawn
from the seed, with the reference.
"""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from h100bench import inputs
from h100bench.counts import nerf as counts
from h100bench.program import build_pipeline
from h100bench.reference import nerf as reference

METRICS = ("frame_ms",)


class Cell:
    def __init__(self, ctx) -> None:
        self.ctx = ctx
        self.work = counts.frame_work(ctx.config)
        self.answers: List[tuple] = []  # (pose index, rgb, depth) of every frame rendered after the warm-up

    def setup(self) -> None:
        from yanerf_tpu_torch.serve import RenderService

        ctx, traffic = self.ctx, self.ctx.traffic
        sampler = ctx.config["pipeline"]["ray_sampler"]
        if (int(traffic["height"]), int(traffic["width"])) != (int(sampler["image_height"]), int(sampler["image_width"])):
            raise ValueError("the traffic's frame size differs from the configuration's")
        self.weights = ctx.weights()
        rng = np.random.RandomState(ctx.seeds["cameras"])
        self.poses = inputs.orbit_poses(rng, int(traffic["poses"]), float(traffic["radius"]), traffic["elevation_deg"],
                                        traffic["target"])[:, :3, :4]
        self.focal = float(np.float32(inputs.focal_length(traffic)))
        _, pipeline = build_pipeline(ctx.config, self.weights, ctx.device, ctx.seeds["weights"])
        pipeline.eval()
        self.service = RenderService(pipeline, self.focal, (int(traffic["height"]), int(traffic["width"])),
                                     (sampler.get("min_depth"), sampler.get("max_depth")))
        self.service.warmup()

    def _render(self) -> bool:
        i = len(self.answers)
        rgb, depth = self.service.render(self.poses[i % len(self.poses)], self.focal)
        self.answers.append((i % len(self.poses), rgb, depth))
        return bool(np.isfinite(rgb).all() and np.isfinite(depth).all())

    def window(self, seconds: float) -> dict:
        frames = failed = 0
        self.ctx.sync()
        t0 = time.perf_counter()
        while frames == 0 or time.perf_counter() - t0 < seconds:
            failed += 0 if self._render() else 1
            frames += 1
        elapsed = time.perf_counter() - t0
        return {"metrics": {"frame_ms": elapsed * 1e3 / frames}, "attempted": frames, "failed": failed}

    def stretch(self) -> int:
        n = int(self.ctx.traffic["trace_frames"])
        for _ in range(n):
            self._render()
        return n

    def free(self) -> None:
        self.service = None

    def _sample(self) -> List[tuple]:
        rng = np.random.RandomState(self.ctx.seeds["cameras"] + 1)
        k = min(int(self.ctx.traffic["check_frames"]), len(self.answers))
        return [self.answers[i] for i in sorted(rng.choice(len(self.answers), k, replace=False))]

    def _frame(self, i: int, precision: str):
        renderer = reference.Renderer(self.ctx.config, precision)
        return renderer.frame(self.weights, torch.as_tensor(self.poses[i], device=self.ctx.device), self.focal)

    def _gaps(self, answers: List[tuple]) -> Dict[str, float]:
        """``answers`` against the reference's frames at the same cameras: the worst frame's RMSE of rgb and of
        depth."""
        gaps = {"rgb_rmse": 0.0, "depth_rmse": 0.0}
        for i, rgb, depth in answers:
            ref_rgb, ref_depth = self._frame(i, "float32")
            gaps["rgb_rmse"] = max(gaps["rgb_rmse"], _rmse(rgb, ref_rgb))
            gaps["depth_rmse"] = max(gaps["depth_rmse"], _rmse(depth, ref_depth))
        return gaps

    def check(self) -> Dict[str, float]:
        return self._gaps(self._sample())

    def control(self) -> Dict[str, float]:
        """The numbers the check compares, with the reference in float8 in the program's place."""
        answers = []
        for i, _, _ in self._sample():
            rgb, depth = self._frame(i, "fp8")
            answers.append((i, rgb.cpu().numpy(), depth.cpu().numpy()))
        return self._gaps(answers)


def _rmse(program: np.ndarray, ref: torch.Tensor) -> float:
    diff = torch.as_tensor(program, device=ref.device, dtype=torch.float64) - ref.double()
    return float(torch.sqrt(torch.mean(diff * diff)))
