"""Traffic kind ``train``: epochs of the runner's training over a procedural Blender-format scene.

The program trains as its CLI does (``runners.apis.train_one_epoch``, the
fused K-step CUDA graph where the configuration asks for it, per step
otherwise) from the device cache of the scene's training views. Set-up
builds one train state and takes its first ``check_steps`` steps through
the window's own calls on the epoch's first images: on the fused path one
dispatch of step 1 (which captures the CUDA graph) and one of steps 2 to
``check_steps``, read at the device counter as every dispatch reads its
rows. Their losses, the first gradient as Adam holds it and the
parameters' change are the readings the check compares. Set-up then
finishes epoch 0 and hands the same state to the window, which trains
whole epochs until ``--seconds`` have passed. ``train_rays_per_s`` is
every ray of every step in the window over the window's seconds, from one
device synchronize to another. The traced stretch is one epoch.

Parameters (the traffic file): ``views``, ``height``, ``width``,
``camera_angle_x``, ``radius``, ``elevation_deg``, ``target``, ``spheres``
(the scene) and ``check_steps``.
"""

from __future__ import annotations

import logging
import time
from typing import Dict

import numpy as np
import torch

from h100bench import inputs
from h100bench.counts import nerf as counts
from h100bench.program import build_pipeline
from h100bench.reference import nerf as reference

METRICS = ("train_rays_per_s",)
ADAM_BETA1 = 0.9


class SceneDataset:
    """The scene's training views as the Blender loader's items: ``(pose 4x4, focal (1,), image (H, W, 3))``,
    the images ``k / 255`` in float32 as a PNG decodes."""

    def __init__(self, poses: np.ndarray, images_u8: np.ndarray, focal: float, data_wrapper) -> None:
        self.poses, self.images, self.focal = poses, images_u8, np.float32(focal)
        self.data_wrapper = data_wrapper

    def __getitem__(self, i: int):
        return self.poses[i], np.asarray([self.focal], np.float32), self.images[i].astype(np.float32) / 255.0

    def __len__(self) -> int:
        return len(self.poses)


class _StopAt:
    """A preemption guard that asks the loop to stop once the state has taken ``steps`` steps."""

    def __init__(self, state, steps: int) -> None:
        self.state, self.steps = state, steps

    @property
    def preempted(self) -> bool:
        return self.state.step >= self.steps


def _norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.detach().double())) for k, v in tensors.items()}


class Cell:
    def __init__(self, ctx) -> None:
        self.ctx = ctx
        self.work = counts.step_work(ctx.config)

    def setup(self) -> None:
        from yanerf_tpu_torch.datasets import BlenderDatasetWrapper, DeviceCachedLoader, create_loader, create_sampler
        from yanerf_tpu_torch.run import setup_iter_based_runner
        from yanerf_tpu_torch.runners import (
            TrainState, create_lr_schedule, create_optimizer, make_train_step, make_train_step_fused,
        )

        ctx, traffic = self.ctx, self.ctx.traffic
        seeds, device = ctx.seeds, ctx.device
        self.weights = ctx.weights()
        poses, images = inputs.make_scene(traffic, seeds["scene"], device)
        self.poses, self.images, self.focal = poses, images, float(np.float32(inputs.focal_length(traffic)))
        dataset = SceneDataset(poses, images.cpu().numpy(), self.focal, BlenderDatasetWrapper)

        config = dict(ctx.config, runner=dict(ctx.config["runner"], seed=seeds["runner"]))
        cfg, pipeline = build_pipeline(config, self.weights, device, seeds["runner"])
        runner = cfg.runner
        sampler = create_sampler(dataset, shuffle=True, seed=seeds["runner"])
        loader = create_loader(dataset, sampler, runner.batch_size_list[0], 0, is_train=True)
        if runner.get("cache_dataset_on_device", False):
            loader = DeviceCachedLoader(loader, device, quantize_images=bool(runner.get("cache_quantize_images", False)))
        setup_iter_based_runner(runner, loader, logging.getLogger("h100bench"))
        optimizer = create_optimizer(runner, pipeline)
        self.state = TrainState(pipeline=pipeline, optimizer=optimizer, step=0)
        self.loader, self.runner = loader, runner
        self.lr_schedule = create_lr_schedule(runner)
        self.train_step = make_train_step(pipeline, runner, seeds["runner"])
        self.fused = (make_train_step_fused(pipeline, runner, seeds["runner"], loader.data_wrapper)
                      if int(runner.get("steps_per_call", 1) or 1) > 1 else None)
        self.readings = self._first_steps(int(traffic["check_steps"]))
        self._epoch(0, skip_iters=self.state.step)  # the rest of epoch 0: the capture, the first replays
        self.next_epoch = 1

    def _epoch(self, epoch: int, skip_iters: int = 0, guard=None) -> Dict[str, float]:
        from yanerf_tpu_torch.runners import RunType, train_one_epoch

        self.state, stats = train_one_epoch(RunType.TRAIN, self.runner, epoch, self.state, self.loader,
                                            self.train_step, self.lr_schedule, preemption_guard=guard,
                                            train_step_fused=self.fused, skip_iters=skip_iters)
        return stats

    def _first_steps(self, n: int) -> dict:
        """The first ``n`` steps through the window's own calls; the losses, the first gradient as Adam holds it
        after step 1, and each leaf's change after step ``n``. On the fused path step 1 is a dispatch of its own
        (Adam's state then holds its gradient alone) and steps 2 to ``n`` one dispatch of ``n - 1`` rows, as the
        window's dispatches read theirs: rows, rates and draws at the device counter."""
        state, losses, grads = self.state, [], None
        fused = self.fused is not None and self._fused_eligible()
        if fused:
            self.loader.sampler.set_epoch(0)
            batch = self.loader.batch_size
            rows = self.loader.sampler.indices()[:n * batch].reshape(n, batch)
        for first, last in ((0, 1), (1, n)) if n > 1 else ((0, 1),):
            if fused:
                hist = self.fused(state, self.loader._arrays, rows[first:last])
                losses += [float(step.double().mean()) for step in hist["objective"]]
            else:
                for k in range(first, last):
                    losses.append(self._epoch(0, skip_iters=k, guard=_StopAt(state, k + 1))["objective"])
            if state.step != last:
                raise RuntimeError(f"the train state took {state.step} steps where {last} were asked for")
            if first == 0:
                params = dict(state.pipeline.named_parameters())
                # an optimizer that kept no first moment got no gradient
                grads = {name: state.optimizer.state[p].get("exp_avg", torch.zeros_like(p)) / (1.0 - ADAM_BETA1)
                         for name, p in params.items()}
                grads = _norms(grads)
        change = _norms({name: p - self.weights[name] for name, p in state.pipeline.named_parameters()})
        return {"losses": losses, "grads": grads, "change": change}

    def _fused_eligible(self) -> bool:
        from yanerf_tpu_torch.runners.apis import _fused_eligible

        return _fused_eligible(self.runner, self.loader, self.fused)

    def window(self, seconds: float) -> dict:
        rays = int(self.ctx.config["pipeline"]["ray_sampler"]["n_rays_per_image_sampled_from_mask"])
        steps = failed = 0
        self.ctx.sync()
        t0 = time.perf_counter()
        while True:
            stats = self._epoch(self.next_epoch)  # ends in a device synchronize
            self.next_epoch += 1
            steps += len(self.loader)
            failed += 0 if np.isfinite(stats["objective"]) else len(self.loader)
            if time.perf_counter() - t0 >= seconds:
                break
        elapsed = time.perf_counter() - t0
        return {"metrics": {"train_rays_per_s": steps * rays * self.runner.batch_size_list[0] / elapsed},
                "attempted": steps, "failed": failed}

    def stretch(self) -> int:
        self._epoch(self.next_epoch)
        self.next_epoch += 1
        return len(self.loader)

    def free(self) -> None:
        self.state = self.loader = self.fused = self.train_step = None

    def _reference(self, precision: str) -> dict:
        losses, grads, params = reference.train(
            self.ctx.config, self.weights, torch.as_tensor(self.poses, device=self.ctx.device), self.focal,
            self.images, self.ctx.seeds["runner"], int(self.ctx.traffic["check_steps"]), precision=precision)
        return {"losses": losses, "grads": _norms(grads),
                "change": _norms({k: params[k] - self.weights[k] for k in params})}

    def check(self) -> Dict[str, float]:
        """The program's readings against the reference's on the same weights, scene and seed."""
        return compare(self.readings, self._reference("float32"))

    def control(self) -> Dict[str, float]:
        """The numbers the check compares, with the reference in float8 in the program's place."""
        return compare(self._reference("fp8"), self._reference("float32"))


def compare(program: dict, ref: dict) -> Dict[str, float]:
    """``loss_gap``: the worst step's relative gap of the objective; ``grad_gap`` / ``change_gap``: the worst
    leaf's gap of the first gradient's / the parameters' change's norms (``reference.leaf_gap``). Leaves whose
    reference gradient is under a thousandth of the median leaf's move by round-off alone: their change is left
    out."""
    loss_gap = max(abs(p - r) / abs(r) for p, r in zip(program["losses"], ref["losses"]))
    median = float(np.median(list(ref["grads"].values())))
    moving = [k for k, g in ref["grads"].items() if g >= 1e-3 * median]
    return {"loss_gap": loss_gap,
            "grad_gap": reference.leaf_gap(program["grads"], ref["grads"], list(ref["grads"])),
            "change_gap": reference.leaf_gap(program["change"], ref["change"], moving)}
