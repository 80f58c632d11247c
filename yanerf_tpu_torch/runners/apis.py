"""The train step and the train / eval loops.

Counterpart of ``yanerf_tpu/runners/apis.py`` (``prepare_batch``,
``make_train_step``, the per-step ``train_one_epoch``, ``eval_one_epoch``)
on one GPU:
  * a train step is the pipeline's TRAINING forward, the mean of the
    per-sample objective, ``backward()`` and one Adam update, with the
    learning rate of the update's index (``optim.set_learning_rates``);
  * the randomness of step ``k`` comes from a ``torch.Generator`` seeded
    from ``(seed, k)``, so a resumed run draws what an unbroken one would
    (the JAX package folds its key with the step the same way). Tests feed
    the JAX package's own draws instead (``draws``);
  * the fused K-step dispatch (``make_train_step_fused``), hooks, the
    periodic training vis and distributed training are not ported yet:
    ``steps_per_call > 1`` logs once and runs the per-step loop.
"""

from __future__ import annotations

import logging
import time
from collections import defaultdict
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..ops.metrics import mse2psnr
from ..ops.structures import EvaluationMode
from .optim import TrainState, set_learning_rates

LOG_HEADER = "{}\tEpoch:\t[{}]"
logger = logging.getLogger("yanerf_tpu_torch.runner")


def create_stats(preds: Dict, prefixes=("loss_", "objective")) -> Dict[str, float]:
    """Mean every ``loss_*`` / ``objective`` entry to a float; derive ``*_psnr`` from ``*_mse``."""
    stats: Dict[str, float] = {}
    for key, value in preds.items():
        if any(key.startswith(prefix) for prefix in prefixes):
            stats[key] = float(torch.as_tensor(value, dtype=torch.float64).mean())
            if "mse" in key:
                stats["psnr".join(key.split("mse"))] = mse2psnr(stats[key])
    return stats


def prepare_batch(data: Tuple, data_wrapper: Callable, device: torch.device) -> Dict[str, Any]:
    """A loader tuple as pipeline keyword arguments, arrays as tensors on ``device``."""
    out: Dict[str, Any] = {}
    for key, value in data_wrapper(*data)._asdict().items():
        if isinstance(value, (np.ndarray, torch.Tensor)):
            out[key] = torch.as_tensor(value, device=device)
        else:
            out[key] = value
    return out


def step_generator(device: torch.device, seed: int, step: int) -> torch.Generator:
    """The generator of train step ``step``: a function of the run's seed and the step alone."""
    return torch.Generator(device=device).manual_seed((int(seed) << 32) + int(step))


def make_train_step(pipeline, runner_config, seed: int) -> Callable:
    """``step(state, batch, draws=None) -> preds``: one update of ``state`` in place."""

    def step(state: TrainState, batch: Dict[str, Any], draws: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
        set_learning_rates(runner_config, state.optimizer, state.step)
        pipeline.train()
        preds = pipeline(
            evaluation_mode=EvaluationMode.TRAINING,
            output_rasterized_mc=False,
            generator=step_generator(pipeline.device, seed, state.step),
            draws=draws,
            **batch,
        )
        if "objective" not in preds:
            raise KeyError("In train mode, but no loss (`objective`) is found.")
        state.optimizer.zero_grad(set_to_none=True)
        torch.mean(preds["objective"]).backward()
        state.optimizer.step()
        state.step += 1
        return {k: v.detach() if isinstance(v, torch.Tensor) else v for k, v in preds.items()}

    return step


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def train_one_epoch(
    run_type: str,
    config,
    epoch: int,
    state: TrainState,
    dataloader,
    train_step: Callable,
    lr_schedule: Optional[Callable] = None,
) -> Tuple[TrainState, Dict[str, float]]:
    """One epoch of per-step updates; the stats hold the last step's losses and ``step_s``.

    ``step_s`` is the host time per step from the end of the epoch's first
    step to the end of its last, each end a device synchronize (the first
    step carries one-off costs: kernel builds, library set-up).
    """
    if int(config.get("steps_per_call", 1) or 1) > 1 and epoch == 0:
        logger.info(
            "steps_per_call requested but the fused K-step dispatch is not ported yet — using the per-step loop."
        )
    device = state.pipeline.device
    passed_iter = epoch * len(dataloader)
    header = LOG_HEADER.format(run_type, epoch)
    print_per_iter = config.get("print_per_iter", 100)
    if dataloader.sampler is not None:
        dataloader.sampler.set_epoch(epoch)

    preds: Dict[str, Any] = {}
    t_first = t_last = None
    n_steps = 0
    t_data = time.perf_counter()
    for i, data in enumerate(dataloader):
        batch = prepare_batch(data, dataloader.data_wrapper, device)
        data_s = time.perf_counter() - t_data
        preds = train_step(state, batch)
        n_steps += 1
        if i == 0:
            _sync(device)
            t_first = time.perf_counter()
        if passed_iter % print_per_iter == 0:
            _sync(device)
            if lr_schedule is not None:
                logger.info(f"{header}\tlr: {lr_schedule(passed_iter):.3e}.")
            stats = create_stats(preds)
            log_string = "\t".join(
                [f"iter: {passed_iter}\tsampler: [{i * dataloader.batch_size}/{len(dataloader) * dataloader.batch_size}]"]
                + [f"data: {data_s:.3f}"]
                + [f"{k}: {v:.3f}" for k, v in stats.items()]
            )
            logger.info(f"{header}: {log_string}")
        passed_iter += 1
        t_data = time.perf_counter()
    _sync(device)
    t_last = time.perf_counter()
    stats = create_stats(preds)
    if n_steps > 1:
        stats["step_s"] = (t_last - t_first) / (n_steps - 1)
    return state, stats


@torch.inference_mode()
def eval_one_epoch(run_type: str, config, epoch: int, pipeline, dataloader, seed: int) -> Dict[str, float]:
    """Render every frame of ``dataloader`` in EVALUATION and mean its per-sample losses."""
    if dataloader.drop_last:
        raise ValueError("Incomplete eval due to `drop_last`.")
    header = LOG_HEADER.format(run_type, epoch)
    print_per_iter = config.get("print_per_iter", 50)
    pipeline.eval()
    metric_stats: Dict[str, list] = defaultdict(list)
    for i, data in enumerate(dataloader):
        batch = prepare_batch(data, dataloader.data_wrapper, pipeline.device)
        preds = pipeline(
            evaluation_mode=EvaluationMode.EVALUATION,
            generator=step_generator(pipeline.device, seed, i),
            **batch,
        )
        for key, value in preds.items():
            if key.startswith("loss_") or key.startswith("objective"):
                metric_stats[key].append(value.detach().double().cpu().numpy())
        if i % print_per_iter == 0:
            stats = create_stats(preds)
            logger.info(f"{header}: sampler: [{i * dataloader.batch_size}/{len(dataloader.dataset)}]\t"
                        + "\t".join(f"{k}: {v:.3f}" for k, v in stats.items()))
    final = {key: float(np.mean(np.concatenate(chunks)[: len(dataloader.dataset)])) for key, chunks in metric_stats.items()}
    stats = create_stats(final)
    logger.info(f"{header}: [{len(dataloader.dataset)}/{len(dataloader.dataset)}]\t"
                + "\t".join(f"{k}: {v:.3f}" for k, v in stats.items()))
    return stats
