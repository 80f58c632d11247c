"""Train / test entry point of the port.

    python -m yanerf_tpu_torch.run --config configs/nerf/lego_proposal.yml \\
        --cfg_options pipeline.model.2.use_pallas_train=True datasets.0.base_dir=... \\
        datasets.1.base_dir=... datasets.2.base_dir=...

Counterpart of ``scripts/run.py`` over the same configs and
``--cfg_options``: a versioned output directory (``version_N``) with
``config.yml`` and ``run.log``; the iteration-based runner converted to
epochs over the loader; training with Adam and the configured schedule,
per step or, with ``runner.steps_per_call > 1`` and the device dataset
cache, in fused dispatches of K steps (one captured CUDA graph replayed K
times on the card; ``runners/apis.py``); the hooks of ``runner.hooks``;
the periodic training vis (``runner.train_vis``, on by default) and the
eval frames as PNGs under ``visualization/``; a ``torch.profiler`` trace
with ``runner.profile_dir``; ``{train,val,test}_stats.json``; checkpoints
``ckpts_{epoch:04d}`` (periodic and final) and ``ckpts_-001`` (best
``loss_rgb_psnr`` at validation); and the test metrics at the end.
SIGTERM / SIGINT stop training between steps (dispatches) and write the
resumable ``ckpts_preempt``; ``--auto_resume`` continues from the newest
checkpoint of the output directory, where the run stopped. The periodic
and best-model checkpoints are written by a writer thread
(``save_checkpoint(..., async_save=True)``), the final and the emergency
ones at once. ``--device cuda`` is the default and raises without a GPU;
``--device cpu`` runs the kernels' plain versions. ``--checkpoint``
resumes from a checkpoint of this runner, or takes the weights of a
reference-layout ``.pth`` (``import_torch_checkpoint``) with a fresh
optimizer at epoch 0. ``--debug`` (``runner.debug``) logs at DEBUG and
cuts the run to one iteration over ``batch_size + 1`` items of each split
(``setup_debug_env``). The last line of ``run.log`` gives the kernels'
launches in the process (``kernel launches: {...}``), so that a run
started by another program reports its kernel use. Distributed training
is not ported yet.
"""

from __future__ import annotations

import argparse
import datetime
import json
import logging
import random
import time
from math import ceil, floor
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from .ops.kernels import launch_count
from .utils import resolve_device
from .utils.config import Config, DictAction

MONITOR_METRIC_NAME = "loss_rgb_psnr"  # higher is better


def get_version(path: Path) -> int:
    return len(list(path.glob("version_*")))


def setup_output_dir_for_training(output_dir) -> Path:
    output_dir = Path(output_dir)
    if output_dir.stem.startswith("version_"):
        output_dir = output_dir.parent
    return output_dir / f"version_{get_version(output_dir)}"


def setup_iter_based_runner(runner_config, dataloader, logger, world_size: int = 1) -> None:
    """Convert the iteration-based config to epochs over the loader (``scripts/run.py`` semantics)."""
    iters_per_epoch = len(dataloader) * world_size * dataloader.batch_size
    runner_config["num_iters_on_one_gpu"] = runner_config["num_iters"]
    runner_config["num_epochs"] = ceil(runner_config["num_iters"] / iters_per_epoch)
    runner_config["num_iters"] = runner_config["num_epochs"] * len(dataloader)
    runner_config["val_per_epoch"] = max(1, floor(runner_config["val_per_iter"] / iters_per_epoch))
    runner_config["save_per_epoch"] = max(1, floor(runner_config["save_per_iter"] / iters_per_epoch))
    logger.info("Iter-based runner converted to epoch-based:")
    for old_key, new_key in (
        ("val_per_iter", "val_per_epoch"),
        ("save_per_iter", "save_per_epoch"),
        ("num_iters_on_one_gpu", "num_iters"),
    ):
        logger.info(f"\t{old_key}: {runner_config[old_key]} -> {new_key}: {runner_config[new_key]}")
    logger.info(f"\tnum_epochs: {runner_config['num_epochs']}")
    ratio = runner_config["num_iters"] / runner_config["num_iters_on_one_gpu"]
    for key in list(runner_config.keys()):
        if key != "num_iters" and "iters" in key and isinstance(runner_config[key], (int, float)):
            old = runner_config[key]
            runner_config[key] = ceil(old * ratio)
            logger.info(f"\t{key}: {old} -> {runner_config[key]}")


def setup_debug_env(runner_config, datasets, logger):
    """``scripts/run.py``'s debug mode: every split cut to ``batch_size + 1`` items, one iteration, eval and
    checkpoint at every epoch, no loader workers."""
    from .datasets import Subset

    logger.warning("In DEBUG mode, some hyperparameters have been changed.")
    runner_config["val_per_epoch"] = 1
    runner_config["save_per_epoch"] = 1
    for index in (0, 1, 2):
        datasets[index] = Subset(datasets[index], list(range(runner_config["batch_size_list"][index] + 1)))
    runner_config["num_iters"] = 1
    runner_config["print_per_iter"] = 1
    runner_config["save_per_iter"] = 1
    runner_config["val_per_iter"] = 1
    runner_config["num_workers_list"] = [0 for _ in runner_config["num_workers_list"]]
    return datasets


def _get_logger(log_file: Path, debug: bool) -> logging.Logger:
    logger = logging.getLogger("yanerf_tpu_torch")
    logger.setLevel(logging.DEBUG if debug else logging.INFO)
    for h in list(logger.handlers):
        logger.removeHandler(h)
        h.close()
    fmt = logging.Formatter("%(asctime)s - %(name)s - %(levelname)s - %(message)s")
    for handler in (logging.StreamHandler(), logging.FileHandler(log_file, mode="a")):
        handler.setFormatter(fmt)
        logger.addHandler(handler)
    return logger


def _append_json(path: Path, record: Dict[str, Any]) -> None:
    with open(path, "a") as f:
        f.write(json.dumps(record) + "\n")


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    """Run the CLI; returns ``{"output_dir", "state", "train_stats", "val_stats", "test_stats"}``.

    Training runs also return ``"checkpoint"`` (the final one) and
    ``"train_step_fused"`` (the fused trainer, or None); a preempted run
    returns ``"preempted"`` (its emergency checkpoint) and skips the test.
    """
    try:
        return _main(argv)
    finally:
        logging.getLogger("yanerf_tpu_torch").info(f"kernel launches: {json.dumps(launch_count.totals())}")


def _main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    args = parse_args(argv)
    config = Config.fromfile(args.config)
    if args.cfg_options is not None:
        config.merge_from_dict(args.cfg_options)
    if args.debug:
        config.runner.debug = True

    from .datasets import DATASETS, DeviceCachedLoader, create_loader, create_sampler
    from .pipelines import PIPELINES
    from .runners import (
        HOOKS,
        PreemptionGuard,
        RunType,
        TrainState,
        create_lr_schedule,
        create_optimizer,
        eval_one_epoch,
        find_best_checkpoint,
        find_latest_checkpoint,
        import_torch_checkpoint,
        load_checkpoint,
        make_train_step,
        make_train_step_fused,
        save_checkpoint,
        train_one_epoch,
        wait_for_async_saves,
    )

    device = resolve_device(args.device)
    if "seed" not in config.runner:
        config.runner.seed = 42
    if args.seed is not None:
        config.runner.seed = args.seed
    seed = int(config.runner.seed)
    np.random.seed(seed)
    random.seed(seed)

    if args.output_dir is not None:
        config.runner.output_dir = args.output_dir
    output_dir = Path(config.runner.output_dir)
    if not args.test_only:
        resumed = find_latest_checkpoint(output_dir) if args.auto_resume and args.checkpoint is None else None
        if resumed is not None:
            output_dir, checkpoint = resumed
            args.checkpoint = str(checkpoint)
        else:
            output_dir = setup_output_dir_for_training(output_dir)
        config.runner.output_dir = str(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    config.dump(str(output_dir / "config.yml"))
    logger = _get_logger(output_dir / "run.log", bool(config.runner.get("debug", False)))
    logger.info(f"Output Directory: {output_dir}")
    logger.info(f"Device: {device}" + (f" ({torch.cuda.get_device_name(device)})" if device.type == "cuda" else ""))

    datasets = [DATASETS.build(dataset_cfg) for dataset_cfg in config.datasets]
    if config.runner.get("debug", False):
        datasets = setup_debug_env(config.runner, datasets, logger)
    samplers = [
        create_sampler(dataset, shuffle=(dataset_cfg.split == "train"), seed=seed)
        for dataset, dataset_cfg in zip(datasets, config.datasets)
    ]
    dataloaders = [
        create_loader(dataset, sampler, batch_size, num_workers, is_train=(dataset_cfg.split == "train"))
        for dataset, sampler, batch_size, num_workers, dataset_cfg in zip(
            datasets, samplers, config.runner.batch_size_list, config.runner.num_workers_list, config.datasets
        )
    ]
    if config.runner.get("cache_dataset_on_device", False):
        quantize = bool(config.runner.get("cache_quantize_images", False))
        logger.info("Caching datasets on device" + (", lossless uint8 images" if quantize else "") + ".")
        dataloaders = [DeviceCachedLoader(loader, device, quantize_images=quantize) for loader in dataloaders]
    for i, loader in enumerate(dataloaders):
        logger.info(f"Data: dataset No.{i}: {len(loader.dataset)} items, {len(loader)} batches")
        if len(loader) == 0:
            raise ValueError(f"The dataloader No.{i} is empty")
    setup_iter_based_runner(config.runner, dataloaders[0], logger)

    pipeline = PIPELINES.build(config.pipeline, generator=torch.Generator().manual_seed(seed), device=device)
    optimizer = create_optimizer(config.runner, pipeline)
    state = TrainState(pipeline=pipeline, optimizer=optimizer, step=0)
    lr_schedule = create_lr_schedule(config.runner)

    start_epoch = skip_iters = 0
    if args.checkpoint and str(args.checkpoint).endswith(".pth"):
        # the reference's torch weights: the parameters only, no optimizer state
        n_missing = import_torch_checkpoint(args.checkpoint, pipeline)
        logger.info(f"Imported reference .pth weights from: {args.checkpoint} ({n_missing} unmapped tensors)")
    elif args.checkpoint:
        start_epoch = load_checkpoint(args.checkpoint, state)["epoch"] + 1
        done = state.step - start_epoch * len(dataloaders[0])
        if done > 0:  # an emergency checkpoint, saved mid-epoch: go on from the step it reached
            start_epoch, skip_iters = start_epoch + done // len(dataloaders[0]), done % len(dataloaders[0])
        logger.info(f"Resumed checkpoint from: {args.checkpoint} (epoch {start_epoch - 1}, step {state.step})")

    runner = config.runner
    runner["hooks"] = [HOOKS.build(dict(hook_cfg)) for hook_cfg in (runner.get("hooks", []) or [])]
    logger.info(f"Hooks: {[type(h).__name__ for h in runner['hooks']]}")
    result: Dict[str, Any] = {"output_dir": output_dir, "state": state, "train_stats": [], "val_stats": []}
    if not args.test_only:
        train_step = make_train_step(pipeline, runner, seed)
        train_step_vis = make_train_step(pipeline, runner, seed, rasterize_mc=True) if runner.get("train_vis", True) else None
        train_step_fused = None
        if int(runner.get("steps_per_call", 1) or 1) > 1:
            train_step_fused = make_train_step_fused(pipeline, runner, seed, dataloaders[0].data_wrapper)
        result["train_step_fused"] = train_step_fused
        logger.info(f"Start Training. Epoch range: {start_epoch} -> {runner['num_epochs']}")
        best_metric = -1e10
        t0 = time.perf_counter()
        guard = PreemptionGuard().install()
        try:
            for epoch in range(start_epoch, runner["num_epochs"]):
                state, train_stats = train_one_epoch(
                    RunType.TRAIN, runner, epoch, state, dataloaders[0], train_step, lr_schedule,
                    train_step_vis=train_step_vis, preemption_guard=guard, train_step_fused=train_step_fused,
                    skip_iters=skip_iters if epoch == start_epoch else 0,
                )
                if guard.preempted:
                    # saved as the epoch before, so a resume re-enters this epoch at the step it reached
                    path = save_checkpoint(output_dir, state, epoch=epoch - 1, name="ckpts_preempt")
                    logger.info(f"Preemption: saved emergency checkpoint to {path} (mid-epoch {epoch}, step "
                                f"{state.step}); re-run the same command with --auto_resume to continue")
                    result["preempted"] = path
                    return result
                result["train_stats"].append(train_stats)
                _append_json(output_dir / "train_stats.json",
                             {"epoch": epoch, **{f"train_{k}": v for k, v in train_stats.items()}})
                if (epoch + 1) % runner["val_per_epoch"] == 0:
                    logger.info(f"Start val at epoch: {epoch}")
                    val_stats = eval_one_epoch(RunType.VAL, runner, epoch, pipeline, dataloaders[1], seed)
                    result["val_stats"].append(val_stats)
                    _append_json(output_dir / "val_stats.json",
                                 {"epoch": epoch, **{f"val_{k}": v for k, v in val_stats.items()}})
                    current = val_stats.get(MONITOR_METRIC_NAME)
                    if current is not None and current > best_metric:
                        logger.info(f"Monitor Metric: {best_metric} -> {current}.")
                        best_metric = current
                        save_checkpoint(output_dir, state, epoch=-1, async_save=True)
                        logger.info("Save Best Model to Epoch: -1")
                if (epoch + 1) % runner["save_per_epoch"] == 0:
                    save_checkpoint(output_dir, state, epoch=epoch, async_save=True)
                    logger.info(f"Save Model at Epoch: {epoch}")
        finally:
            guard.uninstall()
            wait_for_async_saves()
        logger.info(f"Training time: {datetime.timedelta(seconds=int(time.perf_counter() - t0))}")
        result["checkpoint"] = save_checkpoint(output_dir, state, epoch=runner["num_epochs"] - 1)
        if runner.get("eval_last_epoch_model", True) is False:
            best = find_best_checkpoint(output_dir)
            if best is not None:
                load_checkpoint(best, state)
                logger.info(f"Loaded best checkpoint: {best}")
        else:
            logger.info("eval last epoch model")

    logger.info("Start Testing.")
    test_stats = eval_one_epoch(RunType.TEST, runner, -1, pipeline, dataloaders[2], seed)
    _append_json(output_dir / "test_stats.json", {f"test_{k}": v for k, v in test_stats.items()})
    result["test_stats"] = test_stats
    return result


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--config", default="./configs/nerf/lego.yml")
    parser.add_argument("--output_dir", type=str, default=None)
    parser.add_argument("--checkpoint", type=str, default=None,
                        help="a checkpoint of this runner to resume from, or a reference-layout .pth of weights")
    parser.add_argument("--auto_resume", action="store_true",
                        help="resume from the newest checkpoint under output_dir (after a preemption)")
    parser.add_argument("--test_only", action="store_true")
    parser.add_argument("--device", default="cuda", help="torch device; cuda without a GPU raises")
    parser.add_argument("--seed", default=None, type=int)
    parser.add_argument("--debug", action="store_true")
    parser.add_argument(
        "--cfg_options", nargs="+", action=DictAction,
        help="override settings in the config: key=value pairs merged into it (as scripts/run.py)",
    )
    return parser.parse_args(argv)


if __name__ == "__main__":
    main()
