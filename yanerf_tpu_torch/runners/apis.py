"""The train step, the fused K-step dispatch, and the train / eval loops.

Counterpart of ``yanerf_tpu/runners/apis.py`` on one GPU:
  * a train step (``make_train_step``) is the pipeline's TRAINING forward,
    the mean of the per-sample objective, ``backward()`` and one Adam update
    at the learning rate of the update's index (``optim.py``);
  * the random draws of step ``k`` are made ahead (``make_step_draws``)
    from a ``torch.Generator`` seeded from ``(seed, k)`` and fed in through
    ``draws``, on both train paths, so a resumed run draws what an unbroken
    one would (the JAX package folds its key with the step the same way).
    Tests feed the JAX package's own draws instead;
  * ``make_train_step_fused`` is the counterpart of the JAX package's K
    steps in one ``lax.scan``: on the card one whole step (gather from the
    device dataset cache, decode, forward, ``backward()``, Adam) is
    captured once as a CUDA graph and replayed K times per dispatch,
    reading its batch rows, draws and learning rates from static buffers at
    a device counter; on the CPU the same step runs uncaptured.
    ``_train_one_epoch_fused`` groups an epoch's steps as the JAX loop does
    (epoch tails, one unfused vis step at ``val_per_iter`` boundaries, a
    split at ``profile_start_iter``); ``train_one_epoch`` takes it when
    ``_fused_eligible``;
  * hooks, the periodic training vis (``output_rasterized_mc``), preemption
    checked between steps (between dispatches on the fused path), and a
    ``torch.profiler`` Chrome trace of a few early steps (``profile_dir``,
    ``profile_start_iter``, ``profile_num_iters``) in which each dispatch
    is a named region (``utils.profiling.annotate``): ``train_step_dispatch``
    per step, ``fused_dispatch_K{n}`` around a fused dispatch's n replays;
    inside them ``data.batch`` (the batch: the loader, ``prepare_batch``,
    the hooks; a dispatch's row and rate uploads), ``runner.draws`` and
    ``update``'s ``runner.forward`` / ``runner.backward`` /
    ``runner.optimizer`` (in a captured step at the capture alone);
  * the per-step and per-frame log lines split each span as the JAX loops
    do (``utils.timer.Timer``): ``data`` up to the batch's hooks,
    ``inference`` up to the step's device sync (a print step) or the
    frame's value fetch; the rest of the span is discarded;
  * eval keeps ``eval_frames_in_flight`` frames dispatched before the
    oldest one's losses are fetched, writes the frames on a thread
    (``AsyncVisWriter``), and truncates to the dataset length before the
    mean;
  * under a (data x rays) mesh (``parallel/``) a step reduces the
    gradients over the mesh before Adam (captured with the step on the
    card), and eval gathers the per-sample losses over the data group.
"""

from __future__ import annotations

import itertools
import logging
import time
from collections import defaultdict, deque
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..datasets.loader import decode_cached_field
from ..ops.kernels import launch_count
from ..ops.metrics import mse2psnr
from ..ops.structures import EvaluationMode
from ..parallel import active_mesh, concat_all_gather, is_dist_avail_and_initialized, is_main_process, reduce_gradients
from ..pipelines.nerf_pipeline import make_draws
from ..utils.profiling import annotate, profiler
from ..utils.timer import Timer
from .hooks import EvalDataHook, EvalOutputsHook, TrainDataHook, TrainOutputsHook
from .optim import TrainState, apply_learning_rates, learning_rates, set_learning_rates
from .vis import AsyncVisWriter, RunType, vis_batch_img

LOG_HEADER = "{}\tEpoch:\t[{}]"
logger = logging.getLogger("yanerf_tpu_torch.runner")


def create_stats(preds: Dict, prefixes=("loss_", "objective")) -> Dict[str, float]:
    """Mean every ``loss_*`` / ``objective`` entry to a float; derive ``*_psnr`` from ``*_mse``.

    In the keys' sorted order: the JAX package's jitted steps return their
    dicts so, and the log lines and stats files list the fields in its order.
    """
    stats: Dict[str, float] = {}
    for key in sorted(preds):
        value = preds[key]
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


def make_step_draws(
    pipeline, batch_size: int, seed: int, step: int, out: Optional[Dict[str, Any]] = None, masked: bool = False,
    n_rays_per_image=None,
):
    """The random draws of train step ``step`` (``pipeline.training_draws``), into ``out`` if given; ``masked``
    for a batch whose pixels are drawn by a mask (``pipeline.masked_training``), with its ray count(s)."""
    device = pipeline.device
    specs = pipeline.training_draws(batch_size, n_rays_per_image=n_rays_per_image, masked=masked)
    return make_draws(specs, step_generator(device, seed, step), device, out)


def loss_keys(preds: Dict[str, Any]) -> List[str]:
    """The entries of ``preds`` a loop logs and averages: every ``loss_*`` and the ``objective``."""
    return [k for k in preds if k.startswith("loss_") or k == "objective"]


def update(pipeline, optimizer, batch: Dict[str, Any], draws: Dict[str, Any], rasterize_mc: bool = False):
    """One update at the rates already in ``optimizer``'s groups: the TRAINING forward of ``batch`` with
    ``draws``, ``backward()`` of the mean objective, the gradients reduced over the active mesh
    (``parallel.reduce_gradients``) and the optimizer's step. Returns the predictions.

    Both train paths run this, so the fused step is the per-step loop's
    step bit for bit.
    """
    with annotate("runner.forward"):
        pipeline.train()
        preds = pipeline(evaluation_mode=EvaluationMode.TRAINING, output_rasterized_mc=rasterize_mc, draws=draws,
                         **batch)
        if "objective" not in preds:
            raise KeyError("In train mode, but no loss (`objective`) is found.")
    with annotate("runner.backward"):
        optimizer.zero_grad(set_to_none=True)
        torch.mean(preds["objective"]).backward()
    with annotate("runner.optimizer"):
        reduce_gradients(pipeline.parameters())  # over the mesh, when one is installed: in a captured step too
        optimizer.step()
    return preds


def make_train_step(pipeline, runner_config, seed: int, rasterize_mc: bool = False) -> Callable:
    """``step(state, batch, draws=None) -> preds``: one update of ``state`` in place.

    Without ``draws`` the step makes its own (``make_step_draws``).
    ``rasterize_mc`` splats the Monte-Carlo samples onto the image (the
    training vis step).
    """

    def step(state: TrainState, batch: Dict[str, Any], draws: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
        if draws is None:
            with annotate("runner.draws"):
                draws = make_step_draws(pipeline, batch["poses"].shape[0], seed, state.step,
                                        masked=pipeline.masked_training(batch),
                                        n_rays_per_image=batch.get("n_rays_per_image"))
        set_learning_rates(runner_config, state.optimizer, state.step)
        preds = update(pipeline, state.optimizer, batch, draws, rasterize_mc)
        state.step += 1
        return {k: v.detach() if isinstance(v, torch.Tensor) else v for k, v in preds.items()}

    return step


def _gather_batch(arrays: Sequence[torch.Tensor], data_wrapper: Callable, idx: torch.Tensor) -> Dict[str, Any]:
    """The batch of cache rows ``idx``: a gather of every cached field, uint8 images decoded."""
    return data_wrapper(*[decode_cached_field(a.index_select(0, idx)) for a in arrays])._asdict()


def _upload(dst: torch.Tensor, rows) -> None:
    """Host values into a static buffer; on the card through pinned memory, without a host sync."""
    src = torch.as_tensor(np.asarray(rows), dtype=dst.dtype)
    if dst.is_cuda:
        dst.copy_(src.pin_memory(), non_blocking=True)
    else:
        dst.copy_(src)


class FusedTrainStep:
    """K train steps per host dispatch: ``step(state, arrays, idx) -> {loss key: (K, B) history}``.

    ``arrays`` is a ``DeviceCachedLoader``'s cache and ``idx`` the ``(K, B)``
    cache rows of K consecutive steps. Per dispatch the host writes the
    rows, the K learning rates of every param group and the K steps' draws
    (``make_step_draws``, the per-step loop's calls) into static buffers;
    the step reads them at a device counter, writes its per-sample losses
    to row ``counter`` of a static history and advances the counter.

    On the card the step is captured once per run as a CUDA graph and
    replayed: the first step of the first dispatch runs eagerly on the
    capture's stream (the warm-up is a real step, so it advances the
    training state exactly once), the next is captured and every later step
    is a replay, whatever the group's size. The kernels' launch counts grow
    by the capture's tally at each replay (``launch_count.py``). A capture
    that fails raises: there is no fallback to the per-step loop. On the
    CPU the same step runs K times, uncaptured.

    The graph holds the addresses of the parameters, the Adam state, the
    packed NeRF-MLP weights (rewritten in place each step) and the cache:
    a new optimizer state (a checkpoint loaded after the capture) needs a
    new ``FusedTrainStep``.
    """

    def __init__(self, pipeline, runner_config, seed: int, data_wrapper: Callable, steps_per_call: int) -> None:
        self.pipeline = pipeline
        self.runner_config = runner_config
        self.seed = int(seed)
        self.data_wrapper = data_wrapper
        self.steps_per_call = int(steps_per_call)
        self.seen_group_sizes: set = set()
        self.dispatches = 0
        self.steps = 0
        self.capture_s: Optional[float] = None
        self.graph: Optional["torch.cuda.CUDAGraph"] = None
        self.tally = None  # kernel launches per replay
        self.loss_keys: Optional[List[str]] = None  # the rows of the loss history
        self._arrays = None
        self._optimizer = None

    def _allocate(self, state: TrainState, arrays, batch_size: int) -> None:
        device, k = self.pipeline.device, self.steps_per_call
        self._arrays, self._optimizer, self._batch_size = arrays, state.optimizer, batch_size
        self._row = torch.zeros(1, dtype=torch.int64, device=device)
        self._idx = torch.zeros((k, batch_size), dtype=torch.int64, device=device)
        self._lr = torch.zeros((k, len(state.optimizer.param_groups)), dtype=torch.float32, device=device)
        self._draws: Dict[str, Any] = {}
        for spec in self.pipeline.training_draws(batch_size):
            dtype = torch.float32 if spec.kind in ("uniform", "normal", "gumbel") else torch.int64
            buf = torch.zeros((k, *spec.shape), dtype=dtype, device=device)
            if spec.listed:
                self._draws.setdefault(spec.key, []).append(buf)
            else:
                self._draws[spec.key] = buf
        self._hist = None

    def _step(self) -> None:
        """One train step, all of its inputs read from the static buffers at the device counter."""
        row = self._row
        batch = _gather_batch(self._arrays, self.data_wrapper, self._idx.index_select(0, row)[0])
        if self.pipeline.masked_training(batch):
            raise NotImplementedError("the fused dispatch makes each step's pixel draws ahead, without a mask: a "
                                      "batch with mask_crop / sampling_prob_mask trains per step")
        draws = {
            key: [t.index_select(0, row)[0] for t in buf] if isinstance(buf, list) else buf.index_select(0, row)[0]
            for key, buf in self._draws.items()
        }
        apply_learning_rates(self._optimizer, self._lr.index_select(0, row)[0])
        preds = update(self.pipeline, self._optimizer, batch, draws)
        if self.loss_keys is None:
            self.loss_keys = loss_keys(preds)
        losses = torch.stack([preds[k].detach().to(torch.float32) for k in self.loss_keys])
        if self._hist is None:
            self._hist = torch.zeros((self.steps_per_call, *losses.shape), dtype=torch.float32, device=losses.device)
        self._hist.index_copy_(0, row, losses[None])
        row.add_(1)

    def _capture(self) -> None:
        """The warm-up step (a real one) and the capture, both on a side stream."""
        device = self.pipeline.device
        stream = torch.cuda.Stream(device)
        stream.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(stream):
            self._step()
        torch.cuda.current_stream(device).wait_stream(stream)
        t0 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        self._optimizer.zero_grad(set_to_none=True)
        with launch_count.capturing() as tally:
            with torch.cuda.graph(graph, stream=stream):
                self._step()
        self.capture_s = time.perf_counter() - t0
        self.graph, self.tally = graph, tally
        logger.info(f"captured the train step as a CUDA graph in {self.capture_s:.2f} s; kernel launches per "
                    f"replay: {launch_count.per_replay(tally)}")

    def __call__(self, state: TrainState, arrays, idx: np.ndarray) -> Dict[str, torch.Tensor]:
        n_steps, batch_size = idx.shape
        if not 1 <= n_steps <= self.steps_per_call:
            raise ValueError(f"a dispatch takes 1 to {self.steps_per_call} steps, got {n_steps}")
        if self._arrays is None:
            self._allocate(state, arrays, batch_size)
        elif arrays is not self._arrays or state.optimizer is not self._optimizer or batch_size != self._batch_size:
            raise ValueError("this fused step was built for another dataset cache, optimizer or batch size")
        first = state.step
        with annotate("data.batch"):
            _upload(self._idx[:n_steps], idx)
            _upload(self._lr[:n_steps], learning_rates(self.runner_config, state.optimizer,
                                                       range(first, first + n_steps)))
        with annotate("runner.draws"):
            for k in range(n_steps):
                out = {key: [t[k] for t in buf] if isinstance(buf, list) else buf[k]
                       for key, buf in self._draws.items()}
                make_step_draws(self.pipeline, batch_size, self.seed, first + k, out=out)
        self._row.zero_()
        k = 0
        if self.pipeline.device.type == "cuda" and self.graph is None:
            self._capture()
            k = 1
        for _ in range(k, n_steps):
            if self.graph is None:
                self._step()
            else:
                self.graph.replay()
                launch_count.replayed(self.tally)
        for module in self.pipeline.modules():
            if hasattr(module, "params_changed"):
                module.params_changed()  # the replays changed them behind _version's back
        state.step += n_steps
        self.dispatches += 1
        self.steps += n_steps
        hist = self._hist[:n_steps].clone()
        return {key: hist[:, j] for j, key in enumerate(self.loss_keys)}


def make_train_step_fused(pipeline, runner_config, seed: int, data_wrapper: Callable) -> FusedTrainStep:
    """The fused K-step trainer of ``runner_config.steps_per_call`` (see :class:`FusedTrainStep`)."""
    return FusedTrainStep(pipeline, runner_config, seed, data_wrapper, int(runner_config["steps_per_call"]))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _fetch(x: Optional[torch.Tensor]) -> None:
    """Wait for ``x`` by copying one of its values to the host (the JAX loops' ``_sync_fetch``). On the card
    the copy is stream-ordered: it also waits for the frames dispatched after ``x``'s."""
    if x is not None:
        x.reshape(-1)[:1].cpu()


class _TraceCapture:
    """A ``torch.profiler`` trace of ``profile_num_iters`` steps of epoch 0 from ``profile_start_iter`` on.

    The Chrome trace goes to ``{profile_dir}/{run_type}_trace.json``.
    """

    def __init__(self, config, epoch: int, run_type: RunType, device: torch.device) -> None:
        self.dir = config.get("profile_dir") if epoch == 0 else None
        start, length = config.get("profile_start_iter"), config.get("profile_num_iters")
        self.start = 5 if start is None else int(start)
        self.length = 5 if length is None else int(length)
        self.path = Path(self.dir) / f"{run_type.value}_trace.json" if self.dir else None
        self.device = device
        self.profiler = None
        self.steps = 0

    def maybe_start(self, i: int) -> None:
        if self.dir and self.profiler is None and i >= self.start:
            self.profiler = profiler(self.device.type == "cuda")
            self.profiler.start()

    def stepped(self, n: int) -> None:
        if self.profiler is not None:
            self.steps += n
            if self.steps >= self.length:
                self.stop()

    def stop(self) -> None:
        if self.profiler is None:
            return
        _sync(self.device)
        self.profiler.stop()
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self.profiler.export_chrome_trace(str(self.path))
        logger.info(f"Wrote profiler trace to {self.path}")
        self.profiler, self.dir = None, None


def _fused_eligible(config, dataloader, train_step_fused) -> bool:
    """The fused path needs: ``steps_per_call > 1``, a device cache that fits, no hooks, no ragged final
    batch, and every cached field a tensor the step can gather from."""
    if train_step_fused is None or int(config.get("steps_per_call", 1) or 1) <= 1:
        return False
    if config.get("hooks", []):
        return False
    if not hasattr(dataloader, "_ensure_cache") or not dataloader._ensure_cache():
        return False
    if not dataloader.drop_last and len(dataloader.dataset) % dataloader.batch_size != 0:
        return False
    return all(isinstance(a, torch.Tensor) for a in dataloader._arrays)


def _train_one_epoch_fused(
    run_type: RunType,
    config,
    epoch: int,
    state: TrainState,
    dataloader,
    train_step_fused: FusedTrainStep,
    train_step_vis: Optional[Callable] = None,
    lr_schedule: Optional[Callable] = None,
    preemption_guard=None,
    skip_iters: int = 0,
) -> Tuple[TrainState, Dict[str, float]]:
    """The epoch as fused dispatches of up to ``steps_per_call`` steps (see :class:`FusedTrainStep`).

    The same sampler rows, draws and rates as the per-step loop, and the
    same periodic vis steps (run unfused at ``val_per_iter`` boundaries so
    the rasterized outputs exist): only the host's dispatch granularity
    changes. Preemption is checked between dispatches, so a SIGTERM drains
    at most ``steps_per_call`` steps. ``step_s`` is the host time per step
    from the end of the epoch's first dispatch to the end of its last.
    """
    steps_per_call = int(config["steps_per_call"])
    device = state.pipeline.device
    passed_iter = epoch * len(dataloader)
    header = LOG_HEADER.format(run_type.value, epoch)
    print_per_iter = config.get("print_per_iter", 100)
    val_per_iter = config.get("val_per_iter")

    if dataloader.sampler is not None:
        dataloader.sampler.set_epoch(epoch)
    arrays = dataloader._arrays
    indices = dataloader.sampler.indices() if dataloader.sampler is not None else np.arange(len(dataloader.dataset))
    batch_size = dataloader.batch_size
    rows = [
        indices[s : s + batch_size]
        for s in range(0, len(indices), batch_size)
        if len(indices[s : s + batch_size]) == batch_size or not dataloader.drop_last
    ]
    n = len(rows)

    def is_vis_iter(it: int) -> bool:
        return bool(train_step_vis is not None and val_per_iter and it % val_per_iter == 0)

    trace = _TraceCapture(config, epoch, run_type, device)
    last_losses: Dict[str, Any] = {}
    t_first = None
    timed_steps = 0
    i = skip_iters
    while i < n:
        if preemption_guard is not None and preemption_guard.preempted:
            logger.info(f"{header}: preemption requested, stopping at iter {passed_iter + i}")
            break
        t_span = time.perf_counter()
        trace.maybe_start(i)
        if is_vis_iter(passed_iter + i):
            # one unfused step with the Monte-Carlo rasterization, for the sanity dump
            batch = _gather_batch(arrays, dataloader.data_wrapper, torch.as_tensor(rows[i], device=device))
            preds = train_step_vis(state, batch)
            last_losses = {k: preds[k] for k in loss_keys(preds)}
            if config.get("output_dir") and is_main_process():
                logger.info("save training image to check sanity.")
                vis_batch_img(preds, run_type, config["output_dir"], 0, batch_size, f"{epoch:05d}/")
            j = i + 1
        else:
            j = i + 1
            while j < n and j - i < steps_per_call and not is_vis_iter(passed_iter + j):
                if trace.dir and trace.profiler is None and j == trace.start:
                    break  # the next dispatch begins exactly at profile_start_iter
                j += 1
            if j - i not in train_step_fused.seen_group_sizes:
                train_step_fused.seen_group_sizes.add(j - i)
                if len(train_step_fused.seen_group_sizes) > 1:
                    logger.info(f"{header}: fused dispatch group size K={j - i} is new (seen: "
                                f"{sorted(train_step_fused.seen_group_sizes)}): the captured step replays K times")
            with annotate(f"fused_dispatch_K{j - i}"):  # around the replays: nothing is captured inside it
                hist = train_step_fused(state, arrays, np.stack(rows[i:j]))
            last_losses = {k: v[-1] for k, v in hist.items()}
        trace.stepped(j - i)
        if t_first is None:
            _sync(device)
            t_first = time.perf_counter()
        else:
            timed_steps += j - i

        if any((passed_iter + t) % print_per_iter == 0 for t in range(i, j)):
            stats = create_stats(last_losses)  # a device sync
            span_s = time.perf_counter() - t_span
            if lr_schedule is not None:
                logger.info(f"{header}\tlr: {lr_schedule(passed_iter + j - 1):.3e}.")
            log_string = "\t".join(
                [f"iter: {passed_iter + j - 1}\tsampler: [{i * batch_size}/{n * batch_size}]"]
                + [f"step: {span_s / (j - i):.4f}"]
                + [f"{k}: {v:.3f}" for k, v in stats.items()]
            )
            logger.info(f"{header}: {log_string}")
        i = j

    trace.stop()
    _sync(device)
    stats = create_stats(last_losses)
    if timed_steps:
        stats["step_s"] = (time.perf_counter() - t_first) / timed_steps
    return state, stats


def train_one_epoch(
    run_type: Union[RunType, str],
    config,
    epoch: int,
    state: TrainState,
    dataloader,
    train_step: Callable,
    lr_schedule: Optional[Callable] = None,
    train_step_vis: Optional[Callable] = None,
    preemption_guard=None,
    train_step_fused: Optional[FusedTrainStep] = None,
    skip_iters: int = 0,
) -> Tuple[TrainState, Dict[str, float]]:
    """One epoch of updates; the stats hold the last step's losses and ``step_s``.

    Takes the fused path when ``train_step_fused`` is given and
    ``_fused_eligible``. ``step_s`` is the host time per step from the end
    of the epoch's first step to the end of its last, each end a device
    synchronize (the first step carries one-off costs: kernel builds,
    library set-up). ``skip_iters`` passes over the epoch's first
    iterations (those a resumed emergency checkpoint already took), so the
    run continues where it stopped.
    """
    run_type = RunType(run_type)
    if train_step_fused is not None and int(config.get("steps_per_call", 1) or 1) > 1:
        if _fused_eligible(config, dataloader, train_step_fused):
            return _train_one_epoch_fused(run_type, config, epoch, state, dataloader, train_step_fused,
                                          train_step_vis=train_step_vis, lr_schedule=lr_schedule,
                                          preemption_guard=preemption_guard, skip_iters=skip_iters)
        if epoch == 0:
            logger.info("steps_per_call requested but the fused path is ineligible (needs a fitting device dataset "
                        "cache, no hooks, no ragged final batch) — using the per-step loop.")
    device = state.pipeline.device
    passed_iter = epoch * len(dataloader)
    header = LOG_HEADER.format(run_type.value, epoch)
    print_per_iter = config.get("print_per_iter", 100)
    val_per_iter = config.get("val_per_iter")
    hooks = config.get("hooks", []) or []
    if dataloader.sampler is not None:
        dataloader.sampler.set_epoch(epoch)

    trace = _TraceCapture(config, epoch, run_type, device)
    preds: Dict[str, Any] = {}
    t_first = None
    n_steps = 0
    timer = Timer()
    batches = iter(dataloader)
    for _ in zip(range(skip_iters), batches):  # the iterations a resumed run already took
        passed_iter += 1
    timer.since_last_check()
    for i in itertools.count(skip_iters):
        if preemption_guard is not None and preemption_guard.preempted:
            logger.info(f"{header}: preemption requested, stopping at iter {passed_iter}")
            break
        with annotate("data.batch"):
            data = next(batches, None)
            if data is None:
                break
            batch = prepare_batch(data, dataloader.data_wrapper, device)
            for hook in hooks:
                if isinstance(hook, TrainDataHook):
                    batch = hook(data=batch, iter=passed_iter, epoch=epoch, config=config)
        times: Dict[str, float] = {"data": timer.since_last_check()}
        trace.maybe_start(i)
        want_vis = bool(train_step_vis is not None and val_per_iter and passed_iter % val_per_iter == 0)
        with annotate("train_step_dispatch"):
            preds = (train_step_vis if want_vis else train_step)(state, batch)
        n_steps += 1
        trace.stepped(1)
        for hook in hooks:
            if isinstance(hook, TrainOutputsHook):
                preds = hook(outputs=preds, config=config, iter=passed_iter, epoch=epoch)
        if n_steps == 1:
            _sync(device)
            t_first = time.perf_counter()
        if passed_iter % print_per_iter == 0:
            _sync(device)
            times["inference"] = timer.since_last_check()
            if lr_schedule is not None:
                logger.info(f"{header}\tlr: {lr_schedule(passed_iter):.3e}.")
            stats = create_stats(preds)
            log_string = "\t".join(
                [f"iter: {passed_iter}\tsampler: [{i * dataloader.batch_size}/{len(dataloader) * dataloader.batch_size}]"]
                + [f"{k}: {v:.3f}" for k, v in times.items()]
                + [f"{k}: {v:.3f}" for k, v in stats.items()]
            )
            logger.info(f"{header}: {log_string}")
        if want_vis and config.get("output_dir") and is_main_process():
            logger.info("save training image to check sanity.")
            vis_batch_img(preds, run_type, config["output_dir"], 0, dataloader.batch_size, f"{epoch:05d}/")
        passed_iter += 1
        timer.since_last_check()  # the rest of the step's span (the log, the vis) is no step's data
    trace.stop()
    _sync(device)
    stats = create_stats(preds)
    if n_steps > 1:
        stats["step_s"] = (time.perf_counter() - t_first) / (n_steps - 1)
    return state, stats


@torch.inference_mode()
def eval_one_epoch(
    run_type: Union[RunType, str],
    config,
    epoch: int,
    pipeline,
    dataloader,
    seed: int,
) -> Dict[str, float]:
    """Render every frame of ``dataloader`` in EVALUATION and mean its per-sample losses.

    Frame ``i + eval_frames_in_flight`` (default 2) is dispatched before
    frame ``i``'s losses are fetched, so the card renders while the host
    fetches, logs and hands the frame to the vis writer (with an
    ``output_dir``); the stats do not depend on the depth. The per-sample
    losses are concatenated, truncated to the dataset length, then meaned.
    Under a mesh (``parallel.mesh_context``) each data index renders its
    shard of the frames (each frame's rays split over its ray group), the
    per-sample losses of each batch are gathered over the data group in
    rank order (``concat_all_gather``), and the first process of each data
    index writes its frames' vis at their dataset indices.
    """
    run_type = RunType(run_type)
    if dataloader.drop_last:
        raise ValueError("Incomplete eval due to `drop_last`.")
    header = LOG_HEADER.format(run_type.value, epoch)
    print_per_iter = config.get("print_per_iter", 50)
    hooks = config.get("hooks", []) or []
    batch_size = dataloader.batch_size
    pipeline.eval()
    metric_stats: Dict[str, list] = defaultdict(list)
    mesh = active_mesh()
    gathered = mesh is not None and is_dist_avail_and_initialized()
    data_group = mesh.data_group if gathered else None
    data_parallel, data_index = (mesh.data_parallel, mesh.data_index) if mesh is not None else (1, 0)
    # one writer per frame: the first process of each data index writes its shard's frames
    writes = config.get("output_dir") and (mesh is None or mesh.ray_index == 0)
    vis_writer = AsyncVisWriter() if writes else None

    timer = Timer()

    def process_frame(preds: Dict[str, Any], i: int, times: Dict[str, float]) -> Dict[str, Any]:
        """The host's consumption of a dispatched frame: fetch, metrics, log, vis."""
        for hook in hooks:
            if isinstance(hook, EvalOutputsHook):
                preds = hook(outputs=preds, config=config, iter=i, epoch=epoch)
        _fetch(preds.get("objective", preds.get("rendered_images")))
        times["inference"] = timer.since_last_check()
        for key in loss_keys(preds):
            value = preds[key].detach().double().cpu().numpy()
            metric_stats[key].append(concat_all_gather(value, data_group) if gathered else value)
        if i % print_per_iter == 0:
            stats = create_stats(preds)
            logger.info(f"{header}: " + "\t".join([f"sampler: [{i * batch_size}/{len(dataloader.dataset)}]"]
                                                   + [f"{k}: {v:.3f}" for k, v in times.items()]
                                                   + [f"{k}: {v:.3f}" for k, v in stats.items()]))
        if vis_writer is not None:
            start_idx = (i * data_parallel + data_index) * batch_size
            end_idx = min(len(dataloader.dataset), start_idx + batch_size)
            vis_writer.submit(preds, run_type, config["output_dir"], start_idx, end_idx,
                              "" if run_type == RunType.TEST else f"{epoch:05d}/")
        timer.since_last_check()  # the host's consumption is not the next frame's data
        return preds

    depth = max(1, int(config.get("eval_frames_in_flight", 2)))
    pending: deque = deque()  # each: (preds, index, times)
    try:
        for i, data in enumerate(dataloader):
            times: Dict[str, float] = {}
            batch = prepare_batch(data, dataloader.data_wrapper, pipeline.device)
            for hook in hooks:
                if isinstance(hook, EvalDataHook):
                    batch = hook(data=batch, config=config, iter=i, epoch=epoch)
            times["data"] = timer.since_last_check()
            preds = pipeline(
                evaluation_mode=EvaluationMode.EVALUATION,
                generator=step_generator(pipeline.device, seed, i),
                **batch,
            )
            preds.update(batch)
            if len(pending) >= depth:
                process_frame(*pending.popleft())
            pending.append((preds, i, times))
        while pending:
            process_frame(*pending.popleft())
    finally:
        if vis_writer is not None:
            vis_writer.close()
    final = {key: float(np.mean(np.concatenate(chunks)[: len(dataloader.dataset)])) for key, chunks in metric_stats.items()}
    stats = create_stats(final)
    logger.info(f"{header}: [{len(dataloader.dataset)}/{len(dataloader.dataset)}]\t"
                + "\t".join(f"{k}: {v:.3f}" for k, v in stats.items()))
    return stats
