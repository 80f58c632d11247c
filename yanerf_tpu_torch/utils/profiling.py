"""Profiling / tracing helpers of the port.

``trace`` wraps a region in a ``torch.profiler`` trace (a Chrome trace in
the TensorBoard plugin's layout, readable in Perfetto or
chrome://tracing), ``annotate`` names a region inside a trace (a flag
check and nothing more while no profiler runs), and ``StepTimer`` keeps
the reference's data/inference split for the periodic log line.
``profiler`` is the one place that picks a trace's activities; the
runner's ``_TraceCapture`` takes it too.

The regions, nested on the host thread that opens them:
  * train step (``runners/apis.py``): ``train_step_dispatch`` per step,
    ``fused_dispatch_K{n}`` per fused dispatch; ``data.batch`` (the
    loader's batch, ``prepare_batch``, the data hooks; a dispatch's row
    and rate uploads), ``runner.draws``, and in ``update``
    ``runner.forward`` / ``runner.backward`` (the main thread waits there
    while autograd's thread launches the backward) / ``runner.optimizer``;
  * frame (``serve.py``, ``pipelines/``): ``service.render`` per request,
    ``service.fetch`` (the frame's copies to the host), ``pipeline.rays``,
    ``pipeline.chunk`` per chunk, ``model.<class name>`` per implicit
    function call (in a ``HashGridNeRF``'s, ``model.hash_encode`` around the
    encoding), ``renderer.refine`` / ``renderer.composite`` /
    ``renderer.losses``, ``pipeline.collate``.
"""

from __future__ import annotations

import contextlib
from pathlib import Path
from typing import Iterator, Union

import torch
import torch.autograd.profiler as autograd_profiler

from .timer import Timer

NO_SPAN = contextlib.nullcontext()  # what ``annotate`` returns while it records nothing


def profiler(cuda: bool, on_trace_ready=None) -> "torch.profiler.profile":
    """A ``torch.profiler.profile`` of the host's operators, and of the card's kernels when ``cuda``."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=activities, on_trace_ready=on_trace_ready)


@contextlib.contextmanager
def trace(log_dir: Union[str, Path, None], create_perfetto_link: bool = False) -> Iterator[None]:
    """Capture a ``torch.profiler`` trace of the enclosed region into ``log_dir``.

    A ``None`` log_dir disables tracing, so call sites can be
    unconditional: ``with trace(cfg.get("profile_dir")): ...``. The trace
    covers the host, and the card when one is present (its kernels end
    inside the region: it synchronizes before the trace stops); it is
    written as ``{host}_{pid}.{ns}.pt.trace.json`` in ``log_dir``, which it
    creates. A Perfetto link would upload the trace: the port makes none.
    """
    if log_dir is None:
        yield
        return
    if create_perfetto_link:
        raise NotImplementedError("trace(create_perfetto_link=True): a Perfetto link uploads the trace, which the "
                                  "port does not do; open the .pt.trace.json written to log_dir in ui.perfetto.dev")
    Path(log_dir).mkdir(parents=True, exist_ok=True)
    cuda = torch.cuda.is_available()
    with profiler(cuda, on_trace_ready=torch.profiler.tensorboard_trace_handler(str(log_dir))):
        yield
        if cuda:
            torch.cuda.synchronize()


def annotate(name: str) -> "Union[torch.profiler.record_function, contextlib.nullcontext]":
    """Name a region inside an active trace: a CPU range, and on the card the span of the kernels it launched.

    While no profiler runs (``torch.profiler.profile``, entered or
    ``start()``ed) it returns the shared no-op ``NO_SPAN`` and costs one
    flag check; so it does while ``torch.export`` or ``torch.compile``
    traces, and an exported program holds no profiler node. A region
    inside a step that a CUDA graph captures records at the capture alone:
    the replays run under the runner's ``fused_dispatch_K{n}``.
    """
    if not autograd_profiler._is_profiler_enabled or torch.compiler.is_compiling():
        return NO_SPAN
    return torch.profiler.record_function(name)


class StepTimer:
    """Per-step {phase: seconds} accumulator with the reference's split."""

    def __init__(self) -> None:
        self._timer = Timer()
        self.times: dict = {}

    def check(self, phase: str) -> float:
        dur = self._timer.since_last_check()
        self.times[phase] = dur
        return dur

    def reset(self) -> dict:
        out, self.times = self.times, {}
        self._timer.since_last_check()
        return out
