"""The traced stretch of a ``--trace 1`` run: a ``torch.profiler`` trace kept in memory, reduced to intervals.

The device's busy time is the union of its operations' intervals (kernels,
copies, fills) inside the stretch, never their sum, so overlapping kernels
count once. Idle gaps are labelled by what the host was doing at their
middle: the innermost named region (``record_function``) and the
innermost operator or runtime call covering it.
"""

from __future__ import annotations

import collections
import dataclasses
import re
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

WINDOW = "h100bench.stretch"
DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_KINDS = ("cpu_op", "user_annotation")
LABELLED_GAPS = 500  # the longest gaps, labelled by the host's activity
TOP = 10


def short_name(name: str) -> str:
    """A device operation's name without its return type, anonymous namespace, template and argument lists."""
    name = re.sub(r"^void ", "", name).replace("(anonymous namespace)::", "")
    return re.split(r"[<(]", name, maxsplit=1)[0][:96] or name[:96]


def base_name(name: str) -> str:
    """A kernel's unqualified function name: ``nerf_mlp_fwd_kernel`` of ``(anonymous namespace)::nerf_mlp_fwd_kernel(
    nerf_mlp::FwdArgs)``."""
    return short_name(name).rsplit("::", 1)[-1]


@dataclasses.dataclass
class Trace:
    """The stretch's intervals in microseconds of the profiler's clock.

    ``device``: ``(kind, name, start, end)`` of every device operation;
    ``host``: ``(kind, name, start, end)`` of every host event but the
    stretch itself; ``units`` steps or frames ran in it; ``work`` is the
    traffic's count of what one unit needs (see the traffic kinds).
    """

    device: List[Tuple[str, str, float, float]]
    host: List[Tuple[str, str, float, float]]
    window: Tuple[float, float]
    units: int
    work: Dict[str, Any]

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-6

    def kernels(self, names: Tuple[str, ...] = ()) -> List[Tuple[str, float, float]]:
        """The kernels (not copies or fills), those whose short name is one of ``names`` when given."""
        return [(n, s, e) for kind, n, s, e in self.device
                if kind == "kernel" and (not names or base_name(n) in names)]

    def busy_intervals(self) -> np.ndarray:
        """The union of the device operations' intervals inside the window, merged: ``(k, 2)``."""
        lo, hi = self.window
        spans = sorted((max(s, lo), min(e, hi)) for _, _, s, e in self.device if e > lo and s < hi)
        merged: List[List[float]] = []
        for s, e in spans:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return np.asarray(merged, dtype=np.float64).reshape(-1, 2)

    @property
    def busy_s(self) -> float:
        b = self.busy_intervals()
        return float(np.sum(b[:, 1] - b[:, 0])) * 1e-6

    def regions(self, pattern: str) -> List[Tuple[str, float, float]]:
        """The host's named regions whose name matches ``pattern`` (a regular expression, whole name)."""
        rx = re.compile(pattern)
        return [(n, s, e) for kind, n, s, e in self.host if kind == "user_annotation" and rx.fullmatch(n)]

    def breakdown(self) -> Dict[str, List[List[Any]]]:
        """The device operations that took most time, and the idle time by the host's activity."""
        by_name: Dict[str, float] = collections.defaultdict(float)
        for _, n, s, e in self.device:
            by_name[short_name(n)] += (e - s) * 1e-6
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
        busy = self.busy_intervals()
        starts = np.concatenate([[self.window[0]], busy[:, 1]])
        ends = np.concatenate([busy[:, 0], [self.window[1]]])
        keep = ends > starts
        starts, ends = starts[keep], ends[keep]
        longest = np.argsort(starts - ends)[:LABELLED_GAPS]
        regions = _Intervals([h for h in self.host if h[0] == "user_annotation"])
        calls = _Intervals([h for h in self.host if h[0] != "user_annotation"])
        by_label: Dict[str, float] = collections.defaultdict(float)
        for i in longest:
            mid = 0.5 * (starts[i] + ends[i])
            label = " > ".join(x for x in (regions.innermost(mid), calls.innermost(mid)) if x) or "nothing traced"
            by_label[label] += (ends[i] - starts[i]) * 1e-6
        gaps = sorted(by_label.items(), key=lambda kv: -kv[1])[:TOP]
        return {"device_ops": [[n, v] for n, v in ops], "idle_gaps": [[n, v] for n, v in gaps]}


class _Intervals:
    """Host events as arrays, to find the innermost one covering a time."""

    def __init__(self, events: List[Tuple[str, str, float, float]]) -> None:
        self.names = [n for _, n, _, _ in events]
        self.starts = np.asarray([s for _, _, s, _ in events], dtype=np.float64)
        self.ends = np.asarray([e for _, _, _, e in events], dtype=np.float64)

    def innermost(self, t: float) -> Optional[str]:
        """The name of the latest-starting event that covers ``t``."""
        covering = np.flatnonzero((self.starts <= t) & (self.ends >= t))
        if covering.size == 0:
            return None
        return self.names[covering[np.argmax(self.starts[covering])]]


def _kind(event) -> str:
    """``kernel``, ``gpu_memcpy``, ``gpu_memset`` or ``gpu_user_annotation`` on the device; ``user_annotation`` or
    ``cpu_op`` (operators and runtime calls) on the host."""
    annotation = event.is_user_annotation()
    if event.device_type() == torch.autograd.DeviceType.CPU:
        return "user_annotation" if annotation else "cpu_op"
    if annotation:
        return "gpu_user_annotation"
    name = event.name()
    return "gpu_memcpy" if name.startswith("Memcpy") else "gpu_memset" if name.startswith("Memset") else "kernel"


def profile(stretch: Callable[[], int], work: Dict[str, Any], cuda: bool) -> Trace:
    """Run ``stretch`` (it returns the units it ran) under the profiler and reduce the trace."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        with torch.profiler.record_function(WINDOW):
            if cuda:
                torch.cuda.synchronize()
            units = stretch()
            if cuda:
                torch.cuda.synchronize()
    device, host, window = [], [], None
    for ev in prof.profiler.kineto_results.events():
        kind, name = _kind(ev), ev.name()
        start = ev.start_ns() * 1e-3
        end = start + ev.duration_ns() * 1e-3
        if kind in DEVICE_KINDS:
            device.append((kind, name, start, end))
        elif kind in HOST_KINDS:
            if name == WINDOW:
                window = (start, end)
            else:
                host.append((kind, name, start, end))
    if window is None:
        raise RuntimeError("the profiler recorded no stretch")
    return Trace(device=device, host=host, window=window, units=int(units), work=work)


def roofline_share(trace: Trace, names: Tuple[str, ...], key: str) -> Optional[float]:
    """Percent of its roofline: the least time of the work the stretch's units need of these kernels
    (``trace.work[key]``, ``(operations, bytes)`` per launch) over their device time in the stretch."""
    from h100bench.counts.nerf import least_seconds

    kernels, work = trace.kernels(names), trace.work.get(key)
    if not kernels or not work or not trace.units:
        return None
    device_s = sum(e - s for _, s, e in kernels) * 1e-6
    return 100.0 * trace.units * sum(least_seconds(ops, io) for ops, io in work) / device_s


def mfu(trace: Trace) -> Optional[float]:
    """Percent of the card's bfloat16 peak: the models' operations of the stretch's units over its seconds."""
    from h100bench.counts.nerf import PEAK_BF16_FLOPS

    if not trace.units or not trace.work.get("model_flops"):
        return None
    return 100.0 * trace.units * trace.work["model_flops"] / trace.window_s / PEAK_BF16_FLOPS


def idle_percent(trace: Trace) -> Optional[float]:
    """Percent of the stretch in which no device operation ran (the union of their intervals)."""
    if not trace.device:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)


K1_NAMES = ("nerf_mlp_fwd_kernel", "nerf_mlp_fwd_pipelined_kernel")  # the NeRF MLP's forward kernels (K1, K2)
K3_NAMES = ("tile_kernel", "dw_kernel", "dw_reduce_kernel")  # the NeRF MLP's backward launch (K3)
