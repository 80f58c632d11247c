"""Launch counts of the kernels, CUDA graph replays included.

Each wrapper keeps the launches of its kernel in a module global
(``nerf_mlp_fwd.launches``, ``nerf_mlp_fwd.pipelined_launches``,
``nerf_mlp_bwd.launches``) and adds to it through :func:`count` where it
launches. A wrapper called while its stream is being captured into a CUDA
graph launches nothing: the kernel runs at every replay of the graph. So
under :func:`capturing` a call is noted in the capture's tally instead, and
:func:`replayed` adds that tally once per replay: a count is the launches
the card ran, not the Python calls.
"""

from __future__ import annotations

import collections
import contextlib
from typing import Counter, Dict, Iterator, Optional

import torch

_tally: Optional[Counter] = None  # (module, attribute) -> launches noted by the capture in progress


def count(module, attribute: str) -> None:
    """One launch of ``module.attribute``'s kernel (or, while a stream is captured, one per replay).

    A capture outside :func:`capturing` raises: its replays would launch
    kernels that no count sees.
    """
    if torch.cuda.is_current_stream_capturing():
        if _tally is None:
            raise RuntimeError(f"{module.__name__}.{attribute}: a CUDA graph captures this kernel outside "
                               "launch_count.capturing(), so its replays would go uncounted")
        _tally[(module, attribute)] += 1
        return
    setattr(module, attribute, getattr(module, attribute) + 1)


@contextlib.contextmanager
def capturing() -> Iterator[Counter]:
    """The launches noted while the block captures a graph: the tally to pass to :func:`replayed`."""
    global _tally
    previous, _tally = _tally, collections.Counter()
    try:
        yield _tally
    finally:
        _tally = previous


def replayed(tally: Counter) -> None:
    """Add the launches of one replay of a graph whose capture noted ``tally``."""
    for (module, attribute), n in tally.items():
        setattr(module, attribute, getattr(module, attribute) + n)


def per_replay(tally: Counter) -> Dict[str, int]:
    """``tally`` as ``{"module.attribute": launches per replay}``, for logs and records."""
    return {f"{module.__name__.rsplit('.', 1)[-1]}.{attribute}": n for (module, attribute), n in tally.items()}


def totals() -> Dict[str, int]:
    """Every kernel's launches in this process so far, by kernel."""
    from . import nerf_mlp_bwd, nerf_mlp_fwd

    return {"nerf_mlp_fwd": nerf_mlp_fwd.launches, "nerf_mlp_fwd_pipelined": nerf_mlp_fwd.pipelined_launches,
            "nerf_mlp_bwd": nerf_mlp_bwd.launches}
