"""The EVALUATION chunk loop on static buffers, replayed from one captured CUDA graph.

An eager frame launches every kernel of every chunk from the host: an
800x800 proposal frame is 313 chunks of about 250 small kernels each, and
the card waits for the launches. ``ChunkGraph`` runs the same chunk body
on static buffers of one frame shape, as ``FusedTrainStep`` runs a train
step:
  * the frame's padded inputs (``origins``, ``directions``, ``lengths``,
    ``xys``, ``bg_color`` where given) are written into static
    ``(B, n_padded, 1, C)`` buffers, read as ``(n_chunks, B, chunk_rays,
    1, C)`` chunks;
  * the body reads chunk ``counter`` (``index_select`` at a device
    counter), runs unchanged, writes every leaf of its output tree into
    static stacked outputs (``index_copy_``) and advances the counter;
  * on the card the body is captured once as a CUDA graph and replayed
    once per chunk, each replay a ``pipeline.replay`` trace region: the
    key's first chunk runs eagerly on a side stream (lazy set-up and K1's
    tensor maps are made outside the capture), then the body is captured
    under ``launch_count.capturing()`` and the rest of the frame replays.
    A body that cannot be captured raises at the capture. On the CPU the
    body runs once per chunk, uncaptured.
A body that draws random numbers is never captured: the key's first chunk
looks at the generators' states (the call's generator, the device's
default one), and where one moved, every chunk of the key keeps running
eagerly on the static buffers, drawing in turn as in one loop.

The graph bakes in what ``NeRFPipeline._chunk_graph_key`` lists (the
shapes and dtypes, the grad and inference modes, the device, the
addresses of every parameter, buffer and packed NeRF-MLP weight, K1's
entry point), so a frame whose key differs gets a new ``ChunkGraph``.
"""

from __future__ import annotations

import logging
import time
from typing import Any, Callable, Dict, Hashable, List, Optional

import torch
from torch.utils._pytree import tree_flatten, tree_unflatten

from ..ops.kernels import launch_count
from ..utils.profiling import annotate

logger = logging.getLogger("yanerf_tpu_torch.pipeline")


class ChunkGraph:
    """The static buffers, device counter and (on the card) captured graph of one frame shape's chunk loop."""

    def __init__(self, inputs: Dict[str, torch.Tensor], n_chunks: int, chunk_rays: int) -> None:
        self.key: Optional[Hashable] = None  # set by the pipeline after the first frame
        self.n_chunks = n_chunks
        self.chunk_rays = chunk_rays
        # the padded inputs, (B, n_padded, 1, C): ``torch.cat(..., out=)`` writes a frame's into them
        self.inputs = inputs
        self.counter = torch.zeros(1, dtype=torch.int64, device=next(iter(inputs.values())).device)
        self.outputs: Optional[List[torch.Tensor]] = None  # the leaves of the output tree, (n_chunks, ...) each
        self.spec = None
        self.draws: Optional[bool] = None  # whether the body draws random numbers, seen at the key's first chunk
        self.graph: Optional["torch.cuda.CUDAGraph"] = None
        self.tally = None  # kernel launches per replay

    def chunks(self) -> Dict[str, torch.Tensor]:
        """The static inputs as ``(n_chunks, B, chunk_rays, 1, C)`` views."""
        return {name: t.reshape(t.shape[0], self.n_chunks, self.chunk_rays, *t.shape[2:]).movedim(1, 0)
                for name, t in self.inputs.items()}

    def _step(self, body: Callable[[Dict[str, torch.Tensor]], Any]) -> None:
        """The body on chunk ``counter`` of the static inputs, its outputs into row ``counter``; then the next."""
        counter = self.counter
        leaves, spec = tree_flatten(body({k: x.index_select(0, counter)[0] for k, x in self.chunks().items()}))
        if self.outputs is None:
            self.outputs = [leaf.new_empty((self.n_chunks, *leaf.shape)) for leaf in leaves]
            self.spec = spec
        for out, leaf in zip(self.outputs, leaves):
            out.index_copy_(0, counter, leaf[None])
        counter.add_(1)

    def _first(self, body, generator: Optional[torch.Generator], stats: Dict[str, Any]) -> None:
        """The key's first chunk: eagerly (on the card on a side stream), then, if it drew nothing, the capture."""
        device = self.counter.device
        watched = [g for g in (generator, _default_generator(device)) if g is not None]
        before = [g.get_state() for g in watched]
        if device.type != "cuda":
            self._step(body)
        else:
            stream = torch.cuda.Stream(device)
            stream.wait_stream(torch.cuda.current_stream(device))
            with torch.cuda.stream(stream):
                self._step(body)
            torch.cuda.current_stream(device).wait_stream(stream)
        draws = any(not torch.equal(b, g.get_state()) for b, g in zip(before, watched))
        if device.type == "cuda" and not draws:
            t0 = time.perf_counter()
            graph = torch.cuda.CUDAGraph()
            # thread_local: a thread that works on its own stream meanwhile (the eval loop's frame writer) is no fault
            with launch_count.capturing() as tally:
                with torch.cuda.graph(graph, stream=stream, capture_error_mode="thread_local"):
                    self._step(body)
            capture_s = time.perf_counter() - t0
            self.graph, self.tally = graph, tally
            stats["captures"] += 1
            stats["capture_s"] += capture_s
            logger.info(f"captured the chunk body of {self.n_chunks} x {self.chunk_rays} rays as a CUDA graph in "
                        f"{capture_s:.2f} s; kernel launches per replay: {launch_count.per_replay(tally)}")
        self.draws = draws

    def run(self, body: Callable[[Dict[str, torch.Tensor]], Any], generator: Optional[torch.Generator],
            stats: Dict[str, Any]) -> Any:
        """``body`` over every chunk of the static inputs, each chunk a ``pipeline.chunk`` region; returns the
        stacked output tree, the static outputs themselves (the next frame overwrites them)."""
        self.counter.zero_()
        for _ in range(self.n_chunks):
            with annotate("pipeline.chunk"):
                if self.graph is not None:
                    with annotate("pipeline.replay"):
                        self.graph.replay()
                    launch_count.replayed(self.tally)
                    stats["replayed_chunks"] += 1
                    continue
                if self.draws is None:
                    self._first(body, generator, stats)
                else:
                    self._step(body)
                stats["eager_chunks"] += 1
        return tree_unflatten(self.outputs, self.spec)


def _default_generator(device: torch.device) -> Optional[torch.Generator]:
    """The generator a draw on ``device`` without one takes."""
    if device.type == "cuda":
        return torch.cuda.default_generators[device.index if device.index is not None else torch.cuda.current_device()]
    return torch.default_generator if device.type == "cpu" else None
