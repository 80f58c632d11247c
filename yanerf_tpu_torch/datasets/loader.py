"""Host-side batching and the device-resident dataset cache.

Counterpart of ``yanerf_tpu/datasets/loader.py`` for one process:
  * ``ShardedEpochSampler`` keeps DistributedSampler's semantics (a
    shuffle seeded by ``seed + epoch``, wraparound padding to equal shards)
    with ``world_size`` 1 and ``rank`` 0 unless told otherwise;
  * ``DataLoader`` stacks items into numpy batches (``stack_batch``), on a
    thread pool when ``num_workers > 1``, and with ``num_workers > 0`` on a
    background thread that keeps ``prefetch_depth`` batches ready, in
    order; an exception there reaches the consumer;
  * ``DeviceCachedLoader`` stacks the whole dataset once, moves it to the
    GPU and yields per-batch gathers there. With ``quantize_images`` an
    image field is kept as uint8 when that is lossless (every value k/255)
    and decoded through a table of the exact float32 values k/255, so the
    decode reproduces the loaders' ``astype(float32) / 255`` bit for bit.
    The table is made once per device, so a decode copies nothing from the
    host (a captured train step gathers and decodes on the card).
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator, List, Optional, Sequence, Union

import numpy as np
import torch

from ..utils import device_constant

_U8_DECODE_TABLE = np.arange(256, dtype=np.float32) / 255.0  # exact k/255 values


class ShardedEpochSampler:
    """DistributedSampler-equivalent index sharding (one process by default)."""

    def __init__(self, dataset_len: int, shuffle: bool, world_size: int = 1, rank: int = 0, seed: int = 0) -> None:
        self.dataset_len = dataset_len
        self.shuffle = shuffle
        self.world_size = world_size
        self.rank = rank
        self.seed = seed
        self.epoch = 0
        self.num_samples = -(-dataset_len // world_size)
        self.total_size = self.num_samples * world_size

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def indices(self) -> np.ndarray:
        if self.shuffle:
            order = np.random.RandomState(self.seed + self.epoch).permutation(self.dataset_len)
        else:
            order = np.arange(self.dataset_len)
        if self.total_size > len(order):
            order = np.concatenate([order, order[: self.total_size - len(order)]])
        return order[self.rank : self.total_size : self.world_size]

    def __len__(self) -> int:
        return self.num_samples


def stack_batch(items: Sequence) -> tuple:
    """Stack per-item tuples: arrays stacked, floats averaged, ints/None/str lists as the JAX package does."""
    out: List = []
    for field_idx in range(len(items[0])):
        values = [item[field_idx] for item in items]
        v0 = values[0]
        if isinstance(v0, np.ndarray):
            out.append(np.stack(values, axis=0))
        elif np.isscalar(v0) and isinstance(v0, (float, np.floating)):
            out.append(float(np.mean(values)))
        elif isinstance(v0, (int, np.integer)):
            out.append(values[0])
        elif isinstance(v0, str) or v0 is None:
            out.append(values if isinstance(v0, str) else None)
        else:
            out.append(np.stack([np.asarray(v) for v in values], axis=0))
    return tuple(out)


class DataLoader:
    """Iterates batches as stacked numpy tuples."""

    def __init__(
        self,
        dataset,
        sampler: Optional[ShardedEpochSampler],
        batch_size: int,
        is_train: bool,
        num_workers: int = 0,
        collate_fn: Optional[Callable] = None,
        prefetch_depth: int = 2,
    ) -> None:
        self.dataset = dataset
        self.sampler = sampler
        self.batch_size = batch_size
        self.drop_last = bool(is_train)
        self.is_train = is_train
        self.num_workers = max(0, num_workers)
        self.prefetch_depth = max(1, prefetch_depth)
        self.collate_fn = collate_fn or stack_batch
        self._pool = None

    @property
    def data_wrapper(self):
        return self.dataset.data_wrapper

    def _indices(self) -> np.ndarray:
        if self.sampler is not None:
            return self.sampler.indices()
        indices = np.arange(len(self.dataset))
        return np.random.permutation(indices) if self.is_train else indices

    def _chunks(self) -> List[np.ndarray]:
        indices = self._indices()
        chunks = [indices[s : s + self.batch_size] for s in range(0, len(indices), self.batch_size)]
        return [c for c in chunks if len(c) == self.batch_size or not self.drop_last]

    def __len__(self) -> int:
        n = len(self.sampler) if self.sampler is not None else len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _load_batch(self, idx_chunk: np.ndarray):
        if self.num_workers > 1:
            if self._pool is None:
                from concurrent.futures import ThreadPoolExecutor

                self._pool = ThreadPoolExecutor(max_workers=self.num_workers)
            items = list(self._pool.map(self.dataset.__getitem__, (int(i) for i in idx_chunk)))
        else:
            items = [self.dataset[int(i)] for i in idx_chunk]
        return self.collate_fn(items)

    def __iter__(self) -> Iterator[tuple]:
        chunks = self._chunks()
        if self.num_workers == 0:
            for chunk in chunks:
                yield self._load_batch(chunk)
            return

        ready: "queue.Queue" = queue.Queue(maxsize=self.prefetch_depth)
        stop = threading.Event()

        def put(item) -> bool:
            # a consumer that stops iterating sets ``stop``: poll, never block on a full queue
            while not stop.is_set():
                try:
                    ready.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def produce() -> None:
            try:
                for chunk in chunks:
                    if not put(("batch", self._load_batch(chunk))):
                        return
                put(("done", None))
            except Exception as exc:  # handed to the consumer
                put(("error", exc))

        threading.Thread(target=produce, daemon=True, name="loader-prefetch").start()
        try:
            while True:
                kind, payload = ready.get()
                if kind == "done":
                    return
                if kind == "error":
                    raise payload
                yield payload
        finally:
            stop.set()


def create_sampler(dataset, shuffle: bool, world_size: int = 1, rank: int = 0, seed: int = 0) -> ShardedEpochSampler:
    return ShardedEpochSampler(len(dataset), shuffle=shuffle, world_size=world_size, rank=rank, seed=seed)


def create_loader(dataset, sampler, batch_size: int, num_workers: int, is_train: bool, collate_fn=None,
                  prefetch_depth: int = 2, **_) -> DataLoader:
    return DataLoader(dataset, sampler, batch_size=batch_size, is_train=is_train, num_workers=num_workers,
                      collate_fn=collate_fn, prefetch_depth=prefetch_depth)


def decode_cached_field(a):
    """A uint8 cache field back to float32 k/255 through the exact table; anything else passes through."""
    if isinstance(a, torch.Tensor) and a.dtype == torch.uint8:
        return device_constant("u8_decode", lambda: _U8_DECODE_TABLE, torch.float32, a.device)[a.long()]
    if isinstance(a, np.ndarray) and a.dtype == np.uint8:
        return _U8_DECODE_TABLE[a]
    return a


class DeviceCachedLoader:
    """The whole dataset on the GPU once; batches become gathers there.

    Acts as the wrapped loader when the cache would exceed ``max_bytes``.
    """

    def __init__(
        self,
        loader: DataLoader,
        device: Union[str, torch.device],
        max_bytes: int = 4 << 30,
        quantize_images: bool = False,
    ):
        self.inner = loader
        self.dataset = loader.dataset
        self.sampler = loader.sampler
        self.batch_size = loader.batch_size
        self.drop_last = loader.drop_last
        self.device = torch.device(device)
        self.max_bytes = max_bytes
        self.quantize_images = quantize_images
        self._arrays = None
        self._fits = None

    def _maybe_quantize(self, f):
        """float32 -> uint8 only when exactly invertible (values are k/255)."""
        if (
            self.quantize_images
            and isinstance(f, np.ndarray)
            and f.dtype == np.float32
            and f.ndim >= 3
            and f.size > 0
            and float(f.min()) >= 0.0
            and float(f.max()) <= 1.0
        ):
            u8 = np.round(f * 255.0).astype(np.uint8)
            if np.array_equal(u8.astype(np.float32) / 255.0, f):
                return u8
        return f

    @property
    def data_wrapper(self):
        return self.inner.data_wrapper

    def __len__(self):
        return len(self.inner)

    def _ensure_cache(self) -> bool:
        if self._fits is not None:
            return self._fits
        if self.inner.collate_fn is not stack_batch:
            self._fits = False
            return False
        probe = self.dataset[0]
        item_bytes = sum(self._maybe_quantize(f).nbytes for f in probe if isinstance(f, np.ndarray))
        if item_bytes * len(self.dataset) > self.max_bytes:
            self._fits = False
            return False
        items = [self.dataset[i] for i in range(len(self.dataset))]
        stacked = []
        for fi in range(len(items[0])):
            vals = [it[fi] for it in items]
            if isinstance(vals[0], np.ndarray):
                q = [self._maybe_quantize(v) for v in vals]
                if not all(a.dtype == q[0].dtype for a in q):
                    q = vals  # mixed outcome: keep the lossless float32 field
                stacked.append(torch.as_tensor(np.stack(q, axis=0), device=self.device))
            else:
                stacked.append(("itemlist", vals))  # stack_batch's rules, applied per batch
        self._arrays = tuple(stacked)
        self._fits = True
        return True

    def __iter__(self):
        if not self._ensure_cache():
            yield from self.inner
            return
        for chunk in self.inner._chunks():
            idx = torch.as_tensor(chunk, device=self.device)
            out = []
            for f in self._arrays:
                if isinstance(f, tuple):
                    out.append(stack_batch([(f[1][int(i)],) for i in chunk])[0])
                else:
                    out.append(decode_cached_field(f[idx]))
            yield tuple(out)
