"""The (data x rays) layout of a multi-process run: one GPU per process.

Counterpart of ``yanerf_tpu/parallel/mesh.py``. The ranks are laid out
row-major as the JAX package lays out its devices, ``rank = data_index *
ray_parallel + ray_index``:
  * ``data``: each data index trains on its own shard of the batch (the
    sampler shards over the data axis), and the gradients are averaged over
    the data axis;
  * ``rays``: the processes of one data index see the same images and
    draws, and each computes its slice of the ray axis (``sharding.py``).
``create_mesh`` sizes the two axes with ``create_mesh``'s semantics and
errors in the JAX package (pinned by tests/test_parallel.py): by default
every process goes to the ray axis; one axis given, the other covers the
world; a mesh that leaves processes out is refused unless both axes are
given, and one that needs more than the world always.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Any, Dict, List, Optional

from .distributed import get_rank, get_world_size, is_dist_avail_and_initialized

DATA_AXIS = "data"
RAY_AXIS = "rays"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The layout and this process's place in it; the process groups of its two axes (None without a group)."""

    data_parallel: int
    ray_parallel: int
    rank: int
    data_group: Any = None  # the processes of this ray index: gradients are averaged over them
    ray_group: Any = None  # the processes of this data index: they split the ray axis
    world_group: Any = None  # every process of the mesh

    @property
    def shape(self) -> Dict[str, int]:
        return {DATA_AXIS: self.data_parallel, RAY_AXIS: self.ray_parallel}

    @property
    def size(self) -> int:
        return self.data_parallel * self.ray_parallel

    @property
    def data_index(self) -> int:
        return self.rank // self.ray_parallel

    @property
    def ray_index(self) -> int:
        return self.rank % self.ray_parallel

    def data_ranks(self, ray_index: int) -> List[int]:
        return [d * self.ray_parallel + ray_index for d in range(self.data_parallel)]

    def ray_ranks(self, data_index: int) -> List[int]:
        return [data_index * self.ray_parallel + r for r in range(self.ray_parallel)]


def mesh_shape(world_size: int, data_parallel: Optional[int] = None, ray_parallel: Optional[int] = None) -> tuple:
    """``(data_parallel, ray_parallel)`` over ``world_size`` processes, with ``create_mesh``'s sizing rules."""
    n = world_size
    both_explicit = data_parallel is not None and ray_parallel is not None
    if data_parallel is None and ray_parallel is None:
        data_parallel, ray_parallel = 1, n
    elif data_parallel is None:
        if ray_parallel <= 0 or n % ray_parallel:
            raise ValueError(f"ray_parallel={ray_parallel} must evenly divide {n} devices")
        data_parallel = n // ray_parallel
    elif ray_parallel is None:
        if data_parallel <= 0 or n % data_parallel:
            raise ValueError(f"data_parallel={data_parallel} must evenly divide {n} devices")
        ray_parallel = n // data_parallel
    total = data_parallel * ray_parallel
    if total > n:
        raise ValueError(f"mesh {data_parallel}x{ray_parallel} needs {total} devices, only {n} available")
    if total < n:
        if not both_explicit:
            raise ValueError(
                f"mesh {data_parallel}x{ray_parallel} uses {total} of {n} devices; "
                "size the axes to cover the machine (or pass an explicit devices subset)"
            )
        logging.getLogger(__name__).warning(
            "mesh %dx%d uses only %d of %d devices; the remaining %d idle",
            data_parallel, ray_parallel, total, n, n - total,
        )
    return data_parallel, ray_parallel


def create_mesh(data_parallel: Optional[int] = None, ray_parallel: Optional[int] = None,
                world_size: Optional[int] = None, rank: Optional[int] = None) -> Mesh:
    """The (data, rays) mesh over the run's processes (``world_size`` / ``rank``: the group's unless given).

    In a process group, every process must call this in the same order:
    it makes the process groups of both axes (``torch.distributed.new_group``
    is collective), those of the other processes too.
    """
    world_size = get_world_size() if world_size is None else world_size
    rank = get_rank() if rank is None else rank
    data_parallel, ray_parallel = mesh_shape(world_size, data_parallel, ray_parallel)
    mesh = Mesh(data_parallel, ray_parallel, rank)
    if not is_dist_avail_and_initialized():
        return mesh
    import torch.distributed as dist

    groups = {"world_group": dist.new_group(list(range(mesh.size)))}
    for r in range(ray_parallel):
        group = dist.new_group(mesh.data_ranks(r))
        if rank < mesh.size and r == mesh.ray_index:
            groups["data_group"] = group
    for d in range(data_parallel):
        group = dist.new_group(mesh.ray_ranks(d))
        if rank < mesh.size and d == mesh.data_index:
            groups["ray_group"] = group
    return dataclasses.replace(mesh, **groups)
