"""Multi-process training and eval: the process group, the (data x rays) mesh, the ray split.

Counterpart of ``yanerf_tpu/parallel/`` on ``torch.distributed``, one GPU
per process (NCCL; gloo on the CPU). Outside a mesh every helper is a
no-op, so a run of one process computes what it computed without them.
"""

from .distributed import (
    barrier,
    concat_all_gather,
    get_rank,
    get_world_size,
    init_distributed_mode,
    is_dist_avail_and_initialized,
    is_main_process,
    pause_to_debug,
)
from .mesh import DATA_AXIS, RAY_AXIS, Mesh, create_mesh
from .sharding import active_mesh, gather_rays, mesh_context, ray_parallel, reduce_gradients, shard_rays

__all__ = [
    "DATA_AXIS",
    "Mesh",
    "RAY_AXIS",
    "active_mesh",
    "barrier",
    "concat_all_gather",
    "create_mesh",
    "gather_rays",
    "get_rank",
    "get_world_size",
    "init_distributed_mode",
    "is_dist_avail_and_initialized",
    "is_main_process",
    "mesh_context",
    "pause_to_debug",
    "ray_parallel",
    "reduce_gradients",
    "shard_rays",
]
