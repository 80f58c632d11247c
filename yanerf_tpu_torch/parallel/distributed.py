"""Process-group helpers: the bootstrap, rank and world size, the eval gather, barriers.

Counterpart of ``yanerf_tpu/parallel/distributed.py`` on ``torch.distributed``.
A multi-process run is detected from ``RANK`` / ``WORLD_SIZE`` (a
``torchrun``-style launcher) or ``SLURM_PROCID`` / ``SLURM_NTASKS``, the
rendezvous from ``MASTER_ADDR`` / ``MASTER_PORT`` (``env://``) or an
explicit ``dist_url`` (``tcp://host:port``). One process per GPU: NCCL
on the card, gloo on the CPU. A run of one process is a no-op, and every
helper then answers for one process.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional, Union

import numpy as np
import torch
import torch.distributed as dist


def detect_world() -> tuple:
    """``(world_size, rank)`` from the launcher's environment, ``(1, 0)`` when there is none."""
    if "WORLD_SIZE" in os.environ and "RANK" in os.environ:
        return int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
    if "SLURM_NTASKS" in os.environ and "SLURM_PROCID" in os.environ:
        return int(os.environ["SLURM_NTASKS"]), int(os.environ["SLURM_PROCID"])
    return 1, 0


def init_distributed_mode(dist_url: Optional[str] = None, device: Union[str, torch.device] = "cuda") -> bool:
    """Join the process group of a multi-process run; False (and nothing done) for one process.

    ``dist_url``: ``tcp://host:port``, or ``env://`` / None for
    ``MASTER_ADDR`` / ``MASTER_PORT`` (required then). On the card each
    process takes GPU ``LOCAL_RANK`` (else ``rank`` modulo the GPUs) and the
    group is NCCL; on the CPU gloo.
    """
    world_size, rank = detect_world()
    if world_size <= 1:
        return False
    if dist.is_initialized():
        return True
    if dist_url in (None, "", "env://"):
        if "MASTER_ADDR" not in os.environ:
            raise ValueError(f"a run of {world_size} processes needs MASTER_ADDR / MASTER_PORT or a tcp:// dist_url")
        dist_url = f"tcp://{os.environ['MASTER_ADDR']}:{os.environ.get('MASTER_PORT', '12355')}"
    device = torch.device(device)
    if device.type == "cuda":
        local_rank = int(os.environ.get("LOCAL_RANK", rank % max(1, torch.cuda.device_count())))
        torch.cuda.set_device(local_rank)
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo", init_method=dist_url,
                            world_size=world_size, rank=rank, timeout=datetime.timedelta(minutes=30))
    return True


def is_dist_avail_and_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def get_world_size() -> int:
    return dist.get_world_size() if is_dist_avail_and_initialized() else 1


def get_rank() -> int:
    return dist.get_rank() if is_dist_avail_and_initialized() else 0


def is_main_process() -> bool:
    return get_rank() == 0


def collective_device() -> torch.device:
    """Where a collective's tensors live: the current GPU for NCCL, the CPU for gloo."""
    if is_dist_avail_and_initialized() and dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def concat_all_gather(x, group=None) -> np.ndarray:
    """Per-sample arrays of every process of ``group`` (default: all), concatenated on axis 0 in rank order.

    The host-side gather of the eval loop: per-sample losses, then
    truncated to the dataset length and meaned. Every process must give an
    array of the same shape.
    """
    x = np.asarray(x)
    if not is_dist_avail_and_initialized():
        return x
    t = torch.as_tensor(x).to(collective_device())
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t, group=group)
    return torch.cat(parts, dim=0).cpu().numpy()


def barrier(name: str = "barrier") -> None:
    """Wait for every process (``name`` says where, for a reader of a hung run)."""
    if not is_dist_avail_and_initialized():
        return
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()


def pause_to_debug() -> None:
    """Drop rank 0 into a debugger, the other ranks waiting at a barrier."""
    if is_main_process():
        import pdb

        pdb.set_trace()
    barrier("pause_to_debug")
