"""The ray split and the gradient reduction of a (data x rays) mesh, threaded through the compute path.

Counterpart of ``yanerf_tpu/parallel/sharding.py``. The JAX package
annotates the ray axis (``constrain_rays``) and lets GSPMD partition the
work and insert the collectives; here the same places do it by hand, while
a mesh is installed (``mesh_context``; the runner installs it), and are
no-ops otherwise, as in JAX:
  * ``shard_rays``: this process's slice of the ray axis (the
    ``ray_index``-th of ``ray_parallel`` equal slices);
  * ``gather_rays``: the slices of the ray group concatenated in rank
    order. Every process of the group then holds the whole output, and
    computes the same per-ray losses and objective as one process would;
    the backward hands each process the cotangent of its own slice (no
    reduction: the objective is the same on every process), so each
    process's parameter gradients are its rays' share;
  * ``reduce_gradients``: the shares summed over the ray group and
    averaged over the data group (each data index means its own batch
    shard), one all-reduce over the mesh of the gradients flattened into
    one buffer, between ``backward()`` and the optimizer's step. Its
    collective is issued under any mesh, even of one process, so a train
    step captured as a CUDA graph captures it too.
So the objective and every gradient equal the unsharded step's up to the
order of the sums.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Iterable, Optional

import torch
import torch.distributed as dist

from .distributed import is_dist_avail_and_initialized
from .mesh import Mesh

_state = threading.local()


def active_mesh() -> Optional[Mesh]:
    return getattr(_state, "mesh", None)


@contextmanager
def mesh_context(mesh: Optional[Mesh]):
    """Install ``mesh`` as the active layout (None: none)."""
    previous = getattr(_state, "mesh", None)
    _state.mesh = mesh
    try:
        yield
    finally:
        _state.mesh = previous


def ray_parallel() -> int:
    """How many processes split the ray axis (1 outside a mesh)."""
    mesh = active_mesh()
    return 1 if mesh is None else mesh.ray_parallel


def shard_rays(t: Optional[torch.Tensor], ray_dim: int = 1) -> Optional[torch.Tensor]:
    """This process's slice of ``t``'s ray axis ``ray_dim``; ``t`` itself outside a ray split."""
    mesh = active_mesh()
    if t is None or mesh is None or mesh.ray_parallel == 1:
        return t
    n = t.shape[ray_dim]
    if n % mesh.ray_parallel:
        raise ValueError(f"{n} rays do not split over {mesh.ray_parallel} processes")
    per = n // mesh.ray_parallel
    return t.narrow(ray_dim, mesh.ray_index * per, per)


class _GatherRays(torch.autograd.Function):
    """All-gather over the ray group on ``ray_dim``; the backward keeps the own slice of the cotangent."""

    @staticmethod
    def forward(ctx, t, ray_dim, mesh):
        parts = [torch.empty_like(t) for _ in range(mesh.ray_parallel)]
        dist.all_gather(parts, t.contiguous(), group=mesh.ray_group)
        ctx.ray_dim, ctx.index, ctx.n = ray_dim, mesh.ray_index, t.shape[ray_dim]
        return torch.cat(parts, dim=ray_dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.ray_dim, ctx.index * ctx.n, ctx.n), None, None


def gather_rays(t: Optional[torch.Tensor], ray_dim: int = 1) -> Optional[torch.Tensor]:
    """The ray group's slices of ``t`` joined on ``ray_dim`` (see the module's docstring); ``t`` outside a split."""
    mesh = active_mesh()
    if t is None or mesh is None or mesh.ray_parallel == 1:
        return t
    return _GatherRays.apply(t, ray_dim, mesh)


def reduce_gradients(parameters: Iterable[torch.nn.Parameter]) -> None:
    """Sum the gradients over the ray group and average them over the data group, in place (see the docstring)."""
    mesh = active_mesh()
    if mesh is None or not is_dist_avail_and_initialized():
        return
    grads = [p.grad for p in parameters if p.grad is not None]
    if not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=mesh.world_group)
    if mesh.data_parallel > 1:
        flat.div_(mesh.data_parallel)
    offset = 0
    for g in grads:
        g.copy_(flat[offset : offset + g.numel()].view_as(g))
        offset += g.numel()
