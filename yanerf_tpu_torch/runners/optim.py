"""The optimizer and the train state.

Counterpart of ``yanerf_tpu/runners/optim.py``. The JAX chain
``add_decayed_weights -> scale_by_adam(0.9, 0.999, 1e-8) -> learning rate``
is ``torch.optim.Adam`` with coupled ``weight_decay`` (the decay is added to
the gradient before the moments). ``lr_param_groups`` entries (``prefix``,
``base``) become Adam param groups: a parameter joins the first group whose
prefix its dotted name starts with (the names are the JAX tree's paths),
and that group's schedule starts from ``base * init_lr``. Each group keeps
its own ``init_lr`` beside Adam's hyperparameters, so a checkpoint of the
optimizer restores the schedules too.

The learning rate of every group is a one-element float32 tensor on the
parameters' device, never a host float: a step captured as a CUDA graph
reads it on the card, where a host float would be frozen at capture. On
the card Adam is ``capturable`` (its step count lives on the card too) on
every path, so the per-step loop and the captured step run the same
update. On the CPU it is not: ``capturable`` refuses CPU tensors.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Dict, List, Sequence

import torch

from .schedules import create_lr_schedule

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class TrainState:
    """The pipeline (its parameters), its optimizer, and the number of updates taken."""

    pipeline: torch.nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0


def create_optimizer(runner_config, pipeline: torch.nn.Module) -> torch.optim.Adam:
    weight_decay = float(runner_config.get("weight_decay", 0.0) or 0.0)
    init_lr = float(runner_config["init_lr"])
    groups = runner_config.get("lr_param_groups", None) or []
    prefixes = [g["prefix"] for g in groups]
    members: Dict[int, List[torch.nn.Parameter]] = {i: [] for i in range(len(groups) + 1)}
    for name, p in pipeline.named_parameters():
        gi = next((i for i, prefix in enumerate(prefixes) if name.startswith(prefix)), len(groups))
        members[gi].append(p)
    lrs = [float(g["base"]) * init_lr for g in groups] + [init_lr]
    device = next(pipeline.parameters()).device
    param_groups = [
        dict(params=members[i], init_lr=lrs[i], lr=torch.tensor(lrs[i], dtype=torch.float32, device=device))
        for i in members
        if members[i]
    ]
    if groups:
        counts = {("default" if i == len(groups) else f"group_{i}"): len(members[i]) for i in members}
        logger.info(f"param groups: {counts} (prefixes: {prefixes}, lr multipliers: {[g['base'] for g in groups]})")
    return torch.optim.Adam(
        param_groups, lr=init_lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=weight_decay,
        capturable=device.type == "cuda",
    )


def learning_rates(runner_config, optimizer: torch.optim.Optimizer, steps: Sequence[int]) -> List[List[float]]:
    """The rate of every param group at each update of ``steps`` (counted from 0): ``[step][group]``."""
    schedules = [create_lr_schedule(runner_config, init_lr=group["init_lr"]) for group in optimizer.param_groups]
    return [[schedule(step) for schedule in schedules] for step in steps]


def set_learning_rates(runner_config, optimizer: torch.optim.Optimizer, step: int) -> None:
    """Give every param group the rate its schedule has at update ``step`` (counted from 0)."""
    for group, rate in zip(optimizer.param_groups, learning_rates(runner_config, optimizer, [step])[0]):
        group["lr"].fill_(rate)


def apply_learning_rates(optimizer: torch.optim.Optimizer, rates: torch.Tensor) -> None:
    """Copy ``rates`` (one float32 per group, on the card) into the groups' rates: no host value involved."""
    for g, group in enumerate(optimizer.param_groups):
        group["lr"].copy_(rates[g])

