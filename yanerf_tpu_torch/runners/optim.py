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
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Dict, List

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
    param_groups = [dict(params=members[i], init_lr=lrs[i]) for i in members if members[i]]
    if groups:
        counts = {("default" if i == len(groups) else f"group_{i}"): len(members[i]) for i in members}
        logger.info(f"param groups: {counts} (prefixes: {prefixes}, lr multipliers: {[g['base'] for g in groups]})")
    return torch.optim.Adam(param_groups, lr=init_lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=weight_decay)


def set_learning_rates(runner_config, optimizer: torch.optim.Optimizer, step: int) -> None:
    """Give every param group the rate its schedule has at update ``step`` (counted from 0)."""
    for group in optimizer.param_groups:
        group["lr"] = create_lr_schedule(runner_config, init_lr=group["init_lr"])(step)
