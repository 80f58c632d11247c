"""The benchmark's calls into the program under test (``yanerf_tpu_torch``), and nothing else of it.

The configuration is the file's resolved dict, handed to the program's
own config type; the pipeline is built by its registry and then takes the
benchmark's weights, by the program's parameter names.
"""

from __future__ import annotations

from typing import Dict

import torch


def build_pipeline(config: dict, weights: Dict[str, torch.Tensor], device, seed: int):
    """The configuration's pipeline on ``device`` holding ``weights`` (copied; names and shapes must match)."""
    from yanerf_tpu_torch.pipelines import PIPELINES
    from yanerf_tpu_torch.utils.config import Config

    cfg = Config(config)
    pipeline = PIPELINES.build(cfg.pipeline, generator=torch.Generator().manual_seed(seed), device=device)
    params = dict(pipeline.named_parameters())
    if set(params) != set(weights):
        raise ValueError(f"the program's parameters {sorted(set(params) ^ set(weights))} differ from the benchmark's")
    with torch.no_grad():
        for name, p in params.items():
            if tuple(p.shape) != tuple(weights[name].shape):
                raise ValueError(f"{name}: the program holds {tuple(p.shape)}, the benchmark {tuple(weights[name].shape)}")
            p.copy_(weights[name])
    return cfg, pipeline


def kernel_launches() -> Dict[str, int]:
    """The program's own count of its kernels' launches in this process, CUDA graph replays included."""
    from yanerf_tpu_torch.ops.kernels import launch_count

    return launch_count.totals()
