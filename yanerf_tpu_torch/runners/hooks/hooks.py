"""Runner hooks: pluggable transforms around each step.

Counterpart of ``yanerf_tpu/runners/hooks/hooks.py``. ``runner.hooks`` in a
config lists hook dicts built from ``HOOKS``. Data hooks take the batch
(the pipeline's keyword arguments) before a step and may add flags such as
``use_smooth``; output hooks take the predictions after it. The train loop
calls ``TrainDataHook`` / ``TrainOutputsHook``, the eval loop
``EvalDataHook`` / ``EvalOutputsHook``; a config with hooks trains on the
per-step loop (the fused dispatch runs no Python between its steps).
"""

from __future__ import annotations

from abc import ABC, abstractmethod

from ...utils.registry import Registry

HOOKS = Registry("hooks")


class TrainDataHook(ABC):
    @abstractmethod
    def __call__(self, data, *args, **kwargs):
        return data


class EvalDataHook(ABC):
    @abstractmethod
    def __call__(self, data, *args, **kwargs):
        return data


class TrainOutputsHook(ABC):
    @abstractmethod
    def __call__(self, outputs, *args, **kwargs):
        return outputs


class EvalOutputsHook(ABC):
    @abstractmethod
    def __call__(self, outputs, *args, **kwargs):
        return outputs


@HOOKS.register_module()
class ADNeRFTrainDataHook(TrainDataHook):
    """Turn the smooth flag on once training passes ``train_no_smooth_iters``."""

    def __call__(self, data, iter, config, *args, **kwargs):
        data["use_smooth"] = bool(iter >= config["train_no_smooth_iters"])
        return data


@HOOKS.register_module()
class ADNeRFEvalDataHook(EvalDataHook):
    def __call__(self, data, config, *args, **kwargs):
        data["use_smooth"] = bool(config["eval_use_smooth"])
        return data


@HOOKS.register_module()
class SDNeRFTrainDataHook(ADNeRFTrainDataHook):
    pass


@HOOKS.register_module()
class SDNeRFEvalDataHook(ADNeRFEvalDataHook):
    pass


@HOOKS.register_module()
class SDNeRFOutputsHook(TrainOutputsHook, EvalOutputsHook):
    def __call__(self, outputs, *args, **kwargs):
        return outputs
