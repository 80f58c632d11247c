"""Runner hooks: transforms of the batch before a step and of its outputs after it."""

from .hooks import (
    HOOKS,
    ADNeRFEvalDataHook,
    ADNeRFTrainDataHook,
    EvalDataHook,
    EvalOutputsHook,
    SDNeRFEvalDataHook,
    SDNeRFOutputsHook,
    SDNeRFTrainDataHook,
    TrainDataHook,
    TrainOutputsHook,
)

__all__ = [
    "HOOKS",
    "ADNeRFEvalDataHook",
    "ADNeRFTrainDataHook",
    "EvalDataHook",
    "EvalOutputsHook",
    "SDNeRFEvalDataHook",
    "SDNeRFOutputsHook",
    "SDNeRFTrainDataHook",
    "TrainDataHook",
    "TrainOutputsHook",
]
