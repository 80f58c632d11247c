"""Traffic kind ``train_hash``: kind ``train`` (``traffic/train.py``) on a hash-grid configuration.

The same scene, epochs, window, traced stretch and check as ``train``; the
weights are the hash grid's (``inputs_hash.py``), the counts its encoding
kernels' and MLPs' (``counts/hash_grid.py``), and the reference
``reference/hash_grid.py``. Parameters: those of ``train``.
"""

from __future__ import annotations

import torch

from h100bench import inputs_hash
from h100bench.counts import hash_grid as counts
from h100bench.reference import hash_grid as reference
from h100bench.traffic import train

METRICS = train.METRICS


class _Context:
    """The run's context, whose weights are the hash grid's."""

    def __init__(self, ctx) -> None:
        self._ctx = ctx

    def __getattr__(self, name: str):
        return getattr(self._ctx, name)

    def weights(self):
        return inputs_hash.make_weights(self._ctx.config, self._ctx.seeds["weights"], self._ctx.device)


class Cell(train.Cell):
    def __init__(self, ctx) -> None:
        self.ctx = _Context(ctx)
        self.work = counts.step_work(ctx.config)

    def _reference(self, precision: str) -> dict:
        losses, grads, params = reference.train(
            self.ctx.config, self.weights, torch.as_tensor(self.poses, device=self.ctx.device), self.focal,
            self.images, self.ctx.seeds["runner"], int(self.ctx.traffic["check_steps"]), precision=precision)
        return {"losses": losses, "grads": train._norms(grads),
                "change": train._norms({k: params[k] - self.weights[k] for k in params})}
