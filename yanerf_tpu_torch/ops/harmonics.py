"""Harmonic (sin/cos positional) embeddings.

Counterpart of ``yanerf_tpu/ops/harmonics.py``. The layout is
frequency-major, ``(x[..., None] * freqs).reshape(..., -1)``, then
``sin | cos | x``.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..utils import device_constant


@lru_cache(maxsize=16)
def harmonic_frequencies(n_harmonic_functions: int, omega_0: float = 1.0, logspace: bool = True) -> np.ndarray:
    if logspace:
        freqs = 2.0 ** np.arange(n_harmonic_functions, dtype=np.float32)
    else:
        freqs = np.linspace(1.0, 2.0 ** (n_harmonic_functions - 1), n_harmonic_functions, dtype=np.float32)
    return freqs * omega_0


def harmonic_embedding(
    x: torch.Tensor,
    n_harmonic_functions: int = 6,
    omega_0: float = 1.0,
    logspace: bool = True,
    append_input: bool = True,
) -> torch.Tensor:
    """Embed ``x (..., D)`` to ``(..., D * (2 * n_harmonic_functions + append))``."""
    freqs = device_constant(("harmonics", n_harmonic_functions, omega_0, logspace),
                            lambda: harmonic_frequencies(n_harmonic_functions, omega_0, logspace), x.dtype, x.device)
    embed = (x[..., None] * freqs).reshape(*x.shape[:-1], -1)
    parts = (torch.sin(embed), torch.cos(embed), x) if append_input else (torch.sin(embed), torch.cos(embed))
    return torch.cat(parts, dim=-1)


def harmonic_embedding_dim(input_dims: int, n_harmonic_functions: int, append_input: bool) -> int:
    """Output dim of :func:`harmonic_embedding` for the given settings."""
    return input_dims * (2 * n_harmonic_functions + int(append_input))
