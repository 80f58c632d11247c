"""The fused NeRF-MLP path over several optimizer steps.

Five Adam steps of a tiny NeRFMLP, from the same params and on the same
inputs, three ways: the port's kernel path (``use_pallas``: K1 / K3's plain
versions through ``FusedNerfMlp``), the JAX package's ``make_fused_mlp``
(Pallas in interpret mode, run op by op in bf16 so that each bf16 rounding
of the kernels stays where they make it) and its XLA path (jitted, as it
trains).
The port's eager model runs beside them. Tolerances, relative to how far
the steps moved the params (``_drift``):
  * float32: all four within 1e-4 of each other (measured 3.3e-5 at the
    most: sums in another order);
  * bfloat16: the port's kernel path within 2e-3 of ``make_fused_mlp`` on
    every tensor (measured 3.1e-4), and at least ten times farther from the
    XLA path (measured 0.146); the port's eager model within 0.1 of the XLA
    path (measured 0.055), which the two bf16 policies (bias added in
    float32 by the kernels, in bf16 by the eager models) do not reach.
So the port's kernel path trains as the JAX kernel path does, and both
part from the JAX XLA path by the same amount in bf16.
"""

import os.path as osp

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from yanerf_tpu.models import MODELS as JAX_MODELS
from yanerf_tpu.utils import Config
from yanerf_tpu_torch.convert import flatten_tree, load_jax_params
from yanerf_tpu_torch.models import MODELS

CFG_DIR = osp.join(osp.dirname(__file__), "configs")
N_RAYS, N_PTS, STEPS, LR = 16, 8, 5, 5e-4
F32_TOL = 1e-4
BF16_KERNEL_TOL = 2e-3
BF16_EAGER_TOL = 0.1


def _small_cfg():
    return dict(Config.fromfile(osp.join(CFG_DIR, "models/nerf_mlp.yml")).model)


def _step_inputs(step):
    rng = np.random.RandomState(100 + step)
    origins = (rng.randn(1, N_RAYS, 3) * 0.3).astype(np.float32)
    dirs = rng.randn(1, N_RAYS, 3).astype(np.float32)
    lengths = np.sort(rng.uniform(2, 6, (1, N_RAYS, N_PTS)), -1).astype(np.float32)
    rgb = rng.uniform(0, 1, (1, N_RAYS, N_PTS, 3)).astype(np.float32)
    sigma = rng.randn(1, N_RAYS, N_PTS, 1).astype(np.float32)
    return origins, dirs, lengths, rgb, sigma


def _jax_steps(model, params, use_pallas):
    def loss(p, o, d, l, rgb, sigma):
        out = model.apply(p, o, d, l, use_pallas=use_pallas)
        return jnp.mean((out["rays_features"] - rgb) ** 2) + 0.01 * jnp.mean((out["rays_densities"] - sigma) ** 2)

    # the kernel path op by op in bf16, where jit could drop its roundings; jitted otherwise
    grad = jax.grad(loss) if use_pallas and model.compute_dtype == jnp.bfloat16 else jax.jit(jax.grad(loss))
    opt = optax.adam(LR, b1=0.9, b2=0.999, eps=1e-8)
    state = opt.init(params)
    for k in range(STEPS):
        updates, state = opt.update(grad(params, *map(jnp.asarray, _step_inputs(k))), state, params)
        params = optax.apply_updates(params, updates)
    return flatten_tree(jax.tree_util.tree_map(np.asarray, params))


def _port_steps(cfg, params, use_pallas):
    model = MODELS.build(dict(cfg, use_pallas=True))
    load_jax_params(model, jax.tree_util.tree_map(np.asarray, params))
    opt = torch.optim.Adam(model.parameters(), lr=LR, betas=(0.9, 0.999), eps=1e-8)
    for k in range(STEPS):
        o, d, l, rgb, sigma = map(torch.from_numpy, _step_inputs(k))
        out = model(o, d, l, use_pallas=use_pallas)
        loss = torch.mean((out["rays_features"] - rgb) ** 2) + 0.01 * torch.mean((out["rays_densities"] - sigma) ** 2)
        opt.zero_grad()
        loss.backward()
        opt.step()
    return {k: v.detach().numpy() for k, v in model.named_parameters()}


def _drift(a, b, init):
    """Per tensor: ``|a - b| / |b - init|``, the distance of two runs over how far ``b`` moved."""
    return {k: float(np.linalg.norm(a[k] - b[k]) / np.linalg.norm(b[k] - init[k])) for k in init}


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_kernel_path_tracks_make_fused_mlp_over_five_adam_steps(compute_dtype):
    cfg = dict(_small_cfg(), compute_dtype=compute_dtype)
    jax_model = JAX_MODELS.build(dict(cfg))
    params = jax_model.init(jax.random.PRNGKey(0))
    init = flatten_tree(jax.tree_util.tree_map(np.asarray, params))
    runs = {
        "jax_fused": _jax_steps(jax_model, params, True),
        "jax_xla": _jax_steps(jax_model, params, False),
        "port_kernel": _port_steps(cfg, params, True),
        "port_eager": _port_steps(cfg, params, False),
    }
    assert runs["port_kernel"].keys() == init.keys()
    kernel_fused = max(_drift(runs["port_kernel"], runs["jax_fused"], init).values())
    kernel_xla = max(_drift(runs["port_kernel"], runs["jax_xla"], init).values())
    eager_xla = max(_drift(runs["port_eager"], runs["jax_xla"], init).values())
    if compute_dtype == "float32":
        assert max(kernel_fused, kernel_xla, eager_xla) <= F32_TOL, (kernel_fused, kernel_xla, eager_xla)
    else:
        assert kernel_fused <= BF16_KERNEL_TOL, kernel_fused
        assert eager_xla <= BF16_EAGER_TOL, eager_xla
        # the measurement this test records: the kernel path is the JAX kernel path, not the XLA one
        assert kernel_xla >= 10 * kernel_fused and kernel_xla > BF16_EAGER_TOL, (kernel_xla, kernel_fused)

