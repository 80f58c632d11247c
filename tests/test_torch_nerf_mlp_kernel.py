"""The fused NeRF-MLP kernel's plain version against the Pallas kernel (interpret mode), and its wrapper.

``nerf_mlp_fwd_plain`` mirrors ``_nerf_mlp_kernel`` (float32 bias after
float32 accumulation, cos as sin(t + pi/2)), so it is held to the Pallas
kernel, never to the eager model, whose bf16 policy differs.

Tolerances: float32 at rtol/atol 1e-5, as tests/test_pallas.py holds the
Pallas kernel to the jnp path. bfloat16 at atol 4e-3, one bf16 ulp (2^-8) of
an output of order 1: both round at the same places, and a float32 sum in
another order can move one rounding by an ulp. The CUDA kernel is held to
the plain version at atol + rtol 1e-2, as in chip_smoke.py: the tensor
cores sum the 256-long products in their own order, so over 65,440 points
a few hidden activations round the other way and the following layers
carry that on.

The CUDA kernel is held to the plain version on a card by
tests/test_torch_cuda_kernels.py, which imports no JAX (the card machine
has none).
"""

import os.path as osp

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yanerf_tpu.models import MODELS as JAX_MODELS
from yanerf_tpu.ops.pallas.nerf_mlp_kernel import nerf_mlp_forward_pallas
from yanerf_tpu.utils import Config
from yanerf_tpu_torch.convert import load_jax_params
from yanerf_tpu_torch.models import MODELS
from yanerf_tpu_torch.ops.kernels import nerf_mlp_fwd as K

CFG_DIR = osp.join(osp.dirname(__file__), "configs")
TOLS = {"float32": dict(rtol=1e-5, atol=1e-5), "bfloat16": dict(rtol=0.0, atol=4e-3)}
FLAGSHIP = dict(type="NeRFMLP")  # defaults: 8x256, skip at 5, 10/4 frequencies, 128-wide color head


def _small_cfg():
    return dict(Config.fromfile(osp.join(CFG_DIR, "models/nerf_mlp.yml")).model)


def _pair(cfg, compute_dtype, seed=0):
    cfg = dict(cfg, compute_dtype=compute_dtype)
    jax_model = JAX_MODELS.build(dict(cfg))
    params = jax_model.init(jax.random.PRNGKey(seed))
    model = MODELS.build(dict(cfg, use_pallas=True))
    load_jax_params(model, jax.tree_util.tree_map(np.asarray, params))
    return jax_model, params, model


def _points(n_rays, n_pts, seed=1):
    rng = np.random.RandomState(seed)
    pts = (rng.randn(1, n_rays, n_pts, 3) * 1.5).astype(np.float32)
    dirs = rng.randn(1, n_rays, 3).astype(np.float32)
    return pts, dirs


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n_rays,n_pts,tile", [(16, 16, 64), (10, 7, 32), (2, 3, 128), (3, 5, 8)])
def test_plain_matches_pallas_kernel(compute_dtype, n_rays, n_pts, tile):
    jax_model, params, model = _pair(_small_cfg(), compute_dtype)
    pts, dirs = _points(n_rays, n_pts)
    d_ref, c_ref = nerf_mlp_forward_pallas(jax_model, params, jnp.asarray(pts), jnp.asarray(dirs), tile=tile, interpret=True)
    out = K.nerf_mlp_fwd_plain(
        model.packed_weights(), torch.from_numpy(pts.reshape(-1, 3)), torch.from_numpy(dirs.reshape(-1, 3)), n_pts
    )
    tol = TOLS[compute_dtype]
    np.testing.assert_allclose(out[:, :1].numpy(), np.asarray(d_ref).reshape(-1, 1), **tol)
    np.testing.assert_allclose(out[:, 1:].numpy(), np.asarray(c_ref).reshape(-1, 3), **tol)


def test_plain_matches_pallas_kernel_at_flagship_widths():
    """8x256 with the 63 -> 64 and 27 -> 32 K padding (Pallas pads to 128 lanes)."""
    jax_model, params, model = _pair(FLAGSHIP, "bfloat16", seed=2)
    pts, dirs = _points(4, 16, seed=3)
    d_ref, c_ref = nerf_mlp_forward_pallas(jax_model, params, jnp.asarray(pts), jnp.asarray(dirs), tile=64, interpret=True)
    packed = model.packed_weights()
    assert (packed.k_xyz, packed.k_dir) == (64, 32)
    assert [tuple(w.shape) for w in packed.weights][:1] + [tuple(packed.weights[5].shape)] == [(64, 256), (320, 256)]
    out = K.nerf_mlp_fwd_plain(packed, torch.from_numpy(pts.reshape(-1, 3)), torch.from_numpy(dirs.reshape(-1, 3)), 16)
    np.testing.assert_allclose(out[:, :1].numpy(), np.asarray(d_ref).reshape(-1, 1), **TOLS["bfloat16"])
    np.testing.assert_allclose(out[:, 1:].numpy(), np.asarray(c_ref).reshape(-1, 3), **TOLS["bfloat16"])
    assert K.flops_per_point(packed) == 1_186_816  # 1.187 MFLOP per point, the bound's numerator


def test_model_switch_routes_cpu_tensors_to_the_plain_version():
    jax_model, params, model = _pair(_small_cfg(), "float32")
    rng = np.random.RandomState(4)
    o = rng.randn(1, 3, 1, 3).astype(np.float32)
    d = rng.randn(1, 3, 1, 3).astype(np.float32)
    l = np.sort(rng.uniform(1, 4, (1, 3, 1, 5)), axis=-1).astype(np.float32)
    ref = jax_model.apply(params, jnp.asarray(o), jnp.asarray(d), jnp.asarray(l), use_pallas=True)
    before = K.launches
    with torch.no_grad():
        got = model(torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(l))
    assert K.launches == before, "CPU tensors must not count as kernel launches"
    assert got["rays_densities"].shape == ref["rays_densities"].shape
    np.testing.assert_allclose(got["rays_densities"].numpy(), np.asarray(ref["rays_densities"]), **TOLS["float32"])
    np.testing.assert_allclose(got["rays_features"].numpy(), np.asarray(ref["rays_features"]), **TOLS["float32"])


def test_packed_weights_are_cached_until_a_parameter_changes():
    model = MODELS.build(dict(_small_cfg(), use_pallas=True))
    first = model.packed_weights()
    assert model.packed_weights() is first
    with torch.no_grad():
        model.density_layer.b.add_(1.0)
    second = model.packed_weights()
    assert second is not first
    assert float(second.biases[model.n_layers + 1][0]) == float(model.density_layer.b.detach()[0])


def test_cuda_input_checks_reject_what_the_kernel_does_not_take():
    pts, dirs = torch.zeros(6, 3), torch.zeros(3, 3)
    small = MODELS.build(dict(_small_cfg(), compute_dtype="bfloat16")).packed_weights()
    with pytest.raises(NotImplementedError, match="hidden widths"):
        K._check_cuda_inputs(small, pts, dirs, 2)
    f32 = MODELS.build(dict(FLAGSHIP)).packed_weights()
    with pytest.raises(NotImplementedError, match="bfloat16"):
        K._check_cuda_inputs(f32, pts, dirs, 2)
    packed = MODELS.build(dict(FLAGSHIP, compute_dtype="bfloat16")).packed_weights()
    K._check_cuda_inputs(packed, pts, dirs, 2)
    with pytest.raises(ValueError, match="rays"):
        K._check_cuda_inputs(packed, pts, dirs, 3)
    with pytest.raises(ValueError, match="float32"):
        K._check_cuda_inputs(packed, pts.double(), dirs, 2)
    with pytest.raises(ValueError, match="contiguous"):
        K._check_cuda_inputs(packed, torch.zeros(3, 6).t(), dirs, 2)
