"""yanerf_tpu_torch models (eager path) against yanerf_tpu's ``apply``, with weights through ``convert.py``.

Tolerances: float32 at rtol/atol 1e-5 (the same arithmetic; matrix products
sum in another order). bfloat16 at atol 4e-3, one bf16 ulp (2^-8) of an
output of order 1: both sides round inputs, weights, bias and every
activation to bf16 at the same places, and a float32 sum taken in another
order can move one rounding by an ulp.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yanerf_tpu.models import MODELS as JAX_MODELS
from yanerf_tpu_torch.convert import export_jax_params, flatten_tree, load_jax_params, unflatten_tree
from yanerf_tpu_torch.models import MODELS

NERF_CFG = dict(
    type="NeRFMLP", n_layers=5, input_skips=[3], n_harmonic_functions_xyz=4, n_hidden_neurons_xyz=64,
    n_harmonic_functions_dir=2, n_hidden_neurons_dir=32, color_dim=3,
)
PROPOSAL_CFG = dict(type="ProposalMLP", n_layers=3, hidden_dim=32, n_harmonic_functions_xyz=5)
TOLS = {"float32": dict(rtol=1e-5, atol=1e-5), "bfloat16": dict(rtol=0.0, atol=4e-3)}


def _inputs(seed=0, n_rays=4, n_pts=6):
    rng = np.random.RandomState(seed)
    origins = rng.randn(1, n_rays, 1, 3).astype(np.float32)
    directions = rng.randn(1, n_rays, 1, 3).astype(np.float32)
    lengths = np.sort(rng.uniform(1, 4, (1, n_rays, 1, n_pts)), axis=-1).astype(np.float32)
    return origins, directions, lengths


def _pair(cfg, compute_dtype, seed=0, **extra):
    jax_model = JAX_MODELS.build(dict(cfg, compute_dtype=compute_dtype, **extra))
    params = jax_model.init(jax.random.PRNGKey(seed))
    model = MODELS.build(dict(cfg, compute_dtype=compute_dtype, **extra))
    load_jax_params(model, jax.tree_util.tree_map(np.asarray, params))
    return jax_model, params, model


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cfg", [NERF_CFG, dict(NERF_CFG, nerf_paper_v1=True)], ids=["nerf", "nerf_v1"])
def test_nerf_mlp_eager_matches_apply(cfg, compute_dtype):
    jax_model, params, model = _pair(cfg, compute_dtype)
    o, d, l = _inputs()
    ref = jax_model.apply(params, jnp.asarray(o), jnp.asarray(d), jnp.asarray(l), use_pallas=False)
    with torch.no_grad():
        got = model(torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(l), use_pallas=False)
    for key in ("rays_densities", "rays_features"):
        assert got[key].shape == ref[key].shape and got[key].dtype == torch.float32
        np.testing.assert_allclose(got[key].numpy(), np.asarray(ref[key]), **TOLS[compute_dtype], err_msg=key)


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_proposal_mlp_matches_apply(compute_dtype):
    jax_model, params, model = _pair(PROPOSAL_CFG, compute_dtype, seed=3)
    o, d, l = _inputs(seed=1)
    ref = jax_model.apply(params, jnp.asarray(o), jnp.asarray(d), jnp.asarray(l))
    with torch.no_grad():
        got = model(torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(l))
    np.testing.assert_allclose(got["rays_densities"].numpy(), np.asarray(ref["rays_densities"]), **TOLS[compute_dtype])
    assert got["rays_features"].shape == ref["rays_features"].shape
    assert not got["rays_features"].any()


def test_bridge_round_trip_is_exact():
    jax_model = JAX_MODELS.build(dict(NERF_CFG))
    params = jax.tree_util.tree_map(np.asarray, jax_model.init(jax.random.PRNGKey(1)))
    model = load_jax_params(MODELS.build(dict(NERF_CFG)), params)
    back = export_jax_params(model)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(params)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(a, b)
    flat = flatten_tree(params)
    assert "xyz_encoder.mlp.0.w" in flat and flat["xyz_encoder.mlp.0.w"].shape == (27, 64)  # JAX (in, out)
    # the flattened form loads too, and unflattens to the same tree
    load_jax_params(MODELS.build(dict(NERF_CFG)), flat)
    assert jax.tree_util.tree_structure(unflatten_tree(flat)) == jax.tree_util.tree_structure(params)


def test_bridge_rejects_missing_extra_and_misshapen_keys():
    model = MODELS.build(dict(NERF_CFG))
    flat = flatten_tree(export_jax_params(model))
    missing = dict(flat)
    del missing["density_layer.b"]
    with pytest.raises(KeyError, match="density_layer.b"):
        load_jax_params(model, missing)
    with pytest.raises(KeyError, match="extra"):
        load_jax_params(model, dict(flat, **{"color_layer.9.w": np.zeros((1, 1), np.float32)}))
    before = model.density_layer.w.detach().clone()
    bad = dict(flat, **{"intermediate_linear.w": np.zeros((64, 63), np.float32)})
    bad["density_layer.w"] = np.ones_like(flat["density_layer.w"])
    with pytest.raises(ValueError, match="intermediate_linear.w"):
        load_jax_params(model, bad)
    torch.testing.assert_close(model.density_layer.w.detach(), before)  # nothing written on failure


def test_torch_inits_have_the_reference_bounds():
    g = torch.Generator().manual_seed(0)
    model = MODELS.build(dict(NERF_CFG, generator=g))
    w = model.xyz_encoder.mlp[1].w.detach()
    bound = np.sqrt(6.0 / (64 + 64))  # xavier-uniform
    assert float(w.abs().max()) <= bound and float(w.abs().max()) > 0.9 * bound
    assert not model.density_layer.b.any()  # zero density bias
    c = model.color_layer[0]
    assert float(c.w.detach().abs().max()) <= 1.0 / np.sqrt(c.in_features)  # torch default U(1/sqrt(fan_in))
    again = MODELS.build(dict(NERF_CFG, generator=torch.Generator().manual_seed(0)))
    torch.testing.assert_close(again.xyz_encoder.mlp[1].w, w, rtol=0, atol=0)


def test_unported_model_options_raise():
    with pytest.raises(NotImplementedError):
        MODELS.build(dict(NERF_CFG, latent_dim=4))
    with pytest.raises(NotImplementedError, match="contract_coords"):
        MODELS.build(dict(type="HashGridNeRF", contract_coords=True, scene_bound=2.0))
