"""Two config switches held to ``yanerf_tpu``: the renderers' ``eval_compositing_dtype`` and the MLP's
``skip_affine_trans`` / ``no_last_relu``.

* A chunked EVALUATION frame with ``eval_compositing_dtype: bfloat16``, of
  the proposal and the multipass renderer, against the JAX pipeline at
  5e-3 (a bf16 rounding that goes the other way moves a resampled depth by
  as much, tests/test_torch_pipeline.py); TRAINING is unchanged by it, bit
  for bit.
* ``MLPWithInputSkips`` with the affine skip and / or a linear last layer,
  its weights carried from the JAX tree by ``convert.py``: the forward and
  every gradient at float32 (1e-5; rtol 2e-4 / atol 2e-5), the bfloat16
  forward at one bf16 step. K1's rule refuses a NeRF-MLP whose trunk has
  either switch.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yanerf_tpu.models.mlp import MLPWithInputSkips as JaxMLP
from yanerf_tpu.ops.structures import EvaluationMode as JaxEvaluationMode
from yanerf_tpu.pipelines import PIPELINES as JAX_PIPELINES
from torch_config_pin import with_mass
from yanerf_tpu_torch.convert import flatten_tree, load_jax_params
from yanerf_tpu_torch.models import MODELS
from yanerf_tpu_torch.models.mlp import MLPWithInputSkips
from yanerf_tpu_torch.ops.kernels import nerf_mlp_fwd as K1
from yanerf_tpu_torch.ops.structures import EvaluationMode
from yanerf_tpu_torch.pipelines import PIPELINES
from yanerf_tpu_torch.serve import CAM_CALIBRATION, orbit_pose

HW = 8
NERF = dict(type="NeRFMLP", n_layers=3, input_skips=[2], n_harmonic_functions_xyz=3, n_harmonic_functions_dir=2,
            n_hidden_neurons_xyz=32, n_hidden_neurons_dir=16)


def _cfg(renderer_type, eval_compositing_dtype):
    sampler = dict(type="RaySampler", image_height=HW, image_width=HW, min_depth=1.0, max_depth=3.0,
                   n_pts_per_ray_training=5, n_pts_per_ray_evaluation=6, n_rays_per_image_sampled_from_mask=8,
                   pixel_replacement=True)
    if renderer_type == "proposal":
        return dict(
            type="NeRFPipeline", chunk_size_grid=42, num_passes=3, output_rasterized_mc=False,
            loss_weights={"loss_rgb_mse": 1.0, "loss_proposal": 1.0},
            model=[dict(type="ProposalMLP", n_layers=2, hidden_dim=16), dict(type="ProposalMLP", n_layers=2,
                                                                            hidden_dim=16), dict(NERF)],
            ray_sampler=sampler,
            renderer=dict(type="ProposalEmissionAbsorpsionRenderer", n_pts_per_ray_final_training=4,
                          n_pts_per_ray_final_evaluation=5, n_pts_per_ray_intermediate_training=[6],
                          n_pts_per_ray_intermediate_evaluation=[6], bg_color=[0.0, 0.0, 0.0],
                          background_density_bias=1e-6, eval_compositing_dtype=eval_compositing_dtype),
            feature_extractor=[],
        )
    return dict(
        type="NeRFPipeline", chunk_size_grid=40, num_passes=2, output_rasterized_mc=False,
        loss_weights={"loss_prev_stage_rgb_mse": 1.0, "loss_rgb_mse": 1.0}, model=dict(NERF),
        ray_sampler=sampler,
        renderer=dict(type="MultipassEmissionAbsorpsionRenderer", append_coarse_samples_to_fine=True,
                      bg_color=[0.0, 0.0, 0.0], n_pts_per_ray_fine_training=6, n_pts_per_ray_fine_evaluation=7,
                      background_density_bias=1e-6, eval_compositing_dtype=eval_compositing_dtype),
        feature_extractor=[],
    )


@pytest.mark.parametrize("renderer_type", ["proposal", "multipass"])
def test_eval_compositing_dtype_frame_matches_jax(renderer_type):
    cfg = _cfg(renderer_type, "bfloat16")
    jax_pipeline = JAX_PIPELINES.build(dict(cfg))
    params = with_mass(jax_pipeline.init(jax.random.PRNGKey(0)))
    pose = (orbit_pose(30.0, -30.0, 2.0) @ CAM_CALIBRATION)[:3, :4].astype(np.float32)[None]
    image = np.random.RandomState(0).rand(1, HW, HW, 3).astype(np.float32)
    ref = jax_pipeline.forward(params, jax.random.PRNGKey(1), poses=jnp.asarray(pose),
                               focal_lengths=jnp.asarray([10.0]), image_rgb=jnp.asarray(image),
                               evaluation_mode=JaxEvaluationMode.EVALUATION)
    pipeline = PIPELINES.build(dict(cfg), device="cpu")
    load_jax_params(pipeline, jax.tree_util.tree_map(np.asarray, params))
    assert pipeline.renderer.eval_compositing_dtype == torch.bfloat16
    with torch.no_grad():
        got = pipeline(poses=torch.from_numpy(pose), focal_lengths=torch.tensor([10.0]),
                       image_rgb=torch.from_numpy(image), evaluation_mode=EvaluationMode.EVALUATION)
        plain = PIPELINES.build(dict(_cfg(renderer_type, None)), device="cpu")
        load_jax_params(plain, jax.tree_util.tree_map(np.asarray, params))
        f32 = plain(poses=torch.from_numpy(pose), focal_lengths=torch.tensor([10.0]),
                    image_rgb=torch.from_numpy(image), evaluation_mode=EvaluationMode.EVALUATION)
    for key in ("rendered_images", "rendered_depths", "rendered_alpha_masks", "objective"):
        assert got[key].dtype == torch.float32, key
        np.testing.assert_allclose(got[key].numpy(), np.asarray(ref[key]), rtol=5e-3, atol=5e-3, err_msg=key)
    assert not torch.equal(got["rendered_images"], f32["rendered_images"]), "the cast is applied at evaluation"

    # TRAINING is unchanged by the switch, bit for bit
    batch = dict(poses=torch.from_numpy(pose), focal_lengths=torch.tensor([[10.0]]), image_rgb=torch.from_numpy(image))
    outs = []
    for p in (pipeline, plain):
        preds = p(evaluation_mode=EvaluationMode.TRAINING, generator=torch.Generator().manual_seed(3), **batch)
        torch.mean(preds["objective"]).backward()
        outs.append((preds["objective"].detach(), {k: v.grad.clone() for k, v in p.named_parameters()}))
    assert torch.equal(outs[0][0], outs[1][0])
    for key, grad in outs[0][1].items():
        assert torch.equal(grad, outs[1][1][key]), key


@pytest.mark.parametrize("skip_affine_trans,no_last_relu", [(True, False), (False, True), (True, True)])
@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_mlp_switches_match_jax_forward_and_gradients(skip_affine_trans, no_last_relu, compute_dtype):
    kw = dict(n_layers=5, input_dim=9, output_dim=6, skip_dim=7, hidden_dim=16, input_skips=(2, 4),
              skip_affine_trans=skip_affine_trans, no_last_relu=no_last_relu)
    jax_mlp = JaxMLP(**kw, compute_dtype=compute_dtype)
    params = jax_mlp.init(jax.random.PRNGKey(2))
    flat = flatten_tree(jax.tree_util.tree_map(np.asarray, params))
    assert any(k.startswith("skip_affines.1.l2.") for k in flat) == skip_affine_trans
    mlp = MLPWithInputSkips(**kw, compute_dtype=getattr(torch, compute_dtype))
    load_jax_params(mlp, flat)  # strict: every key of the JAX tree has its place
    assert set(dict(mlp.named_parameters())) == set(flat)

    rng = np.random.RandomState(1)
    x, z = rng.randn(11, 9).astype(np.float32), rng.randn(11, 7).astype(np.float32)
    r = rng.randn(11, 6).astype(np.float32)

    def jax_loss(p, x, z):
        y = jax_mlp.apply(p, x, z)
        return jnp.sum(y.astype(jnp.float32) * r), y

    (_, ref), (ref_grads, ref_dx, ref_dz) = jax.value_and_grad(jax_loss, argnums=(0, 1, 2), has_aux=True)(
        params, jnp.asarray(x), jnp.asarray(z))
    ref_grads = flatten_tree(jax.tree_util.tree_map(np.asarray, ref_grads))
    tx, tz = torch.from_numpy(x).requires_grad_(), torch.from_numpy(z).requires_grad_()
    y = mlp(tx, tz)
    assert y.dtype == getattr(torch, compute_dtype)
    torch.sum(y.to(torch.float32) * torch.from_numpy(r)).backward()
    if compute_dtype == "float32":
        fwd, grad = dict(rtol=1e-5, atol=1e-5), dict(rtol=2e-4, atol=2e-5)
        if not no_last_relu:
            assert np.all(y.detach().numpy() >= 0)
        else:
            assert np.any(y.detach().numpy() < 0), "the last layer is linear"
    else:  # one bf16 step of the largest value
        fwd = grad = dict(rtol=2 ** -7, atol=2 ** -7 * max(1.0, float(np.abs(np.asarray(ref, np.float32)).max())))
    np.testing.assert_allclose(y.detach().to(torch.float32).numpy(), np.asarray(ref, np.float32), **fwd)
    if compute_dtype == "bfloat16":
        return  # bf16 gradients differ by rounding order; the forward pins the switches
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(ref_dx), **grad)
    np.testing.assert_allclose(tz.grad.numpy(), np.asarray(ref_dz), **grad)
    for key, p in mlp.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), ref_grads[key], err_msg=key, **grad)


@pytest.mark.parametrize("switch", ["skip_affine_trans", "no_last_relu"])
def test_k1_refuses_a_trunk_with_either_switch(switch):
    model = MODELS.build(dict(NERF, use_pallas=True))
    setattr(model.xyz_encoder, switch, True)
    with pytest.raises(NotImplementedError, match=switch):
        K1.pack_weights(model)
