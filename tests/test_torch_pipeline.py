"""A full EVALUATION frame of a tiny two-level proposal pipeline: yanerf_tpu_torch vs yanerf_tpu.

The same structure as configs/nerf/lego_proposal.yml (two ProposalMLPs and
a NeRFMLP with the fused kernel switched on, on both sides) at tiny widths,
same weights through ``convert.py``. ``chunk_size_grid`` 42 makes 64 rays of
6 points into 10 chunks of 7 rays, the last one edge-padded.

Tolerance rtol/atol 1e-4 in float32: the ops agree to ~1e-6 one by one
(tests/test_torch_ops.py), and the two inverse-CDF resamplings divide by
per-bin CDF steps, which scales those differences up before the next pass.
In bfloat16, atol 5e-3: a bf16 rounding that goes the other way (2^-8
relative) in a proposal density moves the resampled depths by as much.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yanerf_tpu.ops.structures import EvaluationMode as JaxEvaluationMode
from yanerf_tpu.pipelines import PIPELINES as JAX_PIPELINES
from yanerf_tpu_torch.convert import load_jax_params
from yanerf_tpu_torch.ops.kernels import nerf_mlp_fwd as K
from yanerf_tpu_torch.ops.structures import EvaluationMode
from yanerf_tpu_torch.pipelines import PIPELINES
from yanerf_tpu_torch.serve import CAM_CALIBRATION, orbit_pose

HW = 8


def _cfg(compute_dtype="float32", chunk_size_grid=42):
    return dict(
        type="NeRFPipeline",
        chunk_size_grid=chunk_size_grid,
        num_passes=3,
        output_rasterized_mc=False,
        loss_weights={"loss_rgb_mse": 1.0, "loss_proposal": 1.0},
        model=[
            dict(type="ProposalMLP", n_layers=2, hidden_dim=16, compute_dtype=compute_dtype),
            dict(type="ProposalMLP", n_layers=2, hidden_dim=16, compute_dtype=compute_dtype),
            dict(type="NeRFMLP", n_layers=3, input_skips=[2], n_harmonic_functions_xyz=3,
                 n_harmonic_functions_dir=2, n_hidden_neurons_xyz=32, n_hidden_neurons_dir=16,
                 compute_dtype=compute_dtype, use_pallas=True),
        ],
        ray_sampler=dict(
            type="RaySampler", image_height=HW, image_width=HW, min_depth=1.0,
            max_depth=3.0, n_pts_per_ray_training=4, n_pts_per_ray_evaluation=6,
            n_rays_per_image_sampled_from_mask=8,
        ),
        renderer=dict(
            type="ProposalEmissionAbsorpsionRenderer", n_pts_per_ray_final_training=3,
            n_pts_per_ray_final_evaluation=5, n_pts_per_ray_intermediate_training=[3],
            n_pts_per_ray_intermediate_evaluation=[6], bg_color=[0.0, 0.0, 0.0],
            background_density_bias=1e-6,
        ),
        feature_extractor=[],
    )


def _frames(cfg, seed=0):
    jax_pipeline = JAX_PIPELINES.build(dict(cfg))
    params = jax_pipeline.init(jax.random.PRNGKey(seed))
    pose = (orbit_pose(30.0, -30.0, 2.0) @ CAM_CALIBRATION)[:3, :4].astype(np.float32)
    ref = jax_pipeline.forward(
        params, jax.random.PRNGKey(1), poses=jnp.asarray(pose)[None], focal_lengths=jnp.asarray([10.0]),
        evaluation_mode=JaxEvaluationMode.EVALUATION,
    )
    pipeline = PIPELINES.build(dict(cfg), device="cpu")
    load_jax_params(pipeline, jax.tree_util.tree_map(np.asarray, params))
    with torch.no_grad():
        got = pipeline(
            poses=torch.from_numpy(pose)[None], focal_lengths=torch.tensor([10.0]),
            evaluation_mode=EvaluationMode.EVALUATION,
        )
    return got, ref


KEYS = ("rendered_images", "rendered_depths", "rendered_alpha_masks", "loss_proposal", "loss_distortion", "objective")


@pytest.mark.parametrize("compute_dtype,tol", [("float32", 1e-4), ("bfloat16", 5e-3)])
def test_eval_frame_matches_jax_pipeline(compute_dtype, tol):
    launches = K.launches
    got, ref = _frames(_cfg(compute_dtype))
    assert K.launches == launches, "on the CPU the kernel's plain version runs, no launch"
    assert set(KEYS) <= set(got) and set(KEYS) <= set(ref)
    for key in KEYS:
        assert tuple(got[key].shape) == tuple(ref[key].shape), key
        np.testing.assert_allclose(got[key].numpy(), np.asarray(ref[key]), rtol=tol, atol=tol, err_msg=key)
    assert float(got["rendered_images"].std()) > 0.0, "the frame is not blank"


@pytest.mark.parametrize("chunk_size_grid", [0, 64 * 6, 6])
def test_chunking_does_not_change_the_frame(chunk_size_grid):
    """No chunking, one chunk, and one ray per chunk give the frame of the padded default."""
    base, _ = _frames(_cfg())
    got, _ = _frames(_cfg(chunk_size_grid=chunk_size_grid))
    for key in KEYS:
        np.testing.assert_allclose(got[key].numpy(), base[key].numpy(), rtol=1e-6, atol=1e-6, err_msg=key)


def test_training_mode_is_the_next_slice():
    """Training is ported (tests/test_torch_train.py, test_torch_classic.py); its unported options still raise."""
    cfg = _cfg()
    cfg["ray_sampler"] = dict(cfg["ray_sampler"], approx_top_k=True)  # ported: the exact top-k
    preds = PIPELINES.build(cfg, device="cpu")(poses=torch.eye(4)[None], focal_lengths=torch.tensor([10.0]),
                                               evaluation_mode=EvaluationMode.TRAINING,
                                               image_rgb=torch.rand(1, HW, HW, 3),
                                               generator=torch.Generator().manual_seed(0))
    assert bool(torch.isfinite(preds["objective"]).all())
    pipeline = PIPELINES.build(dict(_cfg()), device="cpu")
    # sampling masks are ported (tests/test_torch_masks.py): every drawn pixel lies in the mask
    mask = torch.zeros(1, 1, HW, HW)
    mask[..., 2:6, 1:5] = 1.0
    preds = pipeline(poses=torch.eye(4)[None], focal_lengths=torch.tensor([10.0]),
                     evaluation_mode=EvaluationMode.TRAINING, image_rgb=torch.rand(1, HW, HW, 3), mask_crop=mask,
                     output_rasterized_mc=True, generator=torch.Generator().manual_seed(0))
    assert bool(torch.isfinite(preds["objective"]).all())
    assert bool((preds["rendered_alpha_masks"][mask[:, 0] == 0] == 0).all())
    # the training vis's rasterization is ported: the Monte-Carlo samples land on the image grid
    preds = pipeline(poses=torch.eye(4)[None], focal_lengths=torch.tensor([10.0]), evaluation_mode=EvaluationMode.TRAINING,
                     output_rasterized_mc=True, generator=torch.Generator().manual_seed(0))
    assert tuple(preds["rendered_images"].shape) == (1, HW, HW, 3)
    assert tuple(preds["rendered_depths"].shape) == (1, HW, HW, 1)
