"""The fused K-step dispatch captured as a CUDA graph, on a card.

Every test here is marked ``cuda`` and skips without a card; the file
imports no JAX:

    python -m pytest tests/test_torch_cuda_graph.py -m cuda --noconftest

A train step of a small proposal pipeline with the NeRF-MLP on K1 / K3
(bfloat16, the widths the kernels are compiled for: 256 / 128) runs three
times from the same start: eagerly (``make_train_step``), and as one
dispatch of the fused trainer (``make_train_step_fused``: the first step
eager on the capture's stream, then the captured graph replayed). The
replayed steps must equal the eager ones bit for bit, K1 and K3 must be
counted once per replay, and the packed weights must keep their address.
"""

from collections import namedtuple

import numpy as np
import pytest
import torch

from yanerf_tpu_torch.ops.kernels import launch_count
from yanerf_tpu_torch.ops.kernels import nerf_mlp_bwd as K3
from yanerf_tpu_torch.ops.kernels import nerf_mlp_fwd as K1
from yanerf_tpu_torch.pipelines import PIPELINES
from yanerf_tpu_torch.runners import TrainState, apis, create_optimizer, make_train_step, make_train_step_fused
from yanerf_tpu_torch.serve import CAM_CALIBRATION, orbit_pose

HW = 32
RUNNER = dict(init_lr=5e-3, min_lr=5e-4, lr_decay_type="exponential", lr_decay_rate=0.1, lr_decay_iters=10,
              warmup_steps=2, warmup_lr=1e-4, weight_decay=1e-3, num_iters=100, steps_per_call=4,
              lr_param_groups=[dict(prefix="implicit_functions.0", base=0.5)])
PIPELINE = dict(
    type="NeRFPipeline", chunk_size_grid=4096, num_passes=3, output_rasterized_mc=False,
    loss_weights={"loss_rgb_mse": 1.0, "loss_proposal": 1.0},
    model=[
        dict(type="ProposalMLP", n_layers=2, hidden_dim=32, compute_dtype="bfloat16"),
        dict(type="ProposalMLP", n_layers=2, hidden_dim=32, compute_dtype="bfloat16"),
        dict(type="NeRFMLP", n_layers=4, input_skips=[2], compute_dtype="bfloat16", use_pallas_train=True),
    ],
    ray_sampler=dict(type="RaySampler", image_height=HW, image_width=HW, min_depth=2.0, max_depth=6.0,
                     n_pts_per_ray_training=16, n_pts_per_ray_evaluation=16,
                     n_rays_per_image_sampled_from_mask=256, pixel_replacement=True),
    renderer=dict(type="ProposalEmissionAbsorpsionRenderer", n_pts_per_ray_final_training=8,
                  n_pts_per_ray_final_evaluation=8, n_pts_per_ray_intermediate_training=[16],
                  n_pts_per_ray_intermediate_evaluation=[16], bg_color=[0.0, 0.0, 0.0],
                  background_density_bias=1e-6),
    feature_extractor=[],
)
Batch = namedtuple("Batch", ["poses", "focal_lengths", "image_rgb"])


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _state(device):
    pipeline = PIPELINES.build(PIPELINE, generator=torch.Generator().manual_seed(0), device=device)
    return TrainState(pipeline=pipeline, optimizer=create_optimizer(RUNNER, pipeline), step=0)


@pytest.mark.cuda
def test_replayed_train_steps_equal_eager_steps(cuda_device):
    gen = torch.Generator().manual_seed(1)
    poses = torch.stack([torch.as_tensor(orbit_pose(30.0 + 50 * i, -30.0, 4.0) @ CAM_CALIBRATION, dtype=torch.float32)
                         for i in range(3)])
    arrays = (poses.to(cuda_device), torch.full((3, 1), 40.0, device=cuda_device),
              (torch.rand(3, HW, HW, 3, generator=gen) * 255).round().to(torch.uint8).to(cuda_device))
    rows = np.array([[2], [0], [1], [2]])

    eager, fused = _state(cuda_device), _state(cuda_device)
    step = make_train_step(eager.pipeline, RUNNER, seed=3)
    eager_objectives = []
    for row in rows:  # the batches the fused step gathers: cache rows, the uint8 images decoded
        batch = apis._gather_batch(arrays, Batch, torch.as_tensor(row, device=cuda_device))
        eager_objectives.append(step(eager, batch)["objective"])

    trainer = make_train_step_fused(fused.pipeline, RUNNER, 3, Batch)
    nerf = fused.pipeline.implicit_functions[2]
    K1.launches = K3.launches = 0
    hist = trainer(fused, arrays, rows)
    torch.cuda.synchronize()
    assert trainer.graph is not None and trainer.capture_s is not None
    assert launch_count.per_replay(trainer.tally) == {"nerf_mlp_fwd.launches": 1, "nerf_mlp_bwd.launches": 1}
    assert K1.launches == K3.launches == len(rows), "one eager step, then one launch of each per replay"
    assert fused.step == eager.step == len(rows)
    assert torch.equal(hist["objective"][:, 0], torch.cat(eager_objectives))
    for (name, p), q in zip(fused.pipeline.named_parameters(), eager.pipeline.parameters()):
        assert torch.equal(p, q), name
    flat = nerf.packed_weights().flat.data_ptr()
    trainer(fused, arrays, rows[:2])  # a shorter group replays the same graph
    assert nerf.packed_weights().flat.data_ptr() == flat and trainer.dispatches == 2 and fused.step == 6
