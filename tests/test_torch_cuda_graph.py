"""The fused K-step dispatch and the EVALUATION chunk body captured as CUDA graphs, on a card.

Every test here is marked ``cuda`` and skips without a card; the file
imports no JAX:

    python -m pytest tests/test_torch_cuda_graph.py -m cuda --noconftest

A train step of a small proposal pipeline with the NeRF-MLP on K1 / K3
(bfloat16, the widths the kernels are compiled for: 256 / 128; the two
ProposalMLPs at K7's 128) runs three
times from the same start: eagerly (``make_train_step``), and as one
dispatch of the fused trainer (``make_train_step_fused``: the first step
eager on the capture's stream, then the captured graph replayed). The
replayed steps must equal the eager ones bit for bit, K1 and K3 must be
counted once per replay (K6 twice: one per proposal; K7 never: a train
step's ProposalMLPs run their own layers), and the packed weights must keep
their address.

A served frame of a small proposal and a small multipass pipeline (the
NeRF-MLPs on K1) runs its chunk body from one captured graph, replayed
per chunk (``pipelines/chunk_graph.py``): the frame must equal the plain
per-chunk loop's within 1e-6 (bit for bit expected; both run K7 for the
ProposalMLPs), K1 must be counted once per replay and NeRF-MLP (K6 once
per refinement, K7 once per ProposalMLP), the service's counters must read
one capture and ``n_chunks`` replays a frame after the warm-up, and after a
train step has changed the weights in place the next frame must follow the
new weights, K7's packed weights among them.
"""

from collections import namedtuple

import numpy as np
import pytest
import torch

from yanerf_tpu_torch.ops.kernels import launch_count
from yanerf_tpu_torch.ops.kernels import nerf_mlp_bwd as K3
from yanerf_tpu_torch.ops.kernels import nerf_mlp_fwd as K1
from yanerf_tpu_torch.ops.kernels import proposal_mlp_fwd as K7
from yanerf_tpu_torch.pipelines import PIPELINES
from yanerf_tpu_torch.runners import TrainState, apis, create_optimizer, make_train_step, make_train_step_fused
from yanerf_tpu_torch.ops.structures import EvaluationMode
from yanerf_tpu_torch.serve import CAM_CALIBRATION, RenderService, orbit_pose

HW = 32
RUNNER = dict(init_lr=5e-3, min_lr=5e-4, lr_decay_type="exponential", lr_decay_rate=0.1, lr_decay_iters=10,
              warmup_steps=2, warmup_lr=1e-4, weight_decay=1e-3, num_iters=100, steps_per_call=4,
              lr_param_groups=[dict(prefix="implicit_functions.0", base=0.5)])
PIPELINE = dict(
    type="NeRFPipeline", chunk_size_grid=4096, num_passes=3, output_rasterized_mc=False,
    loss_weights={"loss_rgb_mse": 1.0, "loss_proposal": 1.0},
    model=[
        dict(type="ProposalMLP", n_layers=2, hidden_dim=128, compute_dtype="bfloat16"),
        dict(type="ProposalMLP", n_layers=2, hidden_dim=128, compute_dtype="bfloat16"),
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
    assert launch_count.per_replay(trainer.tally) == {"nerf_mlp_fwd.launches": 1, "nerf_mlp_bwd.launches": 1,
                                                      "sample_pdf.launches": 2}  # K6: one per proposal
    assert K1.launches == K3.launches == len(rows), "one eager step, then one launch of each per replay"
    assert fused.step == eager.step == len(rows)
    assert torch.equal(hist["objective"][:, 0], torch.cat(eager_objectives))
    for (name, p), q in zip(fused.pipeline.named_parameters(), eager.pipeline.parameters()):
        assert torch.equal(p, q), name
    flat = nerf.packed_weights().flat.data_ptr()
    trainer(fused, arrays, rows[:2])  # a shorter group replays the same graph
    assert nerf.packed_weights().flat.data_ptr() == flat and trainer.dispatches == 2 and fused.step == 6


# --- the served frame's chunk body ------------------------------------------------------------------------


def _frame_cfg(kind):
    """The train step's pipeline with K1 in EVALUATION too (``proposal``), or two NeRF-MLPs coarse to fine."""
    nerf = dict(PIPELINE["model"][2], use_pallas=True)
    if kind == "proposal":
        return dict(PIPELINE, model=[*PIPELINE["model"][:2], nerf])
    return dict(PIPELINE, num_passes=2, model=[nerf, nerf], loss_weights={"loss_rgb_mse": 1.0},
                renderer=dict(type="MultipassEmissionAbsorpsionRenderer", n_pts_per_ray_fine_training=8,
                              n_pts_per_ray_fine_evaluation=8, bg_color=[0.0, 0.0, 0.0]))


FRAME_KINDS = {"proposal": 1, "multipass": 2}  # NeRF-MLPs a chunk
REFINEMENTS = {"proposal": 2, "multipass": 1}  # K6's launches a chunk
PROPOSALS = {"proposal": 2, "multipass": 0}  # K7's launches a chunk
N_CHUNKS = HW * HW * PIPELINE["ray_sampler"]["n_pts_per_ray_evaluation"] // PIPELINE["chunk_size_grid"]
POSE = (orbit_pose(70.0, -30.0, 4.0) @ CAM_CALIBRATION)[:3, :4].astype(np.float32)


def _eager_frame(pipeline, pose):
    """The frame through the plain per-chunk loop, which a frame with a gradient takes (no parameter needs one)."""
    flags = [p.requires_grad for p in pipeline.parameters()]
    for p in pipeline.parameters():
        p.requires_grad_(False)
    with torch.enable_grad():
        preds = pipeline(poses=torch.as_tensor(pose, device=pipeline.device)[None],
                         focal_lengths=torch.tensor([40.0], device=pipeline.device),
                         evaluation_mode=EvaluationMode.EVALUATION)
    for p, flag in zip(pipeline.parameters(), flags):
        p.requires_grad_(flag)
    return preds["rendered_images"][0].cpu().numpy(), preds["rendered_depths"][0, ..., 0].cpu().numpy()


def _service(kind, device):
    state = TrainState(pipeline=PIPELINES.build(_frame_cfg(kind), generator=torch.Generator().manual_seed(0),
                                                device=device), optimizer=None, step=0)
    state.optimizer = create_optimizer(RUNNER, state.pipeline)
    state.pipeline.eval()
    service = RenderService(state.pipeline, 40.0, (HW, HW), (2.0, 6.0))
    service.warmup()
    return state, service


def _gap(a, b):
    return float(np.max(np.abs(a - b)))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", sorted(FRAME_KINDS))
def test_replayed_frame_equals_the_eager_loop(cuda_device, kind):
    _, service = _service(kind, cuda_device)
    pipeline = service._pipeline
    assert N_CHUNKS > 1
    stats = service.stats()["chunk_loop"]
    assert (stats["keys"], stats["captures"], stats["eager_chunks"], stats["replayed_chunks"]) == (1, 1, 1,
                                                                                                   N_CHUNKS - 1)
    k7 = {"proposal_mlp_fwd.launches": PROPOSALS[kind]} if PROPOSALS[kind] else {}
    assert launch_count.per_replay(pipeline._chunk_graph.tally) == {"nerf_mlp_fwd.launches": FRAME_KINDS[kind],
                                                                    "sample_pdf.launches": REFINEMENTS[kind], **k7}
    K1.launches = K7.launches = 0
    rgb, depth = service.render(POSE, 40.0)
    torch.cuda.synchronize()
    assert K1.launches == N_CHUNKS * FRAME_KINDS[kind], "one launch per replay and NeRF-MLP"
    assert K7.launches == N_CHUNKS * PROPOSALS[kind], "one launch per replay and ProposalMLP"
    stats = service.stats()["chunk_loop"]
    assert (stats["keys"], stats["captures"], stats["replayed_chunks"]) == (1, 1, 2 * N_CHUNKS - 1)
    eager_rgb, eager_depth = _eager_frame(pipeline, POSE)
    print(f"{kind}: replayed against eager, rgb {_gap(rgb, eager_rgb)}, depth {_gap(depth, eager_depth)}, "
          f"capture {stats['capture_s']:.3f} s")
    assert _gap(rgb, eager_rgb) <= 1e-6 and _gap(depth, eager_depth) <= 1e-6
    assert service.stats()["chunk_loop"]["replayed_chunks"] == 2 * N_CHUNKS - 1, "the eager frame replays nothing"


@pytest.mark.cuda
@pytest.mark.parametrize("kind", sorted(FRAME_KINDS))
def test_frame_after_a_train_step_follows_the_new_weights(cuda_device, kind):
    state, service = _service(kind, cuda_device)
    before, _ = service.render(POSE, 40.0)
    gen = torch.Generator().manual_seed(1)
    arrays = (torch.as_tensor(orbit_pose(30.0, -30.0, 4.0) @ CAM_CALIBRATION, dtype=torch.float32)[None],
              torch.full((1, 1), 40.0), (torch.rand(1, HW, HW, 3, generator=gen) * 255).round().to(torch.uint8))
    batch = apis._gather_batch([a.to(cuda_device) for a in arrays], Batch, torch.zeros(1, dtype=torch.int64,
                                                                                        device=cuda_device))
    make_train_step(state.pipeline, RUNNER, seed=3)(state, batch)  # Adam writes the parameters in place
    state.pipeline.eval()
    rgb, depth = service.render(POSE, 40.0)
    eager_rgb, eager_depth = _eager_frame(state.pipeline, POSE)
    assert _gap(rgb, before) > 1e-4, "the replayed frame still shows the old weights"
    for fn in state.pipeline.implicit_functions[:PROPOSALS[kind]]:  # the buffers the replays read: a fresh pack's
        fresh = K7.pack_weights(fn)
        assert torch.equal(fn._packed[1].flat, fresh.flat) and torch.equal(fn._packed[1].biases_flat,
                                                                           fresh.biases_flat)
    assert _gap(rgb, eager_rgb) <= 1e-6 and _gap(depth, eager_depth) <= 1e-6
    assert service.stats()["chunk_loop"]["captures"] == 1, "weights written in place keep the graph"
