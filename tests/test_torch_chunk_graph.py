"""The EVALUATION chunk loop on static buffers (``pipelines/chunk_graph.py``), run uncaptured on the CPU.

For the proposal and the multipass renderer at tiny widths (NeRF-MLPs on
K1's plain version, through their packed weights):
  * a frame through the static buffers is bit for bit the plain per-chunk
    loop's (``chunk_map``, which a frame with a gradient takes);
  * two poses give two different frames, each its own plain frame, and the
    first frame's tensors stay the caller's after the second;
  * another frame size takes a new key (one key is kept, the newest);
  * weights written in place between frames keep the key and give the new
    weights' frame; a replaced parameter takes a new key;
  * the plain loop runs with a gradient and with a feature extractor; a
    body that draws from the call's generator runs its chunks eagerly, in
    turn, as the plain loop does, and one that draws nothing leaves the
    generator alone;
  * ``RenderService.stats()`` reports the counters.
The card's half (the capture and the replays) is in
``tests/test_torch_cuda_graph.py``; the exported frame's loop in
``tests/test_torch_export_loop.py``.
"""

import pytest
import torch

from yanerf_tpu_torch.ops.structures import EvaluationMode
from yanerf_tpu_torch.pipelines import PIPELINES
from yanerf_tpu_torch.serve import CAM_CALIBRATION, RenderService, orbit_pose

HW = 8


def proposal_cfg(chunk_size_grid=64, latent_dim=0):
    nerf = dict(type="NeRFMLP", n_layers=3, input_skips=[2], n_harmonic_functions_xyz=3, n_harmonic_functions_dir=2,
                n_hidden_neurons_xyz=32, n_hidden_neurons_dir=16, use_pallas=latent_dim == 0, latent_dim=latent_dim)
    proposal = dict(type="ProposalMLP", n_layers=2, hidden_dim=16, latent_dim=latent_dim)
    return dict(
        type="NeRFPipeline", chunk_size_grid=chunk_size_grid, num_passes=3, output_rasterized_mc=False,
        loss_weights={"loss_rgb_mse": 1.0, "loss_proposal": 1.0}, model=[proposal, proposal, nerf],
        ray_sampler=dict(type="RaySampler", image_height=HW, image_width=HW, min_depth=1.0, max_depth=3.0,
                         n_pts_per_ray_training=5, n_pts_per_ray_evaluation=6, n_rays_per_image_sampled_from_mask=12),
        renderer=dict(type="ProposalEmissionAbsorpsionRenderer", n_pts_per_ray_final_training=4,
                      n_pts_per_ray_final_evaluation=5, n_pts_per_ray_intermediate_training=[6],
                      n_pts_per_ray_intermediate_evaluation=[6], bg_color=[0.0, 0.0, 0.0],
                      background_density_bias=1e-6),
        feature_extractor=([dict(type="LearnedSceneEmbedding", n_scenes=2, latent_dim=latent_dim)]
                           if latent_dim else []),
    )


def multipass_cfg():
    cfg = proposal_cfg()
    return dict(cfg, num_passes=2, model=[cfg["model"][2]] * 2, loss_weights={"loss_rgb_mse": 1.0},
                renderer=dict(type="MultipassEmissionAbsorpsionRenderer", n_pts_per_ray_fine_training=4,
                              n_pts_per_ray_fine_evaluation=5, bg_color=[0.0, 0.0, 0.0]))


KINDS = {"proposal": proposal_cfg, "multipass": multipass_cfg}


def _pipeline(cfg):
    return PIPELINES.build(cfg, generator=torch.Generator().manual_seed(0), device="cpu").eval()


def _pose(theta):
    return torch.as_tensor((orbit_pose(theta, -30.0, 2.0) @ CAM_CALIBRATION)[:3, :4], dtype=torch.float32)[None]


def _frame(pipeline, theta=20.0, hw=HW, grad=False, **kw):
    """The frame's outputs; ``grad``: with a gradient, so through the plain loop."""
    mode = torch.enable_grad() if grad else torch.inference_mode()
    with mode:
        preds = pipeline(poses=_pose(theta), focal_lengths=torch.tensor([float(hw)]), image_height=hw,
                         image_width=hw, evaluation_mode=EvaluationMode.EVALUATION, **kw)
    return {k: v.detach().clone() for k, v in preds.items() if k.startswith(("rendered_", "loss_"))}


def _plain(pipeline, **kw):
    """The frame through the plain loop; the parameters need no gradient, so nothing else differs."""
    flags = [p.requires_grad for p in pipeline.parameters()]
    for p in pipeline.parameters():
        p.requires_grad_(False)
    stats = dict(pipeline.chunk_stats)
    try:
        frame = _frame(pipeline, grad=True, **kw)
    finally:
        for p, flag in zip(pipeline.parameters(), flags):
            p.requires_grad_(flag)
    assert pipeline.chunk_stats == stats, "the plain loop touches no static buffer"
    return frame


def _equal(a, b):
    return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


def _n_chunks(cfg, hw=HW):
    return -(-hw * hw * cfg["ray_sampler"]["n_pts_per_ray_evaluation"] // cfg["chunk_size_grid"])


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_static_chunks_are_bit_for_bit_the_plain_loop(kind):
    cfg = KINDS[kind]()
    pipeline = _pipeline(cfg)
    n = _n_chunks(cfg)
    assert n > 1
    static = _frame(pipeline)
    assert pipeline.chunk_stats == {"keys": 1, "captures": 0, "capture_s": 0.0, "replayed_chunks": 0,
                                    "eager_chunks": n}
    assert "rendered_images" in static and _equal(static, _plain(pipeline))
    again = _frame(pipeline)
    assert _equal(again, static) and pipeline.chunk_stats["keys"] == 1 and pipeline.chunk_stats["eager_chunks"] == 2 * n


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_two_poses_give_their_own_frames_and_the_first_stays_the_callers(kind):
    pipeline = _pipeline(KINDS[kind]())
    first = _frame(pipeline, theta=20.0)
    with torch.inference_mode():
        kept = pipeline(poses=_pose(20.0), focal_lengths=torch.tensor([float(HW)]),
                        evaluation_mode=EvaluationMode.EVALUATION)["rendered_images"]
    second = _frame(pipeline, theta=140.0)
    assert not torch.equal(first["rendered_images"], second["rendered_images"])
    assert torch.equal(kept, first["rendered_images"]), "the next frame wrote over a frame the caller holds"
    assert _equal(second, _plain(pipeline, theta=140.0)) and _equal(first, _plain(pipeline, theta=20.0))
    assert pipeline.chunk_stats["keys"] == 1


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_another_frame_size_takes_a_new_key(kind):
    pipeline = _pipeline(KINDS[kind]())
    small = _frame(pipeline)
    graph = pipeline._chunk_graph
    large = _frame(pipeline, hw=12)
    assert pipeline.chunk_stats["keys"] == 2 and pipeline._chunk_graph is not graph
    assert large["rendered_images"].shape[1:3] == (12, 12) and _equal(large, _plain(pipeline, hw=12))
    assert _equal(_frame(pipeline), small) and pipeline.chunk_stats["keys"] == 3  # the newest key only


@pytest.mark.parametrize("how", ["in_place", "replaced"])
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_weights_loaded_between_frames_give_the_new_weights_frame(kind, how):
    pipeline = _pipeline(KINDS[kind]())
    before = _frame(pipeline)
    new_state = _pipeline(KINDS[kind]()).state_dict()
    for k in new_state:
        new_state[k] = new_state[k] * 1.5 + 0.05
    pipeline.load_state_dict(new_state, assign=how == "replaced")
    after = _frame(pipeline)
    assert not torch.equal(after["rendered_images"], before["rendered_images"])
    fresh = _pipeline(KINDS[kind]())
    fresh.load_state_dict(new_state)
    assert _equal(after, _plain(fresh)) and _equal(after, _plain(pipeline))
    assert pipeline.chunk_stats["keys"] == (2 if how == "replaced" else 1)


def test_a_gradient_or_a_feature_extractor_takes_the_plain_loop():
    pipeline = _pipeline(proposal_cfg())
    _plain(pipeline)
    assert pipeline.chunk_stats["keys"] == pipeline.chunk_stats["eager_chunks"] == 0
    latent = _pipeline(proposal_cfg(latent_dim=3))
    frame = _frame(latent, scene_id=torch.tensor([[1]]))
    assert "rendered_images" in frame and latent.chunk_stats["keys"] == latent.chunk_stats["eager_chunks"] == 0


@pytest.mark.parametrize("draws", [False, True])
def test_a_body_that_draws_runs_its_chunks_in_turn_as_the_plain_loop(draws):
    cfg = proposal_cfg()
    pipeline, twin = _pipeline(cfg), _pipeline(cfg)
    for p in (pipeline, twin):  # random refinement at eval: the chunks draw from one generator in turn
        p.renderer._final_cfg[EvaluationMode.EVALUATION] = (5, draws)
    gen, twin_gen = torch.Generator().manual_seed(5), torch.Generator().manual_seed(5)
    start = gen.get_state()
    static = _frame(pipeline, generator=gen)
    assert pipeline._chunk_graph.draws is draws and pipeline.chunk_stats["keys"] == 1
    assert torch.equal(gen.get_state(), start) is not draws
    assert _equal(static, _plain(twin, generator=twin_gen)) and torch.equal(gen.get_state(), twin_gen.get_state())
    _frame(pipeline, generator=gen)
    assert pipeline.chunk_stats["eager_chunks"] == 2 * _n_chunks(cfg) and pipeline.chunk_stats["captures"] == 0


def test_render_service_reports_the_chunk_loop():
    cfg = proposal_cfg()
    service = RenderService(_pipeline(cfg), float(HW), (HW, HW), (1.0, 3.0))
    service.warmup()
    service.render((orbit_pose(60.0, -30.0, 2.0) @ CAM_CALIBRATION)[:3, :4], float(HW))
    assert service.stats()["chunk_loop"] == {"keys": 1, "captures": 0, "capture_s": 0.0, "replayed_chunks": 0,
                                             "eager_chunks": 2 * _n_chunks(cfg)}


def test_weights_packed_while_serving_are_repacked_by_a_train_step():
    pipeline = _pipeline(proposal_cfg())
    _frame(pipeline)  # packs the NeRF-MLP's weights under inference mode
    nerf = pipeline.implicit_functions[2]
    flat = nerf.packed_weights().flat
    assert not flat.is_inference()
    with torch.no_grad():
        for p in nerf.parameters():
            p.mul_(1.25)
    assert nerf.packed_weights(refresh=True).flat is flat  # as a train step's forward repacks, outside inference
    assert _equal(_frame(pipeline), _plain(pipeline)) and pipeline.chunk_stats["keys"] == 1
