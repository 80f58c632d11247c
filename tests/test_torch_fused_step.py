"""The fused K-step dispatch of yanerf_tpu_torch, on the CPU.

  * the port's fused epoch (the CUDA graph's step, run uncaptured here)
    equals its per-step epoch bit for bit: parameters, Adam state, ``step``
    and stats, over epoch tails, periodic vis steps and both cache dtypes;
  * its dispatch groups equal those of ``yanerf_tpu``'s
    ``_train_one_epoch_fused``, both loops driven with recording fakes;
  * three fused steps, fed the JAX package's draws, match
    ``make_train_step_fused`` (``lax.scan`` over the Pallas custom VJP in
    interpret mode): per-step objective at 1e-5, parameters at rtol 2e-4 /
    atol 2e-5 where every step's gradient exceeds that atol (elsewhere the
    sign of Adam's update is float32 noise, and the update is bounded);
  * the in-place repack of the NeRF-MLP weights keeps the buffer's address
    and gives a fresh pack's bits;
  * a kernel captured outside ``launch_count.capturing`` raises, and every
    draw of a TRAINING call is one of ``training_draws``.
"""

from collections import namedtuple
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_train import _capture_draws
from yanerf_tpu.ops.structures import EvaluationMode as JaxEvaluationMode
from yanerf_tpu.pipelines import PIPELINES as JAX_PIPELINES
from yanerf_tpu.runners import apis as jax_apis
from yanerf_tpu.runners import optim as jax_optim
from yanerf_tpu.runners.vis import RunType as JaxRunType
from yanerf_tpu_torch.convert import flatten_tree, load_jax_params
from yanerf_tpu_torch.datasets import BlenderDataset, DeviceCachedLoader, create_loader, create_sampler
from yanerf_tpu_torch.models import MODELS
from yanerf_tpu_torch.ops.kernels import launch_count
from yanerf_tpu_torch.ops.kernels import nerf_mlp_fwd as K1
from yanerf_tpu_torch.ops.structures import EvaluationMode
from yanerf_tpu_torch.pipelines import PIPELINES
from yanerf_tpu_torch.runners import (
    RunType,
    TrainState,
    create_optimizer,
    make_train_step,
    make_train_step_fused,
    train_one_epoch,
)
from yanerf_tpu_torch.runners import apis
from yanerf_tpu_torch.serve import CAM_CALIBRATION, orbit_pose
from yanerf_tpu_torch.synth_scene import write_scene

HW = 8
F32_GRAD_TOL = dict(rtol=2e-4, atol=2e-5)
RUNNER = dict(
    init_lr=5e-3, min_lr=5e-4, lr_decay_type="exponential", lr_decay_rate=0.1, lr_decay_iters=10,
    warmup_steps=2, warmup_lr=1e-4, weight_decay=1e-3, num_iters=100, print_per_iter=2,
    lr_param_groups=[dict(prefix="implicit_functions.0", base=0.5)],
)


def proposal_cfg(compute_dtype="float32", hw=HW):
    """A two-level proposal pipeline at a few layers and narrow widths, NeRF-MLP on the fused function."""
    return dict(
        type="NeRFPipeline", chunk_size_grid=64, num_passes=3, output_rasterized_mc=False,
        loss_weights={"loss_rgb_mse": 1.0, "loss_proposal": 1.0},
        model=[
            dict(type="ProposalMLP", n_layers=2, hidden_dim=16, compute_dtype=compute_dtype),
            dict(type="ProposalMLP", n_layers=2, hidden_dim=16, compute_dtype=compute_dtype),
            dict(type="NeRFMLP", n_layers=3, input_skips=[2], n_harmonic_functions_xyz=3,
                 n_harmonic_functions_dir=2, n_hidden_neurons_xyz=32, n_hidden_neurons_dir=16,
                 compute_dtype=compute_dtype, use_pallas_train=True),
        ],
        ray_sampler=dict(
            type="RaySampler", image_height=hw, image_width=hw, min_depth=1.0, max_depth=3.0,
            n_pts_per_ray_training=5, n_pts_per_ray_evaluation=6, n_rays_per_image_sampled_from_mask=12,
            pixel_replacement=True,
        ),
        renderer=dict(
            type="ProposalEmissionAbsorpsionRenderer", n_pts_per_ray_final_training=4,
            n_pts_per_ray_final_evaluation=5, n_pts_per_ray_intermediate_training=[6],
            n_pts_per_ray_intermediate_evaluation=[6], bg_color=[0.0, 0.0, 0.0],
            density_noise_std_train=0.0, background_density_bias=1e-6,
        ),
        feature_extractor=[],
    )


def _train_loader(tmp_path, n_train, quantize):
    scene = write_scene(tmp_path / "scene", hw=HW, n_train=n_train, n_val=1, n_test=1, n_spheres=3, seed=2)
    dataset = BlenderDataset(scene, "train")
    loader = create_loader(dataset, create_sampler(dataset, shuffle=True, seed=3), 1, 0, is_train=True)
    return DeviceCachedLoader(loader, "cpu", quantize_images=quantize)


def _state(cfg, runner):
    pipeline = PIPELINES.build(cfg, generator=torch.Generator().manual_seed(4), device="cpu")
    return TrainState(pipeline=pipeline, optimizer=create_optimizer(runner, pipeline), step=0)


def _assert_states_equal(a: TrainState, b: TrainState):
    assert a.step == b.step
    for (name, p), q in zip(a.pipeline.named_parameters(), b.pipeline.parameters()):
        assert torch.equal(p, q), name
    sa, sb = a.optimizer.state_dict()["state"], b.optimizer.state_dict()["state"]
    assert sa.keys() == sb.keys()
    for i in sa:
        for key in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(torch.as_tensor(sa[i][key]), torch.as_tensor(sb[i][key])), (i, key)


# --- the fused epoch is the per-step epoch ------------------------------------


@pytest.mark.parametrize("quantize,val_per_iter", [(True, None), (False, None), (True, 4)],
                         ids=["uint8_cache", "float32_cache", "uint8_cache_with_vis_steps"])
def test_fused_epochs_equal_per_step_epochs_bit_for_bit(tmp_path, quantize, val_per_iter):
    """Two epochs of 7 steps at K=3: groups 3, 3, 1 (an epoch tail), or split by the vis steps."""
    loader = _train_loader(tmp_path, 7, quantize)
    assert loader._ensure_cache()
    assert (loader._arrays[2].dtype == torch.uint8) == quantize
    runner = dict(RUNNER, steps_per_call=3, val_per_iter=val_per_iter)
    cfg = proposal_cfg()
    per_step, fused = _state(cfg, runner), _state(cfg, runner)
    fused.pipeline.load_state_dict(per_step.pipeline.state_dict())
    step = make_train_step(per_step.pipeline, runner, seed=5)
    vis = make_train_step(per_step.pipeline, runner, seed=5, rasterize_mc=True) if val_per_iter else None
    trainer = make_train_step_fused(fused.pipeline, runner, 5, loader.data_wrapper)
    fused_vis = make_train_step(fused.pipeline, runner, seed=5, rasterize_mc=True) if val_per_iter else None
    for epoch in range(2):
        _, stats = train_one_epoch(RunType.TRAIN, runner, epoch, per_step, loader, step, train_step_vis=vis)
        _, fused_stats = train_one_epoch(RunType.TRAIN, runner, epoch, fused, loader, step,
                                         train_step_vis=fused_vis, train_step_fused=trainer)
        _assert_states_equal(fused, per_step)
        stats.pop("step_s", None), fused_stats.pop("step_s", None)
        assert fused_stats == stats
    assert fused.step == 14
    if val_per_iter:  # vis steps at 0, 4 | 8, 12: groups 3, 2 | 1, 3, 1
        assert trainer.steps == 10 and trainer.dispatches == 5 and sorted(trainer.seen_group_sizes) == [1, 2, 3]
    else:
        assert trainer.steps == 14 and trainer.dispatches == 6 and sorted(trainer.seen_group_sizes) == [1, 3]


def test_hooks_make_the_fused_path_ineligible(tmp_path):
    from yanerf_tpu_torch.runners import HOOKS

    loader = _train_loader(tmp_path, 3, True)
    runner = dict(RUNNER, steps_per_call=3)
    state = _state(proposal_cfg(), runner)
    trainer = make_train_step_fused(state.pipeline, runner, 0, loader.data_wrapper)
    assert apis._fused_eligible(runner, loader, trainer)
    hooked = dict(runner, hooks=[HOOKS.build(dict(type="SDNeRFOutputsHook"))])
    assert not apis._fused_eligible(hooked, loader, trainer)
    train_one_epoch(RunType.TRAIN, hooked, 0, state, loader, make_train_step(state.pipeline, hooked, 0),
                    train_step_fused=trainer)
    assert trainer.dispatches == 0 and state.step == 3
    # a host loader (no device cache) and a single step per call are ineligible too
    assert not apis._fused_eligible(runner, loader.inner, trainer)
    assert not apis._fused_eligible(dict(runner, steps_per_call=1), loader, trainer)


# --- the dispatch groups are the JAX loop's ------------------------------------


class _Loader:
    """What both epoch loops read of a device-cached loader: rows 0..n-1 in order."""

    def __init__(self, n, arrays):
        self.dataset = list(range(n))
        self.sampler = None
        self.batch_size = 1
        self.drop_last = True
        self.data_wrapper = namedtuple("Batch", ["x"])
        self._arrays = arrays

    def __len__(self):
        return len(self.dataset)


@pytest.mark.parametrize(
    "n,k,val_per_iter,profile_start,epoch",
    [(10, 3, None, None, 0), (10, 4, 4, None, 0), (7, 20, 3, 2, 0), (12, 5, 6, 0, 0), (9, 3, None, 4, 0),
     (6, 4, 4, None, 1), (5, 2, 2, 7, 0)],
)
def test_fused_dispatch_groups_match_the_jax_loop(tmp_path, monkeypatch, n, k, val_per_iter, profile_start, epoch):
    config = dict(steps_per_call=k, val_per_iter=val_per_iter, print_per_iter=4, profile_num_iters=3)
    if profile_start is not None:
        config.update(profile_dir=str(tmp_path / "trace"), profile_start_iter=profile_start)
    monkeypatch.setattr(jax.profiler, "start_trace", lambda *a, **kw: None)
    monkeypatch.setattr(jax.profiler, "stop_trace", lambda *a, **kw: None)

    jax_calls = []

    def jax_fused(state, arrays, idx, rng):
        jax_calls.append(("fused", np.asarray(idx)[:, 0].tolist()))
        return state, {"objective": jnp.zeros(idx.shape, jnp.float32)}

    def jax_vis(state, batch, rng):
        jax_calls.append(("vis", np.asarray(batch["x"]).tolist()))
        return state, {"objective": jnp.zeros((1,), jnp.float32)}

    jax_apis._train_one_epoch_fused(JaxRunType.TRAIN, config, epoch, None, _Loader(n, (jnp.arange(n),)), jax_fused,
                                    jax.random.PRNGKey(0), train_step_vis=jax_vis)

    calls = []

    class Fused:
        seen_group_sizes = set()

        def __call__(self, state, arrays, idx):
            calls.append(("fused", idx[:, 0].tolist()))
            return {"objective": torch.zeros(idx.shape)}

    def vis(state, batch):
        calls.append(("vis", batch["x"].tolist()))
        return {"objective": torch.zeros(1)}

    state = SimpleNamespace(pipeline=SimpleNamespace(device=torch.device("cpu")), step=0)
    apis._train_one_epoch_fused(RunType.TRAIN, config, epoch, state, _Loader(n, (torch.arange(n),)), Fused(),
                                train_step_vis=vis)
    assert calls == jax_calls
    assert sum(len(rows) for kind, rows in calls) == n


# --- three fused steps against make_train_step_fused ---------------------------


def test_fused_dispatch_matches_jax_make_train_step_fused(monkeypatch):
    cfg = proposal_cfg()
    runner = dict(RUNNER, steps_per_call=3)
    rng_np = np.random.RandomState(7)
    poses = np.stack([orbit_pose(30.0 + 40 * i, -30.0, 2.0) @ CAM_CALIBRATION for i in range(3)]).astype(np.float32)
    focal = np.full((3, 1), 10.0, np.float32)
    images = rng_np.rand(3, HW, HW, 3).astype(np.float32)
    idx = np.array([[2], [0], [1]])
    wrapper = namedtuple("Batch", ["poses", "focal_lengths", "image_rgb"])

    jax_pipeline = JAX_PIPELINES.build(dict(cfg))
    params = jax_pipeline.init(jax.random.PRNGKey(1))
    # every ray carries mass: on a ray whose densities are all the 1e-6 bias, 1 - exp(-x) cancels and the
    # two libraries' exp put the refined depths ~1e-3 apart (ROADMAP.md Queue 3, "Noted, not faults")
    for fn in params["implicit_functions"]:
        fn["density_layer"]["b"] = fn["density_layer"]["b"] + 1.0
    tx = jax_optim.create_optimizer(runner, params)
    rng = jax.random.PRNGKey(11)
    jax_arrays = (jnp.asarray(poses), jnp.asarray(focal), jnp.asarray(images))

    # each step's draws and gradients, eagerly, on the per-step JAX trajectory
    step = jax_apis.make_train_step(jax_pipeline, tx, donate=False)
    state = jax_optim.create_train_state(params, tx)
    draws, grads, per_step_params = [], [], []
    for k in range(3):
        batch = {key: a[idx[k]] for key, a in zip(wrapper._fields, jax_arrays)}

        def loss_fn(p, batch=batch, k=k):
            preds = jax_pipeline.forward(p, jax.random.fold_in(rng, k), evaluation_mode=JaxEvaluationMode.TRAINING,
                                         output_rasterized_mc=False, **batch)
            return jnp.mean(preds["objective"])

        per_step_params.append(flatten_tree(jax.tree_util.tree_map(np.asarray, state.params)))
        with monkeypatch.context() as m:
            draws.append(_capture_draws(m))
            grads.append(flatten_tree(jax.tree_util.tree_map(np.asarray, jax.grad(loss_fn)(state.params))))
        state, _ = step(state, batch, rng)

    fused = jax_apis.make_train_step_fused(jax_pipeline, tx, wrapper, donate=False)
    ref_state, ref_hist = fused(jax_optim.create_train_state(params, tx), jax_arrays, jnp.asarray(idx), rng)
    ref_params = flatten_tree(jax.tree_util.tree_map(np.asarray, ref_state.params))

    pipeline = PIPELINES.build(dict(cfg), device="cpu")
    load_jax_params(pipeline, jax.tree_util.tree_map(np.asarray, params))
    port = TrainState(pipeline=pipeline, optimizer=create_optimizer(runner, pipeline), step=0)

    def fed_draws(pipeline, batch_size, seed, step, out=None):
        for key, value in draws[step].items():
            targets = out[key] if isinstance(out[key], list) else [out[key]]
            for target, v in zip(targets, value if isinstance(value, list) else [value]):
                target.copy_(v)
        return out

    monkeypatch.setattr(apis, "make_step_draws", fed_draws)
    trainer = make_train_step_fused(pipeline, runner, 0, wrapper)
    hist = trainer(port, tuple(torch.from_numpy(a) for a in (poses, focal, images)), idx)
    assert port.step == 3 and trainer.dispatches == 1
    np.testing.assert_allclose(hist["objective"].numpy(), np.asarray(ref_hist["objective"]), rtol=1e-5, atol=1e-5)
    for key in ("loss_rgb_mse", "loss_proposal"):
        np.testing.assert_allclose(hist[key].numpy(), np.asarray(ref_hist[key]), rtol=1e-5, atol=1e-6, err_msg=key)
    lrs = [float(g["init_lr"]) for g in port.optimizer.param_groups]
    for key, p in pipeline.named_parameters():
        new, ref = p.detach().numpy(), ref_params[key]
        settled = np.all(
            [np.abs(g[key] + RUNNER["weight_decay"] * w[key]) > F32_GRAD_TOL["atol"] for g, w in zip(grads, per_step_params)],
            axis=0,
        )
        np.testing.assert_allclose(new[settled], ref[settled], err_msg=key, **F32_GRAD_TOL)
        lr = lrs[0 if key.startswith("implicit_functions.0") else -1]
        assert np.all(np.abs(new - ref) <= 2.0 * 3 * lr * (1 + 1e-5)), key


# --- the packed weights are rewritten in place ---------------------------------


@pytest.mark.parametrize("compute_dtype", ["bfloat16", "float32"])
def test_repack_in_place_keeps_the_address_and_equals_a_fresh_pack(compute_dtype):
    model = MODELS.build(dict(type="NeRFMLP", n_layers=3, input_skips=[2], n_harmonic_functions_xyz=3,
                              n_harmonic_functions_dir=2, n_hidden_neurons_xyz=32, n_hidden_neurons_dir=16,
                              compute_dtype=compute_dtype, nerf_paper_v1=True))
    packed = model.packed_weights()
    flat_ptr, bias_ptr = packed.flat.data_ptr(), packed.biases_flat.data_ptr()
    with torch.no_grad():
        for p in model.parameters():
            p.add_(torch.randn(p.shape, generator=torch.Generator().manual_seed(p.numel())))
    again = model.packed_weights()
    assert again is packed and again.flat.data_ptr() == flat_ptr and again.biases_flat.data_ptr() == bias_ptr
    fresh = K1.pack_weights(model)
    assert torch.equal(again.flat, fresh.flat) and torch.equal(again.biases_flat, fresh.biases_flat)
    # a write through .data bumps no _version (as a graph replay): params_changed() repacks
    model.density_layer.b.data.add_(1.0)
    assert not torch.equal(model.packed_weights().biases_flat, K1.pack_weights(model).biases_flat)
    model.params_changed()
    assert torch.equal(model.packed_weights().biases_flat, K1.pack_weights(model).biases_flat)
    model.density_layer.b.data.add_(1.0)
    assert torch.equal(model.packed_weights(refresh=True).biases_flat, K1.pack_weights(model).biases_flat)
    assert model.packed_weights().flat.data_ptr() == flat_ptr


# --- launch counts under capture; the draw spec decides every TRAINING draw ----


def test_a_capture_outside_capturing_raises(monkeypatch):
    """A kernel captured into a graph outside ``launch_count.capturing`` raises instead of going uncounted."""
    before = K1.launches
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    with pytest.raises(RuntimeError, match="capturing"):
        launch_count.count(K1, "launches")
    with launch_count.capturing() as tally:
        launch_count.count(K1, "launches")
        launch_count.count(K1, "launches")
    assert K1.launches == before and launch_count.per_replay(tally) == {"nerf_mlp_fwd.launches": 2}
    launch_count.replayed(tally)
    assert K1.launches == before + 2


def test_training_draws_come_from_the_spec_alone(monkeypatch):
    """A TRAINING call with a generator makes ``training_draws`` (the train step's draws); a draw the spec
    does not list, or a call with neither draws nor a generator, raises."""
    pipeline = PIPELINES.build(proposal_cfg(), generator=torch.Generator().manual_seed(4), device="cpu")
    pose = torch.as_tensor(orbit_pose(30.0, -30.0, 2.0) @ CAM_CALIBRATION, dtype=torch.float32)[None]
    batch = dict(poses=pose, focal_lengths=torch.tensor([[10.0]]),
                 image_rgb=torch.rand(1, HW, HW, 3, generator=torch.Generator().manual_seed(5)))
    training = EvaluationMode.TRAINING
    with torch.no_grad():
        from_generator = pipeline(evaluation_mode=training, generator=apis.step_generator("cpu", 7, 3), **batch)
        from_draws = pipeline(evaluation_mode=training, draws=apis.make_step_draws(pipeline, 1, 7, 3), **batch)
        assert torch.equal(from_generator["objective"], from_draws["objective"])
        with pytest.raises(ValueError, match="generator"):
            pipeline(evaluation_mode=training, **batch)
        spec = pipeline.training_draws
        for key in ("pixel_idx", "strata_u", "pdf_u"):
            monkeypatch.setattr(pipeline, "training_draws", lambda b, key=key: [d for d in spec(b) if d.key != key])
            with pytest.raises(ValueError, match="generator"):
                pipeline(evaluation_mode=training, generator=torch.Generator().manual_seed(0), **batch)
