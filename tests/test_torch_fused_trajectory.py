"""The fused NeRF-MLP path over several optimizer steps, and its split arms.

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

Then the split arms of ``fused_mlp.ARMS`` against the whole Function and
the eager model, bit for bit on the CPU, and ``trajectory.py`` at a tiny
size.
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
from yanerf_tpu_torch.ops.kernels.fused_mlp import ARMS, fused_nerf_mlp

CFG_DIR = osp.join(osp.dirname(__file__), "configs")
N_RAYS, N_PTS, STEPS, LR = 16, 8, 5, 5e-4
F32_TOL = 1e-4
BF16_KERNEL_TOL = 2e-3
BF16_EAGER_TOL = 0.1
NARROW = {"n_layers": 3, "input_skips": [2], "n_hidden_neurons_xyz": 32, "n_hidden_neurons_dir": 16}


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


def _arm_grads(model, pts, dirs, g, arm):
    model.zero_grad(set_to_none=True)
    out = model.eager_flat(pts, dirs, N_PTS) if arm == "eager" else fused_nerf_mlp(model, pts, dirs, N_PTS, arm)
    (out * g).sum().backward()
    return out.detach(), [p.grad.clone() for p in model.parameters()]


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_split_arms_are_one_kernel_and_the_eager_models_other_half(compute_dtype):
    model = MODELS.build(dict(_small_cfg(), compute_dtype=compute_dtype, use_pallas=True),
                         generator=torch.Generator().manual_seed(0))
    rng = np.random.RandomState(3)
    pts = torch.from_numpy((rng.randn(N_RAYS * N_PTS, 3) * 1.5).astype(np.float32))
    dirs = torch.from_numpy(rng.randn(N_RAYS, 3).astype(np.float32))
    g = torch.from_numpy(rng.randn(N_RAYS * N_PTS, 4).astype(np.float32))
    got = {arm: _arm_grads(model, pts, dirs, g, arm) for arm in ("eager", *ARMS)}
    # "k1": K1's forward, the eager model's gradient
    assert torch.equal(got["k1"][0], got["k1k3"][0])
    assert all(torch.equal(a, b) for a, b in zip(got["k1"][1], got["eager"][1]))
    # "k3": the eager model's forward, K3's gradient
    assert torch.equal(got["k3"][0], got["eager"][0])
    assert all(torch.equal(a, b) for a, b in zip(got["k3"][1], got["k1k3"][1]))
    # eager_flat is the model's eager path on the kernel's inputs
    o = torch.zeros(1, N_RAYS, 3)
    lengths = torch.ones(1, N_RAYS, N_PTS)
    direct = model(o, dirs[None], lengths, use_pallas=False)
    flat = model.eager_flat(torch.zeros(N_RAYS * N_PTS, 3) + dirs.repeat_interleave(N_PTS, 0), dirs, N_PTS)
    np.testing.assert_allclose(flat[:, :1].detach().numpy(), direct["rays_densities"].reshape(-1, 1).detach().numpy(),
                               rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="unknown kernel arm"):
        fused_nerf_mlp(model, pts, dirs, N_PTS, "k2")


def test_trajectory_runs_every_arm_from_one_init_on_the_fused_dispatch(tmp_path):
    from yanerf_tpu_torch import trajectory
    from yanerf_tpu_torch.synth_scene import write_scene

    scene = write_scene(tmp_path / "scene", hw=16, n_train=3, n_val=1, n_test=1, n_spheres=3, seed=1)
    cfg = trajectory.flagship_config()
    cfg.merge_from_dict({
        "pipeline.ray_sampler.image_height": 16, "pipeline.ray_sampler.image_width": 16,
        "pipeline.ray_sampler.n_rays_per_image_sampled_from_mask": 16,
        "pipeline.model.2.compute_dtype": "float32", **{f"pipeline.model.2.{k}": v for k, v in NARROW.items()},
        **{f"pipeline.model.{i}.{k}": v for i in (0, 1) for k, v in (("n_layers", 2), ("hidden_dim", 16))}})
    assert trajectory.dispatch_groups(45, (10, 100), 20) == [1, 9, 20, 15]
    record = trajectory.trajectory(cfg, scene, 6, "cpu", checkpoints=(2, 4))
    assert record["checkpoints"] == [2, 4] and set(record["summary"]) == set(trajectory.ARMS)
    names = set(record["per_tensor"]["k1k3"])
    assert {"m0.density_layer.b", "m0.xyz_encoder.mlp.2.w[embedding rows]", "m0.color_layer.0.w[direction rows]"} <= names
    for arm in ("k1k3", "k1", "k3", "eager_ulp"):
        row = record["per_tensor"][arm]["m0.density_layer.w"]
        assert set(row) == {"grad_cosine", "grad_rel_err", "grad_rel_err_f32", "sign_agreement", "rel_update_2",
                            "rel_norm_2", "rel_update_4", "rel_norm_4", "rel_update_6", "rel_norm_6"}
        assert len(record["mse"][arm]) == 6 and all(np.isfinite(record["mse"][arm]))
    # in float32 every arm's step-0 gradient is the eager one up to sums in another order (measured 7e-6)
    for arm in ("k1k3", "k1", "k3"):
        assert all(row["grad_rel_err"] <= 1e-4 for row in record["per_tensor"][arm].values()), arm
    # the float32 config's gradients are the float32 ones
    assert all(row["grad_rel_err_f32"] <= 1e-4 for row in record["per_tensor"]["eager"].values())
    # the ulp control starts one float32 ulp away: its step-0 gradient barely moves
    assert all(row["grad_cosine"] > 0.99999 for row in record["per_tensor"]["eager_ulp"].values())


def test_chip_smoke_trajectory_phase_runs_on_the_cpu(tmp_path, monkeypatch):
    """chip_smoke.py's "trajectory" phase at a tiny size (the CPU's plain versions launch nothing)."""
    import chip_smoke
    from yanerf_tpu_torch.ops.kernels import nerf_mlp_bwd as K3
    from yanerf_tpu_torch.ops.kernels import nerf_mlp_fwd as K1
    from yanerf_tpu_torch.synth_scene import write_scene
    from yanerf_tpu_torch.utils import Config

    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")
    scene = write_scene(tmp_path / "scene", hw=16, n_train=3, n_val=1, n_test=1, n_spheres=3, seed=1)
    cfg = Config.fromfile(str(chip_smoke.CONFIG))
    cfg.merge_from_dict({
        "pipeline.ray_sampler.image_height": 16, "pipeline.ray_sampler.image_width": 16,
        "pipeline.ray_sampler.n_rays_per_image_sampled_from_mask": 16,
        **{f"pipeline.model.2.{k}": v for k, v in NARROW.items()},
        **{f"pipeline.model.{i}.{k}": v for i in (0, 1) for k, v in (("n_layers", 2), ("hidden_dim", 16))}})
    cfg.dump(str(tmp_path / "flagship.yml"))
    paths = chip_smoke.trajectory_phase(torch, K1, K3, "cpu", scene, steps=3, config=tmp_path / "flagship.yml")
    assert paths == {"trajectory_train_fused": {"nerf_mlp_fwd": 0, "nerf_mlp_fwd_pipelined": 0, "nerf_mlp_bwd": 0}}
