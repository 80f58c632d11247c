"""K7, the ProposalMLP forward: its operator ``yanerf_tpu_torch::proposal_mlp_fwd``, its plain version, the
weight pack and the model's choice of path.

On the CPU:
  * the plain version (K7's arithmetic) against the JAX package's
    ``ProposalMLP`` on the same weights and rays, at the shipped widths (4
    x 128, 10 frequencies, bf16; density biases +1, as the benchmark's
    weights set them), on world, contracted and latent (``latent_dim`` 16)
    points, at 1, 127, 129 and 130,880 points (the served call: 2,045 rays
    x 64). Against the JAX model in float32 every density lies within
    ``JAX_ATOL``: four bf16 ulps (2^-8) at the densities' scale (~1.6),
    room for the bf16 roundings of the embedding and of each layer's
    output, each up to half an ulp, carried through four layers (the worst
    reading is 6.9e-3). And K7's arithmetic is the closer of the two bf16
    versions: its RMS gap to float32 is at most the JAX bf16 model's
    (about half of it, measured), which rounds the products' sums and the
    bias adds to bf16 as well;
  * ``takes_widths``, the one predicate of the widths K7 takes, and the
    refusals by name of ``pack_weights`` and of the operator;
  * the operator's CPU kernel is the plain version (``opcheck``, bit for
    bit), its fake gives the shape;
  * the pack follows the weights: after an Adam step, a ``load_state_dict``
    and a write behind ``_version``'s back announced by ``params_changed``
    it holds a fresh pack's bits at the same addresses; a pack made under
    inference mode is rewritten by a train step;
  * CPU points run the model's own layers, whatever the dtype and grad
    mode; ``launch_count.totals`` lists K7.

On the card (marked ``cuda``, skipped without one; nothing of JAX is
imported for them):
  * K7 against the plain version on the same card at the ragged counts and
    the served shape, world, contracted and latent points, within K1's
    tolerance (the two sum the products in other orders, which can move a
    bf16 rounding of an activation), through the model's forward under no
    grad (which must launch K7 once) and through the operator;
  * K7 bit for bit on two launches, and captured in a CUDA graph and
    replayed, counted once per replay;
  * the device rule: a float32 model and a forward under autograd run the
    model's layers (no launch), widths K7 does not take raise by name;
  * ``configs/nerf/lego_proposal.yml`` exported on the card records K7's
    operator, and a fresh process that imports only ``export.load_artifact``
    loads it and renders the same frame.

    python -m pytest tests/test_torch_proposal_mlp_kernel.py -m cuda --noconftest
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from yanerf_tpu_torch.models import MODELS
from yanerf_tpu_torch.ops.harmonics import harmonic_embedding_dim
from yanerf_tpu_torch.ops.kernels import launch_count
from yanerf_tpu_torch.ops.kernels import proposal_mlp_fwd as K7

REPO = Path(__file__).resolve().parents[1]
SHIPPED = dict(type="ProposalMLP", n_layers=4, hidden_dim=128, n_harmonic_functions_xyz=10)
KINDS = {"world": {}, "contracted": dict(contract_coords=True), "latent": dict(latent_dim=16)}
# points -> (batch elements, rays, points a ray): ragged tiles, and the served call (2,045 rays x 64)
COUNTS = {1: (1, 1, 1), 127: (1, 127, 1), 129: (3, 43, 1), 130880: (1, 2045, 64)}
LATENT_SERVED = (5, 409, 64)  # 130,880 points over five scenes
JAX_ATOL = 4 * 2.0**-8 * 1.6
K1_TOL = dict(rtol=1e-2, atol=1e-2)  # tests/test_torch_cuda_kernels.py's, K1 against its plain version


@pytest.fixture
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rays(kind, n, seed=0):
    """Rays of a scene at radius 4 looking inwards, depths in [2, 6] (an unbounded scene's from radius 8, whose
    points the contraction folds), as numpy arrays; with the codes of a latent batch."""
    batch, rays, pts = LATENT_SERVED if kind == "latent" and n == 130880 else COUNTS[n]
    rng = np.random.RandomState(seed + n)
    theta, phi = rng.uniform(0, 2 * np.pi, (batch, rays, 1, 1)), rng.uniform(-1.2, 0.2, (batch, rays, 1, 1))
    unit = np.concatenate([np.cos(theta) * np.cos(phi), np.sin(theta) * np.cos(phi), -np.sin(phi)], axis=-1)
    origins = (unit * (8.0 if kind == "contracted" else 4.0)).astype(np.float32)
    directions = (-unit + 0.2 * rng.randn(batch, rays, 1, 3)).astype(np.float32)
    lengths = np.sort(rng.uniform(2.0, 6.0, (batch, rays, 1, pts)), axis=-1).astype(np.float32)
    codes = rng.randn(batch, 16).astype(np.float32) if kind == "latent" else None
    return origins, directions, lengths, codes


def _model(kind, compute_dtype="bfloat16", seed=0, **widths):
    model = MODELS.build(dict(SHIPPED, compute_dtype=compute_dtype, **KINDS[kind], **widths,
                              generator=torch.Generator().manual_seed(seed)))
    with torch.no_grad():
        model.density_layer.b.add_(1.0)
    return model


def _k7_inputs(model, rays, device="cpu"):
    """The points the model's forward hands K7, ``(n, 3)``, and the codes."""
    origins, directions, lengths, codes = (None if x is None else torch.from_numpy(x).to(device) for x in rays)
    return model._points(origins, directions, lengths).reshape(-1, 3).contiguous(), codes


@pytest.mark.parametrize("n", sorted(COUNTS))
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_the_plain_version_against_the_jax_package(one_thread, kind, n):
    import jax
    import jax.numpy as jnp

    from yanerf_tpu.models import MODELS as JAX_MODELS
    from yanerf_tpu_torch.convert import load_jax_params

    cfg = dict(SHIPPED, **KINDS[kind])
    f32, bf16 = (JAX_MODELS.build(dict(cfg, compute_dtype=dt)) for dt in ("float32", "bfloat16"))
    params = jax.tree_util.tree_map(np.asarray, f32.init(jax.random.PRNGKey(7)))
    params["density_layer"]["b"] = params["density_layer"]["b"] + 1.0
    model = load_jax_params(MODELS.build(dict(cfg, compute_dtype="bfloat16")), params)
    rays = _rays(kind, n)
    kwargs = {} if rays[3] is None else dict(global_codes=jnp.asarray(rays[3]))
    want, jax_bf16 = (np.asarray(m.apply(params, *map(jnp.asarray, rays[:3]), **kwargs)["rays_densities"]).reshape(-1)
                      for m in (f32, bf16))
    points, codes = _k7_inputs(model, rays)
    with torch.no_grad():
        got = K7.proposal_mlp_fwd(model.packed_weights(), points, codes).numpy().reshape(-1)
    assert got.shape == (n,) and np.isfinite(got).all()
    gap, jax_gap = np.abs(got - want), np.abs(jax_bf16 - want)
    print(f"{kind} {n}: K7's arithmetic max {gap.max():.3g} rms {np.sqrt(np.mean(gap**2)):.3g}; JAX bf16 max "
          f"{jax_gap.max():.3g} rms {np.sqrt(np.mean(jax_gap**2)):.3g}; scale {np.abs(want).max():.3g}")
    assert gap.max() <= JAX_ATOL
    if n > 1:  # one point is one sample of either gap
        assert np.sqrt(np.mean(gap**2)) <= np.sqrt(np.mean(jax_gap**2))


@pytest.mark.parametrize("widths, takes", [
    (dict(), True),  # every shipped ProposalMLP: 4 x 128, 10 frequencies and x
    (dict(n_layers=1), True),
    (dict(n_layers=6), True),
    (dict(n_harmonic_functions_xyz=4), True),
    (dict(harmonic_functions_xyz_append_intput=False), True),
    (dict(hidden_dim=64), False),
    (dict(hidden_dim=256), False),
    (dict(n_layers=7), False),
    (dict(n_layers=0), False),
    (dict(n_harmonic_functions_xyz=11), False),
], ids=lambda x: repr(x) if isinstance(x, dict) else str(x))
def test_the_widths_k7_takes(widths, takes):
    model = MODELS.build(dict(SHIPPED, compute_dtype="bfloat16", **widths))
    n_freq, append = model.n_harmonic_functions_xyz, model.harmonic_functions_xyz_append_intput
    assert K7.takes_widths(model.hidden_dim, model.n_layers, n_freq, append) is takes
    if takes:
        packed = K7.pack_weights(model)
        assert packed.flat.numel() == 128 * (64 * (2 * model.n_layers - 1) + 1)
        return
    with pytest.raises(NotImplementedError, match=f"got hidden_dim {model.hidden_dim}, {model.n_layers} layers and "
                                                  f"{harmonic_embedding_dim(3, n_freq, append)} embedding columns"):
        K7.pack_weights(model)
    if model.hidden_dim == K7.KERNEL_HIDDEN:  # the operator sees the depth and the embedding, not the width
        with pytest.raises(NotImplementedError, match="K7 takes 128-wide layers"):
            K7._check_cuda_inputs(torch.zeros(1, 3), torch.zeros(0), torch.zeros(0), torch.zeros(1, 128), 1,
                                  model.n_layers, n_freq, append)


@pytest.mark.parametrize("kind", ["world", "latent"])
def test_the_operator_on_the_cpu_is_the_plain_version(kind):
    model = _model(kind)
    points, codes = _k7_inputs(model, _rays(kind, 129))
    packed = model.packed_weights()
    first = K7.first_layer_bias(packed, codes)
    args = (points, packed.flat, packed.biases_flat, first, 129 // first.shape[0], *packed.layout)
    torch.library.opcheck(K7.proposal_mlp_fwd_op, args)
    got = K7.proposal_mlp_fwd(packed, points, codes)
    assert got.shape == (129, 1) and got.dtype == torch.float32
    assert torch.equal(got, K7.proposal_mlp_fwd_plain(*args))
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode() as mode:
        fake = K7.proposal_mlp_fwd_op(*(mode.from_tensor(a) if isinstance(a, torch.Tensor) else a for a in args))
    assert fake.shape == (129, 1) and fake.dtype == torch.float32


def _adam_step(model):
    opt = torch.optim.Adam(model.parameters(), lr=1e-2)
    o, d, l, _ = (torch.from_numpy(x) if x is not None else None for x in _rays("world", 127))
    model(o, d, l)["rays_densities"].square().mean().backward()
    opt.step()


def _load_state(model):
    other = _model("world", seed=5)
    model.load_state_dict(other.state_dict())


def _behind_version(model):
    for p in model.parameters():
        p.data.mul_(0.5)  # a write through .data bumps no _version, as a graph replay writes
    model.params_changed()


@pytest.mark.parametrize("change", [_adam_step, _load_state, _behind_version], ids=lambda f: f.__name__.strip("_"))
def test_the_pack_follows_the_weights(one_thread, change):
    model = _model("world")
    with torch.inference_mode():  # first packed while serving: the buffers are no inference tensors
        packed = model.packed_weights()
    addresses = (packed.flat.data_ptr(), packed.biases_flat.data_ptr())
    change(model)
    again = model.packed_weights()
    fresh = K7.pack_weights(model)
    assert (again.flat.data_ptr(), again.biases_flat.data_ptr()) == addresses
    assert torch.equal(again.flat, fresh.flat) and torch.equal(again.biases_flat, fresh.biases_flat)
    assert not torch.equal(again.biases_flat[:128], K7.pack_weights(_model("world")).biases_flat[:128])


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_cpu_points_run_the_model_layers(monkeypatch, compute_dtype):
    def refuse(*args, **kwargs):
        raise AssertionError("K7's operator was called on CPU points")

    monkeypatch.setattr(K7, "proposal_mlp_fwd_op", refuse)
    model = _model("world", compute_dtype)
    o, d, l, _ = (torch.from_numpy(x) if x is not None else None for x in _rays("world", 127))
    for grad in (False, True):
        with torch.set_grad_enabled(grad):
            assert not model.on_kernel(model._points(o, d, l))
            assert model(o, d, l)["rays_densities"].shape == (1, 127, 1, 1, 1)
    assert model._packed is None


def test_launch_totals_list_k7(monkeypatch):
    monkeypatch.setattr(K7, "launches", 0)
    assert launch_count.totals()["proposal_mlp_fwd"] == 0
    monkeypatch.setattr(K7, "launches", 626)
    assert launch_count.totals()["proposal_mlp_fwd"] == 626


# --- on the card ------------------------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n", sorted(COUNTS))
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_k7_against_the_plain_version_on_the_card(cuda_device, kind, n):
    model = _model(kind).to(cuda_device)
    rays = _rays(kind, n)
    points, codes = _k7_inputs(model, rays, cuda_device)
    o, d, l, _ = (None if x is None else torch.from_numpy(x).to(cuda_device) for x in rays)
    before = K7.launches
    with torch.no_grad():
        got = model(o, d, l, global_codes=codes)["rays_densities"].reshape(-1, 1)
        torch.cuda.synchronize()
        assert K7.launches == before + 1, "the model's forward launches K7 once"
        packed = model.packed_weights()
        first = K7.first_layer_bias(packed, codes)
        want = K7.proposal_mlp_fwd_plain(points, packed.flat, packed.biases_flat, first, n // first.shape[0],
                                         *packed.layout)
    assert bool(torch.isfinite(got).all())
    print(f"{kind} {n}: max |K7 - plain| {float((got - want).abs().max()):.3g}")
    torch.testing.assert_close(got, want, **K1_TOL)


@pytest.mark.cuda
def test_k7_is_deterministic_and_replays_in_a_captured_graph(cuda_device):
    model = _model("world").to(cuda_device)
    points, _ = _k7_inputs(model, _rays("world", 130880), cuda_device)
    packed = model.packed_weights()
    first = K7.proposal_mlp_fwd(packed, points)
    assert torch.equal(first, K7.proposal_mlp_fwd(packed, points))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with launch_count.capturing() as tally:
        with torch.cuda.graph(graph, stream=side):
            out = K7.proposal_mlp_fwd(packed, points)
    assert launch_count.per_replay(tally) == {"proposal_mlp_fwd.launches": 1}
    before = K7.launches
    for _ in range(3):
        out.zero_()
        graph.replay()
        launch_count.replayed(tally)
    torch.cuda.synchronize()
    assert K7.launches == before + 3
    assert torch.equal(out, first)


@pytest.mark.cuda
def test_the_device_rule_on_the_card(cuda_device):
    o, d, l, _ = (torch.from_numpy(x).to(cuda_device) if x is not None else None for x in _rays("world", 129))
    before = K7.launches
    float32 = _model("world", "float32").to(cuda_device)
    with torch.no_grad():
        float32(o, d, l)
    trained = _model("world").to(cuda_device)
    trained(o, d, l)["rays_densities"].sum().backward()  # under autograd: the model's layers
    torch.cuda.synchronize()
    assert K7.launches == before and trained._packed is None
    narrow = _model("world", hidden_dim=64).to(cuda_device)
    with torch.no_grad(), pytest.raises(NotImplementedError, match="got hidden_dim 64"):
        narrow(o, d, l)


@pytest.mark.cuda
def test_an_exported_proposal_frame_records_k7_and_loads_in_a_fresh_process(cuda_device, tmp_path):
    from yanerf_tpu_torch import export
    from yanerf_tpu_torch.utils import Config

    render, (_, w) = export.build_render_fn(Config.fromfile(str(REPO / "configs" / "nerf" / "lego_proposal.yml")),
                                            device=cuda_device)
    inputs = export.example_inputs(1, w, cuda_device)
    program = export.trace(render, inputs)
    nodes = [n for n in export.graph_nodes(program) if str(n.target).startswith("yanerf_tpu_torch.proposal_mlp_fwd")]
    assert len(nodes) == 2, "one K7 node for each ProposalMLP in the chunk body"
    torch.export.save(program, tmp_path / "proposal.pt2")
    with torch.inference_mode():
        direct = render(*inputs).cpu().numpy()
    np.save(tmp_path / "poses.npy", inputs[0].cpu().numpy())
    np.save(tmp_path / "focals.npy", inputs[1].cpu().numpy())
    consumer = f"""
import numpy as np
import torch
from yanerf_tpu_torch.export import load_artifact
from yanerf_tpu_torch.ops.kernels import proposal_mlp_fwd
render = load_artifact({str(tmp_path / 'proposal.pt2')!r})
poses, focals = (torch.from_numpy(np.load(f)).cuda() for f in ({str(tmp_path / 'poses.npy')!r}, {str(tmp_path / 'focals.npy')!r}))
with torch.inference_mode():
    np.save({str(tmp_path / 'restored.npy')!r}, render(poses, focals).cpu().numpy())
assert proposal_mlp_fwd.launches > 0, "the restored program ran no K7"
"""
    proc = subprocess.run([sys.executable, "-c", consumer], cwd=REPO, capture_output=True, text=True, timeout=600,
                          env=dict(os.environ, PYTHONPATH=str(REPO)))
    assert proc.returncode == 0, proc.stderr[-4000:]
    restored = np.load(tmp_path / "restored.npy")
    assert restored.shape == direct.shape and float(restored.std()) > 0.0
    np.testing.assert_allclose(restored, direct, rtol=0, atol=1e-6)
