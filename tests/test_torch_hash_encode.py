"""The hash encoding's plain path against the benchmark's plain reference, and its kernels (K4, K5) on a card.

On the CPU (no JAX is imported: the plain path is held to the JAX package
in tests/test_torch_hash_grid.py):
  * the model's plain encoding against ``h100bench/reference/hash_grid.py``
    (written from the paper, independent of the port) at a small size with
    dense and hashed levels, points outside the box, and a table so small
    that most hashed rows collide: features at atol 1e-6 (both sum 8
    float32 products, in other orders), every table's gradient at 1e-6 of
    its largest entry (float32 sums of up to a thousand terms, with
    cancellation, in other orders; the plain path's on one thread, where
    its sum order is the same in every run);
  * the whole model's forward against the reference's at rtol / atol 1e-5;
  * the device rule: the kernels take the shipped widths and not more than 16
    levels, 4 features a level or a hashed table of other than a power-of-two
    rows; CPU points take the plain path in every case, and the config keys
    ``use_pallas`` / ``use_pallas_train`` select nothing; the operators
    refuse CPU tensors, a kernel that cannot be built raises, and points
    that ask for a gradient raise; the launch check refuses the widths the
    kernels do not take; the fake implementations' shapes;
    ``launch_count.totals`` lists K4 / K5 beside the NeRF-MLP kernels,
    whether they launched yet or not.

On the card (marked ``cuda``, skipped without one):
  * K4 against the plain forward, atol 4e-6 times the tables' largest entry:
    the same 8 products, summed in another order;
  * K5 against the exact sum (float64 of the same float32 products) at the
    rounding its docstring argues: 2^-24 relative for the final float32,
    plus half its step 2^-S per contribution to the row; the plain path's
    float32 sum held to the same exact sum at 1e-5 of the row's absolute
    sum;
  * K5 bit for bit on two runs, NaN everywhere on a cotangent that is not
    finite, nothing on zero cotangents;
  * K4 + K5 captured in one CUDA graph, replayed, bit for bit the eager pair,
    launches counted per replay;
  * the model on the kernels, as the device picks them, against the plain
    path, forward and every gradient; CUDA points of widths the kernels do
    not take raise, and never fall back to the plain path.
  * configs/nerf/lego_ngp.yml exported on the card records K4's operator,
    and a fresh process that imports only ``export.load_artifact`` loads
    the program and gives the direct frame.

    python -m pytest tests/test_torch_hash_encode.py -m cuda --noconftest
"""

import contextlib
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

import pytest
import torch

from h100bench.reference import hash_grid as reference
from yanerf_tpu_torch.models import MODELS
from yanerf_tpu_torch.ops.kernels import _build, hash_encode, launch_count

REPO = Path(__file__).resolve().parent.parent

# 4 levels at resolutions 4, 8, 16, 32: dense while (N + 1)^3 <= 2^10 (4 and 8), hashed above
SMALL = dict(type="HashGridNeRF", n_levels=4, table_size_log2=10, n_features_per_level=2, base_resolution=4,
             max_resolution=32, hidden_dim=16, geo_feature_dim=7, n_color_layers=2, n_harmonic_functions_dir=2,
             scene_bound=1.5)
# 2^6 rows: the hashed levels' 17^3 and 33^3 corners share 64 rows
COLLIDING = dict(SMALL, table_size_log2=6, base_resolution=2, max_resolution=32)
SHIPPED = dict(type="HashGridNeRF", n_levels=16, table_size_log2=19, n_features_per_level=2, base_resolution=16,
               max_resolution=2048, hidden_dim=64, geo_feature_dim=15, n_color_layers=2, n_harmonic_functions_dir=4,
               color_dim=3, scene_bound=1.5)


def _model(cfg, seed=0, **kw):
    return MODELS.build(dict(cfg, **kw, generator=torch.Generator().manual_seed(seed)))


def _points(n, seed, bound=1.5, device="cpu"):
    """``n`` points, a fifth of them outside the box in one coordinate; the first tenth close together."""
    gen = torch.Generator().manual_seed(seed)
    pts = (torch.rand(n, 3, generator=gen) * 2 - 1) * bound
    out = torch.rand(n, generator=gen) < 0.2
    axis = torch.randint(0, 3, (n,), generator=gen)
    pts[out, axis[out]] = torch.sign(pts[out, axis[out]]) * bound * (1.01 + torch.rand(int(out.sum()), generator=gen))
    pts[: n // 10] = pts[:1] + 0.01 * torch.rand(n // 10, 3, generator=gen)
    return pts.to(device)


def _random_tables(model, seed, scale=1.0):
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for t in model.tables:
            t.copy_((torch.rand(t.shape, generator=gen) * 2 - 1) * scale)


@contextlib.contextmanager
def _one_thread():
    """One CPU thread inside the block. The plain path's table gradient is ``index_put_(accumulate=True)``, which
    on the CPU adds in parallel above a few thousand rows: its float32 sums then take another order in every run
    (the colliding level's rows sum ~900 terms), so the gap to the reference would change from run to run."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


# -- the plain path against the reference ---------------------------------------------------------------------


@pytest.mark.parametrize("cfg", [SMALL, COLLIDING], ids=["dense_and_hashed", "colliding"])
def test_plain_encoding_and_its_gradient_follow_the_reference(cfg):
    model = _model(cfg)
    _random_tables(model, 1)
    assert reference.resolutions(cfg) == model.resolutions and reference.table_rows(cfg) == model.level_table_sizes
    dense = [model._is_dense(level) for level in range(model.n_levels)]
    assert any(dense) and not all(dense)
    pts = _points(3000, 2)
    tables = [t.detach().clone().requires_grad_(True) for t in model.tables]
    ref_tables = [t.detach().clone().requires_grad_(True) for t in model.tables]
    got, want = model.encode(tables, pts), reference.encode(cfg, ref_tables, pts)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
    cot = torch.randn(got.shape, generator=torch.Generator().manual_seed(3))
    with _one_thread():
        grads = torch.autograd.grad(got, tables, cot)
    ref_grads = torch.autograd.grad(want, ref_tables, cot)
    for level, (g, r) in enumerate(zip(grads, ref_grads)):
        torch.testing.assert_close(g, r, rtol=0, atol=1e-6 * float(r.abs().max()), msg=f"level {level}")
        assert int((r != 0).any(dim=1).sum()) > 0


def test_plain_model_follows_the_reference():
    model = _model(SMALL)
    _random_tables(model, 4, scale=0.5)
    gen = torch.Generator().manual_seed(5)
    origins, directions = torch.randn(2, 7, 3, generator=gen) * 0.2, torch.randn(2, 7, 3, generator=gen)
    lengths = torch.sort(torch.rand(2, 7, 9, generator=gen) * 2 + 0.5, dim=-1).values
    with torch.no_grad():
        out = model(origins, directions, lengths)
    params = {f"implicit_functions.0.{k}": v.detach() for k, v in model.named_parameters()}
    ref = reference.Model({"pipeline": {"model": [SMALL]}})
    points = origins[..., None, :] + lengths[..., :, None] * directions[..., None, :]
    density, color = ref.nerf(params, 0, points, directions)
    torch.testing.assert_close(out["rays_densities"], density, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(out["rays_features"], color, rtol=1e-5, atol=1e-5)


# -- the device rule and the operators off the card ----------------------------------------------------------------


def test_the_switch_on_the_cpu_takes_the_plain_path():
    """``use_pallas`` / ``use_pallas_train`` are still accepted and select nothing: with them the model gives the
    plain path's outputs and table gradients bit for bit."""
    model, plain = _model(SMALL, use_pallas=True, use_pallas_train=True), _model(SMALL)
    assert not hasattr(model, "use_pallas") and not hasattr(model, "use_pallas_train")
    o, d = torch.randn(1, 5, 3), torch.randn(1, 5, 3)
    lengths = torch.sort(torch.rand(1, 5, 6) * 3 + 1, dim=-1).values
    on, off = model(o, d, lengths), plain(o, d, lengths)
    for key in ("rays_densities", "rays_features"):
        assert torch.equal(on[key], off[key])
    grads_on = torch.autograd.grad(on["rays_features"].sum(), list(model.tables))
    grads_off = torch.autograd.grad(off["rays_features"].sum(), list(plain.tables))
    assert all(torch.equal(a, b) for a, b in zip(grads_on, grads_off))


REFUSED = [(dict(SMALL, n_levels=17), None), (dict(SMALL, n_features_per_level=4), None), (SMALL, 1000)]
REFUSED_IDS = ["17_levels", "4_features", "hashed_table_of_1000_rows"]


def _tables(model, hashed_rows):
    """The model's tables, each hashed level's cut to ``hashed_rows`` rows where that is given."""
    return [t if hashed_rows is None or model._is_dense(level) else t[:hashed_rows]
            for level, t in enumerate(model.tables)]


@pytest.mark.parametrize("cfg,hashed_rows,takes", [
    (SHIPPED, None, True), (SMALL, None, True), (COLLIDING, None, True), *[(*case, False) for case in REFUSED],
], ids=["shipped", "dense_and_hashed", "colliding", *REFUSED_IDS])
def test_the_device_picks_the_encoding(cfg, hashed_rows, takes, monkeypatch):
    """``takes_widths`` holds for the shipped widths, and not for more than 16 levels, 4 features a level or a hashed
    table whose rows are not a power of two (the launch check refuses those on the card). On CPU points every case
    runs the plain path."""
    model = _model(cfg)
    sizes = [t.shape[0] for t in _tables(model, hashed_rows)]
    assert hash_encode.takes_widths(model.resolutions, sizes, model.n_features_per_level) is takes

    def kernels(*args, **kwargs):
        raise AssertionError("K4 ran on CPU points")

    monkeypatch.setattr(hash_encode, "hash_encode", kernels)
    o, d = torch.randn(1, 4, 3), torch.randn(1, 4, 3)
    lengths = torch.sort(torch.rand(1, 4, 5) * 3 + 1, dim=-1).values
    out = model(o, d, lengths)
    grads = torch.autograd.grad(out["rays_features"].sum(), list(model.tables))
    assert out["rays_features"].shape == (1, 4, 5, 3) and all(bool(torch.isfinite(g).all()) for g in grads)


def test_the_kernels_raise_where_they_cannot_run(monkeypatch, tmp_path):
    model = _model(SMALL)
    pts = _points(10, 0)
    tables = list(model.tables)
    with pytest.raises(ValueError, match="CUDA tensors"):
        hash_encode.hash_encode(pts, tables, model.resolutions, model.scene_bound)
    with pytest.raises(ValueError, match="no gradient for the points"):
        hash_encode.hash_encode(pts.requires_grad_(True), tables, model.resolutions, model.scene_bound)

    def no_nvcc():
        raise RuntimeError("nvcc was not found: the CUDA kernels cannot be built")

    monkeypatch.setattr(_build, "_nvcc", no_nvcc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(hash_encode, "LIBRARY", _build.CudaLibrary("hash_encode.cu", hash_encode._bind))
    with pytest.raises(RuntimeError, match="nvcc"):
        hash_encode._fwd_cuda(pts.detach(), tables, model.resolutions, model.scene_bound)
    with pytest.raises(RuntimeError, match="nvcc"):
        hash_encode._bwd_cuda(pts.detach(), torch.zeros(10, 8), model.resolutions, model.level_table_sizes,
                              model.scene_bound)


def test_fake_implementations_give_the_shapes():
    from torch._subclasses.fake_tensor import FakeTensorMode

    model = _model(SMALL)
    real = [t.detach() for t in model.tables]
    with FakeTensorMode() as mode:
        pts = mode.from_tensor(torch.zeros(37, 3))
        tables = [mode.from_tensor(t) for t in real]
        out = torch.ops.yanerf_tpu_torch.hash_encode_fwd(pts, tables, model.resolutions, 1.5)
        grad = torch.ops.yanerf_tpu_torch.hash_encode_bwd(pts, out, model.resolutions, model.level_table_sizes, 1.5)
    assert tuple(out.shape) == (37, 8) and out.dtype == torch.float32
    assert tuple(grad.shape) == (sum(model.level_table_sizes), 2)


def test_launch_totals_list_the_hash_kernels_once_they_launched(monkeypatch):
    every = {"nerf_mlp_fwd", "nerf_mlp_fwd_pipelined", "nerf_mlp_bwd", "hash_encode_fwd", "hash_encode_bwd",
             "sample_pdf", "proposal_mlp_fwd"}
    monkeypatch.setattr(hash_encode, "launches", 0)
    monkeypatch.setattr(hash_encode, "bwd_launches", 0)
    totals = launch_count.totals()
    assert set(totals) == every and totals["hash_encode_fwd"] == totals["hash_encode_bwd"] == 0
    monkeypatch.setattr(hash_encode, "launches", 3)
    totals = launch_count.totals()
    assert set(totals) == every and totals["hash_encode_fwd"] == 3 and totals["hash_encode_bwd"] == 0


# -- on the card ----------------------------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    hash_encode.LIBRARY.load()
    return torch.device("cuda")


def _card_model(cfg, device, seed=0, scale=1.0):
    model = _model(cfg, seed).to(device)
    _random_tables(model, seed + 1, scale)
    return model


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 31, 33, 100_003])
def test_k4_against_the_plain_forward(cuda_device, n):
    model = _card_model(SHIPPED, cuda_device)
    pts = _points(n, n, device=cuda_device)
    got = hash_encode.hash_encode(pts, list(model.tables), model.resolutions, model.scene_bound)
    with torch.no_grad():
        want = model.encode(list(model.tables), pts)
    torch.testing.assert_close(got, want, rtol=0, atol=4e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("cfg", [SHIPPED, COLLIDING], ids=["shipped", "colliding"])
def test_k5_against_the_exact_sum_and_the_plain_backward(cuda_device, cfg):
    import chip_smoke

    model = _card_model(cfg, cuda_device)
    n = 200_000
    pts = _points(n, 7, device=cuda_device)
    cot = torch.randn(n, 2 * model.n_levels, generator=torch.Generator().manual_seed(8)).to(cuda_device) * 1e-3
    tables = list(model.tables)
    enc = hash_encode.hash_encode(pts, tables, model.resolutions, model.scene_bound)
    got = torch.autograd.grad(enc, tables, cot)
    plain = torch.autograd.grad(model.encode(tables, pts), tables, cot)
    g_max = float(cot.abs().max())
    step = 2.0 ** (math.frexp(g_max)[1] + math.ceil(math.log2(n)) - 61)  # 2^-S of csrc/hash_encode.cu
    for level in range(model.n_levels):
        rows, w = chip_smoke.hash_corners(torch, model, pts, level)
        g = cot[:, 2 * level:2 * level + 2]
        terms = (w[..., None] * g[:, None, :]).reshape(-1, 2)  # float32 products, as both paths form them
        flat = rows.reshape(-1)
        exact = torch.zeros(tables[level].shape, dtype=torch.float64, device=cuda_device)
        exact.index_add_(0, flat, terms.double())
        absum = torch.zeros_like(exact).index_add_(0, flat, terms.double().abs())
        count = torch.zeros_like(exact).index_add_(0, flat, torch.ones_like(terms, dtype=torch.float64))
        k5_err = (got[level].double() - exact).abs()
        assert bool((k5_err <= 2.0 ** -24 * exact.abs() + count * step / 2 + 1e-45).all()), f"level {level}"
        plain_err = (plain[level].double() - exact).abs()
        assert bool((plain_err <= 1e-5 * absum + 1e-45).all()), f"level {level}"


@pytest.mark.cuda
def test_k5_is_deterministic_and_loud_on_a_cotangent_that_is_not_finite(cuda_device):
    model = _card_model(SHIPPED, cuda_device)
    pts = _points(300_000, 9, device=cuda_device)
    cot = torch.randn(pts.shape[0], 32, generator=torch.Generator().manual_seed(10)).to(cuda_device)
    args = (model.resolutions, model.level_table_sizes, model.scene_bound)
    first = hash_encode.hash_encode_bwd_op(pts, cot, *args)
    second = hash_encode.hash_encode_bwd_op(pts, cot, *args)
    assert torch.equal(first, second) and bool(first.abs().sum() > 0)
    assert bool((hash_encode.hash_encode_bwd_op(pts, torch.zeros_like(cot), *args) == 0).all())
    cot[123, 5] = float("inf")
    assert bool(torch.isnan(hash_encode.hash_encode_bwd_op(pts, cot, *args)).all())


@pytest.mark.cuda
def test_k4_and_k5_in_a_captured_graph_equal_eager(cuda_device):
    model = _card_model(SHIPPED, cuda_device)
    pts = _points(50_000, 11, device=cuda_device)
    cot = torch.randn(pts.shape[0], 32, generator=torch.Generator().manual_seed(12)).to(cuda_device)
    tables = list(model.tables)

    def pair():  # nothing of the autograd graph outlives the call (its nodes would hold the eager stream)
        enc = hash_encode.hash_encode(pts, tables, model.resolutions, model.scene_bound)
        return enc.detach(), torch.autograd.grad(enc, tables, cot)

    eager_enc, eager_grads = pair()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        pair()  # warm-up off the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with launch_count.capturing() as tally:
        with torch.cuda.graph(graph):
            static_enc, static_grads = pair()
    assert launch_count.per_replay(tally) == {"hash_encode.launches": 1, "hash_encode.bwd_launches": 1}
    before = (hash_encode.launches, hash_encode.bwd_launches)
    for _ in range(2):
        graph.replay()
        launch_count.replayed(tally)
    torch.cuda.synchronize()
    assert (hash_encode.launches, hash_encode.bwd_launches) == (before[0] + 2, before[1] + 2)
    assert torch.equal(static_enc, eager_enc)
    assert all(torch.equal(a, b) for a, b in zip(static_grads, eager_grads))


@pytest.mark.cuda
def test_the_model_on_the_kernels_against_the_plain_path(cuda_device, monkeypatch):
    kernels = _card_model(SHIPPED, cuda_device, scale=0.5)
    plain = _card_model(SHIPPED, cuda_device, scale=0.5)
    gen = torch.Generator().manual_seed(13)
    o, d = (torch.randn(2, 300, 3, generator=gen) * 0.3).to(cuda_device), torch.randn(2, 300, 3, generator=gen).to(
        cuda_device)
    lengths = torch.sort(torch.rand(2, 300, 64, generator=gen) * 4 + 2, dim=-1).values.to(cuda_device)

    def forward_and_grads(model):
        out = model(o, d, lengths)
        return out, torch.autograd.grad(out["rays_features"].sum() + out["rays_densities"].sum(),
                                        list(model.parameters()))

    before = hash_encode.launches, hash_encode.bwd_launches
    on_kernels = forward_and_grads(kernels)
    assert (hash_encode.launches, hash_encode.bwd_launches) == (before[0] + 1, before[1] + 1)
    with monkeypatch.context() as patch:  # the plain side: the model's own plain encoding in the kernels' place
        patch.setattr(hash_encode, "hash_encode", lambda points, tables, resolutions, bound: plain.encode(tables,
                                                                                                           points))
        on_plain = forward_and_grads(plain)
    assert (hash_encode.launches, hash_encode.bwd_launches) == (before[0] + 1, before[1] + 1)
    outs, grads = zip(on_kernels, on_plain)
    for key in ("rays_densities", "rays_features"):
        torch.testing.assert_close(outs[0][key], outs[1][key], rtol=1e-5, atol=1e-5)
    for (name, _), a, b in zip(kernels.named_parameters(), *grads):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5 * float(b.abs().max()) + 1e-12, msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("cfg,hashed_rows", REFUSED, ids=REFUSED_IDS)
def test_widths_the_kernels_do_not_take_raise_on_the_card(cuda_device, cfg, hashed_rows, monkeypatch):
    """CUDA points always go to K4 / K5: for widths they do not take the launch check raises, and the plain path
    never runs in their place."""
    model = _card_model(cfg, cuda_device)

    def plain(*args, **kwargs):
        raise AssertionError("the plain encoding ran on CUDA points")

    monkeypatch.setattr(model, "encode", plain)
    pts = _points(100, 14, device=cuda_device)
    with pytest.raises(NotImplementedError, match="the kernels take"):
        hash_encode.hash_encode(pts, _tables(model, hashed_rows), model.resolutions, model.scene_bound)
    if hashed_rows is None:
        o, d = pts[None, :10], torch.randn(1, 10, 3, device=cuda_device)
        with pytest.raises(NotImplementedError, match="the kernels take"):
            model(o, d, torch.sort(torch.rand(1, 10, 5, device=cuda_device) * 3 + 1, dim=-1).values)


@pytest.mark.cuda
def test_an_exported_hash_grid_frame_loads_in_a_fresh_process(cuda_device, tmp_path):
    from yanerf_tpu_torch import export
    from yanerf_tpu_torch.utils import Config

    render, (_, w) = export.build_render_fn(Config.fromfile(str(REPO / "configs" / "nerf" / "lego_ngp.yml")),
                                            device=cuda_device)
    inputs = export.example_inputs(1, w, cuda_device)
    program = export.trace(render, inputs)
    assert [n for n in export.graph_nodes(program) if str(n.target).startswith("yanerf_tpu_torch.hash_encode_fwd")]
    torch.export.save(program, tmp_path / "ngp.pt2")
    with torch.inference_mode():
        direct = render(*inputs).cpu().numpy()
    np.save(tmp_path / "poses.npy", inputs[0].cpu().numpy())
    np.save(tmp_path / "focals.npy", inputs[1].cpu().numpy())
    consumer = f"""
import numpy as np
import torch
from yanerf_tpu_torch.export import load_artifact
render = load_artifact({str(tmp_path / 'ngp.pt2')!r})
poses, focals = (torch.from_numpy(np.load(f)).cuda() for f in ({str(tmp_path / 'poses.npy')!r}, {str(tmp_path / 'focals.npy')!r}))
with torch.inference_mode():
    np.save({str(tmp_path / 'restored.npy')!r}, render(poses, focals).cpu().numpy())
"""
    proc = subprocess.run([sys.executable, "-c", consumer], cwd=REPO, capture_output=True, text=True, timeout=600,
                          env=dict(os.environ, PYTHONPATH=str(REPO)))
    assert proc.returncode == 0, proc.stderr[-4000:]
    restored = np.load(tmp_path / "restored.npy")
    assert restored.shape == direct.shape and float(restored.std()) > 0.0
    np.testing.assert_allclose(restored, direct, rtol=0, atol=1e-6)
