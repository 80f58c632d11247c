"""The fused NeRF-MLP backward (K3): its plain version against the Pallas kernel, and the autograd.Function.

``nerf_mlp_bwd_plain`` repeats ``_nerf_mlp_bwd_kernel``'s arithmetic, so it
is held to ``nerf_mlp_backward_pallas`` in interpret mode on the same
points, directions and cotangents:
  * float32 at rtol 2e-4 / atol 2e-5, the tolerance tests/test_pallas.py
    holds the Pallas backward to XLA's gradients with;
  * bfloat16 at a per-tensor cosine >= 0.9999 and a max abs error within
    2% of the tensor's largest entry: both sides round the same values to
    bf16 at the same places, but float32 sums taken in another order can
    move a rounding of a hidden cotangent by one bf16 ulp (2^-8), and a
    weight gradient sums thousands of such products.
The ``torch.autograd.Function`` (port of ``make_fused_mlp``) gives the
parameter gradients ``jax.grad`` gives through ``make_fused_mlp``.

The CUDA kernel is held to the plain version on a card by
tests/test_torch_cuda_kernels.py.
"""

import os.path as osp

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yanerf_tpu.models import MODELS as JAX_MODELS
from yanerf_tpu.ops.pallas.nerf_mlp_bwd import make_fused_mlp, nerf_mlp_backward_pallas
from yanerf_tpu.utils import Config
from yanerf_tpu_torch.convert import flatten_tree, load_jax_params
from yanerf_tpu_torch.models import MODELS
from yanerf_tpu_torch.ops.kernels import nerf_mlp_bwd as K3
from yanerf_tpu_torch.ops.kernels import nerf_mlp_fwd as K1
from yanerf_tpu_torch.ops.kernels.fused_mlp import fused_nerf_mlp, kernel_order_params

CFG_DIR = osp.join(osp.dirname(__file__), "configs")
F32_TOL = dict(rtol=2e-4, atol=2e-5)
FLAGSHIP = dict(type="NeRFMLP")
MIN_COSINE = 0.9999
BF16_REL_ATOL = 2e-2


def _small_cfg():
    return dict(Config.fromfile(osp.join(CFG_DIR, "models/nerf_mlp.yml")).model)


def _pair(cfg, compute_dtype, seed=0):
    cfg = dict(cfg, compute_dtype=compute_dtype)
    jax_model = JAX_MODELS.build(dict(cfg))
    params = jax_model.init(jax.random.PRNGKey(seed))
    model = MODELS.build(dict(cfg, use_pallas=True))
    load_jax_params(model, jax.tree_util.tree_map(np.asarray, params))
    return jax_model, params, model


def _inputs(n_rays, n_pts, color_dim=3, seed=1):
    rng = np.random.RandomState(seed)
    pts = (rng.randn(1, n_rays, n_pts, 3) * 1.5).astype(np.float32)
    dirs = rng.randn(1, n_rays, 3).astype(np.float32)
    gd = rng.randn(1, n_rays, n_pts, 1).astype(np.float32)
    gc = rng.randn(1, n_rays, n_pts, color_dim).astype(np.float32)
    return pts, dirs, gd, gc


def _plain_grads(model, pts, dirs, gd, gc):
    """The plain version's gradients, cut back to the parameters' shapes, keyed like the JAX tree."""
    packed = model.packed_weights()
    n_pts = pts.shape[-2]
    g = torch.from_numpy(np.concatenate([gd, gc], axis=-1).reshape(-1, gd.shape[-1] + gc.shape[-1]))
    gw, gb = K3.nerf_mlp_bwd_plain(packed, torch.from_numpy(pts.reshape(-1, 3)), torch.from_numpy(dirs.reshape(-1, 3)), n_pts, g)
    ws, bs = K3.grad_views(packed, gw, gb)
    names = {id(p): k for k, p in model.named_parameters()}
    out = {}
    for i, (w, b) in enumerate(zip(ws, bs)):
        pw, pb = kernel_order_params(model)[2 * i : 2 * i + 2]
        out[names[id(pw)]] = K1.unpad_weight(model, i, w).numpy()
        out[names[id(pb)]] = b.numpy()
    return out, packed, ws


def _cosine(a, b):
    a, b = np.asarray(a, np.float64).ravel(), np.asarray(b, np.float64).ravel()
    return float(a @ b / max(np.linalg.norm(a) * np.linalg.norm(b), 1e-30))


def _assert_bf16_close(got, ref, key):
    assert _cosine(got, ref) >= MIN_COSINE, (key, _cosine(got, ref))
    np.testing.assert_allclose(got, ref, rtol=0.0, atol=BF16_REL_ATOL * float(np.abs(ref).max()) + 1e-30, err_msg=key)


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n_rays,n_pts,tile", [(4, 6, 8), (3, 5, 8), (16, 16, 64)])
def test_plain_matches_pallas_backward(compute_dtype, n_rays, n_pts, tile):
    """(3, 5) with tile 8 is the padded tail of tests/test_pallas.py: 15 points, one padded tile."""
    jax_model, params, model = _pair(_small_cfg(), compute_dtype)
    pts, dirs, gd, gc = _inputs(n_rays, n_pts)
    ref = nerf_mlp_backward_pallas(
        jax_model, params, jnp.asarray(pts), jnp.asarray(dirs), jnp.asarray(gd), jnp.asarray(gc), tile=tile, interpret=True
    )
    ref = flatten_tree(jax.tree_util.tree_map(np.asarray, ref))
    got, _, _ = _plain_grads(model, pts, dirs, gd, gc)
    assert set(got) == set(ref)
    for key in ref:
        assert got[key].shape == ref[key].shape, key
        if compute_dtype == "float32":
            np.testing.assert_allclose(got[key], ref[key], err_msg=key, **F32_TOL)
        else:
            _assert_bf16_close(got[key], ref[key], key)


def test_plain_at_flagship_widths_zeroes_the_padded_rows():
    """8x256 with the 63 -> 64 and 27 -> 32 padding: the padded rows of dW are exactly zero."""
    jax_model, params, model = _pair(FLAGSHIP, "bfloat16", seed=2)
    pts, dirs, gd, gc = _inputs(4, 16, seed=3)
    ref = nerf_mlp_backward_pallas(
        jax_model, params, jnp.asarray(pts), jnp.asarray(dirs), jnp.asarray(gd), jnp.asarray(gc), tile=64, interpret=True
    )
    ref = flatten_tree(jax.tree_util.tree_map(np.asarray, ref))
    got, packed, ws = _plain_grads(model, pts, dirs, gd, gc)
    for key in ref:
        _assert_bf16_close(got[key], ref[key], key)
    h = packed.hidden
    assert float(ws[0][63:].abs().max()) == 0.0
    assert float(ws[5][h + 63 :].abs().max()) == 0.0
    assert float(ws[packed.n_layers + 2][h + 27 :].abs().max()) == 0.0
    assert K3.flops_per_point(packed) == 3_521_280  # 3.52 MFLOP per point, the bound's numerator


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_autograd_function_matches_jax_grad_through_make_fused_mlp(compute_dtype):
    jax_model, params, model = _pair(_small_cfg(), compute_dtype)
    pts, dirs, gd, gc = _inputs(4, 6, seed=5)

    def loss(p):
        dens, cols = make_fused_mlp(jax_model)(p, jnp.asarray(pts), jnp.asarray(dirs))
        return jnp.sum(dens * gd) + jnp.sum(cols * gc)

    ref = flatten_tree(jax.tree_util.tree_map(np.asarray, jax.grad(loss)(params)))
    launches = (K1.launches, K3.launches)
    out = fused_nerf_mlp(model, torch.from_numpy(pts.reshape(-1, 3)), torch.from_numpy(dirs.reshape(-1, 3)), 6)
    (out[:, :1] * torch.from_numpy(gd.reshape(-1, 1))).sum().add((out[:, 1:] * torch.from_numpy(gc.reshape(-1, 3))).sum()).backward()
    assert (K1.launches, K3.launches) == launches, "CPU tensors take the plain versions, no launch"
    for key, p in model.named_parameters():
        assert p.grad is not None and tuple(p.grad.shape) == ref[key].shape, key
        if compute_dtype == "float32":
            np.testing.assert_allclose(p.grad.numpy(), ref[key], err_msg=key, **F32_TOL)
        else:
            _assert_bf16_close(p.grad.numpy(), ref[key], key)


def test_autograd_function_refuses_gradients_for_ray_geometry():
    model = MODELS.build(dict(_small_cfg(), use_pallas=True))
    pts = torch.zeros(6, 3, requires_grad=True)
    with pytest.raises(ValueError, match="ray geometry"):
        fused_nerf_mlp(model, pts, torch.ones(2, 3), 3)


def test_cuda_input_checks_of_the_backward():
    packed = MODELS.build(dict(FLAGSHIP, compute_dtype="bfloat16")).packed_weights()
    pts, dirs = torch.zeros(6, 3), torch.ones(3, 3)
    K3._check_bwd_inputs(packed, pts, dirs, 2, torch.zeros(6, 4))
    with pytest.raises(ValueError, match="g must be"):
        K3._check_bwd_inputs(packed, pts, dirs, 2, torch.zeros(6, 3))
    v1 = MODELS.build(dict(FLAGSHIP, compute_dtype="bfloat16", nerf_paper_v1=True)).packed_weights()
    K3._check_bwd_inputs(v1, pts, dirs, 2, torch.zeros(6, 4))  # two extra color layers: the kernel takes them
    v1_deep = MODELS.build(dict(FLAGSHIP, compute_dtype="bfloat16", n_layers=12, nerf_paper_v1=True)).packed_weights()
    with pytest.raises(NotImplementedError, match="extra color"):
        K3._check_bwd_inputs(v1_deep, pts, dirs, 2, torch.zeros(6, 4))
    assert K3.stash_widths(8) == (2560, 2432)
    assert K3.stash_widths(8, 2) == (2816, 2688)


@pytest.mark.parametrize(
    "cfg",
    [dict(FLAGSHIP), dict(FLAGSHIP, n_layers=2, input_skips=()), dict(FLAGSHIP, nerf_paper_v1=True)],
    ids=["8x256", "2x256", "8x256-paper-v1"],
)
def test_weight_grad_jobs_cover_every_gradient_once(cfg):
    """The weight-gradient pass's plan: every (tensor, row, column) of dW and every bias entry exactly once,
    each row from the stash column of its input feature, the cotangent columns inside the stash."""
    packed = MODELS.build(dict(cfg, compute_dtype="bfloat16")).packed_weights()
    nl, ne, h, hd = packed.n_layers, packed.n_extra_color, packed.hidden, packed.hidden_dir
    lda, ldg = K3.stash_widths(nl, ne)
    # the stash column of input row k of each tensor, from the layout stash_widths documents
    a_y = lambda li: 64 + h * li  # noqa: E731
    a_demb, a_cact = a_y(nl) + h, lambda e: a_y(nl) + h + 64 + hd * e  # noqa: E731

    def input_col(i, k):
        if i == 0:
            return k
        if i < nl:
            return a_y(i - 1) + k if k < h else k - h
        if i in (nl, nl + 1):
            return a_y(nl - 1) + k
        if i == nl + 2:
            return a_y(nl) + k if k < h else a_demb + k - h
        return a_cact(i - nl - 3) + k

    seen_w = {i: torch.zeros(tuple(w.shape), dtype=torch.int32) for i, w in enumerate(packed.weights)}
    seen_b = {i: torch.zeros(b.numel(), dtype=torch.int32) for i, b in enumerate(packed.biases)}
    jobs = K3.weight_grad_jobs(packed)
    assert len(jobs) <= 32  # MAX_JOBS of csrc/nerf_mlp_bwd.cu
    tensors = [job[0] for job in jobs]
    assert tensors == sorted(tensors)  # a tensor's jobs are adjacent
    for tensor, row0, a_col0, rows0, a_col1, rows1, g_stash, g_col, n_mma, shift, n_out, bias in jobs:
        assert n_mma in (64, 128, 256) and 0 <= shift and shift + n_out <= n_mma
        assert 0 <= g_col and g_col % 64 == 0 and g_col + shift + n_out <= (lda if g_stash else ldg)
        if g_stash:  # the heads' block: density at column 32, the color head's after it
            assert g_col == a_demb and shift == (32 if tensor == nl + 1 else 33), tensor
        assert row0 % 128 == 0 and 0 < rows0 <= 64 and 0 <= rows1 <= 64 and (rows1 == 0 or rows0 == 64)
        for first, a_col, rows in ((row0, a_col0, rows0), (row0 + 64, a_col1, rows1)):
            for k in range(first, first + rows):
                assert input_col(tensor, k) == a_col + k - first, (tensor, k)
            assert rows == 0 or (a_col % 64 == 0 and a_col + 64 <= lda)
            seen_w[tensor][first : first + rows, :n_out] += 1
        if bias:
            seen_b[tensor][:n_out] += 1
    for i in range(len(packed.weights)):
        assert bool((seen_w[i] == 1).all()), i
        assert bool((seen_b[i] == 1).all()), i
