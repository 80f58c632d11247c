"""The fused NeRF-MLP kernels' plain version against the Pallas kernels (interpret mode), and their wrapper.

``nerf_mlp_fwd_plain`` mirrors ``_nerf_mlp_kernel`` (float32 bias after
float32 accumulation, cos as sin(t + pi/2)), so it is held to the Pallas
kernel, never to the eager model, whose bf16 policy differs. The pipelined
pair (K2, ``pipelined=True`` on both sides) computes the same function:
on CPU tensors ``nerf_mlp_fwd(..., pipelined=True)`` takes the same plain
version, held to ``_nerf_mlp_kernel_pipelined``.

Tolerances: float32 at rtol/atol 1e-5, as tests/test_pallas.py holds the
Pallas kernel to the jnp path. bfloat16 at atol 4e-3, one bf16 ulp (2^-8) of
an output of order 1: both round at the same places, and a float32 sum in
another order can move one rounding by an ulp. The CUDA kernel is held to
the plain version at atol + rtol 1e-2, as in chip_smoke.py: the tensor
cores sum the 256-long products in their own order, so over 65,440 points
a few hidden activations round the other way and the following layers
carry that on.

The CUDA kernel is held to the plain version on a card by
tests/test_torch_cuda_kernels.py, which imports no JAX (the card machine
has none).
"""

import dataclasses
import os.path as osp

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yanerf_tpu.models import MODELS as JAX_MODELS
from yanerf_tpu.ops.pallas.nerf_mlp_kernel import nerf_mlp_forward_pallas
from yanerf_tpu.utils import Config
from yanerf_tpu_torch.convert import load_jax_params
from yanerf_tpu_torch.models import MODELS
from yanerf_tpu_torch.ops.kernels import nerf_mlp_bwd as K3
from yanerf_tpu_torch.ops.kernels import nerf_mlp_fwd as K

CFG_DIR = osp.join(osp.dirname(__file__), "configs")
TOLS = {"float32": dict(rtol=1e-5, atol=1e-5), "bfloat16": dict(rtol=0.0, atol=4e-3)}
FLAGSHIP = dict(type="NeRFMLP")  # defaults: 8x256, skip at 5, 10/4 frequencies, 128-wide color head


def _small_cfg():
    return dict(Config.fromfile(osp.join(CFG_DIR, "models/nerf_mlp.yml")).model)


def _pair(cfg, compute_dtype, seed=0):
    cfg = dict(cfg, compute_dtype=compute_dtype)
    jax_model = JAX_MODELS.build(dict(cfg))
    params = jax_model.init(jax.random.PRNGKey(seed))
    model = MODELS.build(dict(cfg, use_pallas=True))
    load_jax_params(model, jax.tree_util.tree_map(np.asarray, params))
    return jax_model, params, model


def _points(n_rays, n_pts, seed=1):
    rng = np.random.RandomState(seed)
    pts = (rng.randn(1, n_rays, n_pts, 3) * 1.5).astype(np.float32)
    dirs = rng.randn(1, n_rays, 3).astype(np.float32)
    return pts, dirs


SHAPES = [(16, 16, 64), (10, 7, 32), (2, 3, 128), (3, 5, 8)]


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "n_rays,n_pts,tile,pipelined",
    [pytest.param(*shape, False, id="-".join(map(str, shape))) for shape in SHAPES]
    + [pytest.param(*shape, True, id="-".join(map(str, shape)) + "-pipelined") for shape in SHAPES],
)
def test_plain_matches_pallas_kernel(compute_dtype, n_rays, n_pts, tile, pipelined):
    jax_model, params, model = _pair(_small_cfg(), compute_dtype)
    pts, dirs = _points(n_rays, n_pts)
    d_ref, c_ref = nerf_mlp_forward_pallas(
        jax_model, params, jnp.asarray(pts), jnp.asarray(dirs), tile=tile, interpret=True, pipelined=pipelined
    )
    before = (K.launches, K.pipelined_launches)
    out = K.nerf_mlp_fwd(
        model.packed_weights(), torch.from_numpy(pts.reshape(-1, 3)), torch.from_numpy(dirs.reshape(-1, 3)), n_pts,
        pipelined=pipelined,
    )
    assert (K.launches, K.pipelined_launches) == before, "CPU tensors take the plain version, no launch"
    tol = TOLS[compute_dtype]
    np.testing.assert_allclose(out[:, :1].numpy(), np.asarray(d_ref).reshape(-1, 1), **tol)
    np.testing.assert_allclose(out[:, 1:].numpy(), np.asarray(c_ref).reshape(-1, 3), **tol)


def test_plain_matches_pallas_kernel_at_flagship_widths():
    """8x256 with the 63 -> 64 and 27 -> 32 K padding (Pallas pads to 128 lanes)."""
    jax_model, params, model = _pair(FLAGSHIP, "bfloat16", seed=2)
    pts, dirs = _points(4, 16, seed=3)
    d_ref, c_ref = nerf_mlp_forward_pallas(jax_model, params, jnp.asarray(pts), jnp.asarray(dirs), tile=64, interpret=True)
    packed = model.packed_weights()
    assert (packed.k_xyz, packed.k_dir) == (64, 32)
    assert [tuple(w.shape) for w in packed.weights][:1] + [tuple(packed.weights[5].shape)] == [(64, 256), (320, 256)]
    out = K.nerf_mlp_fwd_plain(packed, torch.from_numpy(pts.reshape(-1, 3)), torch.from_numpy(dirs.reshape(-1, 3)), 16)
    np.testing.assert_allclose(out[:, :1].numpy(), np.asarray(d_ref).reshape(-1, 1), **TOLS["bfloat16"])
    np.testing.assert_allclose(out[:, 1:].numpy(), np.asarray(c_ref).reshape(-1, 3), **TOLS["bfloat16"])
    assert K.flops_per_point(packed) == 1_186_816  # 1.187 MFLOP per point, the bound's numerator


def test_model_switch_routes_cpu_tensors_to_the_plain_version():
    jax_model, params, model = _pair(_small_cfg(), "float32")
    rng = np.random.RandomState(4)
    o = rng.randn(1, 3, 1, 3).astype(np.float32)
    d = rng.randn(1, 3, 1, 3).astype(np.float32)
    l = np.sort(rng.uniform(1, 4, (1, 3, 1, 5)), axis=-1).astype(np.float32)
    ref = jax_model.apply(params, jnp.asarray(o), jnp.asarray(d), jnp.asarray(l), use_pallas=True)
    before = K.launches
    with torch.no_grad():
        got = model(torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(l))
    assert K.launches == before, "CPU tensors must not count as kernel launches"
    assert got["rays_densities"].shape == ref["rays_densities"].shape
    np.testing.assert_allclose(got["rays_densities"].numpy(), np.asarray(ref["rays_densities"]), **TOLS["float32"])
    np.testing.assert_allclose(got["rays_features"].numpy(), np.asarray(ref["rays_features"]), **TOLS["float32"])


def test_packed_weights_are_cached_until_a_parameter_changes():
    model = MODELS.build(dict(_small_cfg(), use_pallas=True))
    first = model.packed_weights()
    flat = first.flat.clone()
    assert model.packed_weights() is first
    with torch.no_grad():
        model.density_layer.b.add_(1.0)
    second = model.packed_weights()
    # repacked in place: the same buffers, at the same addresses, with the new values
    assert second is first and second.biases_flat.data_ptr() == first.biases_flat.data_ptr()
    assert float(second.biases[model.n_layers + 1][0]) == float(model.density_layer.b.detach()[0])
    assert torch.equal(second.flat, flat)


def test_build_cache_key_covers_included_headers(tmp_path):
    """A header edit gives a new library path: the build cache cannot hand out a stale ``.so``."""
    from yanerf_tpu_torch.ops.kernels._build import CudaLibrary

    (tmp_path / "kernel.cu").write_text('#include <cuda_runtime.h>\n#include "shared.cuh"\nint f() { return g(); }\n')
    (tmp_path / "shared.cuh").write_text('#pragma once\n#include "inner.cuh"\ninline int g() { return h(); }\n')
    (tmp_path / "inner.cuh").write_text("#pragma once\ninline int h() { return 1; }\n")
    (tmp_path / "other.cuh").write_text("inline int k() { return 0; }\n")
    lib = CudaLibrary(str(tmp_path / "kernel.cu"), lambda _: None)
    assert [p.name for p in lib.sources()] == ["kernel.cu", "shared.cuh", "inner.cuh"]
    first = lib.path()
    assert first == lib.path() and first.name.startswith("libkernel_")
    (tmp_path / "other.cuh").write_text("inline int k() { return 2; }\n")
    assert lib.path() == first, "a header the source does not include is not part of the key"
    (tmp_path / "inner.cuh").write_text("#pragma once\ninline int h() { return 2; }\n")
    second = lib.path()
    assert second != first, "an edit two includes down rebuilds"
    (tmp_path / "shared.cuh").write_text('#pragma once\n#include "inner.cuh"\ninline int g() { return -h(); }\n')
    assert lib.path() not in (first, second)
    # both forward kernels of the package (and K3) run the tile engine of one header, so its edits rebuild them
    engine = ["nerf_mlp_tile.cuh", "hopper.cuh", "nerf_mlp_fwd.cuh"]
    assert [p.name for p in K.LIBRARY.sources()] == ["nerf_mlp_fwd.cu", *engine]
    assert [p.name for p in K.PIPELINED_LIBRARY.sources()] == ["nerf_mlp_fwd_pipelined.cu", *engine]
    assert [p.name for p in K3.LIBRARY.sources()] == ["nerf_mlp_bwd.cu", *engine]
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for src in K.LIBRARY.sources():
        (csrc / src.name).write_bytes(src.read_bytes())
    k1 = CudaLibrary(str(csrc / "nerf_mlp_fwd.cu"), lambda _: None)
    before = k1.path()
    (csrc / "nerf_mlp_tile.cuh").write_bytes(K.LIBRARY.sources()[1].read_bytes() + b"\n// edited\n")
    assert k1.path() != before, "an edit of the shared tile engine rebuilds K1"


def test_cuda_input_checks_reject_what_the_kernel_does_not_take():
    pts, dirs = torch.zeros(6, 3), torch.zeros(3, 3)
    small = MODELS.build(dict(_small_cfg(), compute_dtype="bfloat16")).packed_weights()
    with pytest.raises(NotImplementedError, match="hidden widths"):
        K._check_cuda_inputs(small, pts, dirs, 2)
    f32 = MODELS.build(dict(FLAGSHIP)).packed_weights()
    with pytest.raises(NotImplementedError, match="bfloat16"):
        K._check_cuda_inputs(f32, pts, dirs, 2)
    packed = MODELS.build(dict(FLAGSHIP, compute_dtype="bfloat16")).packed_weights()
    K._check_cuda_inputs(packed, pts, dirs, 2)
    with pytest.raises(ValueError, match="rays"):
        K._check_cuda_inputs(packed, pts, dirs, 3)
    with pytest.raises(ValueError, match="float32"):
        K._check_cuda_inputs(packed, pts.double(), dirs, 2)
    with pytest.raises(ValueError, match="contiguous"):
        K._check_cuda_inputs(packed, torch.zeros(3, 6).t(), dirs, 2)


@pytest.mark.parametrize("paper_v1", [False, True], ids=["flagship", "nerf_paper_v1"])
def test_weight_rows_address_every_packed_matrix(paper_v1):
    """The plan the kernels' tensor maps read: a wrong row gives wrong numbers and no error on the card."""
    packed = MODELS.build(dict(FLAGSHIP, compute_dtype="bfloat16", nerf_paper_v1=paper_v1)).packed_weights()
    rows = K.weight_rows(packed)
    nl, ne = packed.n_layers, packed.n_extra_color
    assert len(rows) == len(packed.weights) == nl + 4 + ne
    heads = (nl + 1, nl + 3 + ne)
    for i, (row, w, off) in enumerate(zip(rows, packed.weights, packed.w_offsets)):
        if i in heads:
            assert row == -1, i
            continue
        width = w.shape[1]
        assert width == (128 if nl + 2 <= i <= nl + 2 + ne else 256), i
        assert off % width == 0 and row == off // width, i
        view = packed.flat[: packed.flat.numel() // width * width].view(-1, width)  # the map's whole rows
        assert torch.equal(view[row : row + w.shape[0]], w), i
    w_off, b_off, w_rows = packed.launch_tables
    assert list(w_rows) == list(rows) and list(w_off) == list(packed.w_offsets)
    assert list(b_off) == list(packed.b_offsets)


def _beyond_the_maxima(case):
    """A packed model past exactly one of the kernels' maxima."""
    if case == "3-extra-color-layers":  # no config reaches it at <= 8 layers: nerf_paper_v1 gives n_layers // 4
        packed = MODELS.build(dict(FLAGSHIP, compute_dtype="bfloat16", nerf_paper_v1=True)).packed_weights()
        assert (packed.n_layers, packed.n_extra_color) == (8, 2)
        return dataclasses.replace(packed, n_extra_color=3)
    overrides = {"9-layers": dict(n_layers=9), "color-dim-5": dict(color_dim=5)}[case]
    return MODELS.build(dict(FLAGSHIP, compute_dtype="bfloat16", **overrides)).packed_weights()


@pytest.mark.parametrize("case", ["9-layers", "3-extra-color-layers", "color-dim-5"])
def test_cuda_input_checks_refuse_beyond_the_kernels_maxima(case):
    """Beyond the tile engine's maxima (8 layers, 2 extra color layers, 4 channels): refused before any launch."""
    packed = _beyond_the_maxima(case)
    pts, dirs = torch.zeros(6, 3), torch.zeros(3, 3)
    with pytest.raises(NotImplementedError, match="xyz layers"):
        K._check_cuda_inputs(packed, pts, dirs, 2)
