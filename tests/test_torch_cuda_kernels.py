"""The CUDA kernels against their plain versions, on a card.

Every test here is marked ``cuda`` and skips without a card. The file
imports no JAX, so it also runs where JAX is not installed:

    python -m pytest tests/test_torch_cuda_kernels.py -m cuda --noconftest

(``--noconftest``: tests/conftest.py sets JAX up.)

Tolerances:
  * K1 (``nerf_mlp_fwd``) at atol + rtol 1e-2, as in chip_smoke.py: the
    tensor cores sum the 256-long products in their own order, so a few
    hidden activations round the other way in bf16 and the following
    layers carry that on.
  * K3 (``nerf_mlp_bwd``) per tensor at cosine >= 0.9999 and a max abs error
    within 5% of the tensor's largest entry, all finite, the rows of the
    packed padding exactly zero. The same bf16 roundings happen at the same
    places; a weight gradient sums one product per point, and a hidden
    cotangent that rounds the other way (2^-8) moves the few sums it enters.
    How far depends on the weights: over five random inits of the flagship
    on an H100 the worst tensor (the last xyz layer's weight, at 49,152
    points) reached 1.1% to 2.1% of its largest entry.
"""

import numpy as np
import pytest
import torch

from yanerf_tpu_torch.models import MODELS
from yanerf_tpu_torch.ops.kernels import nerf_mlp_bwd as K3
from yanerf_tpu_torch.ops.kernels import nerf_mlp_fwd as K1

FLAGSHIP = dict(type="NeRFMLP", compute_dtype="bfloat16", use_pallas=True)  # 8x256, skip at 5, 10/4 frequencies
K1_TOL = dict(rtol=1e-2, atol=1e-2)
K3_MIN_COSINE = 0.9999
K3_REL_ATOL = 5e-2


def k3_agreement(got: torch.Tensor, ref: torch.Tensor):
    """(cosine, max abs error, allowed max abs error) of one gradient tensor."""
    g, r = got.double().flatten(), ref.double().flatten()
    cos = float(g @ r / torch.clamp(g.norm() * r.norm(), min=1e-30))
    return cos, float((g - r).abs().max()), K3_REL_ATOL * float(r.abs().max())


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_version(cuda_device):
    """K1 (``nerf_mlp_fwd``) against its plain version."""
    model = MODELS.build(dict(FLAGSHIP), generator=torch.Generator().manual_seed(0)).to(cuda_device)
    packed = model.packed_weights()
    g = torch.Generator().manual_seed(0)
    for n_rays, n_pts in ((2045, 32), (3, 5), (1, 1)):
        pts = (torch.rand(n_rays * n_pts, 3, generator=g) * 3 - 1.5).to(cuda_device)
        dirs = torch.randn(n_rays, 3, generator=g).to(cuda_device)
        before = K1.launches
        out = K1.nerf_mlp_fwd(packed, pts, dirs, n_pts)
        torch.cuda.synchronize()
        assert K1.launches == before + 1
        ref = K1.nerf_mlp_fwd_plain(packed, pts, dirs, n_pts)
        torch.testing.assert_close(out, ref, **K1_TOL)


@pytest.mark.cuda
def test_nerf_mlp_bwd_matches_plain_version(cuda_device):
    model = MODELS.build(dict(FLAGSHIP), generator=torch.Generator().manual_seed(0)).to(cuda_device)
    packed = model.packed_weights()
    gen = torch.Generator().manual_seed(0)
    for n_rays, n_pts in ((1024, 48), (3, 5), (1, 1)):
        n = n_rays * n_pts
        pts = (torch.rand(n, 3, generator=gen) * 3 - 1.5).to(cuda_device)
        dirs = torch.randn(n_rays, 3, generator=gen).to(cuda_device)
        cot = (torch.randn(n, 4, generator=gen) / n).to(cuda_device)
        before = K3.launches
        gw, gb = K3.nerf_mlp_bwd(packed, pts, dirs, n_pts, cot)
        torch.cuda.synchronize()
        assert K3.launches == before + 1
        rw, rb = K3.nerf_mlp_bwd_plain(packed, pts, dirs, n_pts, cot)
        got_w, got_b = K3.grad_views(packed, gw, gb)
        ref_w, ref_b = K3.grad_views(packed, rw, rb)
        for i, (got, ref) in enumerate(zip(got_w + got_b, ref_w + ref_b)):
            assert bool(torch.isfinite(got).all()), i
            cos, err, allowed = k3_agreement(got, ref)
            assert err <= allowed and (cos >= K3_MIN_COSINE or allowed == 0.0), (i, n, cos, err, allowed)
        assert float(got_w[0][63:].abs().max()) == 0.0
        assert float(got_w[5][256 + 63 :].abs().max()) == 0.0
        assert float(got_w[packed.n_layers + 2][256 + 27 :].abs().max()) == 0.0
        np.testing.assert_array_equal(gw.cpu().numpy(), K3.nerf_mlp_bwd(packed, pts, dirs, n_pts, cot)[0].cpu().numpy())
