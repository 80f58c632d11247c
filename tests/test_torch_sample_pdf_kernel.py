"""The inverse-CDF sampler's operator ``yanerf_tpu_torch::sample_pdf``: its CPU kernel, and K6 on a card.

K6 and the plain version compute one function but sum the CDF in other
orders (K6: the normaliser and the running sum in float64, each prefix
rounded to float32, as the CPU's ``torch.cumsum`` rounds a float32 row).
``sample_pdf.k6_arithmetic`` writes K6's function with the plain version's
ops: its CDF (``k6_cdf``), then the plain version's inverse
(``inverse_cdf``).

On the CPU:
  * ``sample_pdf`` through the operator is the plain version bit for bit,
    under ``det``, stratified and unstratified draws (fed or from a
    generator);
  * ``k6_arithmetic`` against the plain version (``check_against_plain``)
    and against the JAX package's ``sample_pdf`` at a served chunk's shape
    (``check_against``): the two CDFs at most ``CDF_ULPS`` (``JAX_CDF_ULPS``)
    apart; every sample within rtol 1e-5 / atol 2e-5 (tests/test_torch_ops.py's
    tolerances), or in or beside a bin of mass under ``NEAR_EPS``, where the
    reference moves as far when its CDF moves those few ulps: the plain
    inverse fed the other CDF gives the other sample bit for bit;
  * the fake's shapes, the row strides the wrapper hands the kernel (the
    renderer's weights slice, an expanded linspace), its refusals, a kernel
    that cannot be built raising, and ``launch_count.totals`` listing K6.

On the card (marked ``cuda``, skipped without one):
  * K6 bit for bit ``k6_arithmetic`` run on the CPU, at the cells' shapes
    (2,045 rays x 62 bins x 64 / 32 / 128 samples, 4,096 x 62 x 64 / 48 /
    128) under ``det``, stratified and unstratified draws;
  * K6 against the plain version on the same card, ``check_against_plain``;
  * the edge rows (an empty ray, empty last bins, empty first bins) and
    weights that are not finite: K6 gives the plain version's values and
    NaNs;
  * K6 bit for bit on two runs, and captured in a CUDA graph and replayed,
    counted once per replay; more bins than its shared memory holds,
    float64 inputs and rays that do not match raise.

    python -m pytest tests/test_torch_sample_pdf_kernel.py -m cuda --noconftest
"""

import pytest
import torch

from yanerf_tpu_torch.ops.kernels import _build, launch_count
from yanerf_tpu_torch.ops.kernels import sample_pdf as K6
from yanerf_tpu_torch.ops.rays import linspace01
from yanerf_tpu_torch.ops.sample_pdf import sample_pdf

EPS = 1e-5
RTOL, ATOL = 1e-5, 2e-5  # tests/test_torch_ops.py's sample_pdf tolerances
CDF_ULPS = 16  # the two CDFs: each pdf entry a rounding or two apart, then ~log2(n_bins) roundings of the sums
# the JAX package's CDF on the CPU: a float32 running sum, up to half an ulp a term over 62 terms (19 ulps from the
# exact sum at 2,045 x 62, K6's within 2)
JAX_CDF_ULPS = 32
NEAR_EPS = 1e-3  # a bin this light: 1e-7 of CDF moves its sample by 1e-4 of its width (more where eps replaces it)
# (rays, bins, samples): the frames cells' two refinements and the classic fine pass (2,045-ray chunks), the
# train steps' (4,096 rays)
CELL_SHAPES = [(2045, 62, 64), (2045, 62, 32), (2045, 62, 128), (4096, 62, 64), (4096, 62, 48), (4096, 62, 128)]
MODES = ["det", "stratified", "drawn"]


def _inputs(n_rays, n_bins, seed):
    """The renderer's call: edges the midpoints of sorted depths in [2, 6], weights the inner entries of a pass's
    ``(rays, n_bins + 2)`` weights (a view). A third of the rays empty, a third with one or two surfaces (a few
    bins holding almost all the mass, tails falling to nothing), a third uniform draws; the first three rows are
    tests/test_torch_ops.py's edge rows (an empty ray, empty last bins, empty first bins)."""
    gen = torch.Generator().manual_seed(seed)
    z = torch.sort(torch.rand(n_rays, n_bins + 2, generator=gen) * 4.0 + 2.0, dim=-1).values
    bins = 0.5 * (z[..., 1:] + z[..., :-1])
    idx = torch.arange(n_bins + 2, dtype=torch.float32)
    centre = torch.rand(n_rays, 2, 1, generator=gen) * (n_bins + 2)
    width = 0.3 + 2.0 * torch.rand(n_rays, 2, 1, generator=gen)
    height = torch.rand(n_rays, 2, 1, generator=gen) * torch.tensor([1.0, 0.3])[:, None]
    surfaces = (height * torch.exp(-0.5 * ((idx - centre) / width) ** 2)).sum(dim=1)
    kind = torch.randint(0, 3, (n_rays, 1), generator=gen)
    full = torch.where(kind == 0, torch.zeros_like(surfaces),
                       torch.where(kind == 1, surfaces, torch.rand(n_rays, n_bins + 2, generator=gen)))
    full[0] = 0.0
    full[1, -4:] = 0.0
    full[2, :5] = 0.0
    return bins, full[..., 1:-1]


def _draws(mode, n_rays, n_samples, seed, device="cpu"):
    """``sample_pdf``'s u and its ``stratified``: the det linspace expanded, or the generator's draws."""
    if mode == "det":
        return linspace01(n_samples, device=device).expand(n_rays, n_samples), False
    u = torch.rand(n_rays, n_samples, generator=torch.Generator().manual_seed(seed + 1))
    return u.to(device), mode == "stratified"


def plain_cdf(weights, eps=EPS):
    """The plain version's CDF (``sample_pdf_plain`` before its inverse)."""
    masses = torch.clamp(weights, min=0.0) + eps
    cdf = torch.cumsum(masses / torch.sum(masses, dim=-1, keepdim=True), dim=-1)
    return torch.cat([torch.zeros_like(cdf[..., :1]), cdf], dim=-1)


def ulps_apart(a, b):
    """The most float32 steps between two tensors of finite non-negative entries, entry by entry."""
    return int((a.contiguous().view(torch.int32).long() - b.contiguous().view(torch.int32).long()).abs().max())


def check_against(got, want, cdf, bins, weights, u, stratified, eps=EPS, max_ulps=CDF_ULPS):
    """``got`` (K6, or ``k6_arithmetic``) against ``want``, the samples of a reference whose CDF is ``cdf`` (the
    plain version's, or the JAX package's); returns (samples beyond rtol / atol, the largest gap, the CDFs'
    distance in ulps).

    The two CDFs lie at most ``max_ulps`` apart. Where the inverse is steep
    (a bin of mass near ``eps``, whose CDF step the plain version replaces
    by 1 below ``eps``) or jumps (the edge of such a bin), that moves a
    sample by more than rtol / atol: every sample beyond them must lie in or
    beside a bin of mass under ``NEAR_EPS``, and there the plain version fed
    ``got``'s CDF (the reference's moved those few ulps) must give ``got``
    bit for bit. (Fed also ``got``'s u: on the card the plain version
    stratifies by a product with 1 / n, K6 and the CPU by the division, an
    ulp apart where n is not a power of two.)
    """
    ours = K6.k6_cdf(weights, eps)
    ulps = ulps_apart(cdf, ours)
    assert ulps <= max_ulps, f"the CDFs lie {ulps} ulps apart"
    gap = (got - want).abs()
    far = gap > ATOL + RTOL * want.abs()
    if bool(far.any()):
        n_bins = weights.shape[-1]
        x = ((torch.arange(u.shape[-1], dtype=u.dtype) + u.cpu()) / u.shape[-1]).to(u.device) if stratified else u
        step = torch.minimum(cdf[..., 1:] - cdf[..., :-1], ours[..., 1:] - ours[..., :-1])
        near = torch.zeros_like(far)
        for c in (cdf, ours):
            held = torch.searchsorted(c[..., :-1].contiguous(), x.contiguous(), right=True) - 1  # the bin u falls in
            for i in (held - 1, held, held + 1):
                near |= torch.gather(step, -1, i.clamp(0, n_bins - 1)) < NEAR_EPS
        assert bool(near[far].all()), f"{int((far & ~near).sum())} samples beyond the tolerance, away from any " \
                                      "bin of mass near eps"
        fed = K6.inverse_cdf(bins, ours, x, False, eps)
        assert torch.equal(fed[far], got[far]), "the plain version fed the other CDF does not move as far"
    return int(far.sum()), float(gap.max()), ulps


def check_against_plain(got, bins, weights, u, stratified, eps=EPS):
    """``got`` against the plain version on the same device (``check_against``)."""
    want = K6.sample_pdf_plain(bins, weights, u, stratified, eps)
    return check_against(got, want, plain_cdf(weights, eps), bins, weights, u, stratified, eps)


# -- on the CPU ------------------------------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["det", "stratified", "drawn", "generator"])
def test_the_operator_on_the_cpu_is_the_plain_version(mode):
    bins, weights = _inputs(37, 15, seed=1)
    if mode == "generator":
        got = sample_pdf(bins, weights, 9, generator=torch.Generator().manual_seed(5), stratified=True)
        u, stratified = torch.rand(37, 9, generator=torch.Generator().manual_seed(5)), True
    else:
        u, stratified = _draws(mode, 37, 9, seed=2)
        got = sample_pdf(bins, weights, 9, det=mode == "det", stratified=stratified,
                         u=None if mode == "det" else u)
    assert torch.equal(got, K6.sample_pdf_plain(bins, weights, u, stratified, EPS))
    assert torch.equal(got, torch.ops.yanerf_tpu_torch.sample_pdf(bins, weights, u, stratified, EPS))


@pytest.mark.parametrize("mode", MODES)
def test_k6_arithmetic_is_the_plain_version_but_for_its_cdf(mode):
    bins, weights = _inputs(600, 62, seed=3)
    u, stratified = _draws(mode, 600, 32, seed=4)
    check_against_plain(K6.k6_arithmetic(bins, weights, u, stratified, EPS), bins, weights, u, stratified)


@pytest.mark.parametrize("mode", ["det", "stratified"])
def test_k6_arithmetic_against_the_jax_package(mode):
    """K6's arithmetic against ``yanerf_tpu.ops.sample_pdf`` at a served chunk's first refinement (2,045 rays x 62
    bins x 64 samples), on the linspace and on the JAX package's draws fed in, stratified. Fed the JAX package's
    CDF, the port's inverse gives its samples within rtol / atol, so only the CDFs part the two; every sample
    they move beyond the tolerance is certified by ``check_against``. K6 is this arithmetic bit for bit on the
    card (``test_k6_is_its_arithmetic_bit_for_bit``), so K6 is held to the JAX package."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from yanerf_tpu.ops.sample_pdf import sample_pdf as j_sample_pdf

    n_rays, n_bins, n_samples = CELL_SHAPES[0]
    bins, weights = _inputs(n_rays, n_bins, seed=17)
    weights = weights.contiguous()
    jb, jw = jnp.asarray(bins.numpy()), jnp.asarray(weights.numpy())
    if mode == "det":
        want = j_sample_pdf(jb, jw, n_samples, det=True)
        u, stratified = _draws("det", n_rays, n_samples, seed=0)
    else:
        key = jax.random.PRNGKey(19)
        want = j_sample_pdf(jb, jw, n_samples, rng=key, det=False, stratified=True)
        u, stratified = torch.from_numpy(np.array(jax.random.uniform(key, (n_rays, n_samples)))), True
    want = torch.from_numpy(np.array(want))
    masses = jnp.maximum(jw, 0.0) + EPS
    j_cdf = jnp.cumsum(masses / jnp.sum(masses, axis=-1, keepdims=True), axis=-1)
    cdf = torch.from_numpy(np.array(jnp.concatenate([jnp.zeros_like(j_cdf[..., :1]), j_cdf], axis=-1)))
    torch.testing.assert_close(K6.inverse_cdf(bins, cdf, u, stratified, EPS), want, rtol=RTOL, atol=ATOL)
    check_against(K6.k6_arithmetic(bins, weights, u, stratified, EPS), want, cdf, bins, weights, u, stratified,
                  max_ulps=JAX_CDF_ULPS)


def test_the_fake_gives_the_shape():
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode() as mode:
        bins = mode.from_tensor(torch.zeros(2, 5, 17))
        weights = mode.from_tensor(torch.zeros(2, 5, 18))[..., 1:-1]
        u = mode.from_tensor(torch.zeros(7)).expand(2, 5, 7)
        out = torch.ops.yanerf_tpu_torch.sample_pdf(bins, weights, u, False, EPS)
    assert tuple(out.shape) == (2, 5, 7) and out.dtype == torch.float32


def test_the_wrapper_hands_the_kernel_rows_and_their_strides():
    full = torch.rand(3, 5, 64)
    rows, stride = K6._rows(full[..., 1:-1], "weights", 15, 62)  # the renderer's slice: a view, rows 64 apart
    assert stride == 64 and rows.data_ptr() == full[..., 1:-1].data_ptr() and tuple(rows.shape) == (15, 62)
    u = linspace01(32, device="cpu").expand(3, 5, 32)
    rows, stride = K6._rows(u, "draws", 15, 32)
    assert stride == 0 and rows.data_ptr() == u.data_ptr()
    rows, stride = K6._rows(torch.rand(4, 63), "edges", 4, 63)
    assert stride == 63
    strided = torch.rand(63, 4).t()  # a last axis that is not contiguous is copied
    rows, stride = K6._rows(strided, "edges", 4, 63)
    assert stride == 63 and torch.equal(rows, strided)
    with pytest.raises(ValueError, match="float32"):
        K6._rows(torch.rand(4, 63, dtype=torch.float64), "edges", 4, 63)
    with pytest.raises(ValueError, match="63 entries"):
        K6._rows(torch.rand(4, 62), "edges", 4, 63)


def test_k6_raises_where_it_cannot_be_built(monkeypatch, tmp_path):
    bins, weights = _inputs(4, 6, seed=0)

    def no_nvcc():
        raise RuntimeError("nvcc was not found: the CUDA kernels cannot be built")

    monkeypatch.setattr(_build, "_nvcc", no_nvcc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(K6, "LIBRARY", _build.CudaLibrary("sample_pdf.cu", K6._bind))
    with pytest.raises(RuntimeError, match="nvcc"):
        K6._sample_pdf_cuda(bins, weights, torch.rand(4, 3), False, EPS)


def test_launch_totals_list_k6(monkeypatch):
    monkeypatch.setattr(K6, "launches", 0)
    assert launch_count.totals()["sample_pdf"] == 0
    monkeypatch.setattr(K6, "launches", 7)
    assert launch_count.totals()["sample_pdf"] == 7


# -- on the card ----------------------------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    K6.LIBRARY.load()
    return torch.device("cuda")


def _card_case(shape, mode, device, seed=11):
    n_rays, n_bins, n_samples = shape
    bins, weights = _inputs(n_rays, n_bins, seed)
    u, stratified = _draws(mode, n_rays, n_samples, seed, device)
    return bins.to(device), weights.to(device), u, stratified


@pytest.mark.cuda
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("shape", CELL_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_k6_is_its_arithmetic_bit_for_bit(cuda_device, shape, mode):
    bins, weights, u, stratified = _card_case(shape, mode, cuda_device)
    got = K6.sample_pdf_op(bins, weights, u, stratified, EPS).cpu()
    want = K6.k6_arithmetic(bins.cpu(), weights.cpu(), u.cpu(), stratified, EPS)
    assert torch.equal(got, want), f"{int((got != want).sum())} samples differ, by up to {(got - want).abs().max()}"


@pytest.mark.cuda
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("shape", CELL_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_k6_against_the_plain_version_on_the_card(cuda_device, shape, mode):
    bins, weights, u, stratified = _card_case(shape, mode, cuda_device)
    got = K6.sample_pdf_op(bins, weights, u, stratified, EPS)
    far, gap, ulps = check_against_plain(got, bins, weights, u, stratified)
    print(f"{shape} {mode}: {far} of {got.numel()} samples beyond rtol {RTOL} / atol {ATOL} (largest gap {gap:.3g}), "
          f"the CDFs {ulps} ulps apart")


@pytest.mark.cuda
@pytest.mark.parametrize("mode", MODES)
def test_k6_on_edge_rows_and_weights_that_are_not_finite(cuda_device, mode):
    bins, weights = _inputs(12, 15, seed=5)  # rows 0-2: an empty ray, empty last bins, empty first bins
    weights = weights.clone()
    weights[3, 7] = float("nan")  # a NaN normaliser: every CDF entry but the first NaN, no bin holds a u: 0
    weights[4, 6] = float("inf")  # the CDF 0 up to the bin, NaN from it: no bin holds a u: 0
    weights[5, -1] = float("inf")  # the same in the last bin, which holds every u: NaN
    weights[6, 2] = float("-inf")  # clamped to 0
    weights[7] = 3e38  # the normaliser overflows: every pdf entry 0, every sample on the top edge
    bins, weights = bins.to(cuda_device), weights.to(cuda_device)
    u, stratified = _draws(mode, 12, 16, seed=6, device=cuda_device)
    got = K6.sample_pdf_op(bins, weights, u, stratified, EPS)
    want = K6.sample_pdf_plain(bins, weights, u, stratified, EPS)
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL, equal_nan=True)
    torch.testing.assert_close(got.cpu(), K6.k6_arithmetic(bins.cpu(), weights.cpu(), u.cpu(), stratified, EPS), rtol=0,
                               atol=0, equal_nan=True)
    assert bool((got[3:5] == 0).all()) and bool(torch.isnan(got[5]).all())
    assert bool((got[7] == bins[7, -1]).all()) and bool(torch.isfinite(got[[0, 1, 2, 6]]).all())


@pytest.mark.cuda
def test_k6_is_deterministic_and_replays_in_a_captured_graph(cuda_device):
    bins, weights, u, stratified = _card_case((4096, 62, 128), "stratified", cuda_device, seed=13)
    first = K6.sample_pdf_op(bins, weights, u, stratified, EPS)
    assert torch.equal(first, K6.sample_pdf_op(bins, weights, u, stratified, EPS))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        K6.sample_pdf_op(bins, weights, u, stratified, EPS)  # warm-up off the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with launch_count.capturing() as tally:
        with torch.cuda.graph(graph):
            static = K6.sample_pdf_op(bins, weights, u, stratified, EPS)
    assert launch_count.per_replay(tally) == {"sample_pdf.launches": 1}
    before = K6.launches
    for _ in range(2):
        graph.replay()
        launch_count.replayed(tally)
    torch.cuda.synchronize()
    assert K6.launches == before + 2 and torch.equal(static, first)


@pytest.mark.cuda
def test_k6_refuses_what_it_cannot_take(cuda_device):
    limit = K6.MAX_BINS
    u = torch.rand(3, 8, device=cuda_device)
    bins, weights = torch.rand(3, limit + 2, device=cuda_device), torch.rand(3, limit + 1, device=cuda_device)
    with pytest.raises(NotImplementedError, match=f"at most {limit} bins"):
        K6.sample_pdf_op(bins, weights, u, False, EPS)
    assert K6.sample_pdf_op(bins[:, 1:], weights[:, 1:], u, False, EPS).shape == (3, 8)  # the limit itself runs
    bins, weights = torch.rand(3, 9, device=cuda_device), torch.rand(3, 8, device=cuda_device)
    with pytest.raises(ValueError, match="float32"):
        K6.sample_pdf_op(bins.double(), weights.double(), u.double(), False, EPS)
    with pytest.raises(ValueError, match="same rays"):
        K6.sample_pdf_op(bins, weights, torch.rand(4, 8, device=cuda_device), False, EPS)
