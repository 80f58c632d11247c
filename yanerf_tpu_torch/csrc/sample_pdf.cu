// Inverse-CDF sampling of a piecewise-constant pdf for Hopper (sm_90a): K6.
//
// No Pallas kernel stands behind it: the JAX package's sample_pdf
// (yanerf_tpu/ops/sample_pdf.py) is XLA over a gather-free mask, and so is
// the port's plain version (ops/kernels/sample_pdf.py): every u is
// matched to its bin by a (rays, samples, bins) tile of comparisons, about
// fourteen broadcast passes that each write the whole tile to device
// memory, then a sum over the bins. K6 computes the same function a ray
// at a time with the ray's CDF on chip, so the tile never exists:
//   * masses: clamp(w, min 0) + eps; the normaliser their sum; the pdf
//     mass / normaliser, float32;
//   * the CDF: 0, then the running sum of the pdf, accumulated in double
//     and rounded to float32 at every prefix, as the CPU's torch.cumsum
//     accumulates a float32 row; so the CDF is non-decreasing, and the
//     same bits in every run;
//   * u: the caller's draws (or the linspace of det), stratified in the
//     kernel as (i + u) / n when asked;
//   * the bin: bin i holds u when cdf[i] <= u < cdf[i + 1], the last bin
//     cdf[n - 1] <= u (half-open). Over a non-decreasing CDF that is the
//     last i with cdf[i] <= u, found by binary search; a bin of zero width
//     is never chosen. A CDF that is not finite (a weight that is not)
//     turns NaN from some index on, where every comparison is false, as in
//     the mask: the search then finds what the mask finds, and a u that no
//     bin holds gives 0, the mask's empty sum;
//   * the sample: denom = cdf[i + 1] - cdf[i], 1 where below eps;
//     t = (u - cdf[i]) / denom; lo + t * (hi - lo) with each operation
//     rounded on its own (no fused multiply-add, as in separate PyTorch
//     kernels); in the last bin a u >= min(cdf[n], 1) lands on its top
//     edge.
//
// What bounds it: latency, not bytes or operations. A call reads the ray's
// weights, edges and u's and writes its samples, ~2 MB at 2,045 rays x 62
// bins x 64 samples (under 1 us at 3.35 TB/s), and does a few hundred
// operations a ray. The time is one launch and the dependent steps of a
// ray: the loads, the normaliser's reduction, the CDF's sum (a chain of
// n_bins adds), a binary search per sample.
//
// What the design does about it: one launch per call, a warp per ray, four
// rays a block, so that every ray of a call is in flight at once (2,045 to
// 4,096 warps on 132 SMs). The lanes read the ray's weights and edges
// together (coalesced), reduce the normaliser by shuffles, and pass the pdf
// along the warp by shuffles, 32 bins at a time, so the CDF's sum is a
// chain of register adds with no memory in it. The CDF and the edges sit in
// shared memory, 2 x (n_bins + 1) floats a ray; each lane then takes
// samples lane, lane + 32, ..., binary-searches the CDF and writes its
// sample (coalesced). Nothing is summed across lanes in an order that
// changes: K6 gives the same bits in every run, and allocates nothing.
//
// Built with nvcc into a shared library with a plain C entry point
// (sample_pdf_fwd), loaded with ctypes by ops/kernels/sample_pdf.py.

#include <cuda_runtime.h>

namespace {

constexpr int RAYS = 4;  // rays (warps) a block
constexpr int MAX_BINS = 48 * 1024 / (RAYS * 2 * 4) - 1;  // a block's CDFs and edges within 48 KB: 1535
constexpr unsigned FULL = 0xffffffffu;

struct Args {
  const float* bins;     // (rays, n_bins + 1), row stride bins_row
  const float* weights;  // (rays, n_bins), row stride weights_row
  const float* u;        // (rays, n_samples), row stride u_row (0: one row for every ray)
  float* out;            // (rays, n_samples), contiguous
  long long bins_row, weights_row, u_row;
  int n_rays, n_bins, n_samples, stratified;
  float eps;
};

__device__ __forceinline__ float mass(float w, float eps) {
  return __fadd_rn(w < 0.0f ? 0.0f : w, eps);  // clamp(min=0) keeps a NaN, as torch.clamp does
}

__global__ void __launch_bounds__(RAYS * 32) sample_pdf_kernel(const __grid_constant__ Args a) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ray = blockIdx.x * RAYS + warp;
  if (ray >= a.n_rays) return;  // a whole warp: nothing below waits on the block
  const int nb = a.n_bins, ne = nb + 1;
  float* cdf = smem + warp * 2 * ne;
  float* edge = cdf + ne;
  const float* w = a.weights + ray * a.weights_row;
  const float* b = a.bins + ray * a.bins_row;

  for (int j = lane; j < ne; j += 32) edge[j] = __ldg(b + j);
  double part = 0.0;
  for (int j = lane; j < nb; j += 32) part += (double)mass(__ldg(w + j), a.eps);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) part += __shfl_xor_sync(FULL, part, off);  // every lane the same sum
  const float total = __double2float_rn(part);

  // the CDF: lane l of each group of 32 bins holds bin base + l's pdf; every lane runs the one chain of adds
  double run = 0.0;
  if (lane == 0) cdf[0] = 0.0f;
  for (int base = 0; base < nb; base += 32) {
    const int j = base + lane;
    const float p = j < nb ? __fdiv_rn(mass(__ldg(w + j), a.eps), total) : 0.0f;
    float mine = 0.0f;
#pragma unroll
    for (int l = 0; l < 32; ++l) {
      run += (double)__shfl_sync(FULL, p, l);  // past the last bin p is 0: the sum stays as it is
      if (l == lane) mine = __double2float_rn(run);
    }
    if (j < nb) cdf[j + 1] = mine;
  }
  __syncwarp();

  const float* u = a.u + ray * a.u_row;
  float* out = a.out + (long long)ray * a.n_samples;
  const float n = (float)a.n_samples;
  for (int s = lane; s < a.n_samples; s += 32) {
    float x = __ldg(u + s);
    if (a.stratified) x = __fdiv_rn(__fadd_rn((float)s, x), n);
    int lo = 0, hi = nb;  // the count of bins i < nb with cdf[i] <= x: the comparison is true on a prefix
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (cdf[mid] <= x) lo = mid + 1;
      else hi = mid;
    }
    float val = 0.0f;  // no bin holds x (x below 0, or a NaN in the way): the mask's empty sum
    const int i = lo - 1;
    const bool last = i == nb - 1;
    if (i >= 0 && (last || x < cdf[i + 1])) {
      const float c0 = cdf[i], c1 = cdf[i + 1], e0 = edge[i], e1 = edge[i + 1];
      float denom = __fsub_rn(c1, c0);
      if (denom < a.eps) denom = 1.0f;
      const float t = __fdiv_rn(__fsub_rn(x, c0), denom);
      val = __fadd_rn(e0, __fmul_rn(t, __fsub_rn(e1, e0)));
      if (last && x >= (c1 > 1.0f ? 1.0f : c1)) val = e1;  // clamp(max=1) keeps a NaN, as torch.clamp does
      val = __fadd_rn(val, 0.0f);  // the mask's sum over bins starts at +0: a -0 comes out +0
    }
    out[s] = val;
  }
}

}  // namespace

// K6: `out` (n_rays, n_samples) float32 samples of the rays' (n_bins + 1) edges `bins` and n_bins `weights`,
// at the u's `u`; each input's rows `*_row` floats apart, its last axis contiguous.
extern "C" int sample_pdf_fwd(const void* bins, long long bins_row, const void* weights, long long weights_row,
                              const void* u, long long u_row, void* out, int n_rays, int n_bins, int n_samples,
                              int stratified, float eps, void* stream) {
  if (n_bins < 0 || n_bins > MAX_BINS) return (int)cudaErrorInvalidValue;
  if (n_rays == 0 || n_samples == 0) return 0;
  Args a{static_cast<const float*>(bins), static_cast<const float*>(weights), static_cast<const float*>(u),
         static_cast<float*>(out), bins_row, weights_row, u_row, n_rays, n_bins, n_samples, stratified, eps};
  const size_t shared = (size_t)RAYS * 2 * (n_bins + 1) * sizeof(float);
  sample_pdf_kernel<<<(n_rays + RAYS - 1) / RAYS, RAYS * 32, shared, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}
