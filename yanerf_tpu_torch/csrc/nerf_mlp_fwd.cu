// Fused NeRF-MLP forward for Hopper (sm_90a): one CTA per tile of 128 points.
//
// Replaces the Pallas TPU kernel yanerf_tpu/ops/pallas/nerf_mlp_kernel.py
// (_nerf_mlp_kernel, reached via nerf_mlp_forward_pallas) and computes the
// same function, with bf16 operands and float32 accumulation:
//   * the harmonic embedding of the points (sin | cos | x, frequency-major,
//     cos(t) written as sin(t + pi/2)) and of the normalized per-ray
//     directions, in float32 with the accurate sinf (the phase reaches
//     |x| * 2^9 rad, where a fast-math sine is wrong), rounded to bf16;
//   * the xyz layers, each relu(a @ W + b) rounded to bf16, the skip layers
//     as y @ W[:H] + emb @ W[H:];
//   * the density head (float32 out), the intermediate layer (bf16, no
//     relu), the color layer over [inter, dir embedding] with relu, optional
//     extra color layers, and the sigmoid color head (float32 out).
//
// What bounds it: operations. 1.19 MFLOP per point against ~28 bytes of
// input and output per point, far above the card's ~295 FLOP/byte ridge.
// The design keeps every activation of a tile in shared memory (the
// (128, 256) bf16 activation buffer is updated in place, layer by layer),
// so no activation touches device memory, and runs the products on the
// tensor cores (wmma bf16 16x16x16, float32 accumulators; 8 warps, each
// owning a 64-row by N/4-column block of the layer output). The weights
// (~1.2 MB in bf16) do not fit in shared memory: each layer streams them in
// slabs of 64 rows from device memory, where they stay in the 50 MB L2.
// wgmma, TMA and a pipelined weight stream are later work.
//
// Built with nvcc into a shared library with a plain C entry point
// (nerf_mlp_fwd_bf16), loaded with ctypes by ops/kernels/nerf_mlp_fwd.py.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int TILE = 128;     // points per CTA
constexpr int THREADS = 256;  // 8 warps
constexpr int H = 256;        // xyz hidden width
constexpr int HD = 128;       // color hidden width
constexpr int KX_MAX = 64;    // padded xyz-embedding width (10 frequencies -> 63 -> 64)
constexpr int KD_MAX = 32;    // padded dir-embedding width (4 frequencies -> 27 -> 32)
constexpr int KSLAB = 64;     // weight rows staged per pass
constexpr int LDA = H + 8;    // row pitch of the activation buffer (elements)
constexpr int LDX = KX_MAX + 8;
constexpr int LDD = KD_MAX + 8;
constexpr int MAX_TENSORS = 24;
constexpr float HALF_PI = 1.57079632679489661923f;

constexpr int ACT_BYTES = TILE * LDA * 2;
constexpr int XEMB_BYTES = TILE * LDX * 2;
constexpr int DEMB_BYTES = TILE * LDD * 2;
constexpr int WSLAB_BYTES = KSLAB * (H + 8) * 2;
constexpr int STAGE_BYTES = (THREADS / 32) * 256 * 4;
constexpr int VEC_BYTES = TILE * 3 * 4;
constexpr int SMEM_BYTES = ACT_BYTES + XEMB_BYTES + DEMB_BYTES + WSLAB_BYTES + STAGE_BYTES + 2 * VEC_BYTES;

struct Params {
  const float* points;  // (n_points, 3)
  const float* dirs;    // (n_points / pts_per_ray, 3), one per ray
  float* out;           // (n_points, 1 + color_dim)
  const bf16* w[MAX_TENSORS];
  const float* b[MAX_TENSORS];
  int n_points, pts_per_ray, n_layers, skip_mask;
  int nf_xyz, app_xyz, k_xyz, nf_dir, app_dir, k_dir, n_extra_color, color_dim;
};

__device__ __forceinline__ float embed_value(const float* x, int c, int nf, int app) {
  const int base = 3 * nf;
  if (c < base) {
    const int d = c / nf, k = c - d * nf;
    return sinf(x[d] * ldexpf(1.0f, k));
  }
  if (c < 2 * base) {
    const int cc = c - base;
    const int d = cc / nf, k = cc - d * nf;
    return sinf(x[d] * ldexpf(1.0f, k) + HALF_PI);
  }
  if (app && c < 2 * base + 3) return x[c - 2 * base];
  return 0.0f;
}

// out[:, :N] = act(A @ W + b) rounded to bf16, where A = [A0 (K0 wide) | A1
// (K1 wide)] in shared memory and W is (K0 + K1, N) row-major bf16 in device
// memory. `out` may alias A0: every read of A finishes before the epilogue.
template <int N>
__device__ void dense_layer(const bf16* A0, int lda0, int K0, const bf16* A1, int lda1, int K1,
                            const bf16* __restrict__ W, const float* __restrict__ bias, bool relu,
                            bf16* out, int ldo, bf16* wslab, float* stage) {
  constexpr int FM = 4;       // 16-row fragments per warp (64 rows)
  constexpr int FN = N / 64;  // 16-col fragments per warp (N / 4 columns)
  constexpr int LDW = N + 8;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 2, wn = warp & 3;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FM][FN];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  const int ktot = K0 + K1;
  for (int k0 = 0; k0 < ktot; k0 += KSLAB) {
    const int kn = min(KSLAB, ktot - k0);
    __syncthreads();  // the previous slab has been consumed
    constexpr int VPR = N / 8;  // 16-byte vectors per weight row
    for (int i = tid; i < kn * VPR; i += THREADS) {
      const int r = i / VPR, c = (i - r * VPR) * 8;
      *reinterpret_cast<uint4*>(wslab + r * LDW + c) =
          __ldg(reinterpret_cast<const uint4*>(W + (size_t)(k0 + r) * N + c));
    }
    __syncthreads();
    for (int kk = 0; kk < kn; kk += 16) {
      const int k = k0 + kk;
      const bf16* a;
      int lda;
      if (k < K0) {
        a = A0 + k;
        lda = lda0;
      } else {
        a = A1 + (k - K0);
        lda = lda1;
      }
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af[FM];
#pragma unroll
      for (int i = 0; i < FM; ++i) wmma::load_matrix_sync(af[i], a + (wm * 64 + i * 16) * lda, lda);
#pragma unroll
      for (int j = 0; j < FN; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bfr;
        wmma::load_matrix_sync(bfr, wslab + kk * LDW + wn * (N / 4) + j * 16, LDW);
#pragma unroll
        for (int i = 0; i < FM; ++i) wmma::mma_sync(acc[i][j], af[i], bfr, acc[i][j]);
      }
    }
  }
  __syncthreads();  // all reads of A are done: `out` may now be overwritten

  float* st = stage + warp * 256;
#pragma unroll
  for (int i = 0; i < FM; ++i) {
#pragma unroll
    for (int j = 0; j < FN; ++j) {
      wmma::store_matrix_sync(st, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int row0 = wm * 64 + i * 16, col0 = wn * (N / 4) + j * 16;
      for (int e = lane; e < 256; e += 32) {
        const int r = e >> 4, c = e & 15;
        float v = st[e] + bias[col0 + c];
        if (relu) v = fmaxf(v, 0.0f);
        out[(row0 + r) * ldo + col0 + c] = __float2bfloat16(v);
      }
      __syncwarp();
    }
  }
  __syncthreads();
}

__global__ void __launch_bounds__(THREADS, 1) nerf_mlp_fwd_kernel(const Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* act = reinterpret_cast<bf16*>(smem);
  bf16* xemb = reinterpret_cast<bf16*>(smem + ACT_BYTES);
  bf16* demb = reinterpret_cast<bf16*>(smem + ACT_BYTES + XEMB_BYTES);
  bf16* wslab = reinterpret_cast<bf16*>(smem + ACT_BYTES + XEMB_BYTES + DEMB_BYTES);
  float* stage = reinterpret_cast<float*>(smem + ACT_BYTES + XEMB_BYTES + DEMB_BYTES + WSLAB_BYTES);
  float* pts = stage + STAGE_BYTES / 4;
  float* dn = pts + TILE * 3;

  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * TILE;
  const int n = p.n_points;
  const int out_w = 1 + p.color_dim;

  // points and normalized directions of the tile; rows past the end are
  // masked: zeros in, nothing stored
  if (tid < TILE) {
    const int g = row0 + tid;
    float x0 = 0.f, x1 = 0.f, x2 = 0.f, d0 = 0.f, d1 = 0.f, d2 = 0.f;
    if (g < n) {
      x0 = p.points[3 * g];
      x1 = p.points[3 * g + 1];
      x2 = p.points[3 * g + 2];
      const int ray = g / p.pts_per_ray;
      d0 = p.dirs[3 * ray];
      d1 = p.dirs[3 * ray + 1];
      d2 = p.dirs[3 * ray + 2];
    }
    const float nrm = sqrtf(fmaxf(d0 * d0 + d1 * d1 + d2 * d2, 1e-24f));
    pts[3 * tid] = x0;
    pts[3 * tid + 1] = x1;
    pts[3 * tid + 2] = x2;
    dn[3 * tid] = d0 / nrm;
    dn[3 * tid + 1] = d1 / nrm;
    dn[3 * tid + 2] = d2 / nrm;
  }
  __syncthreads();
  for (int e = tid; e < TILE * p.k_xyz; e += THREADS) {
    const int r = e / p.k_xyz, c = e - r * p.k_xyz;
    xemb[r * LDX + c] = __float2bfloat16(embed_value(pts + 3 * r, c, p.nf_xyz, p.app_xyz));
  }
  for (int e = tid; e < TILE * p.k_dir; e += THREADS) {
    const int r = e / p.k_dir, c = e - r * p.k_dir;
    demb[r * LDD + c] = __float2bfloat16(embed_value(dn + 3 * r, c, p.nf_dir, p.app_dir));
  }
  __syncthreads();

  // xyz encoder
  for (int l = 0; l < p.n_layers; ++l) {
    if (l == 0)
      dense_layer<H>(xemb, LDX, p.k_xyz, nullptr, 0, 0, p.w[0], p.b[0], true, act, LDA, wslab, stage);
    else if ((p.skip_mask >> l) & 1)
      dense_layer<H>(act, LDA, H, xemb, LDX, p.k_xyz, p.w[l], p.b[l], true, act, LDA, wslab, stage);
    else
      dense_layer<H>(act, LDA, H, nullptr, 0, 0, p.w[l], p.b[l], true, act, LDA, wslab, stage);
  }
  const int l_int = p.n_layers, l_den = p.n_layers + 1, l_c0 = p.n_layers + 2;

  // density head 256 -> 1: two threads per point, float32 sums of bf16 products
  {
    const int r = tid >> 1, half = tid & 1;
    const bf16* wd = p.w[l_den];
    float s = 0.f;
    for (int k = half * (H / 2); k < (half + 1) * (H / 2); ++k)
      s += __bfloat162float(act[r * LDA + k]) * __bfloat162float(wd[k]);
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    if (half == 0 && row0 + r < n) p.out[(size_t)(row0 + r) * out_w] = s + p.b[l_den][0];
  }

  // intermediate (no relu), then the color layer over [inter | dir embedding]
  dense_layer<H>(act, LDA, H, nullptr, 0, 0, p.w[l_int], p.b[l_int], false, act, LDA, wslab, stage);
  dense_layer<HD>(act, LDA, H, demb, LDD, p.k_dir, p.w[l_c0], p.b[l_c0], true, act, LDA, wslab, stage);
  for (int e = 0; e < p.n_extra_color; ++e)
    dense_layer<HD>(act, LDA, HD, nullptr, 0, 0, p.w[l_c0 + 1 + e], p.b[l_c0 + 1 + e], true, act, LDA,
                    wslab, stage);

  // color head 128 -> color_dim with sigmoid
  {
    const int l_last = l_c0 + 1 + p.n_extra_color;
    const int r = tid >> 1, half = tid & 1;
    const bf16* wc = p.w[l_last];
    for (int c = 0; c < p.color_dim; ++c) {
      float s = 0.f;
      for (int k = half * (HD / 2); k < (half + 1) * (HD / 2); ++k)
        s += __bfloat162float(act[r * LDA + k]) * __bfloat162float(wc[k * p.color_dim + c]);
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      if (half == 0 && row0 + r < n) {
        const float v = s + p.b[l_last][c];
        p.out[(size_t)(row0 + r) * out_w + 1 + c] = 1.0f / (1.0f + expf(-v));
      }
    }
  }
}

int round16(int x) { return (x + 15) / 16 * 16; }

}  // namespace

// Launches the kernel on `stream` and returns cudaGetLastError() (0 on
// success). `w_off`/`b_off` are host arrays of element offsets into the
// packed bf16 weight buffer and the float32 bias buffer, one per tensor in
// kernel order: xyz layers, intermediate, density, color layers.
extern "C" int nerf_mlp_fwd_bf16(const void* points, const void* dirs, void* out, const void* wbuf,
                                 const void* bbuf, const void* w_off, const void* b_off, int n_tensors,
                                 int n_points, int pts_per_ray, int n_layers, int skip_mask, int nf_xyz,
                                 int app_xyz, int nf_dir, int app_dir, int n_extra_color, int color_dim,
                                 void* stream) {
  Params p;
  p.k_xyz = round16(3 * (2 * nf_xyz + (app_xyz ? 1 : 0)));
  p.k_dir = round16(3 * (2 * nf_dir + (app_dir ? 1 : 0)));
  if (n_tensors > MAX_TENSORS || n_tensors != n_layers + 4 + n_extra_color || p.k_xyz > KX_MAX ||
      p.k_dir > KD_MAX || pts_per_ray < 1 || color_dim < 1)
    return (int)cudaErrorInvalidValue;
  const long long* wo = static_cast<const long long*>(w_off);
  const long long* bo = static_cast<const long long*>(b_off);
  for (int i = 0; i < n_tensors; ++i) {
    p.w[i] = static_cast<const bf16*>(wbuf) + wo[i];
    p.b[i] = static_cast<const float*>(bbuf) + bo[i];
  }
  p.points = static_cast<const float*>(points);
  p.dirs = static_cast<const float*>(dirs);
  p.out = static_cast<float*>(out);
  p.n_points = n_points;
  p.pts_per_ray = pts_per_ray;
  p.n_layers = n_layers;
  p.skip_mask = skip_mask;
  p.nf_xyz = nf_xyz;
  p.app_xyz = app_xyz;
  p.nf_dir = nf_dir;
  p.app_dir = app_dir;
  p.n_extra_color = n_extra_color;
  p.color_dim = color_dim;
  if (n_points == 0) return 0;
  cudaError_t err =
      cudaFuncSetAttribute(nerf_mlp_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  const int grid = (n_points + TILE - 1) / TILE;
  nerf_mlp_fwd_kernel<<<grid, THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}
