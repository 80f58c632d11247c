// Device code shared by the fused NeRF-MLP forward kernels: K1
// (nerf_mlp_fwd.cu, one CTA per tile) and K2 (nerf_mlp_fwd_pipelined.cu,
// a persistent CTA whose producer warp group embeds the next tile while
// the consumer warps run the layer chain of the current one).
//
// Both kernels take every floating-point operation of the function from
// this one header, so that they give the same bits: the embedding, the
// direction normalization and the head dot products spell out their
// roundings (__fmul_rn, __fadd_rn, __fmaf_rn), which nvcc may neither
// contract nor split, whatever the inlining context; the layer products
// run the same wmma fragments in the same k-order, with the same float32
// bias add and bf16 rounding in the epilogue. Only the barrier differs
// (the `Sync` policy of dense_layer and mlp_chain).
//
// The function is that of the Pallas TPU kernel
// yanerf_tpu/ops/pallas/nerf_mlp_kernel.py (_nerf_mlp_kernel and its
// pipelined twin _nerf_mlp_kernel_pipelined), with bf16 operands and
// float32 accumulation:
//   * the harmonic embedding of the points (sin | cos | x, frequency-major,
//     cos(t) written as sin(t + pi/2)) and of the normalized per-ray
//     directions, in float32 with the accurate sinf (the phase reaches
//     |x| * 2^9 rad, where a fast-math sine is wrong), rounded to bf16;
//   * the xyz layers, each relu(a @ W + b) rounded to bf16, the skip layers
//     as y @ W[:H] + emb @ W[H:];
//   * the density head (float32 out), the intermediate layer (bf16, no
//     relu), the color layer over [inter, dir embedding] with relu, optional
//     extra color layers, and the sigmoid color head (float32 out).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace nerf_mlp {

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

constexpr int TILE = 128;     // points per tile
constexpr int THREADS = 256;  // 8 warps run the layer chain
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

struct Params {
  const float* points;  // (n_points, 3)
  const float* dirs;    // (n_points / pts_per_ray, 3), one per ray
  float* out;           // (n_points, 1 + color_dim)
  const bf16* w[MAX_TENSORS];
  const float* b[MAX_TENSORS];
  int n_points, pts_per_ray, n_layers, skip_mask;
  int nf_xyz, app_xyz, k_xyz, nf_dir, app_dir, k_dir, n_extra_color, color_dim;
};

// __syncthreads() over the CTA: the layer chain of K1, where all threads run it.
struct CtaSync {
  __device__ __forceinline__ static void sync() { __syncthreads(); }
};

// Named barrier `ID` over the first COUNT threads: the layer chain of K2,
// which its producer warp group does not join.
template <int ID, int COUNT>
struct NamedSync {
  __device__ __forceinline__ static void sync() { asm volatile("bar.sync %0, %1;" ::"n"(ID), "n"(COUNT) : "memory"); }
};

__device__ __forceinline__ float embed_value(const float* x, int c, int nf, int app) {
  const int base = 3 * nf;
  if (c < base) {
    const int d = c / nf, k = c - d * nf;
    return sinf(__fmul_rn(x[d], ldexpf(1.0f, k)));
  }
  if (c < 2 * base) {
    const int cc = c - base;
    const int d = cc / nf, k = cc - d * nf;
    return sinf(__fadd_rn(__fmul_rn(x[d], ldexpf(1.0f, k)), HALF_PI));
  }
  if (app && c < 2 * base + 3) return x[c - 2 * base];
  return 0.0f;
}

// Point `g` into pt[0..2] and its ray's normalized direction into dn[0..2];
// a row past the end gets zeros (masked: nothing of it is stored).
__device__ __forceinline__ void load_point(const Params& p, int g, float* pt, float* dn) {
  float x0 = 0.f, x1 = 0.f, x2 = 0.f, d0 = 0.f, d1 = 0.f, d2 = 0.f;
  if (g < p.n_points) {
    x0 = p.points[3 * g];
    x1 = p.points[3 * g + 1];
    x2 = p.points[3 * g + 2];
    const int ray = g / p.pts_per_ray;
    d0 = p.dirs[3 * ray];
    d1 = p.dirs[3 * ray + 1];
    d2 = p.dirs[3 * ray + 2];
  }
  const float sq = __fmaf_rn(d2, d2, __fmaf_rn(d0, d0, __fmul_rn(d1, d1)));
  const float nrm = sqrtf(fmaxf(sq, 1e-24f));
  pt[0] = x0;
  pt[1] = x1;
  pt[2] = x2;
  dn[0] = __fdiv_rn(d0, nrm);
  dn[1] = __fdiv_rn(d1, nrm);
  dn[2] = __fdiv_rn(d2, nrm);
}

// The bf16 embeddings of one tile (points `pts`, directions `dn`, 3 floats
// per row) into `xemb` / `demb`, element `first`, `first + stride`, ...
__device__ __forceinline__ void embed_tile(const Params& p, const float* pts, const float* dn, bf16* xemb, bf16* demb,
                                           int first, int stride) {
  for (int e = first; e < TILE * p.k_xyz; e += stride) {
    const int r = e / p.k_xyz, c = e - r * p.k_xyz;
    xemb[r * LDX + c] = __float2bfloat16(embed_value(pts + 3 * r, c, p.nf_xyz, p.app_xyz));
  }
  for (int e = first; e < TILE * p.k_dir; e += stride) {
    const int r = e / p.k_dir, c = e - r * p.k_dir;
    demb[r * LDD + c] = __float2bfloat16(embed_value(dn + 3 * r, c, p.nf_dir, p.app_dir));
  }
}

// out[:, :N] = act(A @ W + b) rounded to bf16, where A = [A0 (K0 wide) | A1
// (K1 wide)] in shared memory and W is (K0 + K1, N) row-major bf16 in device
// memory. Run by threads 0..THREADS-1. `out` may alias A0: every read of A
// finishes before the epilogue.
template <int N, class Sync>
__device__ __forceinline__ void dense_layer(const bf16* A0, int lda0, int K0, const bf16* A1, int lda1, int K1,
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
    Sync::sync();  // the previous slab has been consumed
    constexpr int VPR = N / 8;  // 16-byte vectors per weight row
    for (int i = tid; i < kn * VPR; i += THREADS) {
      const int r = i / VPR, c = (i - r * VPR) * 8;
      *reinterpret_cast<uint4*>(wslab + r * LDW + c) =
          __ldg(reinterpret_cast<const uint4*>(W + (size_t)(k0 + r) * N + c));
    }
    Sync::sync();
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
  Sync::sync();  // all reads of A are done: `out` may now be overwritten

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
        float v = __fadd_rn(st[e], bias[col0 + c]);
        if (relu) v = fmaxf(v, 0.0f);
        out[(row0 + r) * ldo + col0 + c] = __float2bfloat16(v);
      }
      __syncwarp();
    }
  }
  Sync::sync();
}

// The layer chain and both heads of the tile whose first point is `row0`,
// from its embeddings `xemb` / `demb`; writes rows row0.. of p.out. Run by
// threads 0..THREADS-1. `act`, `wslab` and `stage` are scratch.
template <class Sync>
__device__ __forceinline__ void mlp_chain(const Params& p, const bf16* xemb, const bf16* demb, bf16* act,
                                          bf16* wslab, float* stage, int row0) {
  const int tid = threadIdx.x;
  const int n = p.n_points;
  const int out_w = 1 + p.color_dim;

  // xyz encoder
  for (int l = 0; l < p.n_layers; ++l) {
    if (l == 0)
      dense_layer<H, Sync>(xemb, LDX, p.k_xyz, nullptr, 0, 0, p.w[0], p.b[0], true, act, LDA, wslab, stage);
    else if ((p.skip_mask >> l) & 1)
      dense_layer<H, Sync>(act, LDA, H, xemb, LDX, p.k_xyz, p.w[l], p.b[l], true, act, LDA, wslab, stage);
    else
      dense_layer<H, Sync>(act, LDA, H, nullptr, 0, 0, p.w[l], p.b[l], true, act, LDA, wslab, stage);
  }
  const int l_int = p.n_layers, l_den = p.n_layers + 1, l_c0 = p.n_layers + 2;

  // density head 256 -> 1: two threads per point, float32 sums of bf16 products
  {
    const int r = tid >> 1, half = tid & 1;
    const bf16* wd = p.w[l_den];
    float s = 0.f;
    for (int k = half * (H / 2); k < (half + 1) * (H / 2); ++k)
      s = __fmaf_rn(__bfloat162float(act[r * LDA + k]), __bfloat162float(wd[k]), s);
    s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, 1));
    if (half == 0 && row0 + r < n) p.out[(size_t)(row0 + r) * out_w] = __fadd_rn(s, p.b[l_den][0]);
  }

  // intermediate (no relu), then the color layer over [inter | dir embedding]
  dense_layer<H, Sync>(act, LDA, H, nullptr, 0, 0, p.w[l_int], p.b[l_int], false, act, LDA, wslab, stage);
  dense_layer<HD, Sync>(act, LDA, H, demb, LDD, p.k_dir, p.w[l_c0], p.b[l_c0], true, act, LDA, wslab, stage);
  for (int e = 0; e < p.n_extra_color; ++e)
    dense_layer<HD, Sync>(act, LDA, HD, nullptr, 0, 0, p.w[l_c0 + 1 + e], p.b[l_c0 + 1 + e], true, act, LDA,
                          wslab, stage);

  // color head 128 -> color_dim with sigmoid
  {
    const int l_last = l_c0 + 1 + p.n_extra_color;
    const int r = tid >> 1, half = tid & 1;
    const bf16* wc = p.w[l_last];
    for (int c = 0; c < p.color_dim; ++c) {
      float s = 0.f;
      for (int k = half * (HD / 2); k < (half + 1) * (HD / 2); ++k)
        s = __fmaf_rn(__bfloat162float(act[r * LDA + k]), __bfloat162float(wc[k * p.color_dim + c]), s);
      s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, 1));
      if (half == 0 && row0 + r < n) {
        const float v = __fadd_rn(s, p.b[l_last][c]);
        p.out[(size_t)(row0 + r) * out_w + 1 + c] = __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-v)));
      }
    }
  }
}

inline int round16(int x) { return (x + 15) / 16 * 16; }

// Fills `p` from the entry points' arguments; returns a cudaError_t (0 if
// they are valid). `w_off`/`b_off` are host arrays of element offsets into
// the packed bf16 weight buffer and the float32 bias buffer, one per tensor
// in kernel order: xyz layers, intermediate, density, color layers.
inline int make_params(Params* p, const void* points, const void* dirs, void* out, const void* wbuf, const void* bbuf,
                       const void* w_off, const void* b_off, int n_tensors, int n_points, int pts_per_ray,
                       int n_layers, int skip_mask, int nf_xyz, int app_xyz, int nf_dir, int app_dir,
                       int n_extra_color, int color_dim) {
  p->k_xyz = round16(3 * (2 * nf_xyz + (app_xyz ? 1 : 0)));
  p->k_dir = round16(3 * (2 * nf_dir + (app_dir ? 1 : 0)));
  if (n_tensors > MAX_TENSORS || n_tensors != n_layers + 4 + n_extra_color || p->k_xyz > KX_MAX ||
      p->k_dir > KD_MAX || pts_per_ray < 1 || color_dim < 1)
    return (int)cudaErrorInvalidValue;
  const long long* wo = static_cast<const long long*>(w_off);
  const long long* bo = static_cast<const long long*>(b_off);
  for (int i = 0; i < n_tensors; ++i) {
    p->w[i] = static_cast<const bf16*>(wbuf) + wo[i];
    p->b[i] = static_cast<const float*>(bbuf) + bo[i];
  }
  p->points = static_cast<const float*>(points);
  p->dirs = static_cast<const float*>(dirs);
  p->out = static_cast<float*>(out);
  p->n_points = n_points;
  p->pts_per_ray = pts_per_ray;
  p->n_layers = n_layers;
  p->skip_mask = skip_mask;
  p->nf_xyz = nf_xyz;
  p->app_xyz = app_xyz;
  p->nf_dir = nf_dir;
  p->app_dir = app_dir;
  p->n_extra_color = n_extra_color;
  p->color_dim = color_dim;
  return 0;
}

}  // namespace nerf_mlp
