// Fused NeRF-MLP backward for Hopper (sm_90a): the weight and bias gradients
// of the fused forward (csrc/nerf_mlp_fwd.cu) given the cotangents of its
// (N, 1 + C) output.
//
// Replaces the Pallas TPU kernel yanerf_tpu/ops/pallas/nerf_mlp_bwd.py
// (_nerf_mlp_bwd_kernel, reached via nerf_mlp_backward_pallas) and computes
// the same function with the same rounding points: bf16 operands and float32
// accumulation, the bias added in float32, the sigmoid's cotangent rounded
// to bf16, every g @ W^T rounded to bf16, ReLU masks taken on the bf16
// activations, dW = a^T g and db = sum(g) summed in float32. The embedding
// is the forward kernel's (accurate sinf, cos(t) = sin(t + pi/2), no
// fast-math: the phases reach |x| * 2^9 rad).
//
// What bounds it: operations. The recomputed forward, the input-gradient
// products and the weight-gradient products come to ~3.5 MFLOP per point
// against ~32 bytes of input per point, far above the card's ~295
// FLOP/byte ridge.
//
// Two things that the TPU kernel keeps on chip do not fit on an SM, and the
// design is three kernels, launched one after another on the stream as one
// launch of K3:
//   * The stash. K3 keeps every layer's input and output of a 1024-point
//     tile in VMEM; here ~10 activations of 256 bf16 per point (5 KB a
//     point) would fill an SM's 227 KB at 44 points. Pass 1
//     (nerf_mlp_bwd_tile_kernel, one CTA per 64 points) recomputes the
//     forward and the backward chain with the current activation in shared
//     memory only, and writes each layer's input (bf16, 5,088 B a point) and
//     each layer's output cotangent (bf16, 4,928 B a point) to a stash in
//     device memory. Recomputing instead would redo the forward once per
//     layer; storing costs ~2 GB of traffic at a train step's 196,608
//     points.
//   * The resident gradients. K3 zeroes grid-resident float32 gradient
//     blocks in program 0 and adds into them step after step, which relies
//     on the TPU grid running in order; the 2.4 MB of float32 gradients do
//     not fit in one SM, and Hopper CTAs run in no order. Pass 2
//     (nerf_mlp_dw_kernel) computes dW = a^T g from the stash as a split-K
//     product: one CTA per 64x64 block of a dW, per slice of the points,
//     writing its partial sum to its own slot; db is the same product
//     against a column of ones. Pass 3 (nerf_mlp_dw_reduce_kernel) sums the
//     slices in a fixed order, so the result is the same from run to run.
//     No atomics.
// The products run on the tensor cores (wmma bf16 16x16x16, float32
// accumulators). The weights (~1.2 MB bf16) stream through shared memory in
// slabs from L2: in pass 1 each weight matrix is read twice, as W in the
// recomputed forward and as W^T in g @ W^T. wgmma, TMA and a pipelined
// weight stream are later work.
//
// Built with nvcc into a shared library with a plain C entry point
// (nerf_mlp_bwd_bf16), loaded with ctypes by ops/kernels/nerf_mlp_bwd.py.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int TILE = 64;      // points per CTA of pass 1
constexpr int THREADS = 256;  // 8 warps
constexpr int H = 256;        // xyz hidden width
constexpr int HD = 128;       // color hidden width
constexpr int KX_MAX = 64;    // padded xyz-embedding width
constexpr int KD_MAX = 32;    // padded dir-embedding width
constexpr int MAXC = 4;       // color channels
constexpr int MAX_LAYERS = 8;
constexpr int MAX_TENSORS = MAX_LAYERS + 4;
constexpr int KSLAB = 64;     // forward: weight rows staged per pass
constexpr int NSLAB = 64;     // backward: weight columns staged per pass
constexpr int LDB = H + 8;    // row pitch of the activation / cotangent buffer
constexpr int LDX = KX_MAX + 8;
constexpr int LDD = KD_MAX + 8;
constexpr int LDWT = NSLAB + 8;
constexpr float HALF_PI = 1.57079632679489661923f;

constexpr int BUF_BYTES = TILE * LDB * 2;
constexpr int XEMB_BYTES = TILE * LDX * 2;
constexpr int DEMB_BYTES = TILE * LDD * 2;
constexpr int WSLAB_FWD_BYTES = KSLAB * (H + 8) * 2;
constexpr int WSLAB_BWD_BYTES = H * LDWT * 2;
constexpr int WSLAB_BYTES = WSLAB_FWD_BYTES > WSLAB_BWD_BYTES ? WSLAB_FWD_BYTES : WSLAB_BWD_BYTES;
constexpr int STAGE_BYTES = (THREADS / 32) * 256 * 4;
constexpr int VEC_FLOATS = TILE * (3 + 3 + (1 + MAXC) + MAXC + MAXC + 1);
constexpr int SMEM_BYTES = BUF_BYTES + XEMB_BYTES + DEMB_BYTES + WSLAB_BYTES + STAGE_BYTES + VEC_FLOATS * 4;

// Stash layouts, bf16 elements per point (ops/kernels/nerf_mlp_bwd.py::stash_widths).
// Activations: ones | xyz embedding | layer outputs | intermediate | dir embedding | color hidden.
__host__ __device__ constexpr int a_ones() { return 0; }
__host__ __device__ constexpr int a_emb() { return 16; }
__host__ __device__ constexpr int a_y(int l) { return 80 + H * l; }
__host__ __device__ constexpr int a_inter(int nl) { return a_y(nl); }
__host__ __device__ constexpr int a_demb(int nl) { return a_inter(nl) + H; }
__host__ __device__ constexpr int a_cact(int nl) { return a_demb(nl) + KD_MAX; }
__host__ __device__ constexpr int a_width(int nl) { return a_cact(nl) + HD; }
// Cotangents of the layer outputs: xyz layers | intermediate | density | color hidden | color head.
__host__ __device__ constexpr int g_y(int l) { return H * l; }
__host__ __device__ constexpr int g_inter(int nl) { return g_y(nl); }
__host__ __device__ constexpr int g_den(int nl) { return g_inter(nl) + H; }
__host__ __device__ constexpr int g_c0(int nl) { return g_den(nl) + 16; }
__host__ __device__ constexpr int g_z(int nl) { return g_c0(nl) + HD; }
__host__ __device__ constexpr int g_width(int nl) { return g_z(nl) + 16; }

struct Params {
  const float* points;  // (n_points, 3)
  const float* dirs;    // (n_points / pts_per_ray, 3), one per ray
  const float* g;       // (n_points, 1 + color_dim) cotangent of density | rgb
  bf16* sa;             // (n_pad, lda) activation stash
  bf16* sg;             // (n_pad, ldg) cotangent stash
  const bf16* w[MAX_TENSORS];
  const float* b[MAX_TENSORS];
  int n_points, pts_per_ray, n_layers, skip_mask;
  int nf_xyz, app_xyz, k_xyz, nf_dir, app_dir, k_dir, color_dim;
  int lda, ldg;
};

// One dW (and its db) of pass 2: rows [0, a_rows0) of the layer input come
// from stash column a_off0, rows [a_rows0, k_rows) from column a_off1.
struct LayerDesc {
  int a_off0, a_rows0, a_off1, k_rows, n_cols, g_off;
  long long w_off, b_off;
};

struct DwParams {
  const bf16* sa;
  const bf16* sg;
  float* part;  // (n_split, total)
  int lda, ldg, n_pad, chunk, n_desc;
  long long total, w_total;
  LayerDesc d[MAX_TENSORS];
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

__device__ __forceinline__ float round_bf16(float v) { return __bfloat162float(__float2bfloat16(v)); }

// dst[r * ldd + c] = src[r * lds + c] for the tile's rows, `cols` a multiple of 8.
__device__ void copy_rows(const bf16* src, int lds, bf16* dst, int ldd, int cols) {
  const int vpr = cols / 8;
  for (int i = threadIdx.x; i < TILE * vpr; i += THREADS) {
    const int r = i / vpr, c = (i - r * vpr) * 8;
    *reinterpret_cast<uint4*>(dst + (size_t)r * ldd + c) = *reinterpret_cast<const uint4*>(src + r * lds + c);
  }
}

// out[:, :N] = act(A @ W + b) rounded to bf16 (the forward kernel's layer at
// 64 rows), A = [A0 (K0 wide) | A1 (K1 wide)] in shared memory, W (K0 + K1, N)
// row-major bf16 in device memory. `out` may alias A0.
template <int N>
__device__ void dense_fwd(const bf16* A0, int lda0, int K0, const bf16* A1, int lda1, int K1,
                          const bf16* __restrict__ W, const float* __restrict__ bias, bool relu, bf16* out,
                          int ldo, bf16* wslab, float* stage) {
  constexpr int FM = 2;       // 16-row fragments per warp (32 rows)
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
    __syncthreads();
    constexpr int VPR = N / 8;
    for (int i = tid; i < kn * VPR; i += THREADS) {
      const int r = i / VPR, c = (i - r * VPR) * 8;
      *reinterpret_cast<uint4*>(wslab + r * LDW + c) =
          __ldg(reinterpret_cast<const uint4*>(W + (size_t)(k0 + r) * N + c));
    }
    __syncthreads();
    for (int kk = 0; kk < kn; kk += 16) {
      const int k = k0 + kk;
      const bf16* a = k < K0 ? A0 + k : A1 + (k - K0);
      const int lda = k < K0 ? lda0 : lda1;
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af[FM];
#pragma unroll
      for (int i = 0; i < FM; ++i) wmma::load_matrix_sync(af[i], a + (wm * 32 + i * 16) * lda, lda);
#pragma unroll
      for (int j = 0; j < FN; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bfr;
        wmma::load_matrix_sync(bfr, wslab + kk * LDW + wn * (N / 4) + j * 16, LDW);
#pragma unroll
        for (int i = 0; i < FM; ++i) wmma::mma_sync(acc[i][j], af[i], bfr, acc[i][j]);
      }
    }
  }
  __syncthreads();  // every read of A is done: `out` may be overwritten

  float* st = stage + warp * 256;
#pragma unroll
  for (int i = 0; i < FM; ++i) {
#pragma unroll
    for (int j = 0; j < FN; ++j) {
      wmma::store_matrix_sync(st, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int row0 = wm * 32 + i * 16, col0 = wn * (N / 4) + j * 16;
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

// The cotangent of a layer input: out[:, :H] = bf16(G @ W^T), G (64, nred)
// in shared memory, W (>= H rows, nred) row-major in device memory (only its
// first H rows: the skip layer's embedding rows carry no gradient on). The
// epilogue optionally adds the density head's bf16(g_den * w_den), masks with
// the ReLU of the stashed activation at column `mask_off` (-1: no mask), and
// writes the result to `buf` (in place) and to the cotangent stash at column
// `gout_off`.
__device__ void dense_t(bf16* buf, int nred, const bf16* __restrict__ W, const float* gden,
                        const bf16* __restrict__ wden, int mask_off, int gout_off, const Params& p, int row0g,
                        bf16* wslab, float* stage) {
  constexpr int FM = 2, FN = H / 64;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 2, wn = warp & 3;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FM][FN];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  for (int n0 = 0; n0 < nred; n0 += NSLAB) {
    __syncthreads();
    constexpr int VPR = NSLAB / 8;
    for (int i = tid; i < H * VPR; i += THREADS) {
      const int r = i / VPR, c = (i - r * VPR) * 8;
      *reinterpret_cast<uint4*>(wslab + r * LDWT + c) =
          __ldg(reinterpret_cast<const uint4*>(W + (size_t)r * nred + n0 + c));
    }
    __syncthreads();
#pragma unroll
    for (int nn = 0; nn < NSLAB; nn += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af[FM];
#pragma unroll
      for (int i = 0; i < FM; ++i) wmma::load_matrix_sync(af[i], buf + (wm * 32 + i * 16) * LDB + n0 + nn, LDB);
#pragma unroll
      for (int j = 0; j < FN; ++j) {
        // W^T (n, k) = W[k * LDWT + n]: column-major in the slab
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bfr;
        wmma::load_matrix_sync(bfr, wslab + (wn * (H / 4) + j * 16) * LDWT + nn, LDWT);
#pragma unroll
        for (int i = 0; i < FM; ++i) wmma::mma_sync(acc[i][j], af[i], bfr, acc[i][j]);
      }
    }
  }
  __syncthreads();  // every read of buf is done

  float* st = stage + warp * 256;
#pragma unroll
  for (int i = 0; i < FM; ++i) {
#pragma unroll
    for (int j = 0; j < FN; ++j) {
      wmma::store_matrix_sync(st, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int row0 = wm * 32 + i * 16, col0 = wn * (H / 4) + j * 16;
      for (int e = lane; e < 256; e += 32) {
        const int r = row0 + (e >> 4), k = col0 + (e & 15);
        float v = round_bf16(st[e]);
        if (gden != nullptr) v = round_bf16(v + round_bf16(gden[r] * __bfloat162float(wden[k])));
        if (mask_off >= 0 && !(__bfloat162float(p.sa[(size_t)(row0g + r) * p.lda + mask_off + k]) > 0.0f)) v *= 0.0f;
        const bf16 o = __float2bfloat16(v);
        buf[r * LDB + k] = o;
        p.sg[(size_t)(row0g + r) * p.ldg + gout_off + k] = o;
      }
      __syncwarp();
    }
  }
  __syncthreads();
}

// Pass 1: per tile of 64 points, recompute the forward and the backward
// chain, stashing every layer input and every layer-output cotangent.
__global__ void __launch_bounds__(THREADS, 1) nerf_mlp_bwd_tile_kernel(const Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* buf = reinterpret_cast<bf16*>(smem);
  bf16* xemb = reinterpret_cast<bf16*>(smem + BUF_BYTES);
  bf16* demb = reinterpret_cast<bf16*>(smem + BUF_BYTES + XEMB_BYTES);
  bf16* wslab = reinterpret_cast<bf16*>(smem + BUF_BYTES + XEMB_BYTES + DEMB_BYTES);
  float* stage = reinterpret_cast<float*>(smem + BUF_BYTES + XEMB_BYTES + DEMB_BYTES + WSLAB_BYTES);
  float* pts = stage + STAGE_BYTES / 4;
  float* dn = pts + TILE * 3;
  float* gin = dn + TILE * 3;      // (TILE, 1 + MAXC)
  float* col = gin + TILE * (1 + MAXC);  // (TILE, MAXC) sigmoid output
  float* gz = col + TILE * MAXC;   // (TILE, MAXC) bf16-rounded sigmoid cotangent
  float* gden = gz + TILE * MAXC;  // (TILE) bf16-rounded density cotangent

  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * TILE;
  const int n = p.n_points, nl = p.n_layers, C = p.color_dim;
  bf16* sa = p.sa + (size_t)row0 * p.lda;
  bf16* sg = p.sg + (size_t)row0 * p.ldg;

  // inputs of the tile; rows past the end get zero points and zero
  // cotangents, so they add nothing to any gradient
  if (tid < TILE) {
    const int gi = row0 + tid;
    float x[3] = {0.f, 0.f, 0.f}, d[3] = {0.f, 0.f, 0.f};
    for (int c = 0; c <= MAXC; ++c) gin[tid * (1 + MAXC) + c] = 0.f;
    if (gi < n) {
      const int ray = gi / p.pts_per_ray;
      for (int c = 0; c < 3; ++c) {
        x[c] = p.points[3 * gi + c];
        d[c] = p.dirs[3 * ray + c];
      }
      for (int c = 0; c <= C; ++c) gin[tid * (1 + MAXC) + c] = p.g[(size_t)gi * (1 + C) + c];
    }
    const float nrm = sqrtf(fmaxf(d[0] * d[0] + d[1] * d[1] + d[2] * d[2], 1e-24f));
    for (int c = 0; c < 3; ++c) {
      pts[3 * tid + c] = x[c];
      dn[3 * tid + c] = d[c] / nrm;
    }
  }
  __syncthreads();
  for (int e = tid; e < TILE * KX_MAX; e += THREADS) {
    const int r = e / KX_MAX, c = e - r * KX_MAX;
    xemb[r * LDX + c] = __float2bfloat16(c < p.k_xyz ? embed_value(pts + 3 * r, c, p.nf_xyz, p.app_xyz) : 0.0f);
  }
  for (int e = tid; e < TILE * KD_MAX; e += THREADS) {
    const int r = e / KD_MAX, c = e - r * KD_MAX;
    demb[r * LDD + c] = __float2bfloat16(c < p.k_dir ? embed_value(dn + 3 * r, c, p.nf_dir, p.app_dir) : 0.0f);
  }
  for (int e = tid; e < TILE * 16; e += THREADS) {
    const int r = e >> 4, c = e & 15;
    sa[(size_t)r * p.lda + a_ones() + c] = __float2bfloat16(c == 0 ? 1.0f : 0.0f);
  }
  __syncthreads();
  copy_rows(xemb, LDX, sa + a_emb(), p.lda, KX_MAX);
  copy_rows(demb, LDD, sa + a_demb(nl), p.lda, KD_MAX);

  // ---- recompute the forward, stashing every layer output ----------------
  for (int l = 0; l < nl; ++l) {
    if (l == 0)
      dense_fwd<H>(xemb, LDX, p.k_xyz, nullptr, 0, 0, p.w[0], p.b[0], true, buf, LDB, wslab, stage);
    else if ((p.skip_mask >> l) & 1)
      dense_fwd<H>(buf, LDB, H, xemb, LDX, p.k_xyz, p.w[l], p.b[l], true, buf, LDB, wslab, stage);
    else
      dense_fwd<H>(buf, LDB, H, nullptr, 0, 0, p.w[l], p.b[l], true, buf, LDB, wslab, stage);
    copy_rows(buf, LDB, sa + a_y(l), p.lda, H);
  }
  const int l_int = nl, l_den = nl + 1, l_c0 = nl + 2, l_last = nl + 3;
  dense_fwd<H>(buf, LDB, H, nullptr, 0, 0, p.w[l_int], p.b[l_int], false, buf, LDB, wslab, stage);
  copy_rows(buf, LDB, sa + a_inter(nl), p.lda, H);
  dense_fwd<HD>(buf, LDB, H, demb, LDD, p.k_dir, p.w[l_c0], p.b[l_c0], true, buf, LDB, wslab, stage);
  copy_rows(buf, LDB, sa + a_cact(nl), p.lda, HD);

  // color head 128 -> C with sigmoid: four threads per point
  {
    const int r = tid >> 2, q = tid & 3;
    const bf16* wc = p.w[l_last];
    for (int c = 0; c < C; ++c) {
      float s = 0.f;
      for (int k = q * (HD / 4); k < (q + 1) * (HD / 4); ++k)
        s += __bfloat162float(buf[r * LDB + k]) * __bfloat162float(wc[k * C + c]);
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      if (q == 0) col[r * MAXC + c] = 1.0f / (1.0f + expf(-(s + p.b[l_last][c])));
    }
  }
  __syncthreads();

  // ---- backward ----------------------------------------------------------
  // sigmoid and density cotangents, bf16 (stash blocks padded to 16 columns)
  for (int e = tid; e < TILE * 16; e += THREADS) {
    const int r = e >> 4, c = e & 15;
    float vz = 0.f, vd = 0.f;
    if (c < C) {
      const float cv = col[r * MAXC + c];
      vz = round_bf16(gin[r * (1 + MAXC) + 1 + c] * cv * (1.0f - cv));
      gz[r * MAXC + c] = vz;
    }
    if (c == 0) {
      vd = round_bf16(gin[r * (1 + MAXC)]);
      gden[r] = vd;
    }
    sg[(size_t)r * p.ldg + g_z(nl) + c] = __float2bfloat16(vz);
    sg[(size_t)r * p.ldg + g_den(nl) + c] = __float2bfloat16(vd);
  }
  __syncthreads();
  // cotangent of the color hidden layer: bf16(gz @ W_last^T), masked by its ReLU (buf holds it)
  {
    const bf16* wl = p.w[l_last];
    for (int e = tid; e < TILE * HD; e += THREADS) {
      const int r = e / HD, j = e - r * HD;
      float s = 0.f;
      for (int c = 0; c < C; ++c) s += gz[r * MAXC + c] * __bfloat162float(wl[j * C + c]);
      float v = round_bf16(s);
      if (!(__bfloat162float(buf[r * LDB + j]) > 0.0f)) v *= 0.0f;
      const bf16 o = __float2bfloat16(v);
      buf[r * LDB + j] = o;
      sg[(size_t)r * p.ldg + g_c0(nl) + j] = o;
    }
  }
  __syncthreads();
  // intermediate: only the hidden rows of the first color layer carry the gradient on
  dense_t(buf, HD, p.w[l_c0], nullptr, nullptr, -1, g_inter(nl), p, row0, wslab, stage);
  // features: intermediate and density heads, then the ReLU of the last xyz layer
  dense_t(buf, H, p.w[l_int], gden, p.w[l_den], a_y(nl - 1), g_y(nl - 1), p, row0, wslab, stage);
  for (int l = nl - 1; l >= 1; --l)
    dense_t(buf, H, p.w[l], nullptr, nullptr, a_y(l - 1), g_y(l - 1), p, row0, wslab, stage);
}

// Pass 2: dW (or db) block of 64 rows x 64 columns over one slice of the
// points: a^T g from the stashes, float32 partial sums to the slice's slot.
__global__ void __launch_bounds__(128) nerf_mlp_dw_kernel(const DwParams p) {
  __shared__ __align__(128) bf16 sA[64 * 72];
  __shared__ __align__(128) bf16 sG[64 * 72];
  __shared__ __align__(128) float stage[4 * 256];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  int job = blockIdx.x, li = 0, kb = 0, nb = 0;
  for (; li < p.n_desc; ++li) {
    const int kbl = (p.d[li].k_rows + 63) / 64 + 1, nbl = (p.d[li].n_cols + 63) / 64;
    if (job < kbl * nbl) {
      kb = job / nbl;
      nb = job - kb * nbl;
      break;
    }
    job -= kbl * nbl;
  }
  if (li == p.n_desc) return;
  const LayerDesc d = p.d[li];
  const bool bias = kb == (d.k_rows + 63) / 64;  // the last row block is db, against the ones column
  int a_col, kr;
  if (bias) {
    a_col = a_ones();
    kr = 16;
  } else {
    const int k0 = kb * 64;
    kr = min(64, d.k_rows - k0);
    a_col = k0 < d.a_rows0 ? d.a_off0 + k0 : d.a_off1 + (k0 - d.a_rows0);
  }
  const int j0 = nb * 64, nc = min(64, d.n_cols - j0), ncp = (nc + 15) / 16 * 16;
  const int g_col = d.g_off + j0;
  const int p0 = blockIdx.y * p.chunk, p1 = min(p.n_pad, p0 + p.chunk);
  const bool active = warp * 16 < kr;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[j], 0.0f);

  for (int pt = p0; pt < p1; pt += 64) {
    __syncthreads();
    const int va = kr / 8, vg = ncp / 8;
    for (int i = tid; i < 64 * va; i += 128) {
      const int r = i / va, c = (i - r * va) * 8;
      *reinterpret_cast<uint4*>(sA + r * 72 + c) =
          *reinterpret_cast<const uint4*>(p.sa + (size_t)(pt + r) * p.lda + a_col + c);
    }
    for (int i = tid; i < 64 * vg; i += 128) {
      const int r = i / vg, c = (i - r * vg) * 8;
      *reinterpret_cast<uint4*>(sG + r * 72 + c) =
          *reinterpret_cast<const uint4*>(p.sg + (size_t)(pt + r) * p.ldg + g_col + c);
    }
    __syncthreads();
    if (active) {
#pragma unroll
      for (int pp = 0; pp < 64; pp += 16) {
        // a^T (k, point) = sA[point * 72 + k]: column-major
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> af;
        wmma::load_matrix_sync(af, sA + pp * 72 + warp * 16, 72);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (j * 16 < ncp) {
            wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bfr;
            wmma::load_matrix_sync(bfr, sG + pp * 72 + j * 16, 72);
            wmma::mma_sync(acc[j], af, bfr, acc[j]);
          }
        }
      }
    }
  }
  if (!active) return;
  float* st = stage + warp * 256;
  float* out = p.part + (size_t)blockIdx.y * p.total;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (j * 16 >= ncp) continue;
    wmma::store_matrix_sync(st, acc[j], 16, wmma::mem_row_major);
    __syncwarp();
    for (int e = lane; e < 256; e += 32) {
      const int k = warp * 16 + (e >> 4), jj = j * 16 + (e & 15);
      if (k >= kr || jj >= nc) continue;
      if (bias) {
        if (k == 0) out[p.w_total + d.b_off + j0 + jj] = st[e];
      } else {
        out[d.w_off + (size_t)(kb * 64 + k) * d.n_cols + j0 + jj] = st[e];
      }
    }
    __syncwarp();
  }
}

// Pass 3: sum the slices' partials in a fixed order.
__global__ void nerf_mlp_dw_reduce_kernel(const float* __restrict__ part, float* __restrict__ out, long long total,
                                          int n_split) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  float s = 0.f;
  for (int sp = 0; sp < n_split; ++sp) s += part[(size_t)sp * total + i];
  out[i] = s;
}

int round16(int x) { return (x + 15) / 16 * 16; }

}  // namespace

// Launches the three passes on `stream` and returns the first CUDA error (0
// on success). `w_off`/`b_off` are host arrays of element offsets into the
// packed bf16 weights and float32 biases, one per tensor in kernel order (xyz
// layers, intermediate, density, color layers); the gradients come out in
// the same layout in `out` ([weights | biases], float32). The caller
// allocates the stashes (n_pad x lda, n_pad x ldg bf16, n_pad = n_points
// rounded up to 64) and the zeroed partials (n_split x (w_total + b_total)).
extern "C" int nerf_mlp_bwd_bf16(const void* points, const void* dirs, const void* g, const void* wbuf,
                                 const void* bbuf, const void* w_off, const void* b_off, void* stash_a,
                                 int n_tensors, int n_points, int pts_per_ray, int n_layers, int skip_mask,
                                 int nf_xyz, int app_xyz, int nf_dir, int app_dir, int n_extra_color, int color_dim,
                                 int lda, int ldg, int w_total, int b_total, int n_split, void* stash_g,
                                 void* partials, void* out, void* stream) {
  Params p;
  p.k_xyz = round16(3 * (2 * nf_xyz + (app_xyz ? 1 : 0)));
  p.k_dir = round16(3 * (2 * nf_dir + (app_dir ? 1 : 0)));
  if (n_layers < 1 || n_layers > MAX_LAYERS || n_tensors != n_layers + 4 || n_extra_color != 0 ||
      p.k_xyz > KX_MAX || p.k_dir > KD_MAX || pts_per_ray < 1 || color_dim < 1 || color_dim > MAXC ||
      lda != a_width(n_layers) || ldg != g_width(n_layers) || n_split < 1)
    return (int)cudaErrorInvalidValue;
  if (n_points == 0) return 0;
  const long long* wo = static_cast<const long long*>(w_off);
  const long long* bo = static_cast<const long long*>(b_off);
  for (int i = 0; i < n_tensors; ++i) {
    p.w[i] = static_cast<const bf16*>(wbuf) + wo[i];
    p.b[i] = static_cast<const float*>(bbuf) + bo[i];
  }
  p.points = static_cast<const float*>(points);
  p.dirs = static_cast<const float*>(dirs);
  p.g = static_cast<const float*>(g);
  p.sa = static_cast<bf16*>(stash_a);
  p.sg = static_cast<bf16*>(stash_g);
  p.n_points = n_points;
  p.pts_per_ray = pts_per_ray;
  p.n_layers = n_layers;
  p.skip_mask = skip_mask;
  p.nf_xyz = nf_xyz;
  p.app_xyz = app_xyz;
  p.nf_dir = nf_dir;
  p.app_dir = app_dir;
  p.color_dim = color_dim;
  p.lda = lda;
  p.ldg = ldg;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_pad = (n_points + TILE - 1) / TILE * TILE;

  cudaError_t err =
      cudaFuncSetAttribute(nerf_mlp_bwd_tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  nerf_mlp_bwd_tile_kernel<<<n_pad / TILE, THREADS, SMEM_BYTES, st>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  DwParams q;
  q.sa = p.sa;
  q.sg = p.sg;
  q.part = static_cast<float*>(partials);
  q.lda = lda;
  q.ldg = ldg;
  q.n_pad = n_pad;
  q.total = (long long)w_total + b_total;
  q.w_total = w_total;
  q.n_desc = n_tensors;
  const int l_int = n_layers, l_den = n_layers + 1, l_c0 = n_layers + 2, l_last = n_layers + 3;
  int jobs = 0;
  for (int i = 0; i < n_tensors; ++i) {
    LayerDesc& d = q.d[i];
    d.a_off1 = 0;
    if (i < n_layers) {
      const bool skip = i > 0 && ((skip_mask >> i) & 1);
      d.a_off0 = i == 0 ? a_emb() : a_y(i - 1);
      d.a_rows0 = i == 0 ? p.k_xyz : H;
      d.a_off1 = skip ? a_emb() : 0;
      d.k_rows = i == 0 ? p.k_xyz : (skip ? H + p.k_xyz : H);
      d.n_cols = H;
      d.g_off = g_y(i);
    } else if (i == l_int || i == l_den) {
      d.a_off0 = a_y(n_layers - 1);
      d.a_rows0 = d.k_rows = H;
      d.n_cols = i == l_int ? H : 1;
      d.g_off = i == l_int ? g_inter(n_layers) : g_den(n_layers);
    } else if (i == l_c0) {  // [intermediate | dir embedding], adjacent in the stash
      d.a_off0 = a_inter(n_layers);
      d.a_rows0 = d.k_rows = H + p.k_dir;
      d.n_cols = HD;
      d.g_off = g_c0(n_layers);
    } else {  // l_last
      d.a_off0 = a_cact(n_layers);
      d.a_rows0 = d.k_rows = HD;
      d.n_cols = color_dim;
      d.g_off = g_z(n_layers);
    }
    (void)l_last;
    d.w_off = wo[i];
    d.b_off = bo[i];
    jobs += ((d.k_rows + 63) / 64 + 1) * ((d.n_cols + 63) / 64);
  }
  q.chunk = ((n_pad + n_split - 1) / n_split + 63) / 64 * 64;
  nerf_mlp_dw_kernel<<<dim3(jobs, n_split), 128, 0, st>>>(q);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const long long total = q.total;
  nerf_mlp_dw_reduce_kernel<<<(unsigned)((total + 255) / 256), 256, 0, st>>>(static_cast<float*>(partials),
                                                                              static_cast<float*>(out), total,
                                                                              n_split);
  return (int)cudaGetLastError();
}
