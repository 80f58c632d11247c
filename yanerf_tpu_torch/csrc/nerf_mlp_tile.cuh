// The NeRF-MLP forward tile engine on Hopper (sm_90a), shared by the
// forward kernels K1 (nerf_mlp_fwd.cu) and K2 (nerf_mlp_fwd_pipelined.cu)
// and by the backward K3 (nerf_mlp_bwd.cu), whose tile pass recomputes the
// same forward before its backward chain. Built on hopper.cuh (wgmma, TMA,
// mbarriers) and nerf_mlp_fwd.cuh (the embedding).
//
// The pieces, in the order a tile meets them:
//   * embed_pairs: the bf16 harmonic embedding of the points into a
//     128B-swizzled chunk (64 columns), the A operand's tail of layer 0, the
//     skip layers and the first color layer (K3 copies it to its stash);
//   * the weight Ring and load_forward_slabs: one producer thread streams
//     every weight slab of a tile's forward (64 rows x 256 or 128 columns of
//     the row-major W, an MN-major B) by TMA through a ring of full/empty
//     mbarriers, in layer order, tile after tile;
//   * gemm_tb: a consumer warp group's acc = A @ B over slabs of the ring,
//     wgmma m64n256k16 / m64n128k16, A the activations (K-major) in shared
//     memory;
//   * epilogue_fwd: bf16(relu(acc + bias)) from the registers straight into
//     the swizzled activation buffer, which is the next layer's A;
//     optionally with the ReLU bits K3's backward needs;
//   * the vector ring (VecRing, fill_vec): one producer warp copies each
//     step's bias, or the density or color head's weights, into shared
//     memory ahead of the consumers, so that no epilogue waits on device
//     memory;
//   * the heads on the CUDA cores: density_logit (256 -> 1), color_logits
//     and sigmoid_rn (128 -> C, sigmoid).
//   * fwd_kernel_body: K1 and K2 themselves (a template on PIPELINED): a
//     persistent CTA per SM walking 128-point tiles; warp group 2 is the
//     producer group, warp groups 0-1 the consumers, 64 points each.
//
// Because K1, K2 and K3 run one engine, K1's activations are bit for bit
// the forward that K3 recomputes: K3's ReLU masks are those of the forward
// that produced the output. K2 differs from K1 only in who embeds (idle
// producer-group warps, into a double-buffered slot) and in its ring depth;
// the wgmma order, the epilogues and the heads are the same code, so its
// output is K1's, bit for bit.
//
// Every layer's product runs each slab's four k16 steps, the same
// instructions on every path, so that nothing but wgmma defines the
// accumulator: A's columns past a layer's K are zero (the embedding writes
// zeros past its width), and B's rows there are the next tensor's (finite)
// or past the end of the buffer (TMA reads zeros).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"
#include "nerf_mlp_fwd.cuh"

namespace nerf_mlp {

using namespace hopper;
typedef __nv_bfloat16 bf16;

constexpr int H = 256;         // xyz hidden width
constexpr int HD = 128;        // color hidden width
constexpr int KX_MAX = 64;     // padded xyz-embedding width (10 frequencies -> 63 -> 64)
constexpr int KD_MAX = 32;     // padded dir-embedding width (4 frequencies -> 27 -> 32)
constexpr int MAXC = 4;        // color channels
constexpr int MAX_LAYERS = 8;
constexpr int MAX_EXTRA = 2;   // extra color layers (nerf_paper_v1: n_layers / 4)
constexpr int MAX_TENSORS = MAX_LAYERS + 4 + MAX_EXTRA;

constexpr int WG = 128;                  // threads of a warp group
constexpr int CONSUMERS = 2 * WG;        // warp groups 0-1
constexpr int THREADS = CONSUMERS + WG;  // + the producer warp group
constexpr int CONSUMER_REGS = 232;
constexpr int PRODUCER_REGS = 40;
constexpr int EMPTY_ARRIVALS = CONSUMERS / 32;  // one per consumer warp

constexpr int TILE = 128;                // points per tile, 64 per consumer warp group
constexpr int SLAB_BYTES = 64 * H * 2;   // a 64 x 256 bf16 weight slab
constexpr int CHUNK_BYTES = TILE * 128;  // 64 columns x 128 rows of the activation buffer
constexpr int WG_ROWS_BYTES = 64 * 128;  // one warp group's rows of a chunk
constexpr int VEC_FLOATS = H + MAXC;     // a step's vector: a bias (<= 256 floats), or a head's weights and bias

__device__ __forceinline__ unsigned char* aligned_smem(unsigned char* raw) {
  return raw + ((1024 - (smem_u32(raw) & 1023)) & 1023);
}

// ---- the embedding ---------------------------------------------------------

// The bf16 harmonic embedding (sin | cos | x, frequency-major; nerf_mlp_fwd.cuh
// says why every rounding is spelled out) of rows 0 .. rows-1 of the points
// at pv[r * PSTRIDE + v_off ..], by the threads `first`, `first + stride`,
// ...; into a 128B-swizzled chunk (SWIZZLED, 64 columns) or plain rows of
// `width` columns at shared address `dst`, zeros past the embedding up to
// `width`. One (point, coordinate, frequency) pair a step, whose sine and
// cosine (sin(t + pi/2)) come from one t = x_d * 2^k (2^k exact); then the
// tail columns. A step per column instead would leave the lanes of a warp
// diverging between the sine, cosine, x and zero cases and each value
// paying its column's integer arithmetic: K1 built so took 1.78 ms at
// 392,640 points against 1.09 ms (NVIDIA H100 80GB HBM3, 700.00 W).
template <bool SWIZZLED, int PSTRIDE>
__device__ __forceinline__ void embed_pairs(const float* pv, int v_off, int rows, int nf, int app, uint32_t dst,
                                            int width, int first, int stride) {
  auto at = [&](int r, int c) -> uint32_t {
    return SWIZZLED ? dst + sw128_offset(r, c) : dst + r * (width * 2) + c * 2;
  };
  const int pairs = 3 * nf;
  for (int u = first; u < rows * pairs; u += stride) {
    const int r = u / pairs, j = u - r * pairs;
    const int d = j / nf, k = j - d * nf;
    const float t = __fmul_rn(pv[r * PSTRIDE + v_off + d], __int_as_float((127 + k) << 23));
    st_shared_b16(at(r, j), __bfloat16_as_ushort(__float2bfloat16_rn(sinf(t))));
    st_shared_b16(at(r, pairs + j), __bfloat16_as_ushort(__float2bfloat16_rn(sinf(__fadd_rn(t, HALF_PI)))));
  }
  const int tail = width - 2 * pairs;
  for (int u = first; u < rows * tail; u += stride) {
    const int r = u / tail, c = u - r * tail;
    const float v = (app && c < 3) ? pv[r * PSTRIDE + v_off + c] : 0.0f;
    st_shared_b16(at(r, 2 * pairs + c), __bfloat16_as_ushort(__float2bfloat16_rn(v)));
  }
}

// ---- the weight ring -------------------------------------------------------

struct Ring {
  unsigned char* base;  // the slabs
  uint64_t* full;
  uint64_t* empty;
  int stage;
  uint32_t phase;
  __device__ __forceinline__ void advance(int stages) {
    if (++stage == stages) {
      stage = 0;
      phase ^= 1;
    }
  }
};

// Producer: n_slabs row slabs of W (64 rows x 64 * n_boxes columns, MN-major
// B of the forward), from row `row0` of the map's view.
template <int STAGES>
__device__ __forceinline__ void load_rows(Ring& r, const CUtensorMap* map, int row0, int n_slabs, int n_boxes) {
  for (int i = 0; i < n_slabs; ++i) {
    mbar_wait(&r.empty[r.stage], r.phase ^ 1);
    mbar_arrive_expect_tx(&r.full[r.stage], n_boxes * 64 * 128);
    unsigned char* dst = r.base + r.stage * SLAB_BYTES;
    for (int j = 0; j < n_boxes; ++j) tma_load_2d(dst + j * 64 * 128, map, 64 * j, row0 + 64 * i, &r.full[r.stage]);
    r.advance(STAGES);
  }
}

// Producer: every slab of one tile's forward, in the consumers' order: layer
// 0 (one slab: the embedding), the xyz layers (four, five for a skip layer),
// the intermediate (four), the first color layer (five: the intermediate,
// then the dir embedding) and the extra color layers (two). `wrow[i]` is
// tensor i's first row in its map's view (ops/kernels/nerf_mlp_fwd.py::
// weight_rows).
template <int STAGES>
__device__ __forceinline__ void load_forward_slabs(Ring& r, const CUtensorMap* w256, const CUtensorMap* w128,
                                                   const int* wrow, int n_layers, int skip_mask, int n_extra) {
  const int l_int = n_layers, l_c0 = n_layers + 2;
  load_rows<STAGES>(r, w256, wrow[0], 1, 4);
  for (int l = 1; l < n_layers; ++l) load_rows<STAGES>(r, w256, wrow[l], ((skip_mask >> l) & 1) ? 5 : 4, 4);
  load_rows<STAGES>(r, w256, wrow[l_int], 4, 4);
  load_rows<STAGES>(r, w128, wrow[l_c0], 5, 2);
  for (int e = 0; e < n_extra; ++e) load_rows<STAGES>(r, w128, wrow[l_c0 + 1 + e], 2, 2);
}

// Consumer warp group: acc = A @ B over n_slabs slabs of the ring, 64 K
// each. Slab i < n_main takes A from activation chunk i (`a_main` + i
// chunks), later slabs from `a_tail`. TB = 1: B is the forward's MN-major W;
// TB = 0: the backward's K-major W^T. Each slab is released to the producer
// as soon as the product after it has been issued.
template <int TB, int STAGES, int NACC>
__device__ __forceinline__ void gemm_tb(float (&acc)[NACC], Ring& r, uint32_t a_main, int n_main, uint32_t a_tail,
                                        int n_slabs) {
  const bool signals = (threadIdx.x & 31) == 0;
  int prev = 0;
  fence_operand(acc);
  for (int i = 0; i < n_slabs; ++i) {
    const uint32_t a = i < n_main ? a_main + i * CHUNK_BYTES : a_tail;
    const uint32_t b = smem_u32(r.base + r.stage * SLAB_BYTES);
    mbar_wait(&r.full[r.stage], r.phase);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const uint64_t db = TB ? mnmajor_desc(b + k * 2048, 64 * 128) : kmajor_desc(b + k * 32);
      wgmma_k16<0, TB>(acc, kmajor_desc(a + k * 32), db, (i | k) != 0);
    }
    wgmma_commit();
    if (i > 0) {
      wgmma_wait<1>();
      if (signals) mbar_arrive(&r.empty[prev]);
    }
    prev = r.stage;
    r.advance(STAGES);
  }
  wgmma_wait<0>();
  fence_operand(acc);
  if (signals) mbar_arrive(&r.empty[prev]);
}

// ---- the forward epilogue --------------------------------------------------

// The writes into the warp group's rows of a swizzled buffer are visible to
// wgmma and TMA.
__device__ __forceinline__ void end_write(int wg) {
  fence_proxy_async();
  named_bar_sync(1 + wg, WG);
}

// bf16(acc + vec[col]) (relu'd with `relu`) into the warp group's rows of
// the activation buffer `act_wg`. Pairs of columns go through packed bf16:
// relu(bf16(x)) = bf16(relu(x)). With a `mask`, the ReLU bits (bf16 x > 0:
// its 16-bit pattern read as a positive integer) are kept one per
// accumulator element, in the thread's own order, at mask[w * CONSUMERS],
// w < NACC / 32.
template <int NACC>
__device__ __forceinline__ void epilogue_fwd(float (&acc)[NACC], bool relu, uint32_t* mask, const float* vec,
                                             unsigned char* act_wg) {
  const int t = threadIdx.x & (WG - 1);
  const uint32_t act_s = smem_u32(act_wg);
  const __nv_bfloat162 zero2 = __floats2bfloat162_rn(0.0f, 0.0f);
  uint32_t bits[NACC / 32];
#pragma unroll
  for (int w = 0; w < NACC / 32; ++w) bits[w] = 0u;
#pragma unroll
  for (int i = 0; i < NACC / 4; ++i) {
    const int c = acc_col(t, i, 0);
    const float2 a = *reinterpret_cast<const float2*>(vec + c);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = acc_row(t, 2 * h), j = 4 * i + 2 * h;
      __nv_bfloat162 o = __floats2bfloat162_rn(__fadd_rn(acc[j], a.x), __fadd_rn(acc[j + 1], a.y));
      if (relu) o = __hmax2(o, zero2);
      const uint32_t w = *reinterpret_cast<const uint32_t*>(&o);
      bits[j >> 5] |= (uint32_t)((int)(w << 16) > 0) << (j & 31);
      bits[j >> 5] |= (uint32_t)((int)w >= 0x10000) << ((j + 1) & 31);
      st_shared_b32(act_s + (c >> 6) * CHUNK_BYTES + sw128_offset(row, c & 63), w);
    }
  }
  if (mask != nullptr) {
#pragma unroll
    for (int w = 0; w < NACC / 32; ++w) mask[w * CONSUMERS] = bits[w];
  }
}

// ---- the vector ring -------------------------------------------------------

// One buffer per step, two buffers, filled by one warp of the producer warp
// group ahead of the consumers.
struct VecRing {
  float* buf;  // 2 x VEC_FLOATS
  uint64_t* full;
  uint64_t* empty;
  int idx;
  uint32_t phase;
  __device__ __forceinline__ void advance() {
    if (++idx == 2) {
      idx = 0;
      phase ^= 1;
    }
  }
};

// What a step's vector holds.
enum VecKind { VEC_NONE, VEC_BIAS, VEC_DENSITY, VEC_HEAD };

// One warp (lane 0..31) fills `dst` with a step's vector: VEC_BIAS, the n
// floats of bias `b`; VEC_DENSITY, the density head's 256 weights `w` as
// float32 (and its bias at float H, with a `b`); VEC_HEAD, W_last (HD x C,
// bf16) and its bias at float H.
__device__ __forceinline__ void fill_vec(float* dst, int kind, int n, const bf16* w, const float* b, int color_dim,
                                         int lane) {
  if (kind == VEC_BIAS) {
    for (int c = lane; c < n; c += 32) dst[c] = b[c];
  } else if (kind == VEC_DENSITY) {
    for (int c = lane; c < H; c += 32) dst[c] = __bfloat162float(w[c]);
    if (b != nullptr && lane == 0) dst[H] = b[0];
  } else if (kind == VEC_HEAD) {
    for (int c = lane; c < HD * color_dim; c += 32) reinterpret_cast<bf16*>(dst)[c] = w[c];
    for (int c = lane; c < color_dim; c += 32) dst[H + c] = b[c];
  }
}

// ---- the heads -------------------------------------------------------------

// The density logit 256 -> 1 of the warp group's point (t >> 1), without
// its bias: two threads a point, each a float32 sum of 128 bf16 products in
// order, the pair's sums added with a shuffle. `wd`: the 256 weights as
// float32.
__device__ __forceinline__ float density_logit(const unsigned char* act_wg, const float* wd) {
  const int t = threadIdx.x & (WG - 1);
  const int rr = t >> 1, half = t & 1;
  float s = 0.f;
  for (int u = 0; u < 16; ++u) {
    const uint4 raw =
        *reinterpret_cast<const uint4*>(act_wg + (half * 2 + (u >> 3)) * CHUNK_BYTES + sw128_offset(rr, (u & 7) * 8));
    const bf16* a8 = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
    for (int e = 0; e < 8; ++e) s = __fmaf_rn(__bfloat162float(a8[e]), wd[half * 128 + u * 8 + e], s);
  }
  return __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, 1));
}

// The color head's logits 128 -> C of the warp group's point (t >> 1),
// without the bias: two threads a point, as density_logit. `wl`: W_last, bf16
// (HD x C).
__device__ __forceinline__ void color_logits(const unsigned char* act_wg, const bf16* wl, int C, float (&s)[MAXC]) {
  const int t = threadIdx.x & (WG - 1);
  const int rr = t >> 1, half = t & 1;
#pragma unroll
  for (int c = 0; c < MAXC; ++c) s[c] = 0.f;
  for (int u = 0; u < 8; ++u) {
    const uint4 raw = *reinterpret_cast<const uint4*>(act_wg + half * CHUNK_BYTES + sw128_offset(rr, u * 8));
    const bf16* a8 = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int k = half * 64 + u * 8 + e;
      const float a = __bfloat162float(a8[e]);
#pragma unroll
      for (int c = 0; c < MAXC; ++c)
        if (c < C) s[c] = __fmaf_rn(a, __bfloat162float(wl[k * C + c]), s[c]);
    }
  }
#pragma unroll
  for (int c = 0; c < MAXC; ++c)
    if (c < C) s[c] = __fadd_rn(s[c], __shfl_xor_sync(0xffffffffu, s[c], 1));
}

// sigmoid(s + b), every rounding spelled out.
__device__ __forceinline__ float sigmoid_rn(float s, float b) {
  return __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-__fadd_rn(s, b))));
}

// ---- K1 and K2 -------------------------------------------------------------

struct FwdArgs {
  CUtensorMap w256, w128;  // the packed weights as (rows, 256) / (rows, 128), boxes of 64 x 64
  const float* points;     // (n_points, 3)
  const float* dirs;       // (n_points / pts_per_ray, 3), one per ray
  float* out;              // (n_points, 1 + color_dim)
  const bf16* w[MAX_TENSORS];
  const float* b[MAX_TENSORS];
  int wrow[MAX_TENSORS];  // first row of tensor i in its tensor map's view (-1: a head, read by the threads)
  int n_points, pts_per_ray, n_layers, skip_mask, n_extra;
  int nf_xyz, app_xyz, nf_dir, app_dir, color_dim;
  int n_tiles;
};

constexpr int PV = 8;  // floats per point of the consumers' inputs: the point (3), its normalized direction (3)
constexpr int SLOT_BYTES = CHUNK_BYTES + TILE * KD_MAX * 2;  // K2's embedding slot: xyz chunk | dir embedding

// Shared memory of K1 (PIPELINED false) and K2: the ring, the activation
// buffer (four 64-column chunks of 128 rows), the embedding (K1: one chunk;
// K2: two slots of an xyz chunk and the dir embedding, 64 bytes a row),
// the points, the vector ring, the barriers.
template <bool PIPELINED, int STAGES>
struct FwdSmem {
  static constexpr int RING = 0;
  static constexpr int ACT = RING + STAGES * SLAB_BYTES;
  static constexpr int EMB = ACT + 4 * CHUNK_BYTES;
  static constexpr int PTS = EMB + (PIPELINED ? 2 * SLOT_BYTES : CHUNK_BYTES);
  static constexpr int VECRING = PTS + TILE * PV * 4;
  static constexpr int BAR = VECRING + 2 * VEC_FLOATS * 4;
  static constexpr int N_BARS = 2 * STAGES + 4 + (PIPELINED ? 4 : 0);
  static constexpr int BYTES = BAR + N_BARS * 8 + 1024;  // + alignment of the base to 1024
  static_assert(SLOT_BYTES % 1024 == 0, "a slot's xyz chunk must sit on a 1024-byte boundary");
  static_assert(BYTES <= 232448, "the forward exceeds the shared memory of a block");
};

// Step s of a tile (n_layers + 4 + n_extra steps): its vector. The xyz
// layers, the density head, the intermediate, the color layers, the color
// head.
__device__ __forceinline__ void fwd_step_vec(const FwdArgs& p, int s, int* kind, int* tensor, int* n) {
  const int nl = p.n_layers;
  *n = H;
  if (s < nl) {
    *kind = VEC_BIAS;
    *tensor = s;
  } else if (s == nl) {
    *kind = VEC_DENSITY;
    *tensor = nl + 1;
  } else if (s == nl + 1) {
    *kind = VEC_BIAS;
    *tensor = nl;
  } else if (s <= nl + 2 + p.n_extra) {
    *kind = VEC_BIAS;
    *tensor = s;
    *n = HD;
  } else {
    *kind = VEC_HEAD;
    *tensor = s;
  }
}

__device__ __forceinline__ void fwd_vec_producer(const FwdArgs& p, VecRing& v) {
  const int lane = threadIdx.x & 31;
  const int n_steps = p.n_layers + 4 + p.n_extra;
  for (int tile = blockIdx.x; tile < p.n_tiles; tile += gridDim.x) {
    for (int s = 0; s < n_steps; ++s) {
      int kind, tensor, n;
      fwd_step_vec(p, s, &kind, &tensor, &n);
      mbar_wait(&v.empty[v.idx], v.phase ^ 1);
      fill_vec(v.buf + v.idx * VEC_FLOATS, kind, n, p.w[tensor], p.b[tensor], p.color_dim, lane);
      mbar_arrive(&v.full[v.idx]);
      v.advance();
    }
  }
}

// The embedding slots of K2: slot s = the xyz chunk (swizzled) | the dir
// embedding (128 rows of 32 bf16, plain).
struct Slots {
  unsigned char* base;
  uint64_t* full;   // 2, filled by the embedding warps (64 arrivals)
  uint64_t* empty;  // 2, released by the consumers (one arrival per consumer warp)
};

constexpr int EMBEDDERS = 64;  // K2: warps 2-3 of the producer warp group
constexpr int BAR_EMBED = 4;   // their named barrier (1-2: the consumer warp groups)

// K2's embedding warps: tile i of the CTA into slot i % 2, once the
// consumers have released what the slot held (tile i - 2).
template <int STAGES>
__device__ __forceinline__ void fwd_embedder(const FwdArgs& p, Slots& sl, float* pv) {
  const int et = threadIdx.x - (CONSUMERS + 64);
  int i = 0;
  for (int tile = blockIdx.x; tile < p.n_tiles; tile += gridDim.x, ++i) {
    const int s = i & 1;
    const uint32_t use = (uint32_t)(i >> 1) & 1u;
    for (int r = et; r < TILE; r += EMBEDDERS)
      load_point(p.points, p.dirs, p.n_points, p.pts_per_ray, tile * TILE + r, pv + r * PV, pv + r * PV + 3);
    named_bar_sync(BAR_EMBED, EMBEDDERS);  // the tile's points are staged
    mbar_wait(&sl.empty[s], use ^ 1);
    unsigned char* slot = sl.base + s * SLOT_BYTES;
    const uint32_t xyz_s = smem_u32(slot);
    embed_pairs<true, PV>(pv, 0, TILE, p.nf_xyz, p.app_xyz, xyz_s, KX_MAX, et, EMBEDDERS);
    embed_pairs<false, PV>(pv, 3, TILE, p.nf_dir, p.app_dir, xyz_s + CHUNK_BYTES, KD_MAX, et, EMBEDDERS);
    fence_proxy_async();  // the xyz chunk is read by wgmma
    mbar_arrive(&sl.full[s]);
    named_bar_sync(BAR_EMBED, EMBEDDERS);  // every read of the staged points is done
  }
}

// A consumer warp group's chain of every tile: 64 points each.
template <bool PIPELINED, int STAGES>
__device__ __forceinline__ void fwd_consumer(const FwdArgs& p, Ring& r, VecRing& v, unsigned char* act,
                                             unsigned char* emb, float* pv, Slots& sl) {
  const int wg = threadIdx.x / WG, t = threadIdx.x & (WG - 1);
  const bool lead = (threadIdx.x & 31) == 0;
  const int nl = p.n_layers, ne = p.n_extra, C = p.color_dim, out_w = 1 + C;
  unsigned char* act_wg = act + wg * WG_ROWS_BYTES;
  const uint32_t a_act = smem_u32(act_wg);
  float* pv_wg = pv + wg * 64 * PV;
  float acc[128];
  float(&acc64)[64] = *reinterpret_cast<float(*)[64]>(&acc[0]);

  auto take_vec = [&]() -> const float* {
    mbar_wait(&v.full[v.idx], v.phase);
    return v.buf + v.idx * VEC_FLOATS;
  };
  auto release_vec = [&]() {
    if (lead) mbar_arrive(&v.empty[v.idx]);
    v.advance();
  };

  int i = 0;
  for (int tile = blockIdx.x; tile < p.n_tiles; tile += gridDim.x, ++i) {
    const int row0g = tile * TILE + wg * 64;  // the warp group's first point
    unsigned char* emb_wg;
    if (PIPELINED) {
      emb_wg = sl.base + (i & 1) * SLOT_BYTES + wg * WG_ROWS_BYTES;
      mbar_wait(&sl.full[i & 1], (uint32_t)(i >> 1) & 1u);
    } else {
      emb_wg = emb + wg * WG_ROWS_BYTES;
      if (t < 64) load_point(p.points, p.dirs, p.n_points, p.pts_per_ray, row0g + t, pv_wg + t * PV, pv_wg + t * PV + 3);
      named_bar_sync(1 + wg, WG);
      embed_pairs<true, PV>(pv_wg, 0, 64, p.nf_xyz, p.app_xyz, smem_u32(emb_wg), KX_MAX, t, WG);
      end_write(wg);
    }
    const uint32_t a_emb = smem_u32(emb_wg);

    // the xyz layers
    for (int l = 0; l < nl; ++l) {
      const float* vec = take_vec();
      gemm_tb<1, STAGES>(acc, r, a_act, l == 0 ? 0 : 4, a_emb, l == 0 ? 1 : (((p.skip_mask >> l) & 1) ? 5 : 4));
      named_bar_sync(1 + wg, WG);  // every product of the warp group has read the buffer
      epilogue_fwd(acc, true, nullptr, vec, act_wg);
      end_write(wg);
      release_vec();
    }

    // the density head, from the last xyz layer's activations
    {
      const float* wd = take_vec();
      const float d = density_logit(act_wg, wd);
      const int row = row0g + (t >> 1);
      if ((t & 1) == 0 && row < p.n_points) p.out[(size_t)row * out_w] = __fadd_rn(d, wd[H]);
      __syncwarp();
      release_vec();
    }

    // the intermediate (no relu); then the dir embedding takes the place of the xyz embedding
    {
      const float* vec = take_vec();
      gemm_tb<1, STAGES>(acc, r, a_act, 4, 0, 4);
      named_bar_sync(1 + wg, WG);
      epilogue_fwd(acc, false, nullptr, vec, act_wg);
      if (PIPELINED) {  // copy the slot's dir embedding into its (dead) xyz chunk, zeros past 32 columns
        const unsigned char* dir = emb_wg - wg * WG_ROWS_BYTES + CHUNK_BYTES + wg * 64 * 64;
        const uint32_t emb_s = smem_u32(emb_wg);
        for (int u = t; u < 64 * 8; u += WG) {
          const int rr = u >> 3, cu = u & 7;
          const uint4 val = cu < 4 ? *reinterpret_cast<const uint4*>(dir + rr * 64 + cu * 16) : make_uint4(0, 0, 0, 0);
          st_shared_v4(emb_s + sw128_offset(rr, cu * 8), val);
        }
      } else {
        embed_pairs<true, PV>(pv_wg, 3, 64, p.nf_dir, p.app_dir, smem_u32(emb_wg), KX_MAX, t, WG);
      }
      end_write(wg);
      release_vec();
    }

    // the color layers: the first over [intermediate | dir embedding], then the extra ones
    for (int e = 0; e <= ne; ++e) {
      const float* vec = take_vec();
      gemm_tb<1, STAGES>(acc64, r, a_act, e == 0 ? 4 : 2, a_emb, e == 0 ? 5 : 2);
      named_bar_sync(1 + wg, WG);
      epilogue_fwd(acc64, true, nullptr, vec, act_wg);
      end_write(wg);
      if (PIPELINED && e == 0 && lead) mbar_arrive(&sl.empty[i & 1]);  // the slot's last reader is done
      release_vec();
    }

    // the color head
    {
      const float* head = take_vec();
      float s[MAXC];
      color_logits(act_wg, reinterpret_cast<const bf16*>(head), C, s);
      const int row = row0g + (t >> 1);
      if ((t & 1) == 0 && row < p.n_points) {
#pragma unroll
        for (int c = 0; c < MAXC; ++c)
          if (c < C) p.out[(size_t)row * out_w + 1 + c] = sigmoid_rn(s[c], head[H + c]);
      }
      __syncwarp();
      release_vec();
    }
  }
}

// The kernel of K1 (PIPELINED false) and K2, with STAGES slabs in the ring.
template <bool PIPELINED, int STAGES>
__device__ __forceinline__ void fwd_kernel_body(const FwdArgs& p, unsigned char* smem_raw) {
  using L = FwdSmem<PIPELINED, STAGES>;
  unsigned char* smem = aligned_smem(smem_raw);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::BAR);
  Ring r{smem + L::RING, bars, bars + STAGES, 0, 0};
  VecRing v{reinterpret_cast<float*>(smem + L::VECRING), bars + 2 * STAGES, bars + 2 * STAGES + 2, 0, 0};
  Slots sl{smem + L::EMB, bars + 2 * STAGES + 4, bars + 2 * STAGES + 6};
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&r.full[s], 1);
      mbar_init(&r.empty[s], EMPTY_ARRIVALS);
    }
    for (int s = 0; s < 2; ++s) {
      mbar_init(&v.full[s], 32);
      mbar_init(&v.empty[s], EMPTY_ARRIVALS);
      if (PIPELINED) {
        mbar_init(&sl.full[s], EMBEDDERS);
        mbar_init(&sl.empty[s], EMPTY_ARRIVALS);
      }
    }
    fence_barrier_init();
  }
  __syncthreads();
  float* pv = reinterpret_cast<float*>(smem + L::PTS);
  if (threadIdx.x >= CONSUMERS) {
    setmaxnreg_dec<PRODUCER_REGS>();
    const int warp = (threadIdx.x - CONSUMERS) / 32;
    if (threadIdx.x == CONSUMERS) {
      for (int tile = blockIdx.x; tile < p.n_tiles; tile += gridDim.x)
        load_forward_slabs<STAGES>(r, &p.w256, &p.w128, p.wrow, p.n_layers, p.skip_mask, p.n_extra);
    } else if (warp == 1) {
      fwd_vec_producer(p, v);
    } else if (PIPELINED && warp >= 2) {
      fwd_embedder<STAGES>(p, sl, pv);
    }
  } else {
    setmaxnreg_inc<CONSUMER_REGS>();
    fwd_consumer<PIPELINED, STAGES>(p, r, v, smem + L::ACT, smem + L::EMB, pv, sl);
  }
}

// ---- host ------------------------------------------------------------------

// The tensor maps of the packed weights at `wbuf` (w_total bf16), as (rows,
// 256) and (rows, 128) views with boxes of 64 x 64. A map is a function of
// the address and the shape alone, so the last few are kept (per host
// thread) and a launch on a buffer seen before encodes nothing.
inline int weight_maps(FwdArgs* p, const void* wbuf, long long w_total) {
  struct Entry {
    CUtensorMap m256, m128;
    const void* base;
    long long total;
  };
  constexpr int N = 8;
  static thread_local Entry cache[N];
  static thread_local int used = 0, next = 0;
  for (int i = 0; i < used; ++i) {
    if (cache[i].base == wbuf && cache[i].total == w_total) {
      p->w256 = cache[i].m256;
      p->w128 = cache[i].m128;
      return 0;
    }
  }
  int err = make_bf16_map(&p->w256, wbuf, w_total / H, H, H * 2, 64, 64);
  if (!err) err = make_bf16_map(&p->w128, wbuf, w_total / HD, HD, HD * 2, 64, 64);
  if (err) return err;
  Entry& e = cache[next];
  e.m256 = p->w256;
  e.m128 = p->w128;
  e.base = wbuf;
  e.total = w_total;
  next = (next + 1) % N;
  if (used < N) ++used;
  return 0;
}

// Fills `p` from the entry points' arguments and launches `kernel` on
// `stream`, a CTA per SM at most; returns a cudaError_t (0 on success).
// `w_off`/`b_off`/`w_rows` are host arrays (int64), one per tensor in kernel
// order (xyz layers, intermediate, density, color layers): the element
// offsets into the packed bf16 weights and float32 biases, and the first row
// of each matrix in its tensor map's view (ops/kernels/nerf_mlp_fwd.py::
// weight_rows; -1 for the heads).
inline int launch_fwd(void (*kernel)(FwdArgs), int smem_bytes, const void* points, const void* dirs, void* out,
                      const void* wbuf, const void* bbuf, const void* w_off, const void* b_off, const void* w_rows,
                      int n_tensors, int n_points, int pts_per_ray, int n_layers, int skip_mask, int nf_xyz,
                      int app_xyz, int nf_dir, int app_dir, int n_extra_color, int color_dim, long long w_total,
                      void* stream) {
  FwdArgs p;
  const int k_xyz = round16(3 * (2 * nf_xyz + (app_xyz ? 1 : 0)));
  const int k_dir = round16(3 * (2 * nf_dir + (app_dir ? 1 : 0)));
  if (n_layers < 1 || n_layers > MAX_LAYERS || n_extra_color < 0 || n_extra_color > MAX_EXTRA ||
      n_tensors != n_layers + 4 + n_extra_color || k_xyz > KX_MAX || k_dir > KD_MAX || pts_per_ray < 1 ||
      color_dim < 1 || color_dim > MAXC)
    return (int)cudaErrorInvalidValue;
  if (n_points == 0) return 0;
  const long long* wo = static_cast<const long long*>(w_off);
  const long long* bo = static_cast<const long long*>(b_off);
  const long long* rows = static_cast<const long long*>(w_rows);
  for (int i = 0; i < n_tensors; ++i) {
    p.w[i] = static_cast<const bf16*>(wbuf) + wo[i];
    p.b[i] = static_cast<const float*>(bbuf) + bo[i];
    p.wrow[i] = (int)rows[i];
  }
  p.points = static_cast<const float*>(points);
  p.dirs = static_cast<const float*>(dirs);
  p.out = static_cast<float*>(out);
  p.n_points = n_points;
  p.pts_per_ray = pts_per_ray;
  p.n_layers = n_layers;
  p.skip_mask = skip_mask;
  p.n_extra = n_extra_color;
  p.nf_xyz = nf_xyz;
  p.app_xyz = app_xyz;
  p.nf_dir = nf_dir;
  p.app_dir = app_dir;
  p.color_dim = color_dim;
  p.n_tiles = (n_points + TILE - 1) / TILE;
  int err = weight_maps(&p, wbuf, w_total);
  if (err) return err;

  int device = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute((const void*)kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (e != cudaSuccess) return (int)e;
  const int grid = p.n_tiles < sms ? p.n_tiles : sms;
  kernel<<<grid, THREADS, smem_bytes, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace nerf_mlp
