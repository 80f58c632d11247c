// Fused NeRF-MLP backward for Hopper (sm_90a), K3: the weight and bias
// gradients of the fused forward (csrc/nerf_mlp_fwd.cu) given the cotangents
// of its (N, 1 + C) output.
//
// Replaces the Pallas TPU kernel yanerf_tpu/ops/pallas/nerf_mlp_bwd.py
// (_nerf_mlp_bwd_kernel, reached via nerf_mlp_backward_pallas) and computes
// the same function with the same rounding points: bf16 operands and float32
// accumulation, the bias added in float32, the sigmoid's cotangent rounded
// to bf16, every g @ W^T rounded to bf16 before the density head's term is
// added, ReLU masks taken on the bf16 activations, dW = a^T g and
// db = sum(g) summed in float32. The embedding is K1's (nerf_mlp_fwd.cuh:
// accurate sinf, cos(t) = sin(t + pi/2), no fast-math).
//
// What bounds it: operations, ~3.5 MFLOP per point against ~32 bytes of
// input. Two things the TPU kernel keeps on chip do not fit on an SM: ten
// 256-wide activations per point (the stash), and the 2.4 MB of float32
// gradients it accumulates across its in-order grid. So K3 is three kernels
// on one stream, one launch of K3, and no atomics:
//
//   Pass 1 (tile_kernel): a persistent CTA per SM walks 128-point tiles.
//     Warp group 2 is the producer: one thread streams every weight slab the
//     tile needs, in the order the consumers use them, through a 3-stage
//     ring of 32 KB with TMA and full/empty mbarriers. Warp groups 0 and 1
//     own 64 points each and run the recomputed forward and the backward
//     chain with wgmma m64n256k16 / m64n128k16: A is the activation (or
//     cotangent) in shared memory, B the ring's slab. The backward reads
//     W^T from the same row-major W, as a K-major operand (column slabs of
//     256 rows x 64), where the forward reads W as an MN-major one (row
//     slabs of 64 x 256): no transposed copy of the weights. Each layer's
//     epilogue runs from the registers (bias, ReLU and bf16 in the forward;
//     bf16, the density term and the ReLU mask in the backward) straight
//     into the 128B-swizzled activation buffer, which is the next layer's
//     A, and one TMA store per layer writes it to the stash in device
//     memory. The ReLU masks stay on chip, one bit per activation in the
//     owning thread's registers' order, so the backward reads nothing back.
//     A second producer warp copies each layer's bias (or the density and
//     color heads' weights) into a two-buffer ring in shared memory ahead
//     of the consumers, so that no epilogue waits on device memory. The
//     narrow heads (256 -> 1, 128 -> C) run on the CUDA cores.
//   Pass 2 (dw_kernel): dW = a^T g from the stash, split over the points.
//     One CTA per job (tensor, 128-row block of its dW, slice of the
//     points): its producer TMA-loads the two activation boxes (64 points x
//     64 features) and the cotangent boxes (64 points x the tensor's width)
//     into a 4-stage ring; each consumer warp group runs wgmma with the
//     activation transposed (MN-major A) for 64 rows of dW x the full width.
//     The job of row block 0 also sums the cotangent columns: db. Each slice
//     writes its partial sums to its own slot. The plan of jobs is made on
//     the host (ops/kernels/nerf_mlp_bwd.py::weight_grad_jobs).
//   Pass 3 (dw_reduce_kernel): sums the slices in a fixed order, so the
//     result is the same from run to run.
//
// Stash: column-blocked, (width / 64, n_points, 64) bf16, so that a TMA box
// of 64 points x 64 columns is one contiguous 8 KB run of device memory in
// both passes (the tensor maps clip stores past n_points and read zeros
// there, so a ragged tail adds nothing). Columns of the activations: xyz
// embedding (64) | the xyz layers' outputs (256 each) | intermediate (256)
// | dir embedding (32) and the heads' cotangents (density, then the
// sigmoid's C), one 64-column block | the color layers' outputs (128 each).
// Of the cotangents of the layer outputs: xyz layers (256 each) |
// intermediate (256) | color layers (128 each). Pass 2 keeps only the
// columns of a block that its job owns.
//
// The wgmma / TMA / mbarrier building blocks are in hopper.cuh. Built with
// nvcc into a shared library with plain C entry points, loaded with ctypes
// by ops/kernels/nerf_mlp_bwd.py.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"
#include "nerf_mlp_fwd.cuh"

using namespace hopper;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int H = 256;         // xyz hidden width
constexpr int HD = 128;        // color hidden width
constexpr int KX_MAX = 64;     // padded xyz-embedding width
constexpr int KD_MAX = 32;     // padded dir-embedding width
constexpr int MAXC = 4;        // color channels
constexpr int MAX_LAYERS = 8;
constexpr int MAX_EXTRA = 2;   // extra color layers (nerf_paper_v1: n_layers / 4)
constexpr int MAX_TENSORS = MAX_LAYERS + 4 + MAX_EXTRA;
constexpr int MAX_JOBS = 32;
constexpr int JOB_FIELDS = 12;  // weight_grad_jobs' tuple

constexpr int WG = 128;                 // threads of a warp group
constexpr int CONSUMERS = 2 * WG;       // warp groups 0-1
constexpr int THREADS = CONSUMERS + WG;  // + the producer warp group
constexpr int CONSUMER_REGS = 232;
constexpr int PRODUCER_REGS = 40;
constexpr int EMPTY_ARRIVALS = CONSUMERS / 32;  // one per consumer warp

// pass 1
constexpr int TILE = 128;               // points per tile, 64 per consumer warp group
constexpr int STAGES = 3;
constexpr int SLAB_BYTES = 64 * H * 2;  // a 64 x 256 bf16 weight slab
constexpr int CHUNK_BYTES = TILE * 128; // 64 columns x 128 rows of the activation buffer
constexpr int WG_ROWS_BYTES = 64 * 128; // one warp group's rows of a chunk
constexpr int MASK_WORDS = MAX_LAYERS * (H / 64) + (1 + MAX_EXTRA) * (HD / 64);  // per consumer thread
constexpr int VEC = 16;                 // floats per point: pts 3 | dn 3 | g 1+C | gz C | gden
constexpr int V_PTS = 0, V_DN = 3, V_G = 6, V_GZ = 11, V_GDEN = 15;
constexpr int OFF_RING = 0;
constexpr int OFF_ACT = OFF_RING + STAGES * SLAB_BYTES;
constexpr int OFF_EMB = OFF_ACT + 4 * CHUNK_BYTES;
constexpr int OFF_MASK = OFF_EMB + CHUNK_BYTES;
constexpr int OFF_VEC = OFF_MASK + MASK_WORDS * CONSUMERS * 4;
constexpr int VEC_FLOATS = H + MAXC;  // a step's vector: a bias (<= 256 floats), or W_last (bf16) and its bias
constexpr int OFF_VECRING = OFF_VEC + TILE * VEC * 4;
constexpr int OFF_BAR = OFF_VECRING + 2 * VEC_FLOATS * 4;
constexpr int SMEM1 = OFF_BAR + (2 * STAGES + 4) * 8 + 1024;  // + alignment of the base to 1024
static_assert(SMEM1 <= 232448, "pass 1 exceeds the shared memory of a block");

// pass 2
constexpr int DW_STAGES = 4;
constexpr int DW_A_BYTES = 2 * 64 * 128;  // two 64-point x 64-feature boxes
constexpr int DW_STAGE_BYTES = DW_A_BYTES + 4 * 64 * 128;  // + up to four cotangent boxes
constexpr int SMEM2 = DW_STAGES * DW_STAGE_BYTES + 2 * DW_STAGES * 8 + 1024;
static_assert(SMEM2 <= 232448, "pass 2 exceeds the shared memory of a block");

// Stash columns (bf16 elements per point); ops/kernels/nerf_mlp_bwd.py::stash_widths mirrors them.
__host__ __device__ constexpr int a_emb() { return 0; }
__host__ __device__ constexpr int a_y(int l) { return KX_MAX + H * l; }
__host__ __device__ constexpr int a_inter(int nl) { return a_y(nl); }
__host__ __device__ constexpr int a_demb(int nl) { return a_inter(nl) + H; }
__host__ __device__ constexpr int a_cact(int nl, int e) { return a_demb(nl) + 64 + HD * e; }
__host__ __device__ constexpr int a_width(int nl, int ne) { return a_cact(nl, ne + 1); }
__host__ __device__ constexpr int g_y(int l) { return H * l; }
__host__ __device__ constexpr int g_inter(int nl) { return g_y(nl); }
__host__ __device__ constexpr int g_c(int nl, int e) { return g_inter(nl) + H + HD * e; }
__host__ __device__ constexpr int g_width(int nl, int ne) { return g_c(nl, ne + 1); }
// The heads' cotangents (density, then the sigmoid's C) sit in the activation
// stash, in the unused half of the dir embedding's block.
__host__ __device__ constexpr int a_heads(int nl) { return a_demb(nl) + KD_MAX; }

struct TileArgs {
  CUtensorMap w256_fwd, w256_bwd, w128_fwd, w128_bwd;  // the packed weights as (rows, 256) / (rows, 128)
  CUtensorMap sa, sg;                                    // the stashes, boxes of 64 points x 64 columns
  const float* points;  // (n_points, 3)
  const float* dirs;    // (n_points / pts_per_ray, 3), one per ray
  const float* g;       // (n_points, 1 + color_dim) cotangent of density | rgb
  bf16* sa_ptr;         // activation stash (the embeddings and the heads are stored by the threads)
  const bf16* w[MAX_TENSORS];
  const float* b[MAX_TENSORS];
  int wrow[MAX_TENSORS];  // first row of tensor i in its tensor map's view
  int n_points, pts_per_ray, n_layers, skip_mask, n_extra;
  int nf_xyz, app_xyz, nf_dir, app_dir, color_dim;
  int n_tiles;
};

// Element (row, col) of a column-blocked stash of n rows.
__device__ __forceinline__ bf16* stash_at(bf16* base, int n, int row, int col) {
  return base + ((size_t)(col >> 6) * n + row) * 64 + (col & 63);
}

struct DwJob {
  int tensor, group, row0, a_col0, rows0, a_col1, rows1, g_stash, g_col, n_mma, shift, n_out;
  long long w_off, b_off;  // b_off < 0: no bias sums in this job
};

struct DwArgs {
  CUtensorMap sa, sg;
  float* part;  // (n_split, total)
  int n_points, chunk, n_jobs, n_split;
  long long total, w_total;
  DwJob jobs[MAX_JOBS];
};

__device__ __forceinline__ float round_bf16(float v) { return __bfloat162float(__float2bfloat16(v)); }

// The first 64 accumulator registers, for the 128-wide products: one array
// for every product of pass 1, so that no two accumulators are live at once.
__device__ __forceinline__ float (&acc64(float (&acc)[128]))[64] { return *reinterpret_cast<float(*)[64]>(&acc[0]); }

// ---- the weight ring ------------------------------------------------------

struct Ring {
  unsigned char* base;  // STAGES slabs
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
__device__ __forceinline__ void load_rows(Ring& r, const CUtensorMap* map, int row0, int n_slabs, int n_boxes) {
  for (int i = 0; i < n_slabs; ++i) {
    mbar_wait(&r.empty[r.stage], r.phase ^ 1);
    mbar_arrive_expect_tx(&r.full[r.stage], n_boxes * 64 * 128);
    unsigned char* dst = r.base + r.stage * SLAB_BYTES;
    for (int j = 0; j < n_boxes; ++j) tma_load_2d(dst + j * 64 * 128, map, 64 * j, row0 + 64 * i, &r.full[r.stage]);
    r.advance(STAGES);
  }
}

// Producer: n_slabs column slabs of W (256 rows x 64 columns, the K-major B
// of g @ W^T), from row `row0` of the map's view.
__device__ __forceinline__ void load_cols(Ring& r, const CUtensorMap* map, int row0, int n_slabs) {
  for (int i = 0; i < n_slabs; ++i) {
    mbar_wait(&r.empty[r.stage], r.phase ^ 1);
    mbar_arrive_expect_tx(&r.full[r.stage], SLAB_BYTES);
    tma_load_2d(r.base + r.stage * SLAB_BYTES, map, 64 * i, row0, &r.full[r.stage]);
    r.advance(STAGES);
  }
}

// Consumer warp group: acc = A @ B over n_slabs slabs of the ring, 64 K
// each. Slab i < n_main takes A from activation chunk i (`a_main` + i
// chunks), later slabs from `a_tail`. TB = 1: B is the forward's MN-major W;
// TB = 0: the backward's K-major W^T. Every slab runs its four k16 steps
// (the same instructions on every path, so that nothing but wgmma defines
// the accumulator): A's columns past a layer's K are zero, and B's rows
// there are the next tensor's (finite) or past the end (zero).
template <int TB, int NACC>
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

template <int NACC>
__device__ __forceinline__ void gemm(float (&acc)[NACC], Ring& r, bool fwd, uint32_t a_main, int n_main,
                                     uint32_t a_tail, int n_slabs) {
  if (fwd)
    gemm_tb<1>(acc, r, a_main, n_main, a_tail, n_slabs);
  else
    gemm_tb<0>(acc, r, a_main, n_main, a_tail, n_slabs);
}

// ---- epilogues: accumulator -> 128B-swizzled activation buffer -------------

// The warp group's rows of the buffer may be overwritten: its stores have read them, its products are done.
__device__ __forceinline__ void begin_write(int wg) {
  if ((threadIdx.x & (WG - 1)) == 0) bulk_wait_read();
  named_bar_sync(1 + wg, WG);
}

// The writes are visible to wgmma and TMA.
__device__ __forceinline__ void end_write(int wg) {
  fence_proxy_async();
  named_bar_sync(1 + wg, WG);
}

// One TMA store per chunk of the warp group's rows to columns col.. of the stash.
__device__ __forceinline__ void stash_rows(const CUtensorMap* map, unsigned char* act_wg, int n_chunks, int col,
                                           int row) {
  if ((threadIdx.x & (WG - 1)) == 0) {
    for (int c = 0; c < n_chunks; ++c) tma_store_3d(map, act_wg + c * CHUNK_BYTES, 0, row, col / 64 + c);
    bulk_commit();
  }
}

// What a layer's epilogue does with the accumulator.
struct Epilogue {
  bool fwd;           // FWD, else BWD (or BWD_DENSITY with `add`)
  bool relu;          // forward
  bool add;           // forward: the bias (every forward layer has one); backward: the density term
  uint32_t* mask;     // forward: stores the ReLU bits; backward: applies them; null: none
};

// The accumulator into the warp group's rows of the activation buffer, in
// one of three modes fixed at compile time (so that nothing branches per
// element): FWD, bf16(relu(acc + vec[col])) with the ReLU bits stored;
// BWD, bf16(acc) times the ReLU bits; BWD_DENSITY, bf16(bf16(acc) +
// bf16(gden[row] * vec[col])) times the bits. `vec` is the layer's vector in
// shared memory (the bias, or the density head's weights as float32),
// `gden` the density cotangents of the warp group's points. The bits are
// kept one per accumulator element, in the thread's own order
// (mask[w * CONSUMERS], w < NACC / 32). Pairs of columns go through packed
// bf16: relu(bf16(x)) = bf16(relu(x)); bf16 x > 0 is its 16-bit pattern
// read as a positive integer; a masked entry keeps only its sign bit, as
// x * 0 does for finite x.
enum EpilogueMode { FWD, BWD, BWD_DENSITY };

template <int MODE, int NACC>
__device__ __forceinline__ void epilogue_mode(float (&acc)[NACC], bool relu, uint32_t* mask, const float* vec,
                                              const float* gden, unsigned char* act_wg) {
  const int t = threadIdx.x & (WG - 1);
  const uint32_t act_s = smem_u32(act_wg);
  const __nv_bfloat162 zero2 = __floats2bfloat162_rn(0.0f, 0.0f);
  uint32_t bits[NACC / 32];
#pragma unroll
  for (int w = 0; w < NACC / 32; ++w) bits[w] = MODE == FWD ? 0u : (mask != nullptr ? mask[w * CONSUMERS] : ~0u);
  const float gd0 = MODE == BWD_DENSITY ? gden[acc_row(t, 0) * VEC] : 0.f;
  const float gd1 = MODE == BWD_DENSITY ? gden[acc_row(t, 2) * VEC] : 0.f;
#pragma unroll
  for (int i = 0; i < NACC / 4; ++i) {
    const int c = acc_col(t, i, 0);
    const float2 a = MODE == BWD ? make_float2(0.f, 0.f) : *reinterpret_cast<const float2*>(vec + c);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = acc_row(t, 2 * h), j = 4 * i + 2 * h;
      __nv_bfloat162 o;
      if (MODE == FWD) {
        o = __floats2bfloat162_rn(__fadd_rn(acc[j], a.x), __fadd_rn(acc[j + 1], a.y));
        if (relu) o = __hmax2(o, zero2);
      } else if (MODE == BWD_DENSITY) {
        const float gd = h == 0 ? gd0 : gd1;
        o = __floats2bfloat162_rn(__fadd_rn(round_bf16(acc[j]), round_bf16(__fmul_rn(gd, a.x))),
                                  __fadd_rn(round_bf16(acc[j + 1]), round_bf16(__fmul_rn(gd, a.y))));
      } else {
        o = __floats2bfloat162_rn(acc[j], acc[j + 1]);
      }
      uint32_t w = *reinterpret_cast<const uint32_t*>(&o);
      if (MODE == FWD) {
        bits[j >> 5] |= (uint32_t)((int)(w << 16) > 0) << (j & 31);
        bits[j >> 5] |= (uint32_t)((int)w >= 0x10000) << ((j + 1) & 31);
      } else {
        const uint32_t b2 = bits[j >> 5] >> (j & 31);  // this pair's bits at 0 and 1
        w &= 0x80008000u | (((b2 & 1u) | ((b2 & 2u) << 15)) * 0x7fffu);
      }
      st_shared_b32(act_s + (c >> 6) * CHUNK_BYTES + sw128_offset(row, c & 63), w);
    }
  }
  if (MODE == FWD && mask != nullptr) {
#pragma unroll
    for (int w = 0; w < NACC / 32; ++w) mask[w * CONSUMERS] = bits[w];
  }
}

template <int NACC>
__device__ __forceinline__ void epilogue(float (&acc)[NACC], const Epilogue e, const float* vec, const float* gden,
                                         unsigned char* act_wg) {
  if (e.fwd)
    epilogue_mode<FWD>(acc, e.relu, e.mask, vec, gden, act_wg);
  else if (e.add)
    epilogue_mode<BWD_DENSITY>(acc, false, e.mask, vec, gden, act_wg);
  else
    epilogue_mode<BWD>(acc, false, e.mask, vec, gden, act_wg);
}

// The bf16 embedding of the warp group's 64 points, embed_value(x, c, nf,
// app) for c < 64 (zero past the embedding's width), into the swizzled chunk
// `emb_wg`, and its first `width` columns (a multiple of 8) into the
// activation stash at column `col`.
__device__ __forceinline__ void embed_rows(const TileArgs& p, const float* vec_wg, int v_off, int nf, int app,
                                           int width, unsigned char* emb_wg, int col, int row0g) {
  const int t = threadIdx.x & (WG - 1);
  const int units = 8;
  const uint32_t emb_s = smem_u32(emb_wg);
  for (int u = t; u < 64 * units; u += WG) {
    const int r = u / units, cu = u - r * units;
    const float* x = vec_wg + r * VEC + v_off;
    uint32_t w[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const __nv_bfloat162 pair = __floats2bfloat162_rn(nerf_mlp::embed_value(x, cu * 8 + 2 * e, nf, app),
                                                        nerf_mlp::embed_value(x, cu * 8 + 2 * e + 1, nf, app));
      w[e] = *reinterpret_cast<const uint32_t*>(&pair);
    }
    const uint4 packed = make_uint4(w[0], w[1], w[2], w[3]);
    st_shared_v4(emb_s + sw128_offset(r, cu * 8), packed);
    if (row0g + r < p.n_points && cu * 8 < width)
      *reinterpret_cast<uint4*>(stash_at(p.sa_ptr, p.n_points, row0g + r, col + cu * 8)) = packed;
  }
}

// ---- pass 1 ---------------------------------------------------------------

// What a step's vector (the layer's buffer of the vector ring) holds.
enum VecKind { VEC_NONE, VEC_BIAS, VEC_DENSITY, VEC_HEAD };

// Step s of a tile's chain (2 n_layers + 4 + 2 n_extra steps): the product
// that makes its accumulator, its epilogue, its vector and the stash block
// of its output.
struct Layer {
  int n;                          // the product's width, 256 or 128
  bool fwd;                       // the product's B: W (forward) or W^T (backward)
  int n_main, n_slabs;            // A: activation chunks, then the embedding chunk
  bool head;                      // no product: the color head, forward and bf16(gz @ W_last^T)
  bool demb;                      // after the epilogue the dir embedding replaces the xyz embedding
  Epilogue e;
  int vec_kind, vec_tensor;       // the vector: what, and of which tensor
  bool stash_g;                   // the output goes to the cotangent stash (else the activation stash)
  int col;                        // at this column
};

__device__ __forceinline__ Layer layer_of(const TileArgs& p, int s, uint32_t* mask_t) {
  const int nl = p.n_layers, ne = p.n_extra;
  const int l_int = nl, l_den = nl + 1, l_c0 = nl + 2;
  auto xyz_mask = [&](int l) { return mask_t + (l * (H / 64)) * CONSUMERS; };
  auto color_mask = [&](int e) { return mask_t + (MAX_LAYERS * (H / 64) + e * (HD / 64)) * CONSUMERS; };
  Layer L{};
  L.n = H;
  L.n_main = 4;
  L.n_slabs = 4;
  L.vec_kind = VEC_NONE;
  if (s < nl) {  // xyz layer s
    const bool skip = s > 0 && ((p.skip_mask >> s) & 1);
    L.fwd = true;
    L.n_main = s == 0 ? 0 : 4;
    L.n_slabs = s == 0 ? 1 : (skip ? 5 : 4);
    L.e = Epilogue{true, true, true, xyz_mask(s)};
    L.vec_kind = VEC_BIAS;
    L.vec_tensor = s;
    L.col = a_y(s);
    return L;
  }
  s -= nl;
  if (s == 0) {  // intermediate, no ReLU
    L.fwd = true;
    L.demb = true;
    L.e = Epilogue{true, false, true, nullptr};
    L.vec_kind = VEC_BIAS;
    L.vec_tensor = l_int;
    L.col = a_inter(nl);
    return L;
  }
  L.n = HD;
  if (s <= 1 + ne) {  // color layers over [intermediate | dir embedding], then the extra ones
    const int e = s - 1;
    L.fwd = true;
    L.n_main = e == 0 ? 4 : 2;
    L.n_slabs = e == 0 ? 5 : 2;
    L.e = Epilogue{true, true, true, color_mask(e)};
    L.vec_kind = VEC_BIAS;
    L.vec_tensor = l_c0 + e;
    L.col = a_cact(nl, e);
    return L;
  }
  s -= 2 + ne;
  L.stash_g = true;
  if (s == 0) {  // the last color layer's output cotangent
    L.head = true;
    L.e = Epilogue{false, false, false, color_mask(ne)};
    L.vec_kind = VEC_HEAD;
    L.vec_tensor = l_c0 + 1 + ne;
    L.col = g_c(nl, ne);
    return L;
  }
  if (s <= ne) {  // back through the extra color layers
    const int e = ne - s;
    L.n_main = L.n_slabs = 2;
    L.e = Epilogue{false, false, false, color_mask(e)};
    L.col = g_c(nl, e);
    return L;
  }
  s -= ne + 1;
  L.n = H;
  if (s == 0) {  // intermediate: only the hidden rows of the first color layer carry the gradient on
    L.n_main = L.n_slabs = 2;
    L.e = Epilogue{false, false, false, nullptr};
    L.col = g_inter(nl);
    return L;
  }
  if (s == 1) {  // features: intermediate and density heads, then the ReLU of the last xyz layer
    L.e = Epilogue{false, false, true, xyz_mask(nl - 1)};
    L.vec_kind = VEC_DENSITY;
    L.vec_tensor = l_den;
    L.col = g_y(nl - 1);
    return L;
  }
  const int l = nl - s + 1;  // xyz layer l (nl - 1 .. 1): the cotangent of its input
  L.e = Epilogue{false, false, false, xyz_mask(l - 1)};
  L.col = g_y(l - 1);
  return L;
}

__device__ __forceinline__ void tile_producer(const TileArgs& p, Ring& r) {
  const int nl = p.n_layers, ne = p.n_extra;
  const int l_int = nl, l_c0 = nl + 2;
  for (int tile = blockIdx.x; tile < p.n_tiles; tile += gridDim.x) {
    load_rows(r, &p.w256_fwd, p.wrow[0], 1, 4);
    for (int l = 1; l < nl; ++l) load_rows(r, &p.w256_fwd, p.wrow[l], ((p.skip_mask >> l) & 1) ? 5 : 4, 4);
    load_rows(r, &p.w256_fwd, p.wrow[l_int], 4, 4);
    load_rows(r, &p.w128_fwd, p.wrow[l_c0], 5, 2);
    for (int e = 0; e < ne; ++e) load_rows(r, &p.w128_fwd, p.wrow[l_c0 + 1 + e], 2, 2);
    for (int e = ne - 1; e >= 0; --e) load_cols(r, &p.w128_bwd, p.wrow[l_c0 + 1 + e], 2);
    load_cols(r, &p.w128_bwd, p.wrow[l_c0], 2);
    load_cols(r, &p.w256_bwd, p.wrow[l_int], 4);
    for (int l = nl - 1; l >= 1; --l) load_cols(r, &p.w256_bwd, p.wrow[l], 4);
  }
}

// The vector ring: one buffer per step, two buffers, filled by one warp of
// the producer warp group ahead of the consumers, so that the epilogues read
// their bias (or the density or color head's weights) from shared memory.
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

// One warp: every step's vector, in the consumers' order.
__device__ __forceinline__ void vec_producer(const TileArgs& p, VecRing& v) {
  const int lane = threadIdx.x & 31;
  const int n_steps = 2 * p.n_layers + 4 + 2 * p.n_extra;
  for (int tile = blockIdx.x; tile < p.n_tiles; tile += gridDim.x) {
    for (int s = 0; s < n_steps; ++s) {
      const Layer L = layer_of(p, s, nullptr);
      mbar_wait(&v.empty[v.idx], v.phase ^ 1);
      float* dst = v.buf + v.idx * VEC_FLOATS;
      if (L.vec_kind == VEC_BIAS) {
        for (int c = lane; c < L.n; c += 32) dst[c] = p.b[L.vec_tensor][c];
      } else if (L.vec_kind == VEC_DENSITY) {
        for (int c = lane; c < H; c += 32) dst[c] = __bfloat162float(p.w[L.vec_tensor][c]);
      } else if (L.vec_kind == VEC_HEAD) {  // W_last (HD x C, bf16), then its bias at float H
        for (int c = lane; c < HD * p.color_dim; c += 32) reinterpret_cast<bf16*>(dst)[c] = p.w[L.vec_tensor][c];
        for (int c = lane; c < p.color_dim; c += 32) dst[H + c] = p.b[L.vec_tensor][c];
      }
      mbar_arrive(&v.full[v.idx]);
      v.advance();
    }
  }
}

// The color head 128 -> C with sigmoid, two threads a point, from W_last and
// its bias in `vec` (bf16 HD x C, then C floats from float H): the bf16 sigmoid and density
// cotangents into the point vectors and the heads block of the cotangent
// stash; then bf16(gz @ W_last^T) in the accumulator's layout, the
// epilogue's input.
__device__ __forceinline__ void color_head(const TileArgs& p, float (&acc)[64], const float* vec,
                                           const unsigned char* act_wg, float* vec_wg, int row0g, int wg) {
  const int t = threadIdx.x & (WG - 1);
  const int C = p.color_dim;
  const bf16* wl = reinterpret_cast<const bf16*>(vec);
  {
    const int rr = t >> 1, half = t & 1;
    float s[MAXC] = {0.f, 0.f, 0.f, 0.f};
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
    if (half == 0) {
      float* v = vec_wg + rr * VEC;
      const float* bl = vec + H;
      const float gd = round_bf16(v[V_G]);
      v[V_GDEN] = gd;
      float gz[MAXC];
#pragma unroll
      for (int c = 0; c < MAXC; ++c) {
        gz[c] = 0.f;
        if (c < C) {
          const float col = __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-__fadd_rn(s[c], bl[c]))));
          gz[c] = round_bf16(__fmul_rn(__fmul_rn(v[V_G + 1 + c], col), __fsub_rn(1.0f, col)));
        }
        v[V_GZ + c] = gz[c];
      }
      // the heads block: density, the C sigmoid cotangents, zeros
      const __nv_bfloat162 h01 = __floats2bfloat162_rn(gd, gz[0]), h23 = __floats2bfloat162_rn(gz[1], gz[2]),
                           h45 = __floats2bfloat162_rn(gz[3], 0.f);
      if (row0g + rr < p.n_points)
        *reinterpret_cast<uint4*>(stash_at(p.sa_ptr, p.n_points, row0g + rr, a_heads(p.n_layers))) =
            make_uint4(*reinterpret_cast<const uint32_t*>(&h01), *reinterpret_cast<const uint32_t*>(&h23),
                       *reinterpret_cast<const uint32_t*>(&h45), 0u);
    }
  }
  named_bar_sync(1 + wg, WG);
#pragma unroll
  for (int i = 0; i < 16; ++i) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float* gz = vec_wg + acc_row(t, q) * VEC + V_GZ;
      const int col = acc_col(t, i, q);
      float s = 0.f;
#pragma unroll
      for (int c = 0; c < MAXC; ++c)
        if (c < C) s = __fmaf_rn(gz[c], __bfloat162float(wl[col * C + c]), s);
      acc[4 * i + q] = s;
    }
  }
}

__device__ __forceinline__ void tile_consumer(const TileArgs& p, Ring& r, VecRing& v, unsigned char* act,
                                              unsigned char* emb, uint32_t* masks, float* vec) {
  const int wg = threadIdx.x / WG, t = threadIdx.x & (WG - 1);
  const int n_steps = 2 * p.n_layers + 4 + 2 * p.n_extra;
  unsigned char* act_wg = act + wg * WG_ROWS_BYTES;
  unsigned char* emb_wg = emb + wg * WG_ROWS_BYTES;
  const uint32_t a_act = smem_u32(act_wg), a_emb_wg = smem_u32(emb_wg);
  float* vec_wg = vec + wg * 64 * VEC;
  float acc[128];

  for (int tile = blockIdx.x; tile < p.n_tiles; tile += gridDim.x) {
    const int row0g = tile * TILE + wg * 64;  // the warp group's first point
    // inputs; rows past the end get zero points and cotangents (stores there are dropped)
    if (t < 64) {
      const int gi = row0g + t;
      float* pv = vec_wg + t * VEC;
      float x0 = 0.f, x1 = 0.f, x2 = 0.f, d0 = 0.f, d1 = 0.f, d2 = 0.f;
      for (int c = 0; c <= MAXC; ++c) pv[V_G + c] = 0.f;
      if (gi < p.n_points) {
        x0 = p.points[3 * gi];
        x1 = p.points[3 * gi + 1];
        x2 = p.points[3 * gi + 2];
        const int ray = gi / p.pts_per_ray;
        d0 = p.dirs[3 * ray];
        d1 = p.dirs[3 * ray + 1];
        d2 = p.dirs[3 * ray + 2];
        for (int c = 0; c <= p.color_dim; ++c) pv[V_G + c] = p.g[(size_t)gi * (1 + p.color_dim) + c];
      }
      const float sq = __fmaf_rn(d2, d2, __fmaf_rn(d0, d0, __fmul_rn(d1, d1)));
      const float nrm = sqrtf(fmaxf(sq, 1e-24f));
      pv[V_PTS] = x0;
      pv[V_PTS + 1] = x1;
      pv[V_PTS + 2] = x2;
      pv[V_DN] = __fdiv_rn(d0, nrm);
      pv[V_DN + 1] = __fdiv_rn(d1, nrm);
      pv[V_DN + 2] = __fdiv_rn(d2, nrm);
    }
    named_bar_sync(1 + wg, WG);
    embed_rows(p, vec_wg, V_PTS, p.nf_xyz, p.app_xyz, KX_MAX, emb_wg, a_emb(), row0g);
    end_write(wg);

    // the recomputed forward, then the backward chain; every layer's output stashed
    for (int s = 0; s < n_steps; ++s) {
      const Layer L = layer_of(p, s, masks + threadIdx.x);
      const float* lvec = v.buf + v.idx * VEC_FLOATS;
      mbar_wait(&v.full[v.idx], v.phase);
      if (L.head) {  // its own registers: only wgmma defines the accumulator
        float head[64];
        color_head(p, head, lvec, act_wg, vec_wg, row0g, wg);
        begin_write(wg);
        epilogue(head, L.e, lvec, vec_wg + V_GDEN, act_wg);
      } else if (L.n == H) {
        gemm(acc, r, L.fwd, a_act, L.n_main, a_emb_wg, L.n_slabs);
        begin_write(wg);
        epilogue(acc, L.e, lvec, vec_wg + V_GDEN, act_wg);
      } else {
        gemm(acc64(acc), r, L.fwd, a_act, L.n_main, a_emb_wg, L.n_slabs);
        begin_write(wg);
        epilogue(acc64(acc), L.e, lvec, vec_wg + V_GDEN, act_wg);
      }
      // the xyz embedding's last reader is done: the dir embedding takes its place
      if (L.demb) embed_rows(p, vec_wg, V_DN, p.nf_dir, p.app_dir, KD_MAX, emb_wg, a_demb(p.n_layers), row0g);
      end_write(wg);
      if ((threadIdx.x & 31) == 0) mbar_arrive(&v.empty[v.idx]);
      v.advance();
      stash_rows(L.stash_g ? &p.sg : &p.sa, act_wg, L.n / 64, L.col, row0g);
    }
  }
  if (t == 0) bulk_wait();
}

__device__ __forceinline__ unsigned char* aligned_smem(unsigned char* raw) {
  return raw + ((1024 - (smem_u32(raw) & 1023)) & 1023);
}

__global__ void __launch_bounds__(THREADS, 1) tile_kernel(const __grid_constant__ TileArgs p) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + OFF_BAR);
  Ring r{smem + OFF_RING, bars, bars + STAGES, 0, 0};
  VecRing v{reinterpret_cast<float*>(smem + OFF_VECRING), bars + 2 * STAGES, bars + 2 * STAGES + 2, 0, 0};
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&r.full[s], 1);
      mbar_init(&r.empty[s], EMPTY_ARRIVALS);
    }
    for (int s = 0; s < 2; ++s) {
      mbar_init(&v.full[s], 32);
      mbar_init(&v.empty[s], EMPTY_ARRIVALS);
    }
    fence_barrier_init();
  }
  __syncthreads();
  if (threadIdx.x >= CONSUMERS) {
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == CONSUMERS)
      tile_producer(p, r);
    else if (threadIdx.x / 32 == CONSUMERS / 32 + 1)
      vec_producer(p, v);
  } else {
    setmaxnreg_inc<CONSUMER_REGS>();
    tile_consumer(p, r, v, smem + OFF_ACT, smem + OFF_EMB, reinterpret_cast<uint32_t*>(smem + OFF_MASK),
                  reinterpret_cast<float*>(smem + OFF_VEC));
  }
}

// ---- pass 2 ---------------------------------------------------------------

template <int NACC>
__device__ __forceinline__ void dw_consumer(const DwArgs& p, const DwJob& job, int slice, int steps, unsigned char* stages,
                            uint64_t* full, uint64_t* empty) {
  constexpr int N = 2 * NACC;
  const int wg = threadIdx.x / WG, t = threadIdx.x & (WG - 1);
  const bool signals = (threadIdx.x & 31) == 0;
  const bool active = (wg == 0 ? job.rows0 : job.rows1) > 0;
  // db: thread (group, unit) sums the cotangent columns 8 unit .. 8 unit + 7 over
  // the rows group, group + GROUPS, ... of every step; the groups' sums are
  // added in a fixed order at the end
  constexpr int UNITS = N / 8, GROUPS = CONSUMERS / UNITS;
  const int unit = threadIdx.x % UNITS, group = threadIdx.x / UNITS;
  const bool sums = job.b_off >= 0;
  float acc[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc[i] = 0.f;
  fence_operand(acc);
  float bsum[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  int stage = 0, prev = 0;
  uint32_t phase = 0;
  for (int s = 0; s < steps; ++s) {
    unsigned char* st = stages + stage * DW_STAGE_BYTES;
    mbar_wait(&full[stage], phase);
    if (sums) {
      const unsigned char* gbox = st + DW_A_BYTES + (unit >> 3) * 64 * 128;
      for (int pt = group; pt < 64; pt += GROUPS) {
        const uint4 raw = *reinterpret_cast<const uint4*>(gbox + sw128_offset(pt, (unit & 7) * 8));
        const bf16* g8 = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
        for (int e = 0; e < 8; ++e) bsum[e] = __fadd_rn(bsum[e], __bfloat162float(g8[e]));
      }
    }
    if (active) {
      const uint32_t a = smem_u32(st + wg * 64 * 128), b = smem_u32(st + DW_A_BYTES);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < 4; ++k)
        wgmma_k16<1, 1>(acc, mnmajor_desc(a + k * 2048, 64 * 128), mnmajor_desc(b + k * 2048, 64 * 128), 1);
      wgmma_commit();
    }
    if (s > 0) {
      wgmma_wait<1>();
      if (signals) mbar_arrive(&empty[prev]);
    }
    prev = stage;
    if (++stage == DW_STAGES) {
      stage = 0;
      phase ^= 1;
    }
  }
  wgmma_wait<0>();
  fence_operand(acc);
  if (steps > 0 && signals) mbar_arrive(&empty[prev]);

  float* out = p.part + (size_t)slice * p.total;
  const int rows = wg == 0 ? job.rows0 : job.rows1;
#pragma unroll
  for (int i = 0; i < NACC / 4; ++i) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int r = acc_row(t, q), c = acc_col(t, i, q) - job.shift;
      if (r < rows && c >= 0 && c < job.n_out)
        out[job.w_off + (size_t)(job.row0 + 64 * wg + r) * job.n_out + c] = acc[4 * i + q];
    }
  }
  if (sums) {  // every stage is consumed: stage 0 holds the groups' sums
    float* red = reinterpret_cast<float*>(stages);
    named_bar_sync(1, CONSUMERS);
#pragma unroll
    for (int e = 0; e < 8; ++e) red[group * N + unit * 8 + e] = bsum[e];
    named_bar_sync(1, CONSUMERS);
    const int c = threadIdx.x - job.shift;
    if (threadIdx.x < N && c >= 0 && c < job.n_out) {
      float total = 0.f;
      for (int gr = 0; gr < GROUPS; ++gr) total = __fadd_rn(total, red[gr * N + threadIdx.x]);
      out[p.w_total + job.b_off + c] = total;
    }
  }
}

__global__ void __launch_bounds__(THREADS, 1) dw_kernel(const __grid_constant__ DwArgs p) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + DW_STAGES * DW_STAGE_BYTES);
  uint64_t* empty = full + DW_STAGES;

  // blockIdx.x -> (job, slice): the row blocks of one (tensor, slice) are adjacent
  int b = blockIdx.x, j = 0, slice = 0;
  while (j < p.n_jobs) {
    const int group = p.jobs[j].group;
    if (b < group * p.n_split) {
      slice = b / group;
      j += b - slice * group;
      break;
    }
    b -= group * p.n_split;
    j += group;
  }
  if (j >= p.n_jobs) return;
  const DwJob& job = p.jobs[j];
  const int p0 = slice * p.chunk;
  const int p1 = min(p.n_points, p0 + p.chunk);
  const int steps = p1 > p0 ? (p1 - p0 + 63) / 64 : 0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < DW_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], EMPTY_ARRIVALS);
    }
    fence_barrier_init();
  }
  __syncthreads();
  if (threadIdx.x >= CONSUMERS) {
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == CONSUMERS) {
      const int n_g = job.n_mma / 64;
      const int a_col1 = job.rows1 > 0 ? job.a_col1 : job.a_col0;
      const CUtensorMap* gmap = job.g_stash ? &p.sa : &p.sg;
      int stage = 0;
      uint32_t phase = 0;
      for (int s = 0; s < steps; ++s) {
        const int pt = p0 + 64 * s;
        unsigned char* st = smem + stage * DW_STAGE_BYTES;
        mbar_wait(&empty[stage], phase ^ 1);
        mbar_arrive_expect_tx(&full[stage], DW_A_BYTES + n_g * 64 * 128);
        tma_load_3d(st, &p.sa, 0, pt, job.a_col0 / 64, &full[stage]);
        tma_load_3d(st + 64 * 128, &p.sa, 0, pt, a_col1 / 64, &full[stage]);
        for (int c = 0; c < n_g; ++c)
          tma_load_3d(st + DW_A_BYTES + c * 64 * 128, gmap, 0, pt, job.g_col / 64 + c, &full[stage]);
        if (++stage == DW_STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    setmaxnreg_inc<CONSUMER_REGS>();
    if (job.n_mma == 256)
      dw_consumer<128>(p, job, slice, steps, smem, full, empty);
    else if (job.n_mma == 128)
      dw_consumer<64>(p, job, slice, steps, smem, full, empty);
    else
      dw_consumer<32>(p, job, slice, steps, smem, full, empty);
  }
}

// ---- pass 3 ---------------------------------------------------------------

__global__ void dw_reduce_kernel(const float* __restrict__ part, float* __restrict__ out, long long total,
                                 int n_split) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  float s = 0.f;
  for (int sp = 0; sp < n_split; ++sp) s += part[(size_t)sp * total + i];
  out[i] = s;
}

// ---- the one-layer check --------------------------------------------------

struct LayerCheckArgs {
  CUtensorMap w_fwd, w_bwd, y, z;
  const bf16* a;  // (128, 256)
};

// y = bf16(a @ w), z = bf16(y @ w^T) for one 128-row tile, through pass 1's
// ring, descriptors, epilogues and TMA stores.
__global__ void __launch_bounds__(THREADS, 1) layer_check_kernel(const __grid_constant__ LayerCheckArgs p) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + OFF_BAR);
  Ring r{smem + OFF_RING, bars, bars + STAGES, 0, 0};
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&r.full[s], 1);
      mbar_init(&r.empty[s], EMPTY_ARRIVALS);
    }
    fence_barrier_init();
  }
  __syncthreads();
  if (threadIdx.x >= CONSUMERS) {
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == CONSUMERS) {
      load_rows(r, &p.w_fwd, 0, 4, 4);
      load_cols(r, &p.w_bwd, 0, 4);
    }
  } else {
    setmaxnreg_inc<CONSUMER_REGS>();
    const int wg = threadIdx.x / WG, t = threadIdx.x & (WG - 1);
    unsigned char* act_wg = smem + OFF_ACT + wg * WG_ROWS_BYTES;
    for (int u = t; u < 64 * 32; u += WG) {  // 64 rows x 32 units of 8
      const int row = u >> 5, col = (u & 31) * 8;
      *reinterpret_cast<uint4*>(act_wg + (col >> 6) * CHUNK_BYTES + sw128_offset(row, col & 63)) =
          *reinterpret_cast<const uint4*>(p.a + (size_t)(wg * 64 + row) * H + col);
    }
    float* zero_bias = reinterpret_cast<float*>(smem + OFF_VECRING);
    for (int c = threadIdx.x; c < H; c += CONSUMERS) zero_bias[c] = 0.0f;
    end_write(wg);
    named_bar_sync(3, CONSUMERS);  // the zero bias is written
    float acc[128];
    gemm_tb<1>(acc, r, smem_u32(act_wg), 4, 0, 4);
    begin_write(wg);
    epilogue(acc, Epilogue{true, false, true, nullptr}, zero_bias, nullptr, act_wg);
    end_write(wg);
    stash_rows(&p.y, act_wg, 4, 0, wg * 64);
    gemm_tb<0>(acc, r, smem_u32(act_wg), 4, 0, 4);
    begin_write(wg);
    epilogue(acc, Epilogue{false, false, false, nullptr}, nullptr, nullptr, act_wg);
    end_write(wg);
    stash_rows(&p.z, act_wg, 4, 0, wg * 64);
    if (t == 0) bulk_wait();
  }
}

int set_smem(const void* kernel, int bytes) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

}  // namespace

// Launches the three passes on `stream` and returns the first CUDA error (0
// on success). `w_off`/`b_off` are host arrays of element offsets into the
// packed bf16 weights and float32 biases, one per tensor in kernel order (xyz
// layers, intermediate, density, color layers); the gradients come out in
// the same layout in `out` ([weights | biases], float32). `jobs` is the host
// array of pass 2's plan, JOB_FIELDS ints per job (weight_grad_jobs). The
// caller allocates the stashes ((lda / 64, n_points, 64) and (ldg / 64, n_points, 64) bf16) and the
// zeroed partials (n_split x (w_total + b_total)).
extern "C" int nerf_mlp_bwd_bf16(const void* points, const void* dirs, const void* g, const void* wbuf,
                                 const void* bbuf, const void* w_off, const void* b_off, void* stash_a, void* stash_g,
                                 void* partials, void* out, const void* jobs, int n_tensors, int n_points,
                                 int pts_per_ray, int n_layers, int skip_mask, int nf_xyz, int app_xyz, int nf_dir,
                                 int app_dir, int n_extra_color, int color_dim, int lda, int ldg, int w_total,
                                 int b_total, int n_split, int n_jobs, void* stream) {
  TileArgs p;
  DwArgs q;
  const int k_xyz = nerf_mlp::round16(3 * (2 * nf_xyz + (app_xyz ? 1 : 0)));
  const int k_dir = nerf_mlp::round16(3 * (2 * nf_dir + (app_dir ? 1 : 0)));
  if (n_layers < 1 || n_layers > MAX_LAYERS || n_extra_color < 0 || n_extra_color > MAX_EXTRA ||
      n_tensors != n_layers + 4 + n_extra_color || k_xyz > KX_MAX || k_dir > KD_MAX || pts_per_ray < 1 ||
      color_dim < 1 || color_dim > MAXC || lda != a_width(n_layers, n_extra_color) ||
      ldg != g_width(n_layers, n_extra_color) || n_split < 1 || n_jobs < 1 || n_jobs > MAX_JOBS)
    return (int)cudaErrorInvalidValue;
  if (n_points == 0) return 0;
  const long long* wo = static_cast<const long long*>(w_off);
  const long long* bo = static_cast<const long long*>(b_off);
  const int l_c0 = n_layers + 2;
  for (int i = 0; i < n_tensors; ++i) {
    p.w[i] = static_cast<const bf16*>(wbuf) + wo[i];
    p.b[i] = static_cast<const float*>(bbuf) + bo[i];
    const int width = (i >= l_c0 && i < l_c0 + 1 + n_extra_color) ? HD : H;
    if (wo[i] % width != 0) return (int)cudaErrorInvalidValue;
    p.wrow[i] = (int)(wo[i] / width);
  }
  p.points = static_cast<const float*>(points);
  p.dirs = static_cast<const float*>(dirs);
  p.g = static_cast<const float*>(g);
  p.sa_ptr = static_cast<bf16*>(stash_a);
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

  int err = make_bf16_map(&p.w256_fwd, wbuf, w_total / H, H, H * 2, 64, 64);
  if (!err) err = make_bf16_map(&p.w256_bwd, wbuf, w_total / H, H, H * 2, H, 64);
  if (!err) err = make_bf16_map(&p.w128_fwd, wbuf, w_total / HD, HD, HD * 2, 64, 64);
  if (!err) err = make_bf16_map(&p.w128_bwd, wbuf, w_total / HD, HD, HD * 2, H, 64);
  if (!err) err = make_bf16_blocked_map(&p.sa, stash_a, lda / 64, n_points, 64);
  if (!err) err = make_bf16_blocked_map(&p.sg, stash_g, ldg / 64, n_points, 64);
  if (err) return err;

  int device = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return (int)e;
  if ((err = set_smem((const void*)tile_kernel, SMEM1)) != 0) return err;
  if ((err = set_smem((const void*)dw_kernel, SMEM2)) != 0) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  tile_kernel<<<p.n_tiles < sms ? p.n_tiles : sms, THREADS, SMEM1, st>>>(p);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;

  q.sa = p.sa;
  q.sg = p.sg;
  q.part = static_cast<float*>(partials);
  q.n_points = n_points;
  q.chunk = ((n_points + n_split - 1) / n_split + 63) / 64 * 64;
  q.n_jobs = n_jobs;
  q.n_split = n_split;
  q.total = (long long)w_total + b_total;
  q.w_total = w_total;
  const long long* plan = static_cast<const long long*>(jobs);
  for (int i = 0; i < n_jobs; ++i) {
    const long long* f = plan + (size_t)i * JOB_FIELDS;
    DwJob& d = q.jobs[i];
    d.tensor = (int)f[0];
    d.row0 = (int)f[1];
    d.a_col0 = (int)f[2];
    d.rows0 = (int)f[3];
    d.a_col1 = (int)f[4];
    d.rows1 = (int)f[5];
    d.g_stash = (int)f[6];
    d.g_col = (int)f[7];
    d.n_mma = (int)f[8];
    d.shift = (int)f[9];
    d.n_out = (int)f[10];
    if (d.tensor < 0 || d.tensor >= n_tensors || (d.n_mma != 64 && d.n_mma != 128 && d.n_mma != 256))
      return (int)cudaErrorInvalidValue;
    d.w_off = wo[d.tensor];
    d.b_off = f[11] ? bo[d.tensor] : -1;
  }
  for (int i = 0; i < n_jobs;) {  // the jobs of one tensor are adjacent: their count goes to the first
    int k = i + 1;
    while (k < n_jobs && q.jobs[k].tensor == q.jobs[i].tensor) ++k;
    q.jobs[i].group = k - i;
    for (int m = i + 1; m < k; ++m) q.jobs[m].group = 0;
    i = k;
  }
  dw_kernel<<<n_jobs * n_split, THREADS, SMEM2, st>>>(q);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;

  const long long total = q.total;
  dw_reduce_kernel<<<(unsigned)((total + 255) / 256), 256, 0, st>>>(static_cast<float*>(partials),
                                                                    static_cast<float*>(out), total, n_split);
  return (int)cudaGetLastError();
}

// The one-layer check of pass 1's building blocks: y = bf16(a @ w) and
// z = bf16(y @ w^T) for a (128, 256) and w (256, 256) bf16 row-major; y and
// z come out column-blocked as the stash, (4, 128, 64).
extern "C" int nerf_mlp_bwd_layer_check(const void* a, const void* w, void* y, void* z, void* stream) {
  LayerCheckArgs p;
  p.a = static_cast<const bf16*>(a);
  int err = make_bf16_map(&p.w_fwd, w, H, H, H * 2, 64, 64);
  if (!err) err = make_bf16_map(&p.w_bwd, w, H, H, H * 2, H, 64);
  if (!err) err = make_bf16_blocked_map(&p.y, y, H / 64, TILE, 64);
  if (!err) err = make_bf16_blocked_map(&p.z, z, H / 64, TILE, 64);
  if (!err) err = set_smem((const void*)layer_check_kernel, SMEM1);
  if (err) return err;
  layer_check_kernel<<<1, THREADS, SMEM1, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}
