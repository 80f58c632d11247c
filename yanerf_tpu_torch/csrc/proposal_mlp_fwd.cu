// The density-only ProposalMLP forward for Hopper (sm_90a): K7.
//
// No Pallas kernel stands behind it: the JAX package leaves the ProposalMLP
// (yanerf_tpu/models/proposal_mlp.py) to XLA, and the port's eager model
// runs it as ~30 PyTorch kernels a call: the harmonic embedding (a
// multiply, sin, cos, cat, a cast), then per layer a cast of w and b, a
// GEMM, a bias add and a ReLU, then the density head. Each writes and reads
// back a (points, 128) activation. K7 computes the whole function per
// point in one launch, (n, 3) float32 points in, (n, 1) float32 raw
// density out:
//   * the embedding: sin | cos | x, frequency-major, cos(t) as
//     sin(t + pi/2), the accurate sinf, rounded to bf16 (embed_pairs of
//     nerf_mlp_tile.cuh, the code K1 embeds with), zeros up to 64 columns;
//   * n_layers layers of 128 (the first over the 64 embedding columns):
//     bf16 products summed in float32 by wgmma, then bf16(relu(acc + b))
//     with the bias added in float32 (K1's epilogue arithmetic). The first
//     layer's bias may differ per point: a latent model's codes @ W[63:] is
//     folded into one bias row per batch element by the wrapper
//     (ops/kernels/proposal_mlp_fwd.py), and point g takes row
//     g / points_per_bias_row;
//   * the density head 128 -> 1 on the last layer's registers: each thread
//     sums its 32 columns of a row in float32, four lanes hold a row, two
//     shuffles add them, and the head's bias is added last.
// No activation touches device memory.
//
// What bounds it: operations. 57,344 multiply-adds a point (63 x 128 +
// 3 x 128^2 + 128 at the shipped 4 x 128) against 16 bytes of input and
// output: 15.0 GFLOP a served call of 130,880 points, 15.2 us at 989
// TFLOP/s, while its 2.1 MB cross HBM in under 1 us.
//
// What the design does about it: the weights are small (64 x 128 + 3 x
// 128 x 128 bf16, 112 KB at the shipped widths), so a persistent CTA per SM
// loads all of them into shared memory once per launch by TMA, in the
// 128B-swizzled layout wgmma reads as an MN-major B, and keeps them there
// while it walks 256-point tiles: there is no weight ring and no producer
// warp. Four warp groups of 64 points each share no step, so one's
// embedding and epilogues (CUDA cores) overlap another's products (tensor
// cores). Layer 0 reads the embedding from shared memory (128B-swizzled,
// the K-major A of wgmma m64n128k16); every later layer takes its A from
// registers: wgmma's accumulator layout, two columns a thread in rows r and
// r + 8, is that of the register A operand, so bf16(relu(acc + b)) packed in
// pairs is the next layer's A as it stands, with no store, no barrier and
// no shared-memory read of the activations. Six layers' weights fill a
// block's shared memory; more are refused.
//
// Measured on an NVIDIA H100 80GB HBM3 at a 700.00 W power limit (130,880
// points, from a CUDA graph of 50 calls): 44.6-46.5 us, a third of its
// bound. Timed builds of other designs: two warp groups with the
// activations in shared memory 78 us (99 us with the products' slab count
// not known at compile time, where ptxas serialised the wgmma chain), three
// and four such warp groups 65 / 51 us; with A in registers two / three /
// four warp groups 59 / 54 / 45 us. Four warp groups with a part removed
// (wrong output, for the time alone): without the embedding 30 us, without
// the products 25 us, without the epilogues 40 us: the embedding's 60
// accurate sines a point, which no product overlaps well, is the largest
// part left.
//
// Built with nvcc into a shared library with a plain C entry point
// (proposal_mlp_fwd_bf16), loaded with ctypes by
// ops/kernels/proposal_mlp_fwd.py.

#include "nerf_mlp_tile.cuh"

namespace {

using namespace hopper;
typedef __nv_bfloat16 bf16;

constexpr int HIDDEN = 128;                 // the layers' width
constexpr int K_EMB = 64;                   // the embedding's padded width: 10 frequencies and x, 63 -> 64
constexpr int WGS = 4;                      // warp groups, 64 points each
constexpr int MAX_LAYERS = 6;               // the most layers whose weights fit a block's shared memory
constexpr int WG = 128;                     // threads of a warp group
constexpr int THREADS = WGS * WG;
constexpr int TILE = 64 * WGS;              // points a tile
constexpr int CHUNK_BYTES = TILE * 128;     // the embedding: 64 columns of the tile's rows, bf16, swizzled
constexpr int WG_ROWS_BYTES = 64 * 128;     // one warp group's rows of it
constexpr int BOX_BYTES = 64 * 128;         // a 64 x 64 box of W: 64 lines of 128 bytes
constexpr int SLAB_BYTES = 2 * BOX_BYTES;   // 64 rows of a layer's W (128 columns), 16 KB
constexpr int PV = 4;                       // floats a staged point

static_assert(WG == nerf_mlp::WG, "end_write syncs a warp group of K1's size");

struct Args {
  CUtensorMap w;             // the packed weights as (rows, 128) bf16, boxes of 64 x 64
  const float* points;       // (n_points, 3)
  float* out;                // (n_points, 1)
  const float* first_bias;   // (bias_rows, 128): layer 0's bias, one row per batch element
  const float* biases;       // layer l's bias at 128 * l (l >= 1), the head's bias at 128 * n_layers
  const bf16* head;          // the head's 128 weights
  long long points_per_bias_row;
  int bias_rows, n_points, n_layers, nf, app, n_tiles;
};

// Slabs of W: one for layer 0 (64 rows), two for every later layer.
__host__ __device__ constexpr int weight_slabs(int n_layers) { return 2 * n_layers - 1; }

// Shared memory: the weights, the embedding (64 columns of the tile's rows,
// the A operand of layer 0; later layers take A from registers), the
// biases, the head, the staged points, one barrier.
__host__ __device__ constexpr int smem_bytes(int n_layers) {
  return weight_slabs(n_layers) * SLAB_BYTES + CHUNK_BYTES + 4 * (n_layers * HIDDEN + HIDDEN + 4 + TILE * PV) + 8 +
         1024;  // + alignment of the base to 1024
}
static_assert(smem_bytes(MAX_LAYERS) <= 232448, "MAX_LAYERS' weights exceed the shared memory of a block");

// D (64 x 128, float32, the fragment layout of acc_row / acc_col) += A (64 x 16) * B (16 x 128), A from the
// registers a0..a3 (two bf16 each: rows r and r + 8, columns 2 (t % 4) and 8 + 2 (t % 4) of the slice, r =
// 16 (t / 32) + (t % 32) / 4), B the MN-major operand of descriptor b. scale_d == 0 drops D's old value.
__device__ __forceinline__ void wgmma_m64n128k16_rs(float (&d)[64], uint32_t a0, uint32_t a1, uint32_t a2,
                                                    uint32_t a3, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "r"(scale_d));
}

// acc (64 x 128) = E @ W0: E the warp group's rows of the embedding at `e` (K-major, 64 columns), W0 the
// resident slab at `w` (MN-major, two 64-column boxes BOX_BYTES apart).
__device__ __forceinline__ void gemm_embedding(float (&acc)[64], uint32_t e, uint32_t w) {
  fence_operand(acc);
  wgmma_fence();
#pragma unroll
  for (int k = 0; k < 4; ++k)
    wgmma_m64n128k16<0, 1>(acc, kmajor_desc(e + k * 32), mnmajor_desc(w + k * 2048, BOX_BYTES), k != 0);
  wgmma_commit();
  wgmma_wait<0>();
  fence_operand(acc);
}

// acc (64 x 128) = A @ W: A the 64 x 128 bf16 activations in the registers `a` (k-slice s in a[4 s .. 4 s + 3]),
// W the layer's two resident slabs at `w`.
__device__ __forceinline__ void gemm_registers(float (&acc)[64], const uint32_t (&a)[32], uint32_t w) {
  fence_operand(acc);
  wgmma_fence();
#pragma unroll
  for (int s = 0; s < 8; ++s)
    wgmma_m64n128k16_rs(acc, a[4 * s], a[4 * s + 1], a[4 * s + 2], a[4 * s + 3],
                        mnmajor_desc(w + (s >> 2) * SLAB_BYTES + (s & 3) * 2048, BOX_BYTES), s != 0);
  wgmma_commit();
  wgmma_wait<0>();
  fence_operand(acc);
}

// bf16(relu(acc + bias)) of the accumulator's element pair j, j + 1, whose columns are c, c + 1;
// relu(bf16(x)) = bf16(relu(x)).
__device__ __forceinline__ __nv_bfloat162 activation(const float (&acc)[64], int j, const float* bias, int c) {
  const float2 b = *reinterpret_cast<const float2*>(bias + c);
  return __hmax2(__floats2bfloat162_rn(__fadd_rn(acc[j], b.x), __fadd_rn(acc[j + 1], b.y)),
                 __floats2bfloat162_rn(0.0f, 0.0f));
}

__global__ void __launch_bounds__(THREADS, 1) proposal_mlp_fwd_kernel(const __grid_constant__ Args p) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = nerf_mlp::aligned_smem(smem_raw);
  const int slabs = weight_slabs(p.n_layers);
  unsigned char* emb = smem + slabs * SLAB_BYTES;
  float* bias = reinterpret_cast<float*>(emb + CHUNK_BYTES);  // n_layers x 128; row 0 when one row serves all
  float* head = bias + p.n_layers * HIDDEN;                   // 128 weights, then the head's bias
  float* pv = head + HIDDEN + 4;
  uint64_t* bar = reinterpret_cast<uint64_t*>(pv + TILE * PV);

  // the weights by TMA, once per launch; the vectors by the threads
  if (threadIdx.x == 0) {
    mbar_init(bar, 1);
    fence_barrier_init();
    mbar_arrive_expect_tx(bar, slabs * SLAB_BYTES);
    for (int s = 0; s < slabs; ++s)
      for (int j = 0; j < 2; ++j) tma_load_2d(smem + s * SLAB_BYTES + j * BOX_BYTES, &p.w, 64 * j, 64 * s, bar);
  }
  for (int i = threadIdx.x; i < p.n_layers * HIDDEN; i += THREADS)
    bias[i] = i < HIDDEN ? (p.bias_rows == 1 ? p.first_bias[i] : 0.0f) : p.biases[i];
  for (int i = threadIdx.x; i < HIDDEN; i += THREADS) head[i] = __bfloat162float(p.head[i]);
  if (threadIdx.x == 0) head[HIDDEN] = p.biases[p.n_layers * HIDDEN];
  __syncthreads();
  mbar_wait(bar, 0);

  const int wg = threadIdx.x / WG, t = threadIdx.x & (WG - 1);
  const uint32_t e_s = smem_u32(emb + wg * WG_ROWS_BYTES);
  const uint32_t w_s = smem_u32(smem);
  float* pv_wg = pv + wg * 64 * PV;
  const int last = p.n_layers - 1;
  float acc[64];
  uint32_t a[32];  // the next layer's A: bf16 pairs in the accumulator's own layout

  for (int tile = blockIdx.x; tile < p.n_tiles; tile += gridDim.x) {
    const int row0 = tile * TILE + wg * 64;  // the warp group's first point
    if (t < 64) {
      const int g = row0 + t;
      const bool in = g < p.n_points;  // the ragged tile's rows past the end embed 0 and store nothing
      pv_wg[t * PV] = in ? p.points[3 * (size_t)g] : 0.0f;
      pv_wg[t * PV + 1] = in ? p.points[3 * (size_t)g + 1] : 0.0f;
      pv_wg[t * PV + 2] = in ? p.points[3 * (size_t)g + 2] : 0.0f;
    }
    named_bar_sync(1 + wg, WG);  // the points are staged; the last tile's layer 0 has read the embedding
    if (p.nf == 10)  // the shipped widths: the index arithmetic divides by constants
      nerf_mlp::embed_pairs<true, PV>(pv_wg, 0, 64, 10, p.app, e_s, K_EMB, t, WG);
    else
      nerf_mlp::embed_pairs<true, PV>(pv_wg, 0, 64, p.nf, p.app, e_s, K_EMB, t, WG);
    nerf_mlp::end_write(wg);

    for (int l = 0; l <= last; ++l) {
      if (l == 0)
        gemm_embedding(acc, e_s, w_s);
      else
        gemm_registers(acc, a, w_s + (2 * l - 1) * SLAB_BYTES);
      // the bias rows of the thread's two accumulator rows (acc_row(t, 0) and acc_row(t, 2))
      const float* b[2] = {bias + l * HIDDEN, bias + l * HIDDEN};
      if (l == 0 && p.bias_rows > 1) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          long long r = (row0 + acc_row(t, 2 * h)) / p.points_per_bias_row;
          b[h] = p.first_bias + (r < p.bias_rows ? r : p.bias_rows - 1) * HIDDEN;
        }
      }
      if (l < last) {
        // k-slice s of the next A is columns 16 s .. 16 s + 15: pairs j = 8 s + 2 m, m = 0..3, rows r, r + 8, r,
        // r + 8 (h = m & 1), columns 16 s + 8 (m >> 1) + 2 (t % 4)
#pragma unroll
        for (int j = 0; j < 64; j += 2) {
          const __nv_bfloat162 o = activation(acc, j, b[(j >> 1) & 1], acc_col(t, j >> 2, 0));
          a[j >> 1] = *reinterpret_cast<const uint32_t*>(&o);
        }
      } else {
        // the density head: the row's 128 columns lie in the four lanes t & ~3 .. t | 3, 32 each
        float s[2] = {0.0f, 0.0f};
#pragma unroll
        for (int j = 0; j < 64; j += 2) {
          const int c = acc_col(t, j >> 2, 0), h = (j >> 1) & 1;
          const float2 y = __bfloat1622float2(activation(acc, j, b[h], c));
          s[h] = __fmaf_rn(y.y, head[c + 1], __fmaf_rn(y.x, head[c], s[h]));
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          s[h] = __fadd_rn(s[h], __shfl_xor_sync(0xffffffffu, s[h], 1));
          s[h] = __fadd_rn(s[h], __shfl_xor_sync(0xffffffffu, s[h], 2));
          const int g = row0 + acc_row(t, 2 * h);
          if ((t & 3) == 0 && g < p.n_points) p.out[g] = __fadd_rn(s[h], head[HIDDEN]);
        }
      }
    }
  }
}

// The tensor map of the packed weights at `wbuf` (w_total bf16) as a (rows,
// 128) view with boxes of 64 x 64. A map is a function of the address and
// the size alone, so the last few are kept (per host thread) and a launch
// on a buffer seen before encodes nothing.
int weight_map(CUtensorMap* map, const void* wbuf, long long w_total) {
  struct Entry {
    CUtensorMap map;
    const void* base;
    long long total;
  };
  constexpr int N = 8;
  static thread_local Entry cache[N];
  static thread_local int used = 0, next = 0;
  for (int i = 0; i < used; ++i) {
    if (cache[i].base == wbuf && cache[i].total == w_total) {
      *map = cache[i].map;
      return 0;
    }
  }
  const int err = make_bf16_map(map, wbuf, w_total / HIDDEN, HIDDEN, HIDDEN * 2, 64, 64);
  if (err) return err;
  cache[next] = Entry{*map, wbuf, w_total};
  next = (next + 1) % N;
  if (used < N) ++used;
  return 0;
}

}  // namespace

// K7 on `stream`: (n_points, 1) float32 raw density `out` of the (n_points,
// 3) float32 `points`. `wbuf` holds w_total bf16, 128 a row: W0's 64 rows
// (the embedding's, zero-padded), then 128 rows of each later layer, then
// the head's weights as one row (ops/kernels/proposal_mlp_fwd.py::
// pack_weights); `bbuf` the float32 biases (layer l at 128 * l, the head's
// at 128 * n_layers); `first_bias` bias_rows rows of 128 float32, the row of
// point g at g / points_per_bias_row. Returns the first CUDA error (0 on
// success).
extern "C" int proposal_mlp_fwd_bf16(const void* points, void* out, const void* wbuf, long long w_total,
                                     const void* bbuf, const void* first_bias, int bias_rows,
                                     long long points_per_bias_row, int n_points, int n_layers, int nf, int app,
                                     void* stream) {
  const long long w_rows = 64LL * weight_slabs(n_layers) + 1;  // the layers' rows and the head's
  if (n_layers < 1 || n_layers > MAX_LAYERS || nerf_mlp::round16(3 * (2 * nf + (app ? 1 : 0))) > K_EMB || nf < 0 ||
      bias_rows < 1 || points_per_bias_row < 1 || n_points < 0 || w_total % HIDDEN || w_total / HIDDEN < w_rows)
    return (int)cudaErrorInvalidValue;
  if (n_points == 0) return 0;
  Args p;
  int err = weight_map(&p.w, wbuf, w_total);
  if (err) return err;
  p.points = static_cast<const float*>(points);
  p.out = static_cast<float*>(out);
  p.first_bias = static_cast<const float*>(first_bias);
  p.biases = static_cast<const float*>(bbuf);
  p.head = static_cast<const bf16*>(wbuf) + (w_rows - 1) * HIDDEN;
  p.points_per_bias_row = points_per_bias_row;
  p.bias_rows = bias_rows;
  p.n_points = n_points;
  p.n_layers = n_layers;
  p.nf = nf;
  p.app = app ? 1 : 0;
  p.n_tiles = (n_points + TILE - 1) / TILE;

  const int bytes = smem_bytes(n_layers);
  int device = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute((const void*)proposal_mlp_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return (int)e;
  const int grid = p.n_tiles < sms ? p.n_tiles : sms;
  proposal_mlp_fwd_kernel<<<grid, THREADS, bytes, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}
