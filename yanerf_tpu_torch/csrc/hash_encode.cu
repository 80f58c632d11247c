// Multiresolution hash encoding for Hopper (sm_90a): K4 (forward) and K5 (the tables' gradient).
//
// No Pallas kernel stands behind these two: the JAX package runs the
// encoding of models/hash_grid.py (Mueller et al. 2022) as XLA gathers and
// one scatter-add per level, and so does the port's plain path. K4 and K5
// compute the same rows, the same clamping to the scene box and the same
// corner order (i, j, k bits of x, y, z, z fastest):
//   * per level l, the resolution N_l; the point in [0, 1]^3 over the box,
//     times N_l, split into the cell (floor) and the fraction;
//   * a dense level ((N_l + 1)^3 rows at most the table) indexes the corner
//     (x * (N_l + 1) + y) * (N_l + 1) + z; a hashed one
//     x ^ y * 2654435761 ^ z * 805459861 in uint32 arithmetic with
//     wrap-around, modulo the table (a power of two), which the plain
//     path's int64 products masked to 32 bits equal;
//   * K4: the features of level l are the 8 corner rows weighted by the
//     trilinear weights, float32, written as (n, L * F) float32;
//   * K5: the gradient of every table row is the sum over the points and
//     corners that read it of the trilinear weight times the features'
//     cotangent, float32, written as the tables' rows one level after
//     another. The points take no gradient.
//
// What bounds them: memory latency. Per point and level 8 rows of 8 bytes
// at random addresses of a 48.8 MB set of tables (16 levels at the
// published widths), against 12 bytes of point and 8 bytes of feature
// (K4) or cotangent (K5): the row traffic is random, the L2 (50 MB) holds
// most of it, and the streamed bytes alone would take a few percent of
// the time.
//
// What the design does about it:
//   * K4: a block of 32 points x L levels, a warp per level, so that one
//     warp reads one level's table at 32 neighbouring points (a ray's
//     samples share the coarse cells: their reads coalesce). Each thread
//     issues its 8 row loads before it uses any. The block's features go
//     through shared memory, so the (n, L * F) output is written whole
//     lines at a time.
//   * K5 is deterministic without a sort: every contribution is rounded to
//     a 64-bit integer at a power-of-two scale and added with integer
//     atomics, which give the same sum in any order. The scale comes from
//     the largest |cotangent| G of the launch (its own max kernel, on the
//     card, so the launch is capturable): with G < 2^e and n points,
//     S = 61 - e - ceil(log2 n). A row sums at most n points' contributions,
//     each point's 8 corners weighing at most 1 in all, so every partial sum
//     stays under n * 2^(e + S) + 4n <= 2^61 + 4n < 2^63: no overflow. The
//     rounding step is 2^-S, about G * 2^-40 at 1.6 M points: a contribution
//     smaller than that is lost, where Adam's epsilon (1e-8) already makes
//     anything that small move its parameter by nothing. A cotangent that is
//     not finite (G = inf or NaN) cannot be scaled: the convert kernel then
//     writes NaN into every row, so the fault does not pass silently.
//     Neighbouring lanes of a warp (a ray's samples, one level) that add to
//     the same row first sum in registers (a segmented scan), which cuts the
//     atomics on the coarse levels' few rows. The scatter's grid is
//     level-major (a block is 512 points of one level), so that the
//     accumulator rows in use are one level's (8.4 MB for a hashed level),
//     which the L2 holds, and not all 97.6 MB at once.
//     K5's kernels each carry a name of their own (hash_encode_bwd_*):
//     zero the accumulator, the max, the scatter, the convert.
//
// Built with nvcc into a shared library with plain C entry points
// (hash_encode_fwd, hash_encode_bwd), loaded with ctypes by
// ops/kernels/hash_encode.py.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_LEVELS = 16;  // a block is 32 points x L levels, 512 threads at the most
constexpr int POINTS = 32;  // points a warp; a K4 block is one warp per level
constexpr int SCATTER_WARPS = 16;  // a K5 scatter block: 16 warps of 32 points, one level
constexpr unsigned FULL = 0xffffffffu;
constexpr uint32_t NO_ROW = 0xffffffffu;  // a lane past the last point

struct Levels {
  const float2* tables[MAX_LEVELS];  // K4: each level's rows, F = 2 floats each
  long long first_row[MAX_LEVELS];   // K5: the level's first row in the flat gradient
  int res[MAX_LEVELS];               // N_l
  int size[MAX_LEVELS];              // rows of the level's table
  int dense[MAX_LEVELS];             // 1: dense grid; 0: hashed (size a power of two)
  int n_levels;
  int n_points;
  float bound;       // the scene box's half extent
  float inv_extent;  // 1 / (2 * bound) in float32: PyTorch divides a CUDA tensor by a scalar as this product
};

// The 8 corner rows of the point's cell at `level` and their trilinear weights, with the plain path's roundings
// (no fused multiply-add where PyTorch rounds the product first).
__device__ __forceinline__ void corners(const Levels& p, int level, float x, float y, float z, uint32_t row[8],
                                        float w[8]) {
  const int res = p.res[level];
  const float fres = (float)res;
  const float in[3] = {x, y, z};
  int cell[3];
  float frac[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    float u = __fmul_rn(__fadd_rn(in[a], p.bound), p.inv_extent);
    u = fminf(fmaxf(u, 0.0f), 1.0f);
    const float s = __fmul_rn(u, fres);
    const float f = floorf(s);
    frac[a] = __fsub_rn(s, f);
    cell[a] = (int)f;
  }
  const uint32_t stride = (uint32_t)res + 1u;
  const uint32_t mask = (uint32_t)p.size[level] - 1u;
  const bool dense = p.dense[level] != 0;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const int bits[3] = {(c >> 2) & 1, (c >> 1) & 1, c & 1};
    uint32_t q[3];
    float wc = 1.0f;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      q[a] = (uint32_t)min(max(cell[a] + bits[a], 0), res);
      const float wa = bits[a] ? frac[a] : __fsub_rn(1.0f, frac[a]);
      wc = a == 0 ? wa : __fmul_rn(wc, wa);
    }
    w[c] = wc;
    row[c] = dense ? (q[0] * stride + q[1]) * stride + q[2]
                   : (q[0] ^ (q[1] * 2654435761u) ^ (q[2] * 805459861u)) & mask;
  }
}

__global__ void __launch_bounds__(POINTS * MAX_LEVELS) hash_encode_fwd_kernel(const __grid_constant__ Levels p,
                                                                      const float* __restrict__ points,
                                                                      float2* __restrict__ out) {
  __shared__ float2 tile[POINTS * (MAX_LEVELS + 1)];  // [point][level], a level of padding against bank conflicts
  const int lane = threadIdx.x, level = threadIdx.y, L = p.n_levels;
  const long long first = (long long)blockIdx.x * POINTS;
  const long long i = first + lane;
  if (i < p.n_points) {
    uint32_t row[8];
    float w[8];
    corners(p, level, points[3 * i], points[3 * i + 1], points[3 * i + 2], row, w);
    const float2* table = p.tables[level];
    float2 v[8];
#pragma unroll
    for (int c = 0; c < 8; ++c) v[c] = __ldg(table + row[c]);
    float2 acc = make_float2(__fmul_rn(v[0].x, w[0]), __fmul_rn(v[0].y, w[0]));
#pragma unroll
    for (int c = 1; c < 8; ++c) {
      acc.x = __fadd_rn(acc.x, __fmul_rn(v[c].x, w[c]));
      acc.y = __fadd_rn(acc.y, __fmul_rn(v[c].y, w[c]));
    }
    tile[lane * (L + 1) + level] = acc;
  }
  __syncthreads();
  // the block's rows of the output are one contiguous run of POINTS * L float2
  const int t = level * POINTS + lane;
  const int pt = t / L, lv = t - pt * L;
  if (first + pt < p.n_points) out[(first + pt) * L + lv] = tile[pt * (L + 1) + lv];
}

// -- K5 -------------------------------------------------------------------------------------------------------

__device__ __forceinline__ bool finite_max(uint32_t gbits) { return gbits != 0u && gbits < 0x7f800000u; }

// S: a contribution c is added as round(c * 2^S); see the header for the bound.
__device__ __forceinline__ int scale_shift(uint32_t gbits, int log2n) {
  int e;
  frexpf(__uint_as_float(gbits), &e);  // G = m * 2^e, 0.5 <= m < 1
  return 61 - log2n - e;
}

__global__ void hash_encode_bwd_zero_kernel(unsigned long long* __restrict__ acc, long long n_words) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n_words;
       i += (long long)gridDim.x * blockDim.x)
    acc[i] = 0ull;
}

// The largest |cotangent| as its float bits (for non-negative floats the bits order as the values; NaN above all).
__global__ void hash_encode_bwd_max_kernel(const float* __restrict__ grad, long long n, unsigned* __restrict__ gmax) {
  unsigned m = 0u;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += (long long)gridDim.x * blockDim.x)
    m = max(m, __float_as_uint(grad[i]) & 0x7fffffffu);
  m = __reduce_max_sync(FULL, m);
  if ((threadIdx.x & 31) == 0 && m) atomicMax(gmax, m);
}

__global__ void __launch_bounds__(POINTS * SCATTER_WARPS) hash_encode_bwd_scatter_kernel(
    const __grid_constant__ Levels p, const float* __restrict__ points, const float2* __restrict__ grad,
    const unsigned* __restrict__ gmax, int log2n, unsigned long long* __restrict__ acc) {
  const uint32_t gbits = *gmax;
  if (!finite_max(gbits)) return;  // all zero: nothing to add; not finite: the convert kernel writes NaN
  const int S = scale_shift(gbits, log2n);
  // level-major: the grid's blocks of one level run together, so its rows of the accumulator stay in the L2
  const int lane = threadIdx.x, level = blockIdx.y, L = p.n_levels;
  const long long i = ((long long)blockIdx.x * blockDim.y + threadIdx.y) * POINTS + lane;
  const bool valid = i < p.n_points;
  uint32_t row[8];
  float w[8];
  float2 g = make_float2(0.0f, 0.0f);
  if (valid) {
    corners(p, level, points[3 * i], points[3 * i + 1], points[3 * i + 2], row, w);
    g = grad[i * L + level];
  }
  const unsigned below = (1u << lane) - 1u;  // the lanes before this one
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const uint32_t r = valid ? row[c] : NO_ROW;
    long long q0 = 0, q1 = 0;
    if (valid) {
      q0 = __double2ll_rn(scalbn((double)__fmul_rn(w[c], g.x), S));
      q1 = __double2ll_rn(scalbn((double)__fmul_rn(w[c], g.y), S));
    }
    // runs of neighbouring lanes on one row sum in registers first; integers, so any order gives the same bits
    const uint32_t prev = __shfl_up_sync(FULL, r, 1);
    const unsigned heads = __ballot_sync(FULL, lane == 0 || prev != r);
    if (heads != FULL) {
      const int start = 31 - __clz(heads & (below | (1u << lane)));
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const long long u0 = __shfl_up_sync(FULL, q0, off), u1 = __shfl_up_sync(FULL, q1, off);
        if (lane - off >= start) {
          q0 += u0;
          q1 += u1;
        }
      }
    }
    const bool tail = lane == 31 || ((heads >> (lane + 1)) & 1u);
    if (tail && r != NO_ROW) {
      unsigned long long* dst = acc + 2 * (p.first_row[level] + r);
      if (q0) atomicAdd(dst, (unsigned long long)q0);
      if (q1) atomicAdd(dst + 1, (unsigned long long)q1);
    }
  }
}

__global__ void hash_encode_bwd_convert_kernel(const unsigned long long* __restrict__ acc, long long n_words,
                                               const unsigned* __restrict__ gmax, int log2n,
                                               float* __restrict__ out) {
  const uint32_t gbits = *gmax;
  const bool finite = gbits < 0x7f800000u;
  const int S = finite_max(gbits) ? scale_shift(gbits, log2n) : 0;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n_words;
       i += (long long)gridDim.x * blockDim.x)
    out[i] = finite ? __double2float_rn(scalbn((double)(long long)acc[i], -S)) : __int_as_float(0x7fffffff);
}

int fill_levels(Levels* p, const int* res, const int* size, int n_levels, int n_points, float bound,
                float inv_extent) {
  if (n_levels < 1 || n_levels > MAX_LEVELS || n_points < 0) return (int)cudaErrorInvalidValue;
  long long first = 0;
  for (int l = 0; l < n_levels; ++l) {
    const long long dense_rows = (long long)(res[l] + 1) * (res[l] + 1) * (res[l] + 1);
    p->res[l] = res[l];
    p->size[l] = size[l];
    p->dense[l] = dense_rows <= size[l];
    if (!p->dense[l] && (size[l] & (size[l] - 1))) return (int)cudaErrorInvalidValue;
    p->first_row[l] = first;
    first += size[l];
  }
  p->n_levels = n_levels;
  p->n_points = n_points;
  p->bound = bound;
  p->inv_extent = inv_extent;
  return 0;
}

int ceil_log2(long long n) {
  int k = 0;
  while ((1ll << k) < n) ++k;
  return k;
}

int grid_for(long long n, int threads) {
  int device = 0, sms = 132;
  if (cudaGetDevice(&device) == cudaSuccess) cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const long long blocks = (n + threads - 1) / threads;
  return (int)(blocks < 8ll * sms ? (blocks > 0 ? blocks : 1) : 8ll * sms);
}

}  // namespace

// K4: (n, 3) float32 points -> (n, n_levels) float2 features. `tables` is a host array of each level's device
// rows, `res` / `size` host arrays. Returns the first CUDA error (0 on success).
extern "C" int hash_encode_fwd(const void* points, void* out, const void* const* tables, const int* res,
                               const int* size, int n_levels, int n_points, float bound, float inv_extent,
                               void* stream) {
  Levels p;
  int err = fill_levels(&p, res, size, n_levels, n_points, bound, inv_extent);
  if (err) return err;
  if (n_points == 0) return 0;
  for (int l = 0; l < n_levels; ++l) p.tables[l] = static_cast<const float2*>(tables[l]);
  hash_encode_fwd_kernel<<<(n_points + POINTS - 1) / POINTS, dim3(POINTS, n_levels), 0,
                           static_cast<cudaStream_t>(stream)>>>(
      p, static_cast<const float*>(points), static_cast<float2*>(out));
  return (int)cudaGetLastError();
}

// K5: the tables' gradient, `out` (sum of `size`, 2) float32, from the (n, n_levels) float2 cotangents `grad`.
// `acc` is scratch of 2 * sum(size) + 1 64-bit words (the accumulator, then the max's word).
extern "C" int hash_encode_bwd(const void* points, const void* grad, void* acc, void* out, const int* res,
                               const int* size, int n_levels, int n_points, float bound, float inv_extent,
                               void* stream) {
  Levels p;
  int err = fill_levels(&p, res, size, n_levels, n_points, bound, inv_extent);
  if (err) return err;
  long long rows = 0;
  for (int l = 0; l < n_levels; ++l) rows += size[l];
  const long long words = 2 * rows;
  auto* a = static_cast<unsigned long long*>(acc);
  auto* gmax = reinterpret_cast<unsigned*>(a + words);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int log2n = ceil_log2(n_points > 0 ? n_points : 1);
  hash_encode_bwd_zero_kernel<<<grid_for(words + 1, 256), 256, 0, s>>>(a, words + 1);
  if (n_points > 0) {
    const long long n = (long long)n_points * n_levels * 2;
    hash_encode_bwd_max_kernel<<<grid_for(n, 256), 256, 0, s>>>(static_cast<const float*>(grad), n, gmax);
    const int per_block = POINTS * SCATTER_WARPS;
    const dim3 grid((n_points + per_block - 1) / per_block, n_levels);
    hash_encode_bwd_scatter_kernel<<<grid, dim3(POINTS, SCATTER_WARPS), 0, s>>>(
        p, static_cast<const float*>(points), static_cast<const float2*>(grad), gmax, log2n, a);
  }
  hash_encode_bwd_convert_kernel<<<grid_for(words, 256), 256, 0, s>>>(a, words, gmax, log2n,
                                                                      static_cast<float*>(out));
  return (int)cudaGetLastError();
}
