// Pipelined fused NeRF-MLP forward for Hopper (sm_90a), K2: the same
// function as K1 (nerf_mlp_fwd.cu), bit for bit, as a two-stage pipeline.
//
// Replaces the Pallas TPU kernel yanerf_tpu/ops/pallas/nerf_mlp_kernel.py
// (_nerf_mlp_kernel_pipelined, nerf_mlp_forward_pallas(pipelined=True)).
// There, grid step i embeds tile i into scratch slot i % 2 while the
// matmul chain runs on tile i - 1 from the other slot, so that the VPU's
// sines overlap the MXU's products.
//
// Here a persistent grid of at most one CTA per SM walks the tiles
// blockIdx.x, blockIdx.x + gridDim.x, ... with three warp groups:
//   * warp group 2, the producer, loads a tile's points and directions and
//     writes its bf16 embeddings into slot i % 2 of a double-buffered
//     xemb / demb (the accurate sinf on the FMA and ALU pipes);
//   * warp groups 0-1, the consumers, run K1's layer chain on the tile of
//     the other slot (wmma bf16 on the tensor cores).
// They hand the slots over with named barriers (bar.arrive by the side that
// is done, bar.sync by the side that waits): FULL[s] when the producer has
// written slot s, EMPTY[s] when the consumers have read it; each side syncs
// within itself on a barrier of its own, never with __syncthreads().
//
// What bounds it: operations, as K1 (1.19 MFLOP per point). The producer
// takes the embedding (84 accurate sines per point) off the consumers'
// path; at K1's pace the chain of a tile takes ~150x the embedding.
// Registers: 384 threads at one CTA per SM get 168 each, below the 218
// that K1's chain holds (a build with one producer warp, 288 threads, is
// allocated as 12 warps too, got 168 and spilled). So the warp groups
// rebalance with setmaxnreg (sm_90a): the producer gives its registers
// down to 40, the consumers take theirs up to 232 (128 x 40 + 256 x 232 =
// 168 x 384). Shared memory: K1's 141 KB plus a second embedding slot,
// 166 KB.
//
// Every floating-point operation comes from nerf_mlp_fwd.cuh, as K1's, so
// the two kernels give the same bits; a ragged last tile is masked as in
// K1 (zeros in, nothing stored).
//
// Built with nvcc into a shared library with a plain C entry point
// (nerf_mlp_fwd_pipelined_bf16), loaded with ctypes by
// ops/kernels/nerf_mlp_fwd.py (nerf_mlp_fwd(..., pipelined=True)).

#include "nerf_mlp_fwd.cuh"

using namespace nerf_mlp;

namespace {

constexpr int CONSUMERS = THREADS;                  // warp groups 0-1: the layer chain
constexpr int PRODUCERS = 128;                      // warp group 2: the embedding
constexpr int PIPE_THREADS = CONSUMERS + PRODUCERS;
constexpr int CONSUMER_REGS = 232;
constexpr int PRODUCER_REGS = 40;
constexpr int BAR_CHAIN = 1;                        // consumers only (0 is __syncthreads)
constexpr int BAR_FULL = 2;                         // + slot: the producer filled it
constexpr int BAR_EMPTY = 4;                        // + slot: the consumers released it
constexpr int BAR_PRODUCER = 6;                     // producer only
constexpr int SMEM_BYTES =
    ACT_BYTES + 2 * XEMB_BYTES + 2 * DEMB_BYTES + WSLAB_BYTES + STAGE_BYTES + 2 * VEC_BYTES;
static_assert(PRODUCERS * PRODUCER_REGS + CONSUMERS * CONSUMER_REGS <= (65536 / PIPE_THREADS / 8 * 8) * PIPE_THREADS,
              "the rebalanced registers must fit the CTA's allocation");

__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(count) : "memory");
}

__global__ void __launch_bounds__(PIPE_THREADS, 1) nerf_mlp_fwd_pipelined_kernel(const Params p, int n_tiles) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* act = reinterpret_cast<bf16*>(smem);
  bf16* xemb = reinterpret_cast<bf16*>(smem + ACT_BYTES);                     // 2 slots
  bf16* demb = reinterpret_cast<bf16*>(smem + ACT_BYTES + 2 * XEMB_BYTES);    // 2 slots
  unsigned char* rest = smem + ACT_BYTES + 2 * XEMB_BYTES + 2 * DEMB_BYTES;
  bf16* wslab = reinterpret_cast<bf16*>(rest);
  float* stage = reinterpret_cast<float*>(rest + WSLAB_BYTES);
  float* pts = stage + STAGE_BYTES / 4;  // the producer's staging of one tile
  float* dn = pts + TILE * 3;

  const int tid = threadIdx.x;
  const int stride = gridDim.x;
  if (tid >= CONSUMERS) {
    // producer: tile i of this CTA into slot i % 2, once the consumers have
    // released what that slot held (tile i - 2)
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(PRODUCER_REGS));
    const int ptid = tid - CONSUMERS;
    int i = 0;
    for (int t = blockIdx.x; t < n_tiles; t += stride, ++i) {
      const int s = i & 1;
      load_point(p, t * TILE + ptid, pts + 3 * ptid, dn + 3 * ptid);
      bar_sync(BAR_PRODUCER, PRODUCERS);  // the tile's points are staged
      if (i >= 2) bar_sync(BAR_EMPTY + s, PIPE_THREADS);
      embed_tile(p, pts, dn, xemb + s * (TILE * LDX), demb + s * (TILE * LDD), ptid, PRODUCERS);
      __threadfence_block();
      bar_arrive(BAR_FULL + s, PIPE_THREADS);
      bar_sync(BAR_PRODUCER, PRODUCERS);  // every read of the staged points is done
    }
  } else {
    // consumers: the layer chain of tile i from slot i % 2, then release the
    // slot if the producer will fill it again
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(CONSUMER_REGS));
    int i = 0;
    for (int t = blockIdx.x; t < n_tiles; t += stride, ++i) {
      const int s = i & 1;
      bar_sync(BAR_FULL + s, PIPE_THREADS);
      mlp_chain<NamedSync<BAR_CHAIN, CONSUMERS>>(p, xemb + s * (TILE * LDX), demb + s * (TILE * LDD), act, wslab,
                                                 stage, t * TILE);
      if (t + 2 * stride < n_tiles) bar_arrive(BAR_EMPTY + s, PIPE_THREADS);
    }
  }
}

}  // namespace

// Launches the kernel on `stream` and returns cudaGetLastError() (0 on
// success); the arguments are those of make_params (nerf_mlp_fwd.cuh).
extern "C" int nerf_mlp_fwd_pipelined_bf16(const void* points, const void* dirs, void* out, const void* wbuf,
                                           const void* bbuf, const void* w_off, const void* b_off, int n_tensors,
                                           int n_points, int pts_per_ray, int n_layers, int skip_mask, int nf_xyz,
                                           int app_xyz, int nf_dir, int app_dir, int n_extra_color, int color_dim,
                                           void* stream) {
  Params p;
  const int bad = make_params(&p, points, dirs, out, wbuf, bbuf, w_off, b_off, n_tensors, n_points, pts_per_ray,
                              n_layers, skip_mask, nf_xyz, app_xyz, nf_dir, app_dir, n_extra_color, color_dim);
  if (bad) return bad;
  if (n_points == 0) return 0;
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(nerf_mlp_fwd_pipelined_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  const int n_tiles = (n_points + TILE - 1) / TILE;
  const int grid = n_tiles < sms ? n_tiles : sms;
  nerf_mlp_fwd_pipelined_kernel<<<grid, PIPE_THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(p, n_tiles);
  return (int)cudaGetLastError();
}
