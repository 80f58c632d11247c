// Fused NeRF-MLP forward for Hopper (sm_90a), K1: one CTA per tile of 128 points.
//
// Replaces the Pallas TPU kernel yanerf_tpu/ops/pallas/nerf_mlp_kernel.py
// (_nerf_mlp_kernel, reached via nerf_mlp_forward_pallas). The function,
// and every floating-point operation of it, is in nerf_mlp_fwd.cuh, which
// the pipelined twin K2 (nerf_mlp_fwd_pipelined.cu) shares bit for bit.
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
// The tile's embedding runs before its layer chain, on the same 8 warps;
// K2 overlaps the two. wgmma, TMA and a pipelined weight stream are later
// work.
//
// Built with nvcc into a shared library with a plain C entry point
// (nerf_mlp_fwd_bf16), loaded with ctypes by ops/kernels/nerf_mlp_fwd.py.

#include "nerf_mlp_fwd.cuh"

using namespace nerf_mlp;

namespace {

constexpr int SMEM_BYTES = ACT_BYTES + XEMB_BYTES + DEMB_BYTES + WSLAB_BYTES + STAGE_BYTES + 2 * VEC_BYTES;

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
  if (tid < TILE) load_point(p, row0 + tid, pts + 3 * tid, dn + 3 * tid);
  __syncthreads();
  embed_tile(p, pts, dn, xemb, demb, tid, THREADS);
  __syncthreads();
  mlp_chain<CtaSync>(p, xemb, demb, act, wslab, stage, row0);
}

}  // namespace

// Launches the kernel on `stream` and returns cudaGetLastError() (0 on
// success); the arguments are those of make_params (nerf_mlp_fwd.cuh).
extern "C" int nerf_mlp_fwd_bf16(const void* points, const void* dirs, void* out, const void* wbuf,
                                 const void* bbuf, const void* w_off, const void* b_off, int n_tensors,
                                 int n_points, int pts_per_ray, int n_layers, int skip_mask, int nf_xyz,
                                 int app_xyz, int nf_dir, int app_dir, int n_extra_color, int color_dim,
                                 void* stream) {
  Params p;
  const int bad = make_params(&p, points, dirs, out, wbuf, bbuf, w_off, b_off, n_tensors, n_points, pts_per_ray,
                              n_layers, skip_mask, nf_xyz, app_xyz, nf_dir, app_dir, n_extra_color, color_dim);
  if (bad) return bad;
  if (n_points == 0) return 0;
  cudaError_t err =
      cudaFuncSetAttribute(nerf_mlp_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  const int grid = (n_points + TILE - 1) / TILE;
  nerf_mlp_fwd_kernel<<<grid, THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}
