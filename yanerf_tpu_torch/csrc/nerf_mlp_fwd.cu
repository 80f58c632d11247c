// Fused NeRF-MLP forward for Hopper (sm_90a), K1.
//
// Replaces the Pallas TPU kernel yanerf_tpu/ops/pallas/nerf_mlp_kernel.py
// (_nerf_mlp_kernel, reached via nerf_mlp_forward_pallas): per point, the
// harmonic embeddings, 8 x 256 ReLU layers with the skip, the density head,
// the intermediate layer, the color layer(s) and the sigmoid color head,
// (N, 3) points and per-ray directions in, (N, 1 + C) float32 out.
//
// What bounds it: operations. 1.19 MFLOP per point against ~28 bytes of
// input and output per point, far above the card's ~295 FLOP/byte ridge;
// the 1.2 MB of bf16 weights are read once per 128-point tile, from L2.
//
// What the design does about it (the engine is nerf_mlp_tile.cuh, shared
// with K2 and with K3's recomputed forward): a persistent CTA per SM walks
// 128-point tiles. One producer thread streams every weight slab of the
// forward (64 rows x 256 or 128 columns) by TMA through a ring of
// four 32 KB slabs with full/empty mbarriers, running ahead into
// the next tile; one producer warp rings each step's bias (or the heads'
// weights) into shared memory; two consumer warp groups of 64 points each
// run every layer as wgmma m64n256k16 / m64n128k16 with W as the MN-major
// B and the activations, kept in shared memory in the 128B-swizzled
// layout, as A. Each epilogue goes from the registers (bias, ReLU, bf16)
// straight into that buffer; no activation touches device memory. The
// consumers embed each tile themselves (K2 moves that to idle producer
// warps), and run the two narrow heads on the CUDA cores.
//
// Measured on an NVIDIA H100 80GB HBM3 at a 700.00 W power limit
// (chip_smoke.py, 392,640 points): 1.08 ms, ~430 TFLOP/s against a 0.47 ms
// bound. Timed builds of other designs (PERF.md): a 3-stage ring was 3-4%
// slower; without the epilogues (wrong output, for the time alone) K2
// took two thirds of its time, without the weight loads 95%: the
// epilogues, which no product overlaps, not the weight stream, are what is
// left.
//
// Built with nvcc into a shared library with a plain C entry point
// (nerf_mlp_fwd_bf16), loaded with ctypes by ops/kernels/nerf_mlp_fwd.py.

#include "nerf_mlp_tile.cuh"

using namespace nerf_mlp;

namespace {

constexpr int STAGES = 4;  // slabs of 32 KB in the weight ring
using Smem = FwdSmem<false, STAGES>;

__global__ void __launch_bounds__(THREADS, 1) nerf_mlp_fwd_kernel(const __grid_constant__ FwdArgs p) {
  extern __shared__ unsigned char smem_raw[];
  fwd_kernel_body<false, STAGES>(p, smem_raw);
}

}  // namespace

// Launches the kernel on `stream` and returns the first CUDA error (0 on
// success); the arguments are those of launch_fwd (nerf_mlp_tile.cuh).
extern "C" int nerf_mlp_fwd_bf16(const void* points, const void* dirs, void* out, const void* wbuf,
                                 const void* bbuf, const void* w_off, const void* b_off, const void* w_rows,
                                 int n_tensors, int n_points, int pts_per_ray, int n_layers, int skip_mask, int nf_xyz,
                                 int app_xyz, int nf_dir, int app_dir, int n_extra_color, int color_dim,
                                 long long w_total, void* stream) {
  return launch_fwd(nerf_mlp_fwd_kernel, Smem::BYTES, points, dirs, out, wbuf, bbuf, w_off, b_off, w_rows, n_tensors,
                    n_points, pts_per_ray, n_layers, skip_mask, nf_xyz, app_xyz, nf_dir, app_dir, n_extra_color,
                    color_dim, w_total, stream);
}
