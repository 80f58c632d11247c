// Pipelined fused NeRF-MLP forward for Hopper (sm_90a), K2: the same
// function as K1 (nerf_mlp_fwd.cu), bit for bit, with the embedding off the
// consumers' path.
//
// Replaces the Pallas TPU kernel yanerf_tpu/ops/pallas/nerf_mlp_kernel.py
// (_nerf_mlp_kernel_pipelined, nerf_mlp_forward_pallas(pipelined=True)).
// There, grid step i embeds tile i into scratch slot i % 2 while the
// matmul chain runs on tile i - 1 from the other slot, so that the VPU's
// sines overlap the MXU's products.
//
// What bounds it: operations, as K1 (1.19 MFLOP per point against ~28
// bytes).
//
// What the design does about it: K1's engine (nerf_mlp_tile.cuh: a
// persistent CTA per SM, a TMA weight ring, wgmma consumers with register
// epilogues), plus the TPU kernel's overlap. Two warps of the producer warp
// group, idle in K1, load tile i + 1's points and write its bf16
// embeddings into one of two slots in shared memory (the xyz chunk in the
// swizzled layout, the dir embedding plain) while the consumer warp groups
// run tile i from the other; full/empty mbarriers hand the slots over. The
// consumers read the xyz chunk as the A operand's tail, and after the
// intermediate layer copy the dir embedding into it. The wgmma order, the
// epilogues and the heads are K1's code, so the output equals K1's. The two
// slots take the shared memory of one ring stage, so K2's ring is
// 3 slabs deep (the bits do not depend on the depth).
//
// Measured on an NVIDIA H100 80GB HBM3 at a 700.00 W power limit
// (chip_smoke.py): 1.00 ms at 392,640 points against K1's 1.08 ms in
// turns; at 65,440 points (about 4 tiles per CTA, the first one's
// embedding not hidden) 0.19 ms, as K1.
//
// Built with nvcc into a shared library with a plain C entry point
// (nerf_mlp_fwd_pipelined_bf16), loaded with ctypes by
// ops/kernels/nerf_mlp_fwd.py (nerf_mlp_fwd(..., pipelined=True)).

#include "nerf_mlp_tile.cuh"

using namespace nerf_mlp;

namespace {

constexpr int STAGES = 3;  // slabs of 32 KB in the weight ring
using Smem = FwdSmem<true, STAGES>;

__global__ void __launch_bounds__(THREADS, 1) nerf_mlp_fwd_pipelined_kernel(const __grid_constant__ FwdArgs p) {
  extern __shared__ unsigned char smem_raw[];
  fwd_kernel_body<true, STAGES>(p, smem_raw);
}

}  // namespace

// Launches the kernel on `stream` and returns the first CUDA error (0 on
// success); the arguments are those of launch_fwd (nerf_mlp_tile.cuh).
extern "C" int nerf_mlp_fwd_pipelined_bf16(const void* points, const void* dirs, void* out, const void* wbuf,
                                           const void* bbuf, const void* w_off, const void* b_off, const void* w_rows,
                                           int n_tensors, int n_points, int pts_per_ray, int n_layers, int skip_mask,
                                           int nf_xyz, int app_xyz, int nf_dir, int app_dir, int n_extra_color,
                                           int color_dim, long long w_total, void* stream) {
  return launch_fwd(nerf_mlp_fwd_pipelined_kernel, Smem::BYTES, points, dirs, out, wbuf, bbuf, w_off, b_off, w_rows,
                    n_tensors, n_points, pts_per_ray, n_layers, skip_mask, nf_xyz, app_xyz, nf_dir, app_dir,
                    n_extra_color, color_dim, w_total, stream);
}
