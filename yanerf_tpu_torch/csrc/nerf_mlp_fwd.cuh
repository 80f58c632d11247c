// The NeRF-MLP's per-point arithmetic outside the tensor cores, shared by
// the forward kernels K1 / K2 (nerf_mlp_fwd.cu, nerf_mlp_fwd_pipelined.cu)
// and the backward K3 (nerf_mlp_bwd.cu) through nerf_mlp_tile.cuh: the
// normalized ray direction of a point, and the constant of the harmonic
// embedding (embed_pairs in nerf_mlp_tile.cuh).
//
// The function is that of the Pallas TPU kernel
// yanerf_tpu/ops/pallas/nerf_mlp_kernel.py (_nerf_mlp_kernel): the harmonic
// embedding of the points (sin | cos | x, frequency-major, cos(t) written as
// sin(t + pi/2)) and of the normalized per-ray directions, in float32 with
// the accurate sinf (the phase reaches |x| * 2^9 rad, where a fast-math sine
// is wrong), rounded to bf16. Every rounding is spelled out (__fmul_rn,
// __fadd_rn, __fmaf_rn), so that nvcc may neither contract nor split it,
// whatever the inlining context: the kernels that embed in different warps
// (K2's producer, K1's and K3's consumers) get the same bits.

#pragma once

#include <cuda_runtime.h>

namespace nerf_mlp {

constexpr float HALF_PI = 1.57079632679489661923f;

// Point `g` of `points` into pt[0..2] and its ray's normalized direction
// into dn[0..2]; a row past n_points gets zeros (masked: nothing of it is
// stored).
__device__ __forceinline__ void load_point(const float* points, const float* dirs, int n_points, int pts_per_ray,
                                           int g, float* pt, float* dn) {
  float x0 = 0.f, x1 = 0.f, x2 = 0.f, d0 = 0.f, d1 = 0.f, d2 = 0.f;
  if (g < n_points) {
    x0 = points[3 * g];
    x1 = points[3 * g + 1];
    x2 = points[3 * g + 2];
    const int ray = g / pts_per_ray;
    d0 = dirs[3 * ray];
    d1 = dirs[3 * ray + 1];
    d2 = dirs[3 * ray + 2];
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

inline int round16(int x) { return (x + 15) / 16 * 16; }

}  // namespace nerf_mlp
