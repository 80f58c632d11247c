// Building blocks of Hopper (sm_90a) kernels written by hand: mbarriers,
// TMA tensor copies, the wgmma tensor-core product and its shared-memory
// descriptors, setmaxnreg, named barriers, and the host-side creation of
// tensor maps. Plain inline PTX and the CUDA headers only: no CUTLASS, no
// PyTorch, nothing to link beyond the CUDA runtime (the driver's
// cuTensorMapEncodeTiled is looked up with cudaGetDriverEntryPoint).
//
// One shared-memory layout throughout, the one TMA writes with
// CU_TENSOR_MAP_SWIZZLE_128B: a tile is a stack of 128-byte lines (64 bf16),
// and the 16-byte unit u of line r sits at unit u ^ (r % 8). A tile starts
// on a 1024-byte boundary, so the pattern is a function of the address and
// TMA, wgmma and the threads' own stores (sw128_offset) agree on it.
//
//   * K-major operand (the reduction index runs along the line): rows of a
//     64-wide slice of K, one 128-byte line each; descriptor kmajor_desc,
//     8-row groups 1024 bytes apart, the k16 step 32 bytes along the line.
//   * MN-major operand (the M or N index runs along the line): one line per
//     k, 64 M/N values each; descriptor mnmajor_desc, 8-k groups 1024 bytes
//     apart, the 64-wide M/N blocks `block_bytes` apart, the k16 step 16
//     lines (2048 bytes). wgmma reads it with its transpose bit set
//     (16-bit types only).
//
// The float32 accumulator of wgmma m64nNk16 is spread over the 128 threads
// of a warp group: thread t holds d[4 i + q] at row acc_row(t, q) and column
// acc_col(t, i, q), i < N / 8.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

// ---- addresses, barriers, fences ----------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of bf16 element (row, col), col < 64, in a 128B-swizzled tile.
__device__ __forceinline__ uint32_t sw128_offset(int row, int col) {
  return row * 128 + ((((col >> 3) ^ row) & 7) << 4) + (col & 7) * 2;
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count) : "memory");
}

// Makes the barriers' initialization visible to the async proxy (TMA).
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

// Arrives and announces `bytes` of TMA traffic that completes the phase.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)), "r"(bytes)
               : "memory");
}

// Waits until the barrier's phase with parity `parity` has completed. A
// phase that never completes is a fault of the kernel: after ~2^26 polls
// (seconds) it traps, and the launch fails instead of hanging.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  for (uint32_t polls = 0; !done; ++polls) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\nselp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (polls == (1u << 26)) __trap();
  }
}

// Stores to shared memory by its 32-bit address (no aliasing with local or
// global memory for the compiler to fear).
__device__ __forceinline__ void st_shared_b32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;" ::"r"(addr), "r"(v));
}
__device__ __forceinline__ void st_shared_v4(uint32_t addr, uint4 v) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};" ::"r"(addr), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w));
}

// Orders this thread's generic-proxy shared-memory writes before later
// async-proxy reads of them (wgmma operands, TMA stores).
__device__ __forceinline__ void fence_proxy_async() { asm volatile("fence.proxy.async.shared::cta;" ::: "memory"); }

__device__ __forceinline__ void named_bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(count) : "memory");
}

template <int REGS>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(REGS));
}

template <int REGS>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(REGS));
}

// ---- TMA ------------------------------------------------------------------

// Box (c0, c1) of the 2-D tensor map into shared memory at `dst`; completes
// the box's bytes on `bar`. `map` must live in kernel parameter space
// (a __grid_constant__ argument) or in global memory.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3}], [%4];" ::"r"(
          smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(smem_u32(bar))
      : "memory");
}

// Box (c0, c1, c2) of a 3-D tensor map into shared memory at `dst`.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, int c0, int c1, int c2,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4}], [%5];" ::
          "r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(smem_u32(bar))
      : "memory");
}

// Shared memory at `src` into box (c0, c1, c2) of a 3-D tensor map.
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map, const void* src, int c0, int c1, int c2) {
  asm volatile("cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];" ::"l"(
                   reinterpret_cast<uint64_t>(map)),
               "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2)
               : "memory");
}

__device__ __forceinline__ void bulk_commit() { asm volatile("cp.async.bulk.commit_group;" ::: "memory"); }

// Waits until the committed stores have read their shared memory.
__device__ __forceinline__ void bulk_wait_read() { asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory"); }

// Waits until the committed stores are complete.
__device__ __forceinline__ void bulk_wait() { asm volatile("cp.async.bulk.wait_group 0;" ::: "memory"); }

// ---- wgmma ----------------------------------------------------------------

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Pins the accumulator registers in program order here: the compiler may
// not move their reads or writes across it (after wgmma_wait, before the
// first wgmma of a product).
template <int N>
__device__ __forceinline__ void fence_operand(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo_bytes, uint32_t sbo_bytes) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo_bytes >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo_bytes >> 4) & 0x3FFF) << 32) | (1ull << 62);  // layout 1: 128-byte swizzle
}

// K-major 128B-swizzled operand at shared address `addr` (the k16 step adds 32 bytes).
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t addr) { return make_desc(addr, 16, 1024); }

// MN-major 128B-swizzled operand at `addr`, its 64-wide M/N blocks
// `block_bytes` apart (the k16 step adds 2048 bytes).
__device__ __forceinline__ uint64_t mnmajor_desc(uint32_t addr, uint32_t block_bytes) {
  return make_desc(addr, block_bytes, 1024);
}

// Row (0..63) and column of accumulator element d[4 i + q] of thread t (0..127).
__device__ __forceinline__ int acc_row(int t, int q) { return ((t >> 5) << 4) + ((t & 31) >> 2) + ((q >> 1) << 3); }
__device__ __forceinline__ int acc_col(int t, int i, int q) { return (i << 3) + ((t & 3) << 1) + (q & 1); }

// D (64 x 256, float32, the fragment layout of acc_row / acc_col) += A (64 x 16) * B (16 x 256),
// bf16 operands read from shared memory through the descriptors a and b.
// scale_d == 0 drops D's old value. TA / TB: 0 for a K-major operand, 1 for
// an MN-major one.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, %131, %132;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(a), "l"(b), "r"(scale_d), "n"(TA), "n"(TB));
}

// D (64 x 128, float32, the fragment layout of acc_row / acc_col) += A (64 x 16) * B (16 x 128),
// bf16 operands read from shared memory through the descriptors a and b.
// scale_d == 0 drops D's old value. TA / TB: 0 for a K-major operand, 1 for
// an MN-major one.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d), "n"(TA), "n"(TB));
}

// D (64 x 64, float32, the fragment layout of acc_row / acc_col) += A (64 x 16) * B (16 x 64),
// bf16 operands read from shared memory through the descriptors a and b.
// scale_d == 0 drops D's old value. TA / TB: 0 for a K-major operand, 1 for
// an MN-major one.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d), "n"(TA), "n"(TB));
}

// wgmma m64nNk16 with N taken from the accumulator's size (N / 2 floats a thread).
template <int TA, int TB>
__device__ __forceinline__ void wgmma_k16(float (&d)[128], uint64_t a, uint64_t b, int scale_d) {
  wgmma_m64n256k16<TA, TB>(d, a, b, scale_d);
}
template <int TA, int TB>
__device__ __forceinline__ void wgmma_k16(float (&d)[64], uint64_t a, uint64_t b, int scale_d) {
  wgmma_m64n128k16<TA, TB>(d, a, b, scale_d);
}
template <int TA, int TB>
__device__ __forceinline__ void wgmma_k16(float (&d)[32], uint64_t a, uint64_t b, int scale_d) {
  wgmma_m64n64k16<TA, TB>(d, a, b, scale_d);
}

// ---- host: tensor maps ----------------------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// The driver's cuTensorMapEncodeTiled, through the runtime (no -lcuda).
inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                                             &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A row-major (rows, cols) bf16 matrix at `base` with rows `row_bytes` apart
// (a multiple of 16), cut into boxes of box_rows x box_cols (box_cols <= 64:
// one 128-byte swizzled line per row). Loads past the end read zeros, stores
// past it are dropped. Returns a cudaError_t.
inline int make_bf16_map(CUtensorMap* map, const void* base, uint64_t rows, uint64_t cols, uint64_t row_bytes,
                         uint32_t box_rows, uint32_t box_cols) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {row_bytes};
  const cuuint32_t box[2] = {box_cols, box_rows};
  const cuuint32_t elem_strides[2] = {1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims, strides, box,
                        elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// A column-blocked bf16 array at `base`: `blocks` blocks of (rows, 64), each
// block's rows 128 bytes apart, cut into boxes of box_rows x 64 (coordinates
// (0, row, block)). A box is then one contiguous run of device memory.
// Loads past `rows` read zeros, stores past it are dropped.
inline int make_bf16_blocked_map(CUtensorMap* map, const void* base, uint64_t blocks, uint64_t rows,
                                 uint32_t box_rows) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[3] = {64, rows, blocks};
  const cuuint64_t strides[2] = {128, rows * 128};
  const cuuint32_t box[3] = {64, box_rows, 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims, strides, box,
                        elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

}  // namespace hopper
