// Building blocks shared by the redesigned Legendre kernels (K1
// scan_legendre.cu, K4 legendre_contract.cu) on sm_90a:
//
//  * cp.async copies global → shared with zero fill (src-size 0), in 16-byte
//    vectors (.cg, L2 only) or single elements (.ca), grouped by commit /
//    wait_group so a ring of shared-memory stages is filled while an earlier
//    stage is contracted;
//  * register-tiled f32 outer products on the CUDA cores (IEEE fmaf, no
//    TF32);
//  * the FP64 tensor-core product mma.sync m16n8k4 (DMMA: IEEE f64 products
//    and sums, 67 TFLOP/s on an H100 SXM against 34 on the FP64 units);
//  * mbarriers, barriers of a group of warps and setmaxnreg, for blocks
//    whose warps take separate roles (K1's float32 tile at 32 planes).

#pragma once

#include <cuda_runtime.h>
#include <cstdint>

namespace cora {

constexpr int kThreads = 256;  // K4 and K1 but its 32-plane f32 tile: 8 warps

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global → shared (with a 128-byte L2 prefetch hint); `ok` false
// writes 16 zero bytes and reads nothing (src must still be a valid
// address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile(
      "cp.async.cg.shared.global.L2::128B [%0], [%1], 16, %2;\n" ::"r"(
          smem_u32(dst)),
      "l"(src), "r"(ok ? 16 : 0)
      : "memory");
}

// One element (4 or 8 bytes) global → shared, zero when !ok.
template <typename T>
__device__ __forceinline__ void cp_async_el(T* dst, const T* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "n"(sizeof(T)), "r"(ok ? (int)sizeof(T) : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// mbarrier (sm_90): a 64-bit barrier in shared memory whose phase completes
// when `count` arrivals have come; a wait names the phase by its parity and
// returns once that phase has completed (phase k has parity k & 1).
// Arrivals release and waits acquire at CTA scope, so what a thread wrote
// before it arrived is seen by a thread that waited.
__device__ __forceinline__ void mbar_init(unsigned long long* bar,
                                          unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

// Make the barriers' initialisation visible before any thread uses them.
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(unsigned long long* bar) {
  asm volatile(
      "{\n\t.reg .b64 st;\n\t"
      "mbarrier.arrive.shared::cta.b64 st, [%0];\n\t}\n" ::"r"(smem_u32(bar))
      : "memory");
}

// One arrival on `bar` once every cp.async this thread has started so far
// has landed (the barrier's pending count is raised by one now, so the
// thread still arrives itself as well).
__device__ __forceinline__ void cp_async_mbar_arrive(unsigned long long* bar) {
  asm volatile("cp.async.mbarrier.arrive.shared::cta.b64 [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                          unsigned parity) {
  asm volatile(
      "{\n\t.reg .pred done;\n\t"
      "WAIT:\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n\t"
      "@!done bra WAIT;\n\t}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// Barrier `id` (1–15; 0 is __syncthreads) of the first `n` threads to
// arrive at it, a multiple of 32: a barrier of one group of warps.
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// Move this warpgroup's register limit to N (sm_90a; every warp of the
// warpgroup executes it, and the paths of the two roles never rejoin).
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

// d += a·b over one 16×8×4 tile on the FP64 tensor cores (sm_90; lane =
// 4·g + t): rows 0-7 of D in d0 = D[g][2t], D[g][2t+1], rows 8-15 in d1;
// a0 = A[g][t], a1 = A[g+8][t], b = B[t][g].  Each output adds the 4
// products of its row and column to its sum.
__device__ __forceinline__ void dmma16(double (&d0)[2], double (&d1)[2],
                                       double a0, double a1, double b) {
  asm volatile(
      "mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, "
      "{%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+d"(d0[0]), "+d"(d0[1]), "+d"(d1[0]), "+d"(d1[1])
      : "d"(a0), "d"(a1), "d"(b));
}

// acc[i][j] += a[i]·b[j] with IEEE fmaf (the f32 register tile).
template <int TP, int TR>
__device__ __forceinline__ void outer_fma(float (&acc)[TP][TR],
                                          const float (&a)[TP],
                                          const float (&b)[TR]) {
#pragma unroll
  for (int i = 0; i < TP; ++i)
#pragma unroll
    for (int j = 0; j < TR; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
}

// n values from shared memory as V-wide vectors: v[j·V + u] =
// src[j·stride + u] (V = 4, 2 or 1 floats; src 4·V-byte aligned).
template <int N, int V>
__device__ __forceinline__ void lds_vec(float (&v)[N], const float* src,
                                        int stride) {
#pragma unroll
  for (int j = 0; j < N / V; ++j) {
    if constexpr (V == 4) {
      const float4 x = *reinterpret_cast<const float4*>(src + j * stride);
      v[4 * j] = x.x;
      v[4 * j + 1] = x.y;
      v[4 * j + 2] = x.z;
      v[4 * j + 3] = x.w;
    } else if constexpr (V == 2) {
      const float2 x = *reinterpret_cast<const float2*>(src + j * stride);
      v[2 * j] = x.x;
      v[2 * j + 1] = x.y;
    } else {
      v[j] = src[j * stride];
    }
  }
}

// Shared-memory row pitch (elements) of a DMMA fragment source whose 4 k
// rows are read together: ≡ 4 (mod 16) doubles, so the 16 lanes of a half
// warp (4 rows × 4 columns) fall on distinct 8-byte banks.
__host__ __device__ constexpr int dmma_pitch(int n) {
  return n + ((4 - n % 16) + 16) % 16;
}

}  // namespace cora
