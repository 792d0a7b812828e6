// The correlated draw of one ℓ-chunk into the parity-packed a_ℓm planes, K6.
//
// Replaces no TPU kernel: the JAX package draws with XLA's einsum
// (cora_tpu/healpix/sht.py `_draw_blocks`).  The port's draw was, per
// ℓ-chunk, a ×1/√2 pass over the white noise ξ, torch.einsum
// ("lzy,lypm->zplm": a cuBLAS bmm and a permuting copy) and two strided
// copies of the even and odd ℓ rows into the planes.  On an H100 80GB HBM3
// at 700 W those passes took about 0.27 ms of device time a map in the
// nside-512 realisation cell, the draw was its largest stage (0.487 ms a
// map), and the host waited between their ~200 launches a frequency chunk.
// K6 does the whole draw after the noise in one launch per ℓ-chunk:
//
//   out_p(i)[2z + p, row(i), m] = Σ_y R[i, z, y] · (ξ[i, y, p, m] · h)
//
//   ξ [lc, nz, 2, mw]     the ℓ-chunk's standard normals (any strides over
//                         its first three axes, m contiguous)
//   R [lc, nzc, nz]       its roots rows z_lo..z_lo+nzc (any strides); rows
//                         i ≥ nvalid read as zero
//   out0, out1            planes-minor [rows, M, fs] (fs = 2·nzc rounded up
//                         to a whole 16-byte vector); row i goes to row
//                         row0_even + i/2 of out0 (i even) or row0_odd + i/2
//                         of out1 (i odd)
//
// ξ·h is rounded to the working precision before it enters the sum, as the
// scaling pass it replaces did; the sum over y is IEEE FMAs in the working
// precision (no TF32).
//
// What bounds it: ξ is read once, 4·nz·2·mw bytes an ℓ (f32); each value
// enters nzc FMAs (16 at the cells' 16-channel chunks), 8 flops a byte,
// below the card's 20 flops a byte of FP32 against 3.35 TB/s.  One
// nside-512 chunk (lc 64, nz 256, Σ mw 19,968 over 24 ℓ-chunks) reads 2.62
// GB of ξ and writes 0.17 GB of planes: 0.83 ms at 3.35 TB/s.  The FMAs
// need 45% of the FP32 rate to keep pace, so the loop must be lean.
//
// The design:
//  * A block owns one ℓ row, 128 m columns (one a thread) and a tile of up
//    to 32 planes (FT), all planes of a (row, m) in one block when F2 ≤ 32,
//    so ξ is read from device memory once; more planes take further tiles
//    along grid z, each reading ξ again.
//  * ξ's y-slices stream through a ring of 3 shared-memory stages filled by
//    cp.async as 16-byte .cg copies (single elements where the strides or
//    mw are not whole vectors); the stage's roots values [y][z] ride along
//    as single-element copies through their strides (row- or column-major
//    matrices alike), so nz is not limited by shared memory.  One barrier a
//    stage; two stages in flight while one is contracted.
//  * Each thread keeps its column's FT sums in registers: per y, two LDS of
//    ξ, two multiplies by h, FT/8 (f32) broadcast LDS.128 of roots values
//    and FT FMAs, in y order, as cuBLAS's GEMM summed them (the same bits
//    on the cells' shapes).
//  * The tile is staged in shared memory and written as 16-byte vectors,
//    consecutive threads on consecutive addresses, every plane of the
//    (row, m) including the zero padding planes: no strided copies.
//  * Rows without roots (i ≥ nvalid) read no ξ and write zeros.
//
// What holds it back: instruction issue.  Besides its 4 FMAs a byte of ξ
// the loop issues an LDS, a multiply and two LDS.128 per 16 FMAs and the
// copies' address arithmetic, about 6 instructions a byte, near 70% of the
// SM's issue rate at the full memory rate.  Tiles probed on an H100
// (128 or 64 columns, 2–4 stages, 4–12 blocks an SM): 5 blocks of 128
// threads (registers capped at 102) and 3 stages ran the nside-512 chunk
// in 1.29–1.33 ms against 1.50–1.56 ms at 4 blocks and 4 stages; the
// nside-2048 chunk (nz 64) took 5.6–5.9 ms in every variant.

#include <cuda_runtime.h>
#include <cstddef>
#include <cstdint>
#include <type_traits>

#include "hopper_tiles.cuh"

namespace {

using cora::cp_async16;
using cora::cp_async_commit;
using cora::cp_async_el;
using cora::cp_async_wait;

constexpr int TM = 128;  // m columns a block, one a thread
constexpr int kDrawThreads = TM;
constexpr int NS = 3;      // shared-memory stages
constexpr int FMAX = 32;   // planes a tile at most
constexpr int kMinBlocks = 5;  // f32 blocks an SM (f64: 3)

template <typename T> struct Cfg {
  static constexpr int V = 16 / (int)sizeof(T);   // elements a vector
  static constexpr int YB = 32 / (int)sizeof(T);  // y values a stage
  static constexpr int XI = YB * 2 * TM;          // ξ elements a stage
  static constexpr int RS = YB * FMAX / 2;        // roots elements a stage
  static constexpr int STAGE = XI + RS;
  static constexpr int OUT = TM * (FMAX + V);     // the staged output tile
  static constexpr int ELEMS = NS * STAGE > OUT ? NS * STAGE : OUT;
};

__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float fma_rn(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}
__device__ __forceinline__ double fma_rn(double a, double b, double c) {
  return __fma_rn(a, b, c);
}

// v[0..N) = src[0..N) by 16-byte shared-memory loads (src 16-byte aligned).
template <int N>
__device__ __forceinline__ void lds16(float (&v)[N], const float* src) {
#pragma unroll
  for (int j = 0; j < N / 4; ++j) {
    const float4 x = reinterpret_cast<const float4*>(src)[j];
    v[4 * j] = x.x;
    v[4 * j + 1] = x.y;
    v[4 * j + 2] = x.z;
    v[4 * j + 3] = x.w;
  }
}
template <int N>
__device__ __forceinline__ void lds16(double (&v)[N], const double* src) {
#pragma unroll
  for (int j = 0; j < N / 2; ++j) {
    const double2 x = reinterpret_cast<const double2*>(src)[j];
    v[2 * j] = x.x;
    v[2 * j + 1] = x.y;
  }
}

template <typename T, int FT>
__global__ void __launch_bounds__(kDrawThreads, sizeof(T) == 4 ? kMinBlocks : 3)
correlated_draw_kernel(const T* __restrict__ xi, long long s_i, long long s_y,
                       long long s_p, const T* __restrict__ R, long long r_l,
                       long long r_z, long long r_y, int nvalid,
                       T* out0, T* out1,  // may be one tensor (cached mode)
                       int row0_even, int row0_odd, int nz, int nzc, int mw,
                       long long pitch, int fs, T h, int vec) {
  using C = Cfg<T>;
  constexpr int V = C::V, YB = C::YB, FH = FT / 2;
  constexpr int RP = FH > V ? FH : V;  // roots pitch a y: whole vectors
  __shared__ __align__(16) T smem[C::ELEMS];

  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * TM;
  const int i = blockIdx.y;
  const int f0 = blockIdx.z * FT;  // the tile's first plane
  const int z0 = blockIdx.z * FH;

  T acc[FT];
#pragma unroll
  for (int f = 0; f < FT; ++f) acc[f] = T(0);

  if (i < nvalid) {
    const T* xrow = xi + (long long)i * s_i;
    const T* rrow = R + (long long)i * r_l + (long long)z0 * r_z;
    const int nsteps = (nz + YB - 1) / YB;

    // Stage s ← y values [step·YB, step·YB + YB): ξ as [y][p][TM], roots
    // as [y][RP] (z < FH used); past nz, mw or nzc zero-filled.
    auto load = [&](int s, int step) {
      T* xs = smem + s * C::STAGE;
      T* rs = xs + C::XI;
      const int y0 = step * YB;
      if (vec) {
        constexpr int VPR = TM / V;  // vectors a (y, p) row
#pragma unroll
        for (int k = 0; k < C::XI / V / kDrawThreads; ++k) {
          const int v = tid + k * kDrawThreads;
          const int yp = v / VPR, col = (v % VPR) * V;
          const int y = y0 + (yp >> 1);
          const bool ok = y < nz && m0 + col < mw;
          const T* src =
              ok ? xrow + (long long)y * s_y + (yp & 1) * s_p + m0 + col : xi;
          cp_async16(xs + yp * TM + col, src, ok);
        }
      } else {
        for (int e = tid; e < C::XI; e += kDrawThreads) {
          const int yp = e / TM, col = e % TM;
          const int y = y0 + (yp >> 1);
          const bool ok = y < nz && m0 + col < mw;
          const T* src =
              ok ? xrow + (long long)y * s_y + (yp & 1) * s_p + m0 + col : xi;
          cp_async_el(xs + e, src, ok);
        }
      }
      for (int e = tid; e < YB * FH; e += kDrawThreads) {
        const int y = y0 + e / FH, z = e % FH;
        const bool ok = y < nz && z0 + z < nzc;
        const T* src = ok ? rrow + (long long)z * r_z + (long long)y * r_y : R;
        cp_async_el(rs + (e / FH) * RP + z, src, ok);
      }
    };

#pragma unroll
    for (int s = 0; s < NS - 1; ++s) {
      if (s < nsteps) load(s, s);
      cp_async_commit();
    }
    for (int step = 0; step < nsteps; ++step) {
      cp_async_wait<NS - 2>();
      __syncthreads();  // stage `step` is in; stage step−1 is free
      const int nxt = step + NS - 1;
      if (nxt < nsteps) load(nxt % NS, nxt);
      cp_async_commit();
      const T* xs = smem + (step % NS) * C::STAGE;
      const T* rs = xs + C::XI;
#pragma unroll
      for (int y = 0; y < YB; ++y) {
        const T x0 = mul_rn(xs[(2 * y) * TM + tid], h);
        const T x1 = mul_rn(xs[(2 * y + 1) * TM + tid], h);
        T r[RP];
        lds16(r, rs + y * RP);
#pragma unroll
        for (int z = 0; z < FH; ++z) {
          acc[2 * z] = fma_rn(r[z], x0, acc[2 * z]);
          acc[2 * z + 1] = fma_rn(r[z], x1, acc[2 * z + 1]);
        }
      }
    }
    cp_async_wait<0>();
    __syncthreads();  // the stages are free for the output tile
  }

  // The tile [TM][FT] through shared memory (pitch FT + V: conflict-free
  // vector stores), then out as whole vectors along (m, plane).
  constexpr int OP = FT + V;
  T* os = smem;
#pragma unroll
  for (int q = 0; q < FT / V; ++q) {
    if constexpr (V == 4) {
      reinterpret_cast<float4*>(os + tid * OP)[q] = make_float4(
          acc[4 * q], acc[4 * q + 1], acc[4 * q + 2], acc[4 * q + 3]);
    } else {
      reinterpret_cast<double2*>(os + tid * OP)[q] =
          make_double2(acc[2 * q], acc[2 * q + 1]);
    }
  }
  __syncthreads();
  const int nq = min(FT, fs - f0) / V;  // vectors a column in this tile
  const int tmv = min(TM, mw - m0);
  T* orow = (i & 1) ? out1 + (long long)(row0_odd + i / 2) * pitch
                    : out0 + (long long)(row0_even + i / 2) * pitch;
  using Vec = typename std::conditional<V == 4, float4, double2>::type;
  for (int v = tid; v < tmv * nq; v += kDrawThreads) {
    const int col = v / nq, q = v % nq;
    *reinterpret_cast<Vec*>(orow + (long long)(m0 + col) * fs + f0 + q * V) =
        *reinterpret_cast<const Vec*>(os + col * OP + q * V);
  }
}

template <typename T, int FT>
cudaError_t launch_tile(const void* xi, long long s_i, long long s_y,
                        long long s_p, const void* R, long long r_l,
                        long long r_z, long long r_y, int nvalid, void* out0,
                        void* out1, int row0_even, int row0_odd, int n, int nz,
                        int nzc, int mw, long long pitch, int fs, double h,
                        int vec, cudaStream_t stream) {
  const dim3 grid((mw + TM - 1) / TM, n, (2 * nzc + FT - 1) / FT);
  correlated_draw_kernel<T, FT><<<grid, kDrawThreads, 0, stream>>>(
      (const T*)xi, s_i, s_y, s_p, (const T*)R, r_l, r_z, r_y, nvalid,
      (T*)out0, (T*)out1, row0_even, row0_odd, nz, nzc, mw, pitch, fs, (T)h,
      vec);
  return cudaGetLastError();
}

template <typename T>
int launch(const void* xi, long long s_i, long long s_y, long long s_p,
           const void* R, long long r_l, long long r_z, long long r_y,
           int nvalid, void* out0, void* out1, int row0_even, int row0_odd,
           int n, int nz, int nzc, int mw, long long pitch, int fs, double h,
           int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0 || mw <= 0 || nzc <= 0) return 0;
  constexpr int V = 16 / sizeof(T);
  if (nz <= 0 || fs < 2 * nzc || fs % V != 0 || pitch % V != 0 ||
      n > 65535 || (2 * nzc + FMAX - 1) / FMAX > 65535 ||
      reinterpret_cast<uintptr_t>(out0) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(out1) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const int vec = reinterpret_cast<uintptr_t>(xi) % 16 == 0 && s_i % V == 0 &&
                  s_y % V == 0 && s_p % V == 0 && mw % V == 0;
  cudaStream_t st = (cudaStream_t)stream;
  const int F2 = 2 * nzc;
  if (F2 <= 4)
    err = launch_tile<T, 4>(xi, s_i, s_y, s_p, R, r_l, r_z, r_y, nvalid, out0,
                            out1, row0_even, row0_odd, n, nz, nzc, mw, pitch,
                            fs, h, vec, st);
  else if (F2 <= 8)
    err = launch_tile<T, 8>(xi, s_i, s_y, s_p, R, r_l, r_z, r_y, nvalid, out0,
                            out1, row0_even, row0_odd, n, nz, nzc, mw, pitch,
                            fs, h, vec, st);
  else if (F2 <= 16)
    err = launch_tile<T, 16>(xi, s_i, s_y, s_p, R, r_l, r_z, r_y, nvalid,
                             out0, out1, row0_even, row0_odd, n, nz, nzc, mw,
                             pitch, fs, h, vec, st);
  else
    err = launch_tile<T, FMAX>(xi, s_i, s_y, s_p, R, r_l, r_z, r_y, nvalid,
                               out0, out1, row0_even, row0_odd, n, nz, nzc,
                               mw, pitch, fs, h, vec, st);
  return (int)err;
}

}  // namespace

extern "C" {

// Launch on `stream` (a cudaStream_t) of device `device`; returns the
// cudaError_t of the launch (0 on success).  Strides are in elements; xi's
// m axis and each plane row are contiguous; out0 and out1 are planes-minor
// [rows, M, fs] with pitch = M·fs, 16-byte aligned; rows i < n are written
// for every m < mw and every plane of fs; h is the scale of ξ.
int cora_correlated_draw_f32(const void* xi, long long s_i, long long s_y,
                             long long s_p, const void* R, long long r_l,
                             long long r_z, long long r_y, int nvalid,
                             void* out0, void* out1, int row0_even,
                             int row0_odd, int n, int nz, int nzc, int mw,
                             long long pitch, int fs, double h, int device,
                             void* stream) {
  return launch<float>(xi, s_i, s_y, s_p, R, r_l, r_z, r_y, nvalid, out0,
                       out1, row0_even, row0_odd, n, nz, nzc, mw, pitch, fs,
                       h, device, stream);
}

// The same on double ξ, roots and planes.
int cora_correlated_draw_f64(const void* xi, long long s_i, long long s_y,
                             long long s_p, const void* R, long long r_l,
                             long long r_z, long long r_y, int nvalid,
                             void* out0, void* out1, int row0_even,
                             int row0_odd, int n, int nz, int nzc, int mw,
                             long long pitch, int fs, double h, int device,
                             void* stream) {
  return launch<double>(xi, s_i, s_y, s_p, R, r_l, r_z, r_y, nvalid, out0,
                        out1, row0_even, row0_odd, n, nz, nzc, mw, pitch, fs,
                        h, device, stream);
}

}  // extern "C"
