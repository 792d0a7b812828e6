// Legendre contraction from a stored Λ table (the cached-Λ SHT mode).
//
// Replaces the TPU kernel cora_tpu/ops/pallas_legendre.py
// `legendre_contract_pallas` (kernel body `_kernel`), which computes
// H[f, r, m] = Σ_ℓ Λ[ℓ, r, m]·a[f, ℓ, m] from a dense Λ.  Here Λ comes as the
// ragged chunks the cached mode stores (cora_tpu/healpix/sht.py
// `_legendre_contract_cached`, spin.py `_contract_cached`), all in one flat
// allocation, and one launch covers every chunk:
//
//   lam                    chunk c at element offset off_c: [mw_c, nrows_c, R]
//                          (m-major, rings minor)
//   desc [nchunk, 5] int64 (off_c, nrows_c, mw_c, row0_c, target_c)
//   A  [F2, LA, M]         real planes (re and im of each batch entry)
//   H0, H1 [F2, R, M]      H_t(c)[f, r, m] += Σ_{i<nrows_c} Λ_c[m, i, r] ·
//                                             A[f, row0_c + i, m],  m < mw_c
//
// The scalar layout packs rows by ℓ parity (evens then odds) and routes each
// chunk to the accumulator of its parity; the spin layout keeps consecutive ℓ
// rows and one accumulator (H1 null).  A dense Λ is the one-chunk case.
//
// What bounds it on an H100: Λ is read once and dominates the bytes (5.23 GB
// in f32 at nside=512, lmax=1535); the flagship call (F2=32) moves 5.80 GB,
// 1.73 ms at 3.35 TB/s, against 83.8 GFLOP of FMAs, 1.25 ms at the 67
// TFLOP/s f32 rate: memory-bound.
//
// Design, against what the TPU version relied on:
//  * The Pallas kernel accumulated a VMEM output tile across a sequential ℓ
//    grid axis.  Here a block owns its output tile (8 m values × 32 rings ×
//    FT planes: 16 in f32, 8 in f64) in registers and loops over the chunks
//    and their rows itself, so H0 and H1 are each read and written once by
//    one thread: no atomics, the same output every run.
//  * One warp per m value, one lane per ring: every Λ row of a warp is one
//    coalesced 128-byte read along the rings.  A step's 32 rows (16 in
//    f64) are loaded into registers at once, before the planes are staged,
//    so enough reads are in flight to cover the memory latency (one read
//    a row left the first version latency-bound at 6× its bound).
//  * The a_lm rows of a 32-row block are staged in shared memory as
//    [row][m][f]; all lanes of a warp share m, so each vector read is a
//    broadcast.  Sums are two-level (a fresh partial per 32-row block, added
//    to the accumulator at block end) to keep the f32 error near that of the
//    per-chunk einsum of the plain version.
//  * The plane tile is the fastest grid axis, so the blocks that read the
//    same Λ tile for other planes run together and find it in L2.
//  * Chunks with mw_c <= m are skipped by the whole block (λ_ℓm = 0 for
//    m > ℓ); ragged chunks and odd L need no padding.  Offsets are 64-bit:
//    the table exceeds 2^32 bytes.
//  * Plain FMA on the CUDA cores: no tensor cores, no TF32.

#include <cuda_runtime.h>
#include <cstddef>
#include <cstdint>

namespace {

constexpr int kWarps = 8;              // m values per block
constexpr int kThreads = kWarps * 32;  // one lane per ring
constexpr int kDesc = 5;               // descriptor entries per chunk

// Planes per block (FT) and rows per step (LB: the Λ values of a step are
// loaded into registers at once, LB loads in flight per thread).
template <typename T> struct Tile;
template <> struct Tile<float> {
  static constexpr int FT = 16;
  static constexpr int LB = 32;
};
template <> struct Tile<double> {
  static constexpr int FT = 8;
  static constexpr int LB = 16;
};

// acc[f] += v · row[f] for one staged a_lm row (FT values of one m).
template <int FT>
__device__ __forceinline__ void fma_row(float* acc, const float* row, float v) {
  const float4* r4 = reinterpret_cast<const float4*>(row);
#pragma unroll
  for (int q = 0; q < FT / 4; ++q) {
    const float4 a = r4[q];
    acc[4 * q + 0] = fmaf(v, a.x, acc[4 * q + 0]);
    acc[4 * q + 1] = fmaf(v, a.y, acc[4 * q + 1]);
    acc[4 * q + 2] = fmaf(v, a.z, acc[4 * q + 2]);
    acc[4 * q + 3] = fmaf(v, a.w, acc[4 * q + 3]);
  }
}

template <int FT>
__device__ __forceinline__ void fma_row(double* acc, const double* row,
                                        double v) {
  const double2* r2 = reinterpret_cast<const double2*>(row);
#pragma unroll
  for (int q = 0; q < FT / 2; ++q) {
    const double2 a = r2[q];
    acc[2 * q + 0] = fma(v, a.x, acc[2 * q + 0]);
    acc[2 * q + 1] = fma(v, a.y, acc[2 * q + 1]);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
legendre_contract_kernel(const T* __restrict__ lam,
                         const long long* __restrict__ desc, int nchunk,
                         const T* __restrict__ A, T* __restrict__ h0,
                         T* __restrict__ h1, int F2, int LA, int M, int R) {
  constexpr int FT = Tile<T>::FT;
  constexpr int kLB = Tile<T>::LB;
  __shared__ __align__(16) T s_a[kLB][kWarps][FT];

  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int f0 = blockIdx.x * FT;
  const int r = blockIdx.y * 32 + lane;
  const int m0 = blockIdx.z * kWarps;
  const int m = m0 + w;
  const bool live = (r < R) && (m < M);

  T acc0[FT], acc1[FT];
#pragma unroll
  for (int f = 0; f < FT; ++f) {
    acc0[f] = 0;
    acc1[f] = 0;
  }

  for (int c = 0; c < nchunk; ++c) {
    const long long* d = desc + (size_t)c * kDesc;
    const long long off = d[0];
    const int nrows = (int)d[1];
    const int mw = (int)d[2];
    const int row0 = (int)d[3];
    const bool tgt1 = d[4] != 0;
    if (m0 >= mw) continue;  // uniform over the block
    const bool mlive = live && m < mw;
    const T* lam_m = lam + off + ((size_t)(mlive ? m : 0) * nrows) * R + r;

    for (int i0 = 0; i0 < nrows; i0 += kLB) {
      const int nb = min(kLB, nrows - i0);
      // this step's Λ rows first: in flight while the planes are staged
      T lv[kLB];
      const T* lp = lam_m + (size_t)i0 * R;
#pragma unroll
      for (int i = 0; i < kLB; ++i)
        lv[i] = (mlive && i < nb) ? __ldg(lp + (size_t)i * R) : T(0);
      __syncthreads();
#pragma unroll
      for (int q = 0; q < kLB * kWarps * FT / kThreads; ++q) {
        const int i = q * kThreads + threadIdx.x;
        const int mm = i % kWarps;
        const int t = i / kWarps;
        const int f = t % FT;
        const int row = t / FT;
        const int gm = m0 + mm, gf = f0 + f;
        T v = 0;
        if (row < nb && gm < mw && gf < F2)
          v = A[((size_t)gf * LA + (row0 + i0 + row)) * M + gm];
        s_a[row][mm][f] = v;
      }
      __syncthreads();

      T part[FT];
#pragma unroll
      for (int f = 0; f < FT; ++f) part[f] = 0;
#pragma unroll
      for (int i = 0; i < kLB; ++i) fma_row<FT>(part, s_a[i][w], lv[i]);
      if (tgt1) {
#pragma unroll
        for (int f = 0; f < FT; ++f) acc1[f] += part[f];
      } else {
#pragma unroll
        for (int f = 0; f < FT; ++f) acc0[f] += part[f];
      }
    }
  }

  if (live) {
#pragma unroll
    for (int f = 0; f < FT; ++f) {
      if (f0 + f < F2) {
        const size_t o = ((size_t)(f0 + f) * R + r) * M + m;
        h0[o] += acc0[f];
        if (h1 != nullptr) h1[o] += acc1[f];
      }
    }
  }
}

template <typename T>
int launch(const void* lam, const void* desc, int nchunk, const void* A,
           void* h0, void* h1, int F2, int LA, int M, int R, int device,
           void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (nchunk <= 0 || F2 <= 0 || M <= 0 || R <= 0) return 0;
  constexpr int FT = Tile<T>::FT;
  const dim3 grid((F2 + FT - 1) / FT, (R + 31) / 32, (M + kWarps - 1) / kWarps);
  legendre_contract_kernel<T><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const T*)lam, (const long long*)desc, nchunk, (const T*)A, (T*)h0,
      (T*)h1, F2, LA, M, R);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch on `stream` (a cudaStream_t) of device `device`; returns the
// cudaError_t of the launch (0 on success).  The caller owns all buffers;
// `desc` is a device pointer; `h1` may be null when no chunk targets it.
int cora_legendre_contract_f32(const void* lam, const void* desc, int nchunk,
                               const void* A, void* h0, void* h1, int F2,
                               int LA, int M, int R, int device,
                               void* stream) {
  return launch<float>(lam, desc, nchunk, A, h0, h1, F2, LA, M, R, device,
                       stream);
}

// The same on double Λ, planes and accumulators.
int cora_legendre_contract_f64(const void* lam, const void* desc, int nchunk,
                               const void* A, void* h0, void* h1, int F2,
                               int LA, int M, int R, int device,
                               void* stream) {
  return launch<double>(lam, desc, nchunk, A, h0, h1, F2, LA, M, R, device,
                        stream);
}

}  // extern "C"
