// Fused scaled-Legendre recurrence + contraction for the scan-mode SHT.
//
// Replaces the TPU kernel cora_tpu/ops/pallas_scan_legendre.py
// `scan_contract_fused` (kernel body `_kernel`).  Same function, same
// layout at the wrapper (cora_tpu_torch/ops/scan_legendre.py):
//
//   rec_a, rec_b [L, M]     recurrence rows a_lm, b_lm
//   seed_T, k0_T [M, R]     pre-scaled λ_mm seeds and their 2^S scale counts
//   z            [R]        cosθ of the northern rings
//   ck_T [nband, 2, M, R]   checkpoint rows (λ_{l0-2}, λ_{l0-1}) per band
//   alm0, alm1 [F2, L/2, M] even-ℓ / odd-ℓ a_lm planes
//   He, Ho     [F2, R, M]   He = Σ_{ℓ even} λ·alm0,  Ho = Σ_{ℓ odd} λ·alm1
//
// λ_ℓ = a_ℓm·(z·λ_{ℓ-1}) + b_ℓm·λ_{ℓ-2}; at ℓ = m the seed and its scale
// count k are injected; a row is emitted only where k == 0; once per row
// pair (after the odd row) a value with |λ| > 2^β and k > 0 is scaled by
// 2^-S and k drops by one; at each band start (every `band_rows` rows)
// the carry restarts from the checkpoint rows where both exceed 2^-20.
// λ never leaves registers.  Two instantiations: float (S=60, β=30, the
// f32 tables' scaling) and double (S=512, β=256, the f64 tables', which
// carry no checkpoints).
//
// What bounds it on an H100: per (f, ℓ, ring, m) one FMA, plus ~10
// instructions of recurrence per (ℓ, ring, m) and f-tile, all on the CUDA
// cores; the a_lm planes are read once per ring tile (L2-resident across
// the ring tiles of one m tile) and He/Ho written once, so device memory
// traffic is small next to the arithmetic.  Issue-bound in f32; the
// double version is bound by the card's f64 FMA rate.
//
// Design, against what the TPU version relied on:
//  * The Pallas kernel kept all F2 planes of He/Ho resident in up to 110 MB
//    of VMEM.  Here the plane axis is a grid dimension (FT planes per
//    block: 16 in f32, 8 in f64 so the accumulators stay in registers);
//    each block recomputes the recurrence for its (m, ring) tile.
//  * The TPU grid walked ℓ-blocks in order and carried the recurrence in
//    scratch.  Here one block loops over ℓ itself: one warp per m value,
//    one lane per ring, carry (λ_p, λ_pp, k) in registers.  A block starts
//    at the ℓ-block holding its first m (rows ℓ < m are exactly zero and
//    leave the carry at zero, so skipping them changes nothing).
//  * The re-seed check runs per row pair against a running band counter,
//    so any even cadence works — the nside=512 default of 64 rows included
//    (the Pallas kernel needed 128-row multiples).
//  * The a_lm rows of one ℓ-block are staged in shared memory as
//    [pair][m][f]: all lanes of a warp share m, so each vector read is a
//    broadcast.  Sums are two-level (a fresh partial per ℓ-block, added to
//    the running total at block end) to keep the summation error near
//    that of the blocked reference contraction.
//  * Plain FMA on the CUDA cores: no tensor cores, no TF32.

#include <cuda_runtime.h>
#include <climits>
#include <cstddef>

namespace {

constexpr int kWarps = 8;              // m values per block
constexpr int kThreads = kWarps * 32;  // one lane per ring
constexpr int kLB = 32;                // ℓ rows staged per step (even)
constexpr int kPairs = kLB / 2;

// Scaling constants and plane tile per real type.
template <typename T> struct Scan;
template <> struct Scan<float> {
  static constexpr int FT = 16;
  static constexpr float thresh = 0x1p30f;
  static constexpr float down = 0x1p-60f;
  static constexpr float ck_use = 0x1p-20f;
};
template <> struct Scan<double> {
  static constexpr int FT = 8;
  static constexpr double thresh = 0x1p256;
  static constexpr double down = 0x1p-512;
  static constexpr double ck_use = 0x1p-20;
};

// acc[f] += out · row[f] for one staged a_lm row (FT values of one m).
template <int FT>
__device__ __forceinline__ void fma_row(float* acc, const float* row,
                                        float out) {
  const float4* r4 = reinterpret_cast<const float4*>(row);
#pragma unroll
  for (int q = 0; q < FT / 4; ++q) {
    const float4 v = r4[q];
    acc[4 * q + 0] = fmaf(out, v.x, acc[4 * q + 0]);
    acc[4 * q + 1] = fmaf(out, v.y, acc[4 * q + 1]);
    acc[4 * q + 2] = fmaf(out, v.z, acc[4 * q + 2]);
    acc[4 * q + 3] = fmaf(out, v.w, acc[4 * q + 3]);
  }
}

template <int FT>
__device__ __forceinline__ void fma_row(double* acc, const double* row,
                                        double out) {
  const double2* r2 = reinterpret_cast<const double2*>(row);
#pragma unroll
  for (int q = 0; q < FT / 2; ++q) {
    const double2 v = r2[q];
    acc[2 * q + 0] = fma(out, v.x, acc[2 * q + 0]);
    acc[2 * q + 1] = fma(out, v.y, acc[2 * q + 1]);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
scan_contract_kernel(const T* __restrict__ rec_a,
                     const T* __restrict__ rec_b,
                     const T* __restrict__ seed_T,
                     const T* __restrict__ k0_T,
                     const T* __restrict__ z,
                     const T* __restrict__ ck_T, int nband,
                     const T* __restrict__ alm0,
                     const T* __restrict__ alm1,
                     T* __restrict__ he, T* __restrict__ ho,
                     int L, int M, int R, int F2, int band_rows) {
  constexpr int FT = Scan<T>::FT;
  __shared__ __align__(16) T s_alm[2][kPairs][kWarps][FT];
  __shared__ T s_rec[2][kLB][kWarps];

  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int r = blockIdx.x * 32 + lane;
  const int m0 = blockIdx.y * kWarps;
  const int m = m0 + w;
  const int f0 = blockIdx.z * FT;
  const bool live = (r < R) && (m < M);
  const int Lh = L / 2;
  const size_t MR = (size_t)M * R;

  T zr = 0, seed = 0, k0 = 1;
  if (live) {
    zr = z[r];
    seed = seed_T[(size_t)m * R + r];
    k0 = k0_T[(size_t)m * R + r];
  }

  T acc_e[FT], acc_o[FT];
#pragma unroll
  for (int f = 0; f < FT; ++f) {
    acc_e[f] = 0;
    acc_o[f] = 0;
  }
  T lp = 0, lpp = 0, k = 0;

  const int lstart = (m0 / kLB) * kLB;
  int next_ck = INT_MAX;
  if (nband > 1) {
    next_ck = ((lstart + band_rows - 1) / band_rows) * band_rows;
    if (next_ck < band_rows) next_ck = band_rows;
  }

  for (int lb0 = lstart; lb0 < L; lb0 += kLB) {
    __syncthreads();
    for (int i = threadIdx.x; i < 2 * kPairs * FT * kWarps; i += kThreads) {
      const int mm = i % kWarps;
      int t = i / kWarps;
      const int f = t % FT;
      t /= FT;
      const int j = t % kPairs;
      const int par = t / kPairs;
      const int gm = m0 + mm, gf = f0 + f, gj = lb0 / 2 + j;
      T v = 0;
      if (gm < M && gf < F2 && gj < Lh)
        v = (par ? alm1 : alm0)[((size_t)gf * Lh + gj) * M + gm];
      s_alm[par][j][mm][f] = v;
    }
    for (int i = threadIdx.x; i < 2 * kLB * kWarps; i += kThreads) {
      const int mm = i % kWarps;
      const int row = (i / kWarps) % kLB;
      const int ab = i / (kWarps * kLB);
      const int gm = m0 + mm, gl = lb0 + row;
      T v = 0;
      if (gm < M && gl < L) v = (ab ? rec_b : rec_a)[(size_t)gl * M + gm];
      s_rec[ab][row][mm] = v;
    }
    __syncthreads();

    T pe[FT], po[FT];
#pragma unroll
    for (int f = 0; f < FT; ++f) {
      pe[f] = 0;
      po[f] = 0;
    }
    const int npair = min(kPairs, (L - lb0) / 2);
    for (int p = 0; p < npair; ++p) {
      const int l = lb0 + 2 * p;
      if (l == next_ck) {  // band start: restart from checkpoint rows
        const int b = l / band_rows;
        if (b < nband && live) {
          const size_t off = (size_t)b * 2 * MR + (size_t)m * R + r;
          const T c0 = ck_T[off];
          const T c1 = ck_T[off + MR];
          if (fabs(c0) > Scan<T>::ck_use && fabs(c1) > Scan<T>::ck_use) {
            lpp = c0;
            lp = c1;
            k = 0;
          }
        }
        next_ck += band_rows;
      }
      // even row ℓ = l
      T lam = s_rec[0][2 * p][w] * (zr * lp) + s_rec[1][2 * p][w] * lpp;
      if (m == l) {
        lam = seed;
        k = k0;
      }
      T out = (k == 0) ? lam : T(0);
      lpp = lp;
      lp = lam;
      fma_row<FT>(pe, s_alm[0][p][w], out);
      // odd row ℓ = l + 1
      lam = s_rec[0][2 * p + 1][w] * (zr * lp) + s_rec[1][2 * p + 1][w] * lpp;
      if (m == l + 1) {
        lam = seed;
        k = k0;
      }
      out = (k == 0) ? lam : T(0);
      lpp = lp;
      lp = lam;
      fma_row<FT>(po, s_alm[1][p][w], out);
      // rescale once per row pair
      if (fabs(lp) > Scan<T>::thresh && k > 0) {
        lp *= Scan<T>::down;
        lpp *= Scan<T>::down;
        k -= 1;
      }
    }
#pragma unroll
    for (int f = 0; f < FT; ++f) {
      acc_e[f] += pe[f];
      acc_o[f] += po[f];
    }
  }

  if (live) {
#pragma unroll
    for (int f = 0; f < FT; ++f) {
      if (f0 + f < F2) {
        const size_t o = ((size_t)(f0 + f) * R + r) * M + m;
        he[o] = acc_e[f];
        ho[o] = acc_o[f];
      }
    }
  }
}

template <typename T>
int launch(const void* rec_a, const void* rec_b, const void* seed_T,
           const void* k0_T, const void* z, const void* ck_T, int nband,
           const void* alm0, const void* alm1, void* he, void* ho, int L,
           int M, int R, int F2, int band_rows, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (L <= 0 || M <= 0 || R <= 0 || F2 <= 0) return 0;
  constexpr int FT = Scan<T>::FT;
  const dim3 grid((R + 31) / 32, (M + kWarps - 1) / kWarps,
                  (F2 + FT - 1) / FT);
  scan_contract_kernel<T><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const T*)rec_a, (const T*)rec_b, (const T*)seed_T, (const T*)k0_T,
      (const T*)z, (const T*)ck_T, nband, (const T*)alm0, (const T*)alm1,
      (T*)he, (T*)ho, L, M, R, F2, band_rows);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch on `stream` (a cudaStream_t) of device `device`; returns the
// cudaError_t of the launch (0 on success).  The caller owns all buffers.
int cora_scan_contract(const void* rec_a, const void* rec_b,
                       const void* seed_T, const void* k0_T, const void* z,
                       const void* ck_T, int nband, const void* alm0,
                       const void* alm1, void* he, void* ho, int L, int M,
                       int R, int F2, int band_rows, int device,
                       void* stream) {
  return launch<float>(rec_a, rec_b, seed_T, k0_T, z, ck_T, nband, alm0,
                       alm1, he, ho, L, M, R, F2, band_rows, device, stream);
}

// The same on double tables (S=512, β=256) and planes.
int cora_scan_contract_f64(const void* rec_a, const void* rec_b,
                           const void* seed_T, const void* k0_T,
                           const void* z, const void* ck_T, int nband,
                           const void* alm0, const void* alm1, void* he,
                           void* ho, int L, int M, int R, int F2,
                           int band_rows, int device, void* stream) {
  return launch<double>(rec_a, rec_b, seed_T, k0_T, z, ck_T, nband, alm0,
                        alm1, he, ho, L, M, R, F2, band_rows, device, stream);
}

}  // extern "C"
