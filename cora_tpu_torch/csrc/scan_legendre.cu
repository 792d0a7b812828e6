// Fused scaled-Legendre recurrence + contraction for the scan-mode SHT.
//
// Replaces the TPU kernel cora_tpu/ops/pallas_scan_legendre.py
// `scan_contract_fused` (kernel body `_kernel`).  Same function, same
// layout at the wrapper (cora_tpu_torch/ops/scan_legendre.py):
//
//   rec_a, rec_b [L, M]     recurrence rows a_lm, b_lm
//   seed_T, k0_T [M, R]     pre-scaled λ_mm seeds and their 2^60 scale counts
//   z            [R]        cosθ of the northern rings
//   ck_T [nband, 2, M, R]   checkpoint rows (λ_{l0-2}, λ_{l0-1}) per band
//   alm0, alm1 [F2, L/2, M] even-ℓ / odd-ℓ a_lm planes
//   He, Ho     [F2, R, M]   He = Σ_{ℓ even} λ·alm0,  Ho = Σ_{ℓ odd} λ·alm1
//
// λ_ℓ = a_ℓm·(z·λ_{ℓ-1}) + b_ℓm·λ_{ℓ-2}; at ℓ = m the seed and its scale
// count k are injected; a row is emitted only where k == 0; once per row
// pair (after the odd row) a value with |λ| > 2^30 and k > 0 is scaled by
// 2^-60 and k drops by one; at each band start (every `band_rows` rows)
// the carry restarts from the checkpoint rows where both exceed 2^-20.
// λ never leaves registers.
//
// What bounds it on an H100: per (f, ℓ, ring, m) one FMA, plus ~10
// instructions of recurrence per (ℓ, ring, m) and f-tile, all f32 on the
// CUDA cores; the a_lm planes are read once per ring tile (L2-resident
// across the ring tiles of one m tile) and He/Ho written once, so device
// memory traffic is small next to the arithmetic.  Issue-bound.
//
// Design, against what the TPU version relied on:
//  * The Pallas kernel kept all F2 planes of He/Ho resident in up to 110 MB
//    of VMEM.  Here the plane axis is a grid dimension (FT planes per
//    block); each block recomputes the recurrence for its (m, ring) tile.
//  * The TPU grid walked ℓ-blocks in order and carried the recurrence in
//    scratch.  Here one block loops over ℓ itself: one warp per m value,
//    one lane per ring, carry (λ_p, λ_pp, k) in registers.  A block starts
//    at the ℓ-block holding its first m (rows ℓ < m are exactly zero and
//    leave the carry at zero, so skipping them changes nothing).
//  * The re-seed check runs per row pair against a running band counter,
//    so any even cadence works — the nside=512 default of 64 rows included
//    (the Pallas kernel needed 128-row multiples).
//  * The a_lm rows of one ℓ-block are staged in shared memory as
//    [pair][m][f]: all lanes of a warp share m, so each float4 read is a
//    broadcast.  Sums are two-level (a fresh partial per ℓ-block, added to
//    the running total at block end) to keep f32 summation error near
//    that of the blocked reference contraction.
//  * Pure f32 FMA: no tensor cores, no TF32.

#include <cuda_runtime.h>
#include <climits>
#include <cstddef>

namespace {

constexpr int kWarps = 8;              // m values per block
constexpr int kThreads = kWarps * 32;  // one lane per ring
constexpr int kFT = 16;                // planes per block
constexpr int kLB = 32;                // ℓ rows staged per step (even)
constexpr int kPairs = kLB / 2;

constexpr float kThresh = 1073741824.0f;           // 2^30
constexpr float kDown = 8.6736173798840355e-19f;   // 2^-60
constexpr float kCkUse = 9.5367431640625e-07f;     // 2^-20

__global__ void __launch_bounds__(kThreads, 2)
scan_contract_kernel(const float* __restrict__ rec_a,
                     const float* __restrict__ rec_b,
                     const float* __restrict__ seed_T,
                     const float* __restrict__ k0_T,
                     const float* __restrict__ z,
                     const float* __restrict__ ck_T, int nband,
                     const float* __restrict__ alm0,
                     const float* __restrict__ alm1,
                     float* __restrict__ he, float* __restrict__ ho,
                     int L, int M, int R, int F2, int band_rows) {
  __shared__ __align__(16) float s_alm[2][kPairs][kWarps][kFT];
  __shared__ float s_rec[2][kLB][kWarps];

  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int r = blockIdx.x * 32 + lane;
  const int m0 = blockIdx.y * kWarps;
  const int m = m0 + w;
  const int f0 = blockIdx.z * kFT;
  const bool live = (r < R) && (m < M);
  const int Lh = L / 2;
  const size_t MR = (size_t)M * R;

  float zr = 0.f, seed = 0.f, k0 = 1.f;
  if (live) {
    zr = z[r];
    seed = seed_T[(size_t)m * R + r];
    k0 = k0_T[(size_t)m * R + r];
  }

  float acc_e[kFT], acc_o[kFT];
#pragma unroll
  for (int f = 0; f < kFT; ++f) {
    acc_e[f] = 0.f;
    acc_o[f] = 0.f;
  }
  float lp = 0.f, lpp = 0.f, k = 0.f;

  const int lstart = (m0 / kLB) * kLB;
  int next_ck = INT_MAX;
  if (nband > 1) {
    next_ck = ((lstart + band_rows - 1) / band_rows) * band_rows;
    if (next_ck < band_rows) next_ck = band_rows;
  }

  for (int lb0 = lstart; lb0 < L; lb0 += kLB) {
    __syncthreads();
    for (int i = threadIdx.x; i < 2 * kPairs * kFT * kWarps; i += kThreads) {
      const int mm = i % kWarps;
      int t = i / kWarps;
      const int f = t % kFT;
      t /= kFT;
      const int j = t % kPairs;
      const int par = t / kPairs;
      const int gm = m0 + mm, gf = f0 + f, gj = lb0 / 2 + j;
      float v = 0.f;
      if (gm < M && gf < F2 && gj < Lh)
        v = (par ? alm1 : alm0)[((size_t)gf * Lh + gj) * M + gm];
      s_alm[par][j][mm][f] = v;
    }
    for (int i = threadIdx.x; i < 2 * kLB * kWarps; i += kThreads) {
      const int mm = i % kWarps;
      const int row = (i / kWarps) % kLB;
      const int ab = i / (kWarps * kLB);
      const int gm = m0 + mm, gl = lb0 + row;
      float v = 0.f;
      if (gm < M && gl < L) v = (ab ? rec_b : rec_a)[(size_t)gl * M + gm];
      s_rec[ab][row][mm] = v;
    }
    __syncthreads();

    float pe[kFT], po[kFT];
#pragma unroll
    for (int f = 0; f < kFT; ++f) {
      pe[f] = 0.f;
      po[f] = 0.f;
    }
    const int npair = min(kPairs, (L - lb0) / 2);
    for (int p = 0; p < npair; ++p) {
      const int l = lb0 + 2 * p;
      if (l == next_ck) {  // band start: restart from checkpoint rows
        const int b = l / band_rows;
        if (b < nband && live) {
          const size_t off = (size_t)b * 2 * MR + (size_t)m * R + r;
          const float c0 = ck_T[off];
          const float c1 = ck_T[off + MR];
          if (fabsf(c0) > kCkUse && fabsf(c1) > kCkUse) {
            lpp = c0;
            lp = c1;
            k = 0.f;
          }
        }
        next_ck += band_rows;
      }
      // even row ℓ = l
      float lam = s_rec[0][2 * p][w] * (zr * lp) + s_rec[1][2 * p][w] * lpp;
      if (m == l) {
        lam = seed;
        k = k0;
      }
      float out = (k == 0.f) ? lam : 0.f;
      lpp = lp;
      lp = lam;
      const float4* ae = reinterpret_cast<const float4*>(s_alm[0][p][w]);
#pragma unroll
      for (int q = 0; q < kFT / 4; ++q) {
        const float4 v = ae[q];
        pe[4 * q + 0] = fmaf(out, v.x, pe[4 * q + 0]);
        pe[4 * q + 1] = fmaf(out, v.y, pe[4 * q + 1]);
        pe[4 * q + 2] = fmaf(out, v.z, pe[4 * q + 2]);
        pe[4 * q + 3] = fmaf(out, v.w, pe[4 * q + 3]);
      }
      // odd row ℓ = l + 1
      lam = s_rec[0][2 * p + 1][w] * (zr * lp) + s_rec[1][2 * p + 1][w] * lpp;
      if (m == l + 1) {
        lam = seed;
        k = k0;
      }
      out = (k == 0.f) ? lam : 0.f;
      lpp = lp;
      lp = lam;
      const float4* ao = reinterpret_cast<const float4*>(s_alm[1][p][w]);
#pragma unroll
      for (int q = 0; q < kFT / 4; ++q) {
        const float4 v = ao[q];
        po[4 * q + 0] = fmaf(out, v.x, po[4 * q + 0]);
        po[4 * q + 1] = fmaf(out, v.y, po[4 * q + 1]);
        po[4 * q + 2] = fmaf(out, v.z, po[4 * q + 2]);
        po[4 * q + 3] = fmaf(out, v.w, po[4 * q + 3]);
      }
      // rescale once per row pair
      if (fabsf(lp) > kThresh && k > 0.f) {
        lp *= kDown;
        lpp *= kDown;
        k -= 1.f;
      }
    }
#pragma unroll
    for (int f = 0; f < kFT; ++f) {
      acc_e[f] += pe[f];
      acc_o[f] += po[f];
    }
  }

  if (live) {
#pragma unroll
    for (int f = 0; f < kFT; ++f) {
      if (f0 + f < F2) {
        const size_t o = ((size_t)(f0 + f) * R + r) * M + m;
        he[o] = acc_e[f];
        ho[o] = acc_o[f];
      }
    }
  }
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
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (L <= 0 || M <= 0 || R <= 0 || F2 <= 0) return 0;
  const dim3 grid((R + 31) / 32, (M + kWarps - 1) / kWarps,
                  (F2 + kFT - 1) / kFT);
  scan_contract_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)rec_a, (const float*)rec_b, (const float*)seed_T,
      (const float*)k0_T, (const float*)z, (const float*)ck_T, nband,
      (const float*)alm0, (const float*)alm1, (float*)he, (float*)ho, L, M,
      R, F2, band_rows);
  return (int)cudaGetLastError();
}

}  // extern "C"
