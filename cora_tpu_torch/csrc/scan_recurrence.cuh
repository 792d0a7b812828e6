// The scaled associated-Legendre recurrence shared by the scan-mode kernels
// (K1 scan_legendre.cu, the synthesis, and K2 scan_project.cu, its adjoint):
//
//   λ_ℓ = a_ℓm·(z·λ_{ℓ-1}) + b_ℓm·λ_{ℓ-2}
//
// At ℓ = m the pre-scaled seed and its scale count k are injected; a row is
// emitted only where k == 0; once per row pair (after the odd row) a value
// with |λ| > 2^β and k > 0 is scaled by 2^-S and k drops by one; at each band
// start (every `band_rows` rows) the carry restarts from the checkpoint rows
// where both exceed 2^-20.  float: S=60, β=30; double: S=512, β=256.
//
// Each thread of a block carries CPT (m, ring) columns in registers; the
// recurrence rows a_ℓm, b_ℓm of the block's m group arrive in shared memory
// by cp.async (load_rec).

#pragma once

#include <climits>
#include <cstddef>

#include "hopper_tiles.cuh"

namespace cora {

// Scaling constants per real type.
template <typename T> struct Scan;
template <> struct Scan<float> {
  static constexpr float thresh = 0x1p30f;
  static constexpr float down = 0x1p-60f;
  static constexpr float ck_use = 0x1p-20f;
};
template <> struct Scan<double> {
  static constexpr double thresh = 0x1p256;
  static constexpr double down = 0x1p-512;
  static constexpr double ck_use = 0x1p-20;
};

// The recurrence of CPT (m, ring) columns per thread: column j is
// c = tid + j·256 of the block's MT × RT, m-major.
template <typename T, int CPT> struct Recurrence {
  T zr[CPT], seed[CPT], k0[CPT], lp[CPT], lpp[CPT], k[CPT], pf0[CPT],
      pf1[CPT];
  int m[CPT], r[CPT], mm[CPT], rl[CPT];
  bool live[CPT];
  int next_ck, pf_l;

  template <int RT>
  __device__ __forceinline__ void init(const T* __restrict__ seed_T,
                                       const T* __restrict__ k0_T,
                                       const T* __restrict__ z, int m0,
                                       int r0, int M, int R, int nband,
                                       int band_rows, int lstart) {
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int c = threadIdx.x + j * kThreads;
      mm[j] = c / RT;
      rl[j] = c % RT;
      m[j] = m0 + mm[j];
      r[j] = r0 + rl[j];
      live[j] = r[j] < R && m[j] < M;
      zr[j] = 0;
      seed[j] = 0;
      k0[j] = 1;
      if (live[j]) {
        zr[j] = z[r[j]];
        seed[j] = seed_T[(size_t)m[j] * R + r[j]];
        k0[j] = k0_T[(size_t)m[j] * R + r[j]];
      }
      lp[j] = lpp[j] = k[j] = 0;
    }
    next_ck = INT_MAX;
    if (nband > 1) {
      next_ck = ((lstart + band_rows - 1) / band_rows) * band_rows;
      if (next_ck < band_rows) next_ck = band_rows;
    }
    pf_l = -1;
  }

  // Fetch the checkpoint rows of the first band start in [lb, lb + LB).
  __device__ __forceinline__ void prefetch(const T* __restrict__ ck_T,
                                           int nband, int band_rows, int lb,
                                           int LB, int M, int R) {
    if (next_ck < lb || next_ck >= lb + LB) return;
    pf_l = next_ck;
    const int b = next_ck / band_rows;
    const size_t MR = (size_t)M * R;
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      pf0[j] = pf1[j] = 0;
      if (b < nband && live[j]) {
        const size_t off = (size_t)b * 2 * MR + (size_t)m[j] * R + r[j];
        pf0[j] = ck_T[off];
        pf1[j] = ck_T[off + MR];
      }
    }
  }

  // Band start at row l: restart from the checkpoint rows (those fetched
  // for pf_l, else read now) where both exceed 2^-20.
  __device__ __forceinline__ void reseed(const T* __restrict__ ck_T,
                                         int nband, int band_rows, int M,
                                         int R, int l) {
    const int b = l / band_rows;
    const size_t MR = (size_t)M * R;
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      if (b < nband && live[j]) {
        T c0, c1;
        if (l == pf_l) {
          c0 = pf0[j];
          c1 = pf1[j];
        } else {
          const size_t off = (size_t)b * 2 * MR + (size_t)m[j] * R + r[j];
          c0 = ck_T[off];
          c1 = ck_T[off + MR];
        }
        if (fabs(c0) > Scan<T>::ck_use && fabs(c1) > Scan<T>::ck_use) {
          lpp[j] = c0;
          lp[j] = c1;
          k[j] = 0;
        }
      }
    }
    next_ck += band_rows;
  }

  // A step whose band starts fall on step boundaries: re-seed at its first
  // row lb when that is one.
  __device__ __forceinline__ void start(const T* __restrict__ ck_T, int nband,
                                        int band_rows, int M, int R, int lb) {
    if (lb == next_ck) reseed(ck_T, nband, band_rows, M, R, lb);
  }

  // Rows l (even) and l + 1 of every column: out0/out1 are the emitted
  // values (0 where k > 0); ra/rb point at the rows' a_lm/b_lm of the
  // block's m group (stride MT between the two rows' entries is `rs`).
  // kCheck: a band may start at l (a cadence that does not divide the
  // step); without it the step loop has no branch.
  template <bool kCheck>
  __device__ __forceinline__ void pair(const T* __restrict__ ck_T, int nband,
                                       int band_rows, int M, int R, int l,
                                       const T* ra, const T* rb, int rs,
                                       T (&out0)[CPT], T (&out1)[CPT]) {
    if (kCheck && l == next_ck) reseed(ck_T, nband, band_rows, M, R, l);
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      // even row ℓ = l
      T lam = ra[mm[j]] * (zr[j] * lp[j]) + rb[mm[j]] * lpp[j];
      if (m[j] == l) {
        lam = seed[j];
        k[j] = k0[j];
      }
      out0[j] = (k[j] == 0) ? lam : T(0);
      lpp[j] = lp[j];
      lp[j] = lam;
      // odd row ℓ = l + 1
      lam = ra[rs + mm[j]] * (zr[j] * lp[j]) + rb[rs + mm[j]] * lpp[j];
      if (m[j] == l + 1) {
        lam = seed[j];
        k[j] = k0[j];
      }
      out1[j] = (k[j] == 0) ? lam : T(0);
      lpp[j] = lp[j];
      lp[j] = lam;
      // rescale once per row pair
      if (fabs(lp[j]) > Scan<T>::thresh && k[j] > 0) {
        lp[j] *= Scan<T>::down;
        lpp[j] *= Scan<T>::down;
        k[j] -= 1;
      }
    }
  }
};

// Start the copies of the recurrence rows [lb, lb + LB) of the block's m
// group into a rec slot [2][LB][MT] (a_lm then b_lm; zero past L or M).
template <typename T, int MT, int LB>
__device__ __forceinline__ void load_rec(T* dst, const T* __restrict__ rec_a,
                                         const T* __restrict__ rec_b, int lb,
                                         int m0, int L, int M) {
  constexpr int N = 2 * LB * MT;
  for (int e = threadIdx.x; e < N; e += kThreads) {
    const int mm = e % MT, row = (e / MT) % LB, ab = e / (MT * LB);
    const int gm = m0 + mm, gl = lb + row;
    const bool ok = gm < M && gl < L;
    const T* src = ok ? (ab ? rec_b : rec_a) + (size_t)gl * M + gm : rec_a;
    cora::cp_async_el(dst + e, src, ok);
  }
}

}  // namespace cora
