// The scaled associated-Legendre recurrence shared by the scan-mode kernels
// (K1 scan_legendre.cu, the synthesis, and K2 scan_project.cu, its adjoint):
//
//   λ_ℓ = a_ℓm·(z·λ_{ℓ-1}) + b_ℓm·λ_{ℓ-2}
//
// At ℓ = m the pre-scaled seed and its scale count k are injected; a row is
// emitted only where k == 0; once per row pair (after the odd row) a value
// with |λ| > 2^256 and k > 0 is scaled by 2^-512 and k drops by one.
//
// The carry is double in every instantiation: the tables (a_ℓm, b_ℓm, z,
// the seeds scaled with S=512, β=256, their scale counts) are double, and
// the float kernels round each emitted λ once to float for their products.
// A float carry is not enough at large nside: near the poles 1 − z is a few
// float ulps (7.9e-8 on the first ring at nside 2048), and there the step
// is λ_ℓ ≈ 2λ_{ℓ-1} − λ_{ℓ-2} plus a term of size (1 − z)·λ below float's
// resolution of λ, so the rounding errors grow like ε·L^1.5: on the 8
// northernmost rings at nside 2048, ℓ ≤ 6143, a float carry ends 17.9% of
// the rows' largest value off, and 4.1% even when re-seeded from exact rows
// every 1024 ℓ.  No rows are read: the double carry runs from the seeds.
//
// Each thread of a block carries CPT (m, ring) columns in registers; the
// recurrence rows a_ℓm, b_ℓm of the block's m group arrive in shared memory
// by cp.async (load_rec).

#pragma once

#include <cstddef>

#include "hopper_tiles.cuh"

namespace cora {

// The scaling of the double carry: rescale above 2^256, by 2^-512.
constexpr double kScanThresh = 0x1p256;
constexpr double kScanDown = 0x1p-512;

// The recurrence of CPT (m, ring) columns per thread, emitting rows of T:
// column j is c = tid + j·256 of the block's MT × RT, m-major (init), or
// where init_col puts it.
template <typename T, int CPT> struct Recurrence {
  double zr[CPT], seed[CPT], lp[CPT], lpp[CPT];
  int k0[CPT], k[CPT], m[CPT], mm[CPT], rl[CPT];

  template <int RT>
  __device__ __forceinline__ void init(const double* __restrict__ seed_T,
                                       const double* __restrict__ k0_T,
                                       const double* __restrict__ z, int m0,
                                       int r0, int M, int R) {
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int c = threadIdx.x + j * kThreads;
      init_col(j, c / RT, c % RT, seed_T, k0_T, z, m0, r0, M, R);
    }
  }

  // Column j at m index mj and ring index rj of the block's tile; mj
  // indexes the rows' a_lm, b_lm in pair.
  __device__ __forceinline__ void init_col(int j, int mj, int rj,
                                           const double* __restrict__ seed_T,
                                           const double* __restrict__ k0_T,
                                           const double* __restrict__ z,
                                           int m0, int r0, int M, int R) {
    mm[j] = mj;
    rl[j] = rj;
    m[j] = m0 + mj;
    const int r = r0 + rj;
    zr[j] = 0;
    seed[j] = 0;
    k0[j] = 1;  // a column past R or M never emits
    if (r < R && m[j] < M) {
      zr[j] = z[r];
      seed[j] = seed_T[(size_t)m[j] * R + r];
      k0[j] = (int)k0_T[(size_t)m[j] * R + r];
    }
    lp[j] = lpp[j] = 0;
    k[j] = 0;
  }

  // Rows l (even) and l + 1 of every column: out0/out1 are the emitted
  // values (0 where k > 0); ra/rb point at the rows' a_lm/b_lm of the
  // block's m group (stride MT between the two rows' entries is `rs`).
  // kSeed: a column's seed row ℓ = m may lie in this pair.  A block's m
  // values all lie in its first step, so only that step's pairs need the
  // check; the others skip its compare and selects (the loop is bound by
  // its instruction issue).  kScaled = false: the caller knows that no
  // column has k > 0 (k only falls after the seed rows), so every row is
  // emitted and none is rescaled; the compare, selects and rescale go, and
  // the bits stay the same.
  template <bool kSeed, bool kScaled = true>
  __device__ __forceinline__ void pair(int l, const double* ra,
                                       const double* rb, int rs,
                                       T (&out0)[CPT], T (&out1)[CPT]) {
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      // even row ℓ = l
      double lam = ra[mm[j]] * (zr[j] * lp[j]) + rb[mm[j]] * lpp[j];
      if (kSeed && m[j] == l) {
        lam = seed[j];
        k[j] = k0[j];
      }
      out0[j] = (!kScaled || k[j] == 0) ? T(lam) : T(0);
      lpp[j] = lp[j];
      lp[j] = lam;
      // odd row ℓ = l + 1
      lam = ra[rs + mm[j]] * (zr[j] * lp[j]) + rb[rs + mm[j]] * lpp[j];
      if (kSeed && m[j] == l + 1) {
        lam = seed[j];
        k[j] = k0[j];
      }
      out1[j] = (!kScaled || k[j] == 0) ? T(lam) : T(0);
      lpp[j] = lp[j];
      lp[j] = lam;
      // rescale once per row pair
      if (kScaled && fabs(lp[j]) > kScanThresh && k[j] > 0) {
        lp[j] *= kScanDown;
        lpp[j] *= kScanDown;
        k[j] -= 1;
      }
    }
  }
};

// Start the copies of the recurrence rows [lb, lb + LB) of the block's m
// group into a rec slot [2][LB][MT] (a_lm then b_lm; zero past L or M).
template <int MT, int LB>
__device__ __forceinline__ void load_rec(double* dst,
                                         const double* __restrict__ rec_a,
                                         const double* __restrict__ rec_b,
                                         int lb, int m0, int L, int M) {
  constexpr int N = 2 * LB * MT;
  for (int e = threadIdx.x; e < N; e += kThreads) {
    const int mm = e % MT, row = (e / MT) % LB, ab = e / (MT * LB);
    const int gm = m0 + mm, gl = lb + row;
    const bool ok = gm < M && gl < L;
    const double* src = ok ? (ab ? rec_b : rec_a) + (size_t)gl * M + gm : rec_a;
    cora::cp_async_el(dst + e, src, ok);
  }
}

}  // namespace cora
