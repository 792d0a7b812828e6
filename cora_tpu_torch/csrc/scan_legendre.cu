// Fused scaled-Legendre recurrence + contraction for the scan-mode SHT, K1.
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
// Two instantiations: float (S=60, β=30, the f32 tables' scaling) and
// double (S=512, β=256, the f64 tables', which carry no checkpoints).
//
// What bounds it on an H100: per (f, ℓ, ring, m ≤ ℓ) one multiply-add,
// plus about 4 operations of recurrence per (ℓ, ring, m); the a_lm planes
// are the only large input and He/Ho are written once, so device memory
// traffic is small next to the arithmetic.  At the flagship call (L=1536,
// R=1024, F2=32) 82 GFLOP: 1.23 ms at 67 TFLOP/s in f32; in f64 (L=1537,
// F2=64) the products on the tensor cores (DMMA, 67 TFLOP/s) take 2.31 ms
// beside the recurrence on the FP64 units (34 TFLOP/s).
//
// What limited the first design (one warp per m, one lane per ring, 16
// planes a block in f32 and 8 in f64 as a grid axis, one LDS.128 of planes
// per 4 FMAs): 7.992 ms in f32 (15% of its bound) and 32.274 ms in f64 (7%;
// chip_smoke.py on an H100 80GB HBM3, 700 W).  The recurrence ran once per
// plane tile (2× at F2=32, 8× at F2=64 in f64), the planes were staged by
// plain loads between two barriers a step, and every row read two
// shared-memory coefficients.  Its sibling K4, probed on the same card,
// spent as long on that loop of FMAs and shared loads as on all its memory
// traffic.
//
// This design (chip_smoke.py, same card, two runs: 4.289–4.341 ms f32,
// 8.892–9.140 ms f64, 28–29% and 25–26% of the bounds):
//  * All planes in one block (32 in f32, 64 in f64), so the recurrence runs
//    once per (ℓ, ring, m) in f32 and twice in f64, where a block covers
//    one ℓ parity (grid z) to keep its accumulators in registers.
//  * λ through shared memory: each thread runs the recurrence of its (m,
//    ring) columns and writes the emitted rows to a double buffer; the rows
//    of step j+1 are generated inside the loop that contracts step j, so
//    the recurrence's dependent chain hides behind independent FMAs.  When
//    the re-seed cadence divides the step (the operators' default), band
//    starts are handled at step boundaries and that loop has no branch.
//  * The planes of coming steps (and the recurrence rows a_lm, b_lm one
//    step further on) arrive by cp.async in a ring of 3 stages, one
//    __syncthreads per 32-row step; the planes as 16-byte copies from
//    planes-minor storage ([L/2, M, fs], fs = F2 rounded up to a whole
//    vector, built so by the transforms).
//  * f32: 4 m × 64 rings a block, a warp per (m, ℓ parity); a lane holds 8
//    planes × 8 rings (4 LDS.128, broadcast, per 64 IEEE FMAs; no TF32) and
//    keeps the two-level sums: a fresh partial per step, added to the
//    total at its end.  The two warps of an m read the λ rows that both
//    generated, after the step's barrier.  F2 ≤ 8 takes a 4 × 4 tile and
//    two blocks an SM.
//  * f64: 4 m (8 at F2 ≤ 32) × 64 rings × one parity a block; the products
//    run on the FP64 tensor cores (mma.sync m16n8k4), 32 planes × 64 rings
//    a warp, from stages padded so a half warp reads distinct banks; the
//    recurrence stays on the FP64 units.
//  * A block starts at the step holding its first m (rows ℓ < m are exactly
//    zero and leave the carry at zero); the checkpoint rows of a coming
//    band start are fetched a step ahead.  He/Ho are staged in shared
//    memory and written once, m-contiguous, no atomics.
//
// What holds it back (probed on the same card by cut-down variants of this
// source): in f32 the contraction with its loads alone takes 3.21 ms, the
// recurrence with the loads 2.92 ms, and at one block of 8 warps per SM
// the two overlap only in part; in f64 the DMMA loop, as in K4, runs at
// about a quarter of the tensor cores' rate.  A re-seed cadence that does
// not divide the 32-row step (none of the operators' defaults) takes a
// per-pair check and runs slower.

#include <cuda_runtime.h>
#include <climits>
#include <cstddef>
#include <cstdint>

#include "hopper_tiles.cuh"

namespace {

using cora::kThreads;

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

// Block tile per (real type, planes a block FP): MT m values × RT rings, LB
// ℓ rows a step, NS plane stages.  f32: a warp per (m, ℓ parity), PG ×
// (32/PG) lanes of TP × TR register tiles.  f64: WPM warps per m, each 32
// planes.
template <typename T, int FP> struct Tile;
template <> struct Tile<float, 32> {
  static constexpr int MT = 4, RT = 64, LB = 32, NS = 3;
  static constexpr int PG = 4, TP = 8, TR = 8;
};
template <> struct Tile<float, 8> {
  static constexpr int MT = 4, RT = 64, LB = 32, NS = 3;
  static constexpr int PG = 2, TP = 4, TR = 4;
};
template <> struct Tile<double, 64> {
  static constexpr int MT = 4, RT = 64, LB = 32, NS = 3, WPM = 2;
};
template <> struct Tile<double, 32> {
  static constexpr int MT = 8, RT = 64, LB = 16, NS = 3, WPM = 1;
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

// Start the copies of the plane rows of pairs [jp0, jp0 + NP) of one
// parity into [NP][KS] (pair row: the m group of FPP planes; zero past the
// planes) from planes-minor alm [Lh, M, fs], as 16-byte vectors.
template <typename T, int MT, int NP, int FP, int FPP, int KS>
__device__ __forceinline__ void load_planes(T* dst, const T* __restrict__ alm,
                                            int jp0, int m0, int f0, int Lh,
                                            int M, int F2, int fs) {
  constexpr int V = 16 / sizeof(T);
  constexpr int NQ = FP / V;
  constexpr int N = NP * MT * NQ;
#pragma unroll
  for (int j = 0; j < (N + kThreads - 1) / kThreads; ++j) {
    const int e = threadIdx.x + j * kThreads;
    if (N % kThreads != 0 && e >= N) break;
    const int q = e % NQ, mm = (e / NQ) % MT, pp = e / (NQ * MT);
    const int gm = m0 + mm, gj = jp0 + pp, gf = f0 + q * V;
    const bool ok = gm < M && gj < Lh && gf < F2;
    const T* src = ok ? alm + ((size_t)gj * M + gm) * fs + gf : alm;
    cora::cp_async16(dst + pp * KS + mm * FPP + q * V, src, ok);
  }
}

// ---------------------------------------------------------------- float --

template <int FP>
struct F32Layout {
  using C = Tile<float, FP>;
  static constexpr int NP = C::LB / 2;
  static constexpr int FPP = FP + 4, KS = C::MT * FPP;
  static constexpr int P_STAGE = 2 * NP * KS;          // [2][NP][KS]
  static constexpr int REC = 2 * C::LB * C::MT;        // [2][LB][MT]
  static constexpr int LAM = C::MT * C::LB * C::RT;    // [MT][LB][RT]
  static constexpr int TOTAL = C::NS * P_STAGE + (C::NS + 1) * REC + 2 * LAM;
  static constexpr int EPI = 2 * FP * C::RT * C::MT;   // [2][FP][RT][MT]
  static constexpr size_t BYTES = 4 * (TOTAL > EPI ? TOTAL : EPI);
};

template <int FP, bool kMid>
__global__ void __launch_bounds__(kThreads, FP <= 8 ? 2 : 1)
scan_contract_f32(const float* __restrict__ rec_a,
                  const float* __restrict__ rec_b,
                  const float* __restrict__ seed_T,
                  const float* __restrict__ k0_T, const float* __restrict__ z,
                  const float* __restrict__ ck_T, int nband,
                  const float* __restrict__ alm0,
                  const float* __restrict__ alm1, float* __restrict__ he,
                  float* __restrict__ ho, int L, int M, int R, int F2,
                  int band_rows, int fs) {
  using C = Tile<float, FP>;
  using Y = F32Layout<FP>;
  constexpr int MT = C::MT, RT = C::RT, LB = C::LB, NP = Y::NP, NS = C::NS;
  constexpr int TP = C::TP, TR = C::TR, PG = C::PG, RG = 32 / PG;
  constexpr int VP = TP < 4 ? TP : 4, VR = TR < 4 ? TR : 4;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* const sP = reinterpret_cast<float*>(smem_raw);
  float* const sRec = sP + NS * Y::P_STAGE;
  float* const sLam = sRec + (NS + 1) * Y::REC;

  static_assert(MT * 2 * 32 == kThreads, "a warp per (m, parity)");
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int wm = w >> 1, wp = w & 1;  // this warp's m and ℓ parity
  const int r0 = blockIdx.x * RT, m0 = blockIdx.y * MT, f0 = blockIdx.z * FP;
  const int Lh = L / 2;
  const int lstart = (m0 / LB) * LB;
  const int nsteps = lstart < L ? (L - lstart + LB - 1) / LB : 0;

  // the recurrence of column (cm, cr): both parities' rows, read by the two
  // warps of that m after the next barrier
  const int cm = threadIdx.x / RT, cr = threadIdx.x % RT;
  Recurrence<float, 1> rc;
  rc.init<RT>(seed_T, k0_T, z, m0, r0, M, R, nband, band_rows, lstart);

  // fragment offsets: planes of lane p, rings of lane q; this warp's m and
  // parity
  const int fp0 = VP * (lane % PG), rr0 = VR * (lane / PG);
  const int a_off = wp * NP * Y::KS + wm * Y::FPP + fp0;
  const int l_off = wm * LB * RT + wp * RT + rr0;

  auto fill = [&](int j) {  // group j: planes of step j, rec rows of j + 1
    if (j < nsteps) {
      const int st = j % NS;
      const int lb = lstart + j * LB;
      load_planes<float, MT, NP, FP, Y::FPP, Y::KS>(
          sP + (st * 2) * NP * Y::KS, alm0, lb / 2, m0, f0, Lh, M, F2, fs);
      load_planes<float, MT, NP, FP, Y::FPP, Y::KS>(
          sP + (st * 2 + 1) * NP * Y::KS, alm1, lb / 2, m0, f0, Lh, M, F2, fs);
      if (j + 1 < nsteps)
        load_rec<float, MT, LB>(sRec + st * Y::REC, rec_a, rec_b, lb + LB,
                                m0, L, M);
    }
    cora::cp_async_commit();
  };
  // λ rows of step j into buffer j & 1, the rec rows at `rec`
  auto gen_pair = [&](int j, int p, const float* rec) {
    float o0[1], o1[1];
    const int l = lstart + j * LB + 2 * p;
    rc.pair<kMid>(ck_T, nband, band_rows, M, R, l, rec + 2 * p * MT,
                  rec + LB * MT + 2 * p * MT, MT, o0, o1);
    float* dst = sLam + ((j & 1) * MT + cm) * LB * RT + 2 * p * RT + cr;
    dst[0] = o0[0];
    dst[RT] = o1[0];
  };

  float acc[TP][TR];
#pragma unroll
  for (int i = 0; i < TP; ++i)
#pragma unroll
    for (int t = 0; t < TR; ++t) acc[i][t] = 0.f;

  if (nsteps > 0) {
    load_rec<float, MT, LB>(sRec + NS * Y::REC, rec_a, rec_b, lstart, m0, L,
                            M);
    cora::cp_async_commit();
#pragma unroll
    for (int j = 0; j < NS - 1; ++j) fill(j);
    cora::cp_async_wait<NS - 1>();
    __syncthreads();
    rc.prefetch(ck_T, nband, band_rows, lstart, LB, M, R);
    if (!kMid) rc.start(ck_T, nband, band_rows, M, R, lstart);
    for (int p = 0; p < NP; ++p) gen_pair(0, p, sRec + NS * Y::REC);
    if (!kMid) rc.prefetch(ck_T, nband, band_rows, lstart + LB, LB, M, R);
  }

  for (int s = 0; s < nsteps; ++s) {
    cora::cp_async_wait<NS - 2>();
    __syncthreads();  // planes of s, rec rows of s + 1, λ of s in place
    fill(s + NS - 1);
    const bool more = s + 1 < nsteps;
    if (more) {  // the checkpoint rows: one step ahead, two when aligned
      const int lb1 = lstart + (s + 1) * LB;
      if (kMid) {
        rc.prefetch(ck_T, nband, band_rows, lb1, LB, M, R);
      } else {
        rc.start(ck_T, nband, band_rows, M, R, lb1);
        rc.prefetch(ck_T, nband, band_rows, lb1 + LB, LB, M, R);
      }
    }
    const float* P = sP + (s % NS) * 2 * NP * Y::KS;
    const float* lam = sLam + ((s & 1) * MT) * LB * RT;
    const float* rec = sRec + (s % NS) * Y::REC;
    // this warp's parity rows into a fresh partial, a row pair of step
    // s + 1 generated beside each (the per-pair band check of kMid unrolled
    // less, to stay within the registers)
    float part[TP][TR];
#pragma unroll
    for (int i = 0; i < TP; ++i)
#pragma unroll
      for (int t = 0; t < TR; ++t) part[i][t] = 0.f;
    constexpr int kUnroll = kMid ? 2 : NP;
#pragma unroll kUnroll
    for (int p = 0; p < NP; ++p) {
      float a[TP], b[TR];
      cora::lds_vec<TP, VP>(a, P + p * Y::KS + a_off, VP * PG);
      cora::lds_vec<TR, VR>(b, lam + 2 * p * RT + l_off, VR * RG);
      cora::outer_fma(part, a, b);
      if (more) gen_pair(s + 1, p, rec);
    }
#pragma unroll
    for (int i = 0; i < TP; ++i)
#pragma unroll
      for (int t = 0; t < TR; ++t) acc[i][t] += part[i][t];
  }

  // He/Ho through shared memory [2][FP][RT][MT], written m-contiguous
  cora::cp_async_wait<0>();
  __syncthreads();
  float* const E = sP;
#pragma unroll
  for (int i = 0; i < TP; ++i)
#pragma unroll
    for (int t = 0; t < TR; ++t) {
      const int f = (i / VP) * VP * PG + fp0 + i % VP;
      const int r = (t / VR) * VR * RG + rr0 + t % VR;
      E[((wp * FP + f) * RT + r) * MT + wm] = acc[i][t];
    }
  __syncthreads();
  const int nf = min(FP, F2 - f0);
  for (int e = threadIdx.x; e < 2 * nf * RT * MT; e += kThreads) {
    const int mm = e % MT, r = (e / MT) % RT, f = (e / (MT * RT)) % nf,
              q = e / (MT * RT * nf);
    const int m = m0 + mm, gr = r0 + r;
    if (m < M && gr < R)
      (q ? ho : he)[((size_t)(f0 + f) * R + gr) * M + m] =
          E[((q * FP + f) * RT + r) * MT + mm];
  }
}

// --------------------------------------------------------------- double --

template <int FP>
struct F64Layout {
  using C = Tile<double, FP>;
  static constexpr int NP = C::LB / 2;  // rows of the block's parity a step
  static constexpr int FPP = FP, KS = cora::dmma_pitch(C::MT * FPP);
  static constexpr int RTP = cora::dmma_pitch(C::RT);
  static constexpr int P_STAGE = NP * KS;              // [NP][KS]
  static constexpr int REC = 2 * C::LB * C::MT;        // [2][LB][MT]
  static constexpr int LAM = C::MT * NP * RTP;         // [MT][NP][RTP]
  static constexpr int TOTAL = C::NS * P_STAGE + (C::NS + 1) * REC + 2 * LAM;
  static constexpr int EPI = FP * C::RT * C::MT;       // [FP][RT][MT]
  static constexpr size_t BYTES = 8 * (TOTAL > EPI ? TOTAL : EPI);
};

template <int FP, bool kMid>
__global__ void __launch_bounds__(kThreads, 1)
scan_contract_f64(const double* __restrict__ rec_a,
                  const double* __restrict__ rec_b,
                  const double* __restrict__ seed_T,
                  const double* __restrict__ k0_T,
                  const double* __restrict__ z,
                  const double* __restrict__ ck_T, int nband,
                  const double* __restrict__ alm0,
                  const double* __restrict__ alm1, double* __restrict__ he,
                  double* __restrict__ ho, int L, int M, int R, int F2,
                  int band_rows, int fs) {
  using C = Tile<double, FP>;
  using Y = F64Layout<FP>;
  constexpr int MT = C::MT, RT = C::RT, LB = C::LB, NP = Y::NP, NS = C::NS;
  constexpr int CPT = MT * RT / kThreads, PT = 4, RTT = RT / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  double* const sP = reinterpret_cast<double*>(smem_raw);
  double* const sRec = sP + NS * Y::P_STAGE;
  double* const sLam = sRec + (NS + 1) * Y::REC;

  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int par = blockIdx.z & 1;
  const int r0 = blockIdx.x * RT, m0 = blockIdx.y * MT,
            f0 = (blockIdx.z >> 1) * FP;
  const double* __restrict__ alm = par ? alm1 : alm0;
  const int Lh = L / 2;
  const int lstart = (m0 / LB) * LB;
  const int nsteps = lstart < L ? (L - lstart + LB - 1) / LB : 0;

  Recurrence<double, CPT> rc;
  rc.template init<RT>(seed_T, k0_T, z, m0, r0, M, R, nband, band_rows, lstart);

  const int g = lane >> 2, t = lane & 3;
  const int wm = w / C::WPM, fw = (w % C::WPM) * 32;
  const int a_off = t * Y::KS + wm * Y::FPP + fw + g;
  const int l_off = (wm * NP + t) * Y::RTP + g;

  auto fill = [&](int j) {
    if (j < nsteps) {
      const int st = j % NS;
      const int lb = lstart + j * LB;
      load_planes<double, MT, NP, FP, Y::FPP, Y::KS>(
          sP + st * Y::P_STAGE, alm, lb / 2, m0, f0, Lh, M, F2, fs);
      if (j + 1 < nsteps)
        load_rec<double, MT, LB>(sRec + st * Y::REC, rec_a, rec_b, lb + LB,
                                 m0, L, M);
    }
    cora::cp_async_commit();
  };
  // the block's parity row of pair p of step j into buffer j & 1
  auto gen_pair = [&](int j, int p, const double* rec) {
    double o0[CPT], o1[CPT];
    const int l = lstart + j * LB + 2 * p;
    rc.template pair<kMid>(ck_T, nband, band_rows, M, R, l, rec + 2 * p * MT,
                           rec + LB * MT + 2 * p * MT, MT, o0, o1);
#pragma unroll
    for (int c = 0; c < CPT; ++c)
      sLam[(((j & 1) * MT + rc.mm[c]) * NP + p) * Y::RTP + rc.rl[c]] =
          par ? o1[c] : o0[c];
  };

  double acc[PT][RTT][2];
#pragma unroll
  for (int i = 0; i < PT; ++i)
#pragma unroll
    for (int j = 0; j < RTT; ++j) acc[i][j][0] = acc[i][j][1] = 0.0;

  if (nsteps > 0) {
    load_rec<double, MT, LB>(sRec + NS * Y::REC, rec_a, rec_b, lstart, m0, L,
                             M);
    cora::cp_async_commit();
#pragma unroll
    for (int j = 0; j < NS - 1; ++j) fill(j);
    cora::cp_async_wait<NS - 1>();
    __syncthreads();
    rc.prefetch(ck_T, nband, band_rows, lstart, LB, M, R);
    if (!kMid) rc.start(ck_T, nband, band_rows, M, R, lstart);
    for (int p = 0; p < NP; ++p) gen_pair(0, p, sRec + NS * Y::REC);
    if (!kMid) rc.prefetch(ck_T, nband, band_rows, lstart + LB, LB, M, R);
  }

  for (int s = 0; s < nsteps; ++s) {
    cora::cp_async_wait<NS - 2>();
    __syncthreads();
    fill(s + NS - 1);
    const bool more = s + 1 < nsteps;
    if (more) {
      const int lb1 = lstart + (s + 1) * LB;
      if (kMid) {
        rc.prefetch(ck_T, nband, band_rows, lb1, LB, M, R);
      } else {
        rc.start(ck_T, nband, band_rows, M, R, lb1);
        rc.prefetch(ck_T, nband, band_rows, lb1 + LB, LB, M, R);
      }
    }
    const double* P = sP + (s % NS) * Y::P_STAGE;
    const double* lam = sLam + (s & 1) * MT * NP * Y::RTP;
    const double* rec = sRec + (s % NS) * Y::REC;
#pragma unroll
    for (int kk = 0; kk < NP / 4; ++kk) {
      double a[PT], b[RTT];
#pragma unroll
      for (int i = 0; i < PT; ++i) a[i] = P[a_off + 4 * kk * Y::KS + 8 * i];
#pragma unroll
      for (int j = 0; j < RTT; ++j)
        b[j] = lam[l_off + 4 * kk * Y::RTP + 8 * j];
#pragma unroll
      for (int i = 0; i < PT; i += 2)
#pragma unroll
        for (int j = 0; j < RTT; ++j)
          cora::dmma16(acc[i][j], acc[i + 1][j], a[i], a[i + 1], b[j]);
      if (more) {
#pragma unroll
        for (int p = 4 * kk; p < 4 * kk + 4; ++p) gen_pair(s + 1, p, rec);
      }
    }
  }

  cora::cp_async_wait<0>();
  __syncthreads();
  double* const E = sP;
#pragma unroll
  for (int i = 0; i < PT; ++i)
#pragma unroll
    for (int j = 0; j < RTT; ++j)
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int f = fw + 8 * i + g, r = 8 * j + 2 * t + u;
        E[(f * RT + r) * MT + wm] = acc[i][j][u];
      }
  __syncthreads();
  double* const out = par ? ho : he;
  const int nf = min(FP, F2 - f0);
  for (int e = threadIdx.x; e < nf * RT * MT; e += kThreads) {
    const int mm = e % MT, r = (e / MT) % RT, f = e / (MT * RT);
    const int m = m0 + mm, gr = r0 + r;
    if (m < M && gr < R) out[((size_t)(f0 + f) * R + gr) * M + m] = E[e];
  }
}

template <typename T, int FP>
cudaError_t launch_tile(const void* rec_a, const void* rec_b,
                        const void* seed_T, const void* k0_T, const void* z,
                        const void* ck_T, int nband, const void* alm0,
                        const void* alm1, void* he, void* ho, int L, int M,
                        int R, int F2, int band_rows, int fs,
                        cudaStream_t stream) {
  using C = Tile<T, FP>;
  constexpr bool f64 = sizeof(T) == 8;
  size_t bytes;
  void (*kern)(const T*, const T*, const T*, const T*, const T*, const T*,
               int, const T*, const T*, T*, T*, int, int, int, int, int, int);
  // band starts inside a step need the per-pair check
  const bool mid = nband > 1 && band_rows % C::LB != 0;
  if constexpr (f64) {
    kern = mid ? scan_contract_f64<FP, true> : scan_contract_f64<FP, false>;
    bytes = F64Layout<FP>::BYTES;
  } else {
    kern = mid ? scan_contract_f32<FP, true> : scan_contract_f32<FP, false>;
    bytes = F32Layout<FP>::BYTES;
  }
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((R + C::RT - 1) / C::RT, (M + C::MT - 1) / C::MT,
                  ((F2 + FP - 1) / FP) * (f64 ? 2 : 1));
  kern<<<grid, kThreads, bytes, stream>>>(
      (const T*)rec_a, (const T*)rec_b, (const T*)seed_T, (const T*)k0_T,
      (const T*)z, (const T*)ck_T, nband, (const T*)alm0, (const T*)alm1,
      (T*)he, (T*)ho, L, M, R, F2, band_rows, fs);
  return cudaGetLastError();
}

template <typename T>
int launch(const void* rec_a, const void* rec_b, const void* seed_T,
           const void* k0_T, const void* z, const void* ck_T, int nband,
           const void* alm0, const void* alm1, void* he, void* ho, int L,
           int M, int R, int F2, int band_rows, int fs, int device,
           void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (L <= 0 || M <= 0 || R <= 0 || F2 <= 0) return 0;
  if (fs < F2 || fs % (16 / (int)sizeof(T)) != 0 ||
      reinterpret_cast<uintptr_t>(alm0) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(alm1) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  constexpr int small = sizeof(T) == 4 ? 8 : 32, big = sizeof(T) == 4 ? 32 : 64;
  err = F2 <= small
            ? launch_tile<T, small>(rec_a, rec_b, seed_T, k0_T, z, ck_T, nband,
                                    alm0, alm1, he, ho, L, M, R, F2, band_rows,
                                    fs, st)
            : launch_tile<T, big>(rec_a, rec_b, seed_T, k0_T, z, ck_T, nband,
                                  alm0, alm1, he, ho, L, M, R, F2, band_rows,
                                  fs, st);
  return (int)err;
}

}  // namespace

extern "C" {

// Launch on `stream` (a cudaStream_t) of device `device`; returns the
// cudaError_t of the launch (0 on success).  The caller owns all buffers;
// every element of he and ho is written.  alm0/alm1 are planes-minor [L/2,
// M, fs] (fs ≥ F2 a multiple of 16 bytes, 16-byte aligned).
int cora_scan_contract(const void* rec_a, const void* rec_b,
                       const void* seed_T, const void* k0_T, const void* z,
                       const void* ck_T, int nband, const void* alm0,
                       const void* alm1, void* he, void* ho, int L, int M,
                       int R, int F2, int band_rows, int fs, int device,
                       void* stream) {
  return launch<float>(rec_a, rec_b, seed_T, k0_T, z, ck_T, nband, alm0,
                       alm1, he, ho, L, M, R, F2, band_rows, fs, device,
                       stream);
}

// The same on double tables (S=512, β=256) and planes.
int cora_scan_contract_f64(const void* rec_a, const void* rec_b,
                           const void* seed_T, const void* k0_T,
                           const void* z, const void* ck_T, int nband,
                           const void* alm0, const void* alm1, void* he,
                           void* ho, int L, int M, int R, int F2,
                           int band_rows, int fs, int device, void* stream) {
  return launch<double>(rec_a, rec_b, seed_T, k0_T, z, ck_T, nband, alm0,
                        alm1, he, ho, L, M, R, F2, band_rows, fs, device,
                        stream);
}

}  // extern "C"
