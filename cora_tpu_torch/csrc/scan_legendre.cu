// Fused scaled-Legendre recurrence + contraction for the scan-mode SHT, K1.
//
// Replaces the TPU kernel cora_tpu/ops/pallas_scan_legendre.py
// `scan_contract_fused` (kernel body `_kernel`).  Same function, same
// layout at the wrapper (cora_tpu_torch/ops/scan_legendre.py), minus the
// checkpoint rows:
//
//   rec_a, rec_b [L, M]     recurrence rows a_lm, b_lm (double)
//   seed_T, k0_T [M, R]     pre-scaled λ_mm seeds and their 2^S scale counts
//                           (double)
//   z            [R]        cosθ of the northern rings (double)
//   alm0, alm1 [F2, L/2, M] even-ℓ / odd-ℓ a_lm planes
//   He, Ho     [F2, R, M]   He = Σ_{ℓ even} λ·alm0,  Ho = Σ_{ℓ odd} λ·alm1
//
// λ_ℓ = a_ℓm·(z·λ_{ℓ-1}) + b_ℓm·λ_{ℓ-2}; at ℓ = m the seed and its scale
// count k are injected; a row is emitted only where k == 0; once per row
// pair (after the odd row) a value with |λ| > 2^256 and k > 0 is scaled by
// 2^-512 and k drops by one.  The carry is double in both instantiations
// (scan_recurrence.cuh says why); float (planes, products and He/Ho in
// float, each emitted λ rounded once to float) and double.
//
// What bounds it on an H100: per (f, ℓ, ring, m ≤ ℓ) one multiply-add,
// plus about 4 operations of recurrence per (ℓ, ring, m), on the FP64
// units (34 TFLOP/s) in both instantiations; the a_lm planes
// are the only large input and He/Ho are written once, so device memory
// traffic is small next to the arithmetic.  At the flagship call (L=1536,
// R=1024, F2=32) 82 GFLOP: 1.23 ms at 67 TFLOP/s in f32; in f64 (L=1537,
// F2=64) the products on the tensor cores (DMMA, 67 TFLOP/s) take 2.31 ms
// beside the recurrence.
//
// What limited the first design (one warp per m, one lane per ring, 16
// planes a block in f32 and 8 in f64 as a grid axis, one LDS.128 of planes
// per 4 FMAs): 7.992 ms in f32 (15% of its bound) and 32.274 ms in f64 (7%;
// chip_smoke.py on an H100 80GB HBM3, 700 W).  The recurrence ran once per
// plane tile (2× at F2=32, 8× at F2=64 in f64), the planes were staged by
// plain loads between two barriers a step, and every row read two
// shared-memory coefficients.
//
// The second design (f64 and F2 ≤ 8 keep it): all planes in one
// block (32 in f32, 64 in f64), so the recurrence runs once per (ℓ, ring,
// m) in f32 and twice in f64, where a block covers one ℓ parity (grid z);
// λ through shared memory, each thread running the recurrence of its (m,
// ring) column and writing the rows of step j+1 from inside the loop that
// contracts step j; the planes of coming steps (and the recurrence rows
// a_lm, b_lm one step further on) by cp.async in a ring of 3 stages, one
// __syncthreads per 32-row step, as 16-byte copies from planes-minor
// storage ([L/2, M, fs], fs = F2 rounded up to a whole vector).  f32: 4 m ×
// 64 rings a block, a warp per (m, ℓ parity), a lane 8 planes × 8 rings (4
// LDS.128 per 64 IEEE FMAs; no TF32) with the two-level sums (a fresh
// partial per step, added to the total at its end); F2 ≤ 8 a 4 × 4 tile and
// two blocks an SM.  f64: 4 m (8 at F2 ≤ 32) × 64 rings × one parity a
// block, the products on the FP64 tensor cores (mma.sync m16n8k4), 32
// planes × 64 rings a warp, from stages padded so a half warp reads distinct
// banks, the recurrence on the FP64 units.  A block starts at the step
// holding its first m (rows ℓ < m are exactly zero and leave the carry at
// zero); He/Ho are staged in shared memory and written once, m-contiguous,
// no atomics.  Its f32 tile at 32 planes, with the float64 carry: 4.06–4.26
// ms at the flagship (29–30% of the bound) and 199.4–201.7 ms at nside 2048
// (R = 4096, F2 = 32; 39.0–39.4%), the cells' shape.  What held it back:
// every warp ran a column's dependent float64 chain, its conversion and
// store, and 8 × 8 products per row, interleaved by hand, with a block-wide
// barrier every step, at 2 warps per scheduler.
//
// This design, f32 at 32 planes (scan_contract_f32_ws): the recurrence and
// the contraction are warp roles that meet only through a ring of NS = 4
// stages, each holding one step's λ rows and plane rows, guarded by
// mbarrier full/empty pairs.
//  * 8 producer warps (a lane per (m, ring) column, 2 warps per m, 56
//    registers by setmaxnreg) run the float64 carry with the same
//    Recurrence::pair steps, so the λ rows keep their bits; a warp's a_lm,
//    b_lm come by one 16-byte load a row.  Once no column of a warp still
//    carries a scale count (k only falls after the seed rows; one vote a
//    step), the warp takes pair's branch-free path.  The producers also copy
//    the step's planes (cp.async, completing on the stage's full barrier)
//    and the recurrence rows two steps ahead, and are at most NS steps
//    ahead of the slowest consumer.
//  * 8 consumer warps (200 registers), one per (m, ℓ parity) as before,
//    only contract: wait on a stage's full barrier, stream λ and plane
//    fragments from it with the next row's loads in flight beside this
//    row's 64 FMAs, keep the same per-step partial and total, and release
//    the stage, one arrival a warp.  The sums run in the same order as in
//    the second design: the output is the same bits.
//  * Measured (CUDA-event medians on an NVIDIA H100 80GB HBM3, 700 W, SM
//    clock 1980 MHz throughout, beside the second design in the same
//    process): the flagship 3.92–4.03 ms
//    against 4.02–4.17 (31%), nside 2048 at F2 = 32 191.8 ms against
//    200.6–201.3 (40.9%).  Consumers alone, fed from a ring by producers
//    that only copy, 3.00–3.16 ms at the flagship (the second design's
//    contraction alone: 3.21 ms) and 135–146 ms at nside 2048; producers
//    alone 98 ms there.
//
// What holds it back: the shared-memory path.  A warp's LDS.128 costs 4 SM
// cycles when a quarter warp reads 4 distinct 16-byte words (the plane
// fragments) and 2.45 when it reads 1 or 2 (the λ fragments, the warp's
// coefficients); 4 of them per 64 FMAs keep that path about as busy as the
// FP32 units.  The consumer loop alone, with no barrier and no producer,
// runs at 59% of the FP32 rate (126 ms at nside 2048), at 76% without its
// loads; the producers' coefficient loads cost 11 ms, and their λ stores
// and conversions share the same path and issue slots.  A wider lane tile
// would load less per FMA but needs twice its width in registers for the
// two-level sums.

#include <cuda_runtime.h>
#include <cstddef>
#include <cstdint>
#include <type_traits>

#include "hopper_tiles.cuh"
#include "scan_recurrence.cuh"

namespace {

using cora::kThreads;
using cora::load_rec;
using cora::Recurrence;

// Block tile per (real type, planes a block FP): MT m values × RT rings, LB
// ℓ rows a step, NS plane stages (at 32 f32 planes, NS stages of λ rows and
// planes).  f32: a warp per (m, ℓ parity), PG × (32/PG) lanes of TP × TR
// register tiles; at 32 planes these are the consumers, beside PRODUCERS
// threads, a lane per (m, ring) column, with the register limits of the two
// roles (setmaxnreg) and 2·CU rows a consumer loop body.  f64: WPM warps per
// m, each 32 planes.
template <typename T, int FP> struct Tile;
template <> struct Tile<float, 32> {
  static constexpr int MT = 4, RT = 64, LB = 32, NS = 4;
  static constexpr int PG = 4, TP = 8, TR = 8;
  static constexpr int CONSUMERS = 2 * MT * 32, PRODUCERS = MT * RT;
  static constexpr int CREG = 200, PREG = 56, CU = 4;
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
  static constexpr int P_STAGE = 2 * NP * KS;          // [2][NP][KS] float
  static constexpr int REC = 2 * C::LB * C::MT;        // [2][LB][MT] double
  static constexpr int LAM = C::MT * C::LB * C::RT;    // [MT][LB][RT] float
  static constexpr size_t TOTAL =
      4 * (C::NS * P_STAGE + 2 * LAM) + 8 * (C::NS + 1) * REC;
  static constexpr size_t EPI = 4 * 2 * FP * C::RT * C::MT;  // [2][FP][RT][MT]
  static constexpr size_t BYTES = TOTAL > EPI ? TOTAL : EPI;
  static_assert((4 * C::NS * P_STAGE) % 16 == 0, "double slots aligned");
};

template <int FP>
__global__ void __launch_bounds__(kThreads, FP <= 8 ? 2 : 1)
scan_contract_f32(const double* __restrict__ rec_a,
                  const double* __restrict__ rec_b,
                  const double* __restrict__ seed_T,
                  const double* __restrict__ k0_T,
                  const double* __restrict__ z,
                  const float* __restrict__ alm0,
                  const float* __restrict__ alm1, float* __restrict__ he,
                  float* __restrict__ ho, int L, int M, int R, int F2,
                  int fs) {
  using C = Tile<float, FP>;
  using Y = F32Layout<FP>;
  constexpr int MT = C::MT, RT = C::RT, LB = C::LB, NP = Y::NP, NS = C::NS;
  constexpr int TP = C::TP, TR = C::TR, PG = C::PG, RG = 32 / PG;
  constexpr int VP = TP < 4 ? TP : 4, VR = TR < 4 ? TR : 4;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* const sP = reinterpret_cast<float*>(smem_raw);
  double* const sRec = reinterpret_cast<double*>(sP + NS * Y::P_STAGE);
  float* const sLam = reinterpret_cast<float*>(sRec + (NS + 1) * Y::REC);

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
  rc.init<RT>(seed_T, k0_T, z, m0, r0, M, R);

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
        load_rec<MT, LB>(sRec + st * Y::REC, rec_a, rec_b, lb + LB, m0, L,
                         M);
    }
    cora::cp_async_commit();
  };
  // λ rows of step j into buffer j & 1, the rec rows at `rec`
  // (step 0 holds the block's seed rows)
  auto gen_pair = [&](int j, int p, const double* rec, auto seed) {
    float o0[1], o1[1];
    const int l = lstart + j * LB + 2 * p;
    rc.template pair<decltype(seed)::value>(
        l, rec + 2 * p * MT, rec + LB * MT + 2 * p * MT, MT, o0, o1);
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
    load_rec<MT, LB>(sRec + NS * Y::REC, rec_a, rec_b, lstart, m0, L, M);
    cora::cp_async_commit();
#pragma unroll
    for (int j = 0; j < NS - 1; ++j) fill(j);
    cora::cp_async_wait<NS - 1>();
    __syncthreads();
    for (int p = 0; p < NP; ++p)
      gen_pair(0, p, sRec + NS * Y::REC, std::true_type{});
  }

  for (int s = 0; s < nsteps; ++s) {
    cora::cp_async_wait<NS - 2>();
    __syncthreads();  // planes of s, rec rows of s + 1, λ of s in place
    fill(s + NS - 1);
    const bool more = s + 1 < nsteps;
    const float* P = sP + (s % NS) * 2 * NP * Y::KS;
    const float* lam = sLam + ((s & 1) * MT) * LB * RT;
    const double* rec = sRec + (s % NS) * Y::REC;
    // this warp's parity rows into a fresh partial, a row pair of step
    // s + 1 generated beside each
    float part[TP][TR];
#pragma unroll
    for (int i = 0; i < TP; ++i)
#pragma unroll
      for (int t = 0; t < TR; ++t) part[i][t] = 0.f;
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      float a[TP], b[TR];
      cora::lds_vec<TP, VP>(a, P + p * Y::KS + a_off, VP * PG);
      cora::lds_vec<TR, VR>(b, lam + 2 * p * RT + l_off, VR * RG);
      cora::outer_fma(part, a, b);
      if (more) gen_pair(s + 1, p, rec, std::false_type{});
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

// ------------------------------------------- float, warp-specialised --

// Shared memory of scan_contract_f32_ws: NS stages, each the λ rows
// [MT][LB][RT] and the plane rows [2][NP][KS] of one step; RS slots of
// recurrence rows [LB][MT][2] (a_lm, b_lm side by side); the stages' full
// and empty barriers.  He/Ho [2][FP][RT][MT] are staged in the stages.
template <int FP>
struct WsLayout {
  using C = Tile<float, FP>;
  static constexpr int NP = C::LB / 2;
  static constexpr int FPP = FP + 4, KS = C::MT * FPP;
  static constexpr int P_STAGE = 2 * NP * KS;        // [2][NP][KS] float
  static constexpr int LAM = C::MT * C::LB * C::RT;  // [MT][LB][RT] float
  static constexpr int REC = 2 * C::LB * C::MT;      // [LB][MT][2] double
  static constexpr int RS = 3;  // recurrence rows are copied two steps ahead
  static constexpr size_t STAGES = 4 * (size_t)C::NS * (LAM + P_STAGE);
  static constexpr size_t BYTES = STAGES + 8 * (RS * REC + 2 * C::NS);
  static constexpr int THREADS = C::CONSUMERS + C::PRODUCERS;
  static_assert(4 * 2 * FP * C::RT * C::MT <= STAGES, "He/Ho fit the stages");
  static_assert(C::PRODUCERS == C::MT * C::RT && C::RT == 64,
                "a producer lane per column, two warps per m");
};

template <int FP>
__global__ void __launch_bounds__(WsLayout<FP>::THREADS, 1)
scan_contract_f32_ws(const double* __restrict__ rec_a,
                     const double* __restrict__ rec_b,
                     const double* __restrict__ seed_T,
                     const double* __restrict__ k0_T,
                     const double* __restrict__ z,
                     const float* __restrict__ alm0,
                     const float* __restrict__ alm1, float* __restrict__ he,
                     float* __restrict__ ho, int L, int M, int R, int F2,
                     int fs) {
  using C = Tile<float, FP>;
  using Y = WsLayout<FP>;
  constexpr int MT = C::MT, RT = C::RT, LB = C::LB, NP = Y::NP, NS = C::NS;
  constexpr int TP = C::TP, TR = C::TR, PG = C::PG, RG = 32 / PG;
  constexpr int VP = 4, VR = 4, NC = C::CONSUMERS, NPT = C::PRODUCERS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* const sLam = reinterpret_cast<float*>(smem_raw);  // [NS][LAM]
  float* const sP = sLam + NS * Y::LAM;                    // [NS][P_STAGE]
  double* const sRec = reinterpret_cast<double*>(sP + NS * Y::P_STAGE);
  unsigned long long* const full =
      reinterpret_cast<unsigned long long*>(sRec + Y::RS * Y::REC);
  unsigned long long* const empty = full + NS;

  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int r0 = blockIdx.x * RT, m0 = blockIdx.y * MT, f0 = blockIdx.z * FP;
  const int lstart = (m0 / LB) * LB;
  const int nsteps = lstart < L ? (L - lstart + LB - 1) / LB : 0;

  // stage s % NS holds step s: full once every producer warp has written
  // its λ rows and the producers' plane copies have landed, empty once
  // every consumer warp has read it
  if (threadIdx.x == 0) {
    for (int i = 0; i < NS; ++i) {
      cora::mbar_init(full + i, NPT / 32);
      cora::mbar_init(empty + i, NC / 32);
    }
    cora::mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < NC) {
    // consumer warp (wm, wp): the products of m index wm and ℓ parity wp,
    // lane tiles of 8 planes × 8 rings, each step's rows into a fresh
    // partial added to the total at the step's end
    cora::setmaxnreg_inc<C::CREG>();
    const int wm = w >> 1, wp = w & 1;
    const int fp0 = VP * (lane % PG), rr0 = VR * (lane / PG);
    const int a_off = wp * NP * Y::KS + wm * Y::FPP + fp0;
    const int l_off = wm * LB * RT + wp * RT + rr0;
    float acc[TP][TR];
#pragma unroll
    for (int i = 0; i < TP; ++i)
#pragma unroll
      for (int t = 0; t < TR; ++t) acc[i][t] = 0.f;

    for (int s = 0; s < nsteps; ++s) {
      const int st = s % NS;
      cora::mbar_wait(full + st, (s / NS) & 1);
      const float* P = sP + st * Y::P_STAGE + a_off;
      const float* lam = sLam + st * Y::LAM + l_off;
      float part[TP][TR];
#pragma unroll
      for (int i = 0; i < TP; ++i)
#pragma unroll
        for (int t = 0; t < TR; ++t) part[i][t] = 0.f;
      // fragments of row p + 1 load while row p's products run
      float a[2][TP], b[2][TR];
      cora::lds_vec<TP, VP>(a[0], P, VP * PG);
      cora::lds_vec<TR, VR>(b[0], lam, VR * RG);
#pragma unroll C::CU
      for (int p = 0; p < NP; p += 2) {
        cora::lds_vec<TP, VP>(a[1], P + (p + 1) * Y::KS, VP * PG);
        cora::lds_vec<TR, VR>(b[1], lam + 2 * (p + 1) * RT, VR * RG);
        cora::outer_fma(part, a[0], b[0]);
        if (p + 2 < NP) {
          cora::lds_vec<TP, VP>(a[0], P + (p + 2) * Y::KS, VP * PG);
          cora::lds_vec<TR, VR>(b[0], lam + 2 * (p + 2) * RT, VR * RG);
        }
        cora::outer_fma(part, a[1], b[1]);
      }
      __syncwarp();
      if (lane == 0) cora::mbar_arrive(empty + st);
#pragma unroll
      for (int i = 0; i < TP; ++i)
#pragma unroll
        for (int t = 0; t < TR; ++t) acc[i][t] += part[i][t];
    }

    // He/Ho through shared memory [2][FP][RT][MT], written m-contiguous,
    // once every consumer has read its last stage
    cora::bar_sync(1, NC);
    float* const E = sLam;
#pragma unroll
    for (int i = 0; i < TP; ++i)
#pragma unroll
      for (int t = 0; t < TR; ++t) {
        const int f = (i / VP) * VP * PG + fp0 + i % VP;
        const int r = (t / VR) * VR * RG + rr0 + t % VR;
        E[((wp * FP + f) * RT + r) * MT + wm] = acc[i][t];
      }
    cora::bar_sync(1, NC);
    const int nf = min(FP, F2 - f0);
    for (int e = threadIdx.x; e < 2 * nf * RT * MT; e += NC) {
      const int mm = e % MT, r = (e / MT) % RT, f = (e / (MT * RT)) % nf,
                q = e / (MT * RT * nf);
      const int m = m0 + mm, gr = r0 + r;
      if (m < M && gr < R)
        (q ? ho : he)[((size_t)(f0 + f) * R + gr) * M + m] =
            E[((q * FP + f) * RT + r) * MT + mm];
    }
  } else {
    // producer warp pw: the float64 carry of column (m index cm, ring cr)
    // in each lane, each step's λ rows into the step's stage; its threads
    // also copy the step's planes there and the recurrence rows two steps
    // ahead into a ring of RS slots
    cora::setmaxnreg_dec<C::PREG>();
    const int pt = threadIdx.x - NC, pw = pt >> 5;
    const int cm = pw / (RT / 32), cr = (pw % (RT / 32)) * 32 + lane;
    // the coefficients reach pair in registers: the column indexes them at 0
    Recurrence<float, 1> rc;
    rc.init_col(0, 0, cr, seed_T, k0_T, z, m0 + cm, r0, M, R);

    // this thread's plane copies: vector q of m index pm, rows pr + k·NPT/32
    constexpr int NQ = FP / 4, NV = 2 * NP * MT * NQ;
    static_assert(NPT % (MT * NQ) == 0 && NV % NPT == 0, "plane copies");
    const int q = pt % NQ, pm = (pt / NQ) % MT, pr = pt / (NQ * MT);
    const bool okv = m0 + pm < M && f0 + q * 4 < F2;
    const size_t voff = (size_t)(m0 + pm) * fs + f0 + q * 4;
    float* const vdst = sP + pm * Y::FPP + q * 4;
    auto load_planes = [&](int s, int st) {
      const int jp0 = (lstart + s * LB) / 2;
#pragma unroll
      for (int k = 0; k < NV / NPT; ++k) {
        const int row = pr + k * (NPT / (NQ * MT));  // [2][NP]
        const int par = row / NP, jr = row % NP;
        const bool ok = okv && jp0 + jr < L / 2;
        const float* src = par ? alm1 : alm0;
        cora::cp_async16(vdst + st * Y::P_STAGE + row * Y::KS,
                         ok ? src + (size_t)(jp0 + jr) * M * fs + voff : src,
                         ok);
      }
    };
    // the a_lm, b_lm rows of step s into slot s % RS, element e of
    // [LB][MT][2] by thread e % NPT
    static_assert(Y::REC % NPT == 0, "recurrence-row copies");
    auto load_rec = [&](int s) {
#pragma unroll
      for (int i = 0; i < Y::REC / NPT; ++i) {
        const int e = pt + i * NPT;
        const int ab = e & 1, mm = (e >> 1) % MT, row = e / (2 * MT);
        const int gl = lstart + s * LB + row;
        const bool ok = m0 + mm < M && gl < L;
        const double* src = ab ? rec_b : rec_a;
        cora::cp_async_el(sRec + (s % Y::RS) * Y::REC + e,
                          ok ? src + (size_t)gl * M + m0 + mm : src, ok);
      }
    };
    // λ rows of step s into stage st; a_lm, b_lm of rows 2p and 2p + 1 of
    // this warp's m by one 16-byte load each
    auto gen_step = [&](int s, int st, auto seed, auto scaled) {
      const double2* rec =
          reinterpret_cast<const double2*>(sRec + (s % Y::RS) * Y::REC) + cm;
      float* dst = sLam + st * Y::LAM + cm * LB * RT + cr;
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        const double2 ev = rec[2 * p * MT], od = rec[(2 * p + 1) * MT];
        const double ra[2] = {ev.x, od.x}, rb[2] = {ev.y, od.y};
        float o0[1], o1[1];
        rc.template pair<decltype(seed)::value, decltype(scaled)::value>(
            lstart + s * LB + 2 * p, ra, rb, 1, o0, o1);
        dst[2 * p * RT] = o0[0];
        dst[(2 * p + 1) * RT] = o1[0];
      }
    };
    // one group of copies a step: the rec rows of s + 2 and the planes of
    // s; waiting for all but the newest group leaves the planes of the
    // step before in flight (the stage's full barrier waits for them)
    auto step = [&](int s, auto seed, auto scaled) {
      const int st = s % NS;
      cora::cp_async_wait<1>();
      cora::bar_sync(2, NPT);  // rec rows of s in; every producer past s - 1
      if (s + 2 < nsteps) load_rec(s + 2);
      if (s >= NS) cora::mbar_wait(empty + st, (s / NS - 1) & 1);
      load_planes(s, st);
      cora::cp_async_mbar_arrive(full + st);
      cora::cp_async_commit();
      gen_step(s, st, seed, scaled);
      __syncwarp();
      if (lane == 0) cora::mbar_arrive(full + st);
    };

    if (nsteps > 0) {
      load_rec(0);
      cora::cp_async_commit();
      if (nsteps > 1) load_rec(1);
      cora::cp_async_commit();
      step(0, std::true_type{}, std::true_type{});  // the block's seed rows
    }
    for (int s = 1; s < nsteps; ++s) {
      // past the seed rows k only falls: a warp none of whose columns still
      // carries a scale count emits every row and rescales none
      if (__any_sync(0xffffffffu, rc.k[0] > 0))
        step(s, std::false_type{}, std::true_type{});
      else
        step(s, std::false_type{}, std::false_type{});
    }
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

template <int FP>
__global__ void __launch_bounds__(kThreads, 1)
scan_contract_f64(const double* __restrict__ rec_a,
                  const double* __restrict__ rec_b,
                  const double* __restrict__ seed_T,
                  const double* __restrict__ k0_T,
                  const double* __restrict__ z,
                  const double* __restrict__ alm0,
                  const double* __restrict__ alm1, double* __restrict__ he,
                  double* __restrict__ ho, int L, int M, int R, int F2,
                  int fs) {
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
  rc.template init<RT>(seed_T, k0_T, z, m0, r0, M, R);

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
        load_rec<MT, LB>(sRec + st * Y::REC, rec_a, rec_b, lb + LB, m0, L,
                         M);
    }
    cora::cp_async_commit();
  };
  // the block's parity row of pair p of step j into buffer j & 1
  // (step 0 holds the block's seed rows)
  auto gen_pair = [&](int j, int p, const double* rec, auto seed) {
    double o0[CPT], o1[CPT];
    const int l = lstart + j * LB + 2 * p;
    rc.template pair<decltype(seed)::value>(
        l, rec + 2 * p * MT, rec + LB * MT + 2 * p * MT, MT, o0, o1);
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
    load_rec<MT, LB>(sRec + NS * Y::REC, rec_a, rec_b, lstart, m0, L, M);
    cora::cp_async_commit();
#pragma unroll
    for (int j = 0; j < NS - 1; ++j) fill(j);
    cora::cp_async_wait<NS - 1>();
    __syncthreads();
    for (int p = 0; p < NP; ++p)
      gen_pair(0, p, sRec + NS * Y::REC, std::true_type{});
  }

  for (int s = 0; s < nsteps; ++s) {
    cora::cp_async_wait<NS - 2>();
    __syncthreads();
    fill(s + NS - 1);
    const bool more = s + 1 < nsteps;
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
        for (int p = 4 * kk; p < 4 * kk + 4; ++p)
          gen_pair(s + 1, p, rec, std::false_type{});
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
                        const void* alm0, const void* alm1, void* he,
                        void* ho, int L, int M, int R, int F2, int fs,
                        cudaStream_t stream) {
  using C = Tile<T, FP>;
  constexpr bool f64 = sizeof(T) == 8;
  size_t bytes;
  int threads = kThreads;
  void (*kern)(const double*, const double*, const double*, const double*,
               const double*, const T*, const T*, T*, T*, int, int, int, int,
               int);
  if constexpr (f64) {
    kern = scan_contract_f64<FP>;
    bytes = F64Layout<FP>::BYTES;
  } else if constexpr (FP == 32) {
    kern = scan_contract_f32_ws<FP>;
    bytes = WsLayout<FP>::BYTES;
    threads = WsLayout<FP>::THREADS;
  } else {
    kern = scan_contract_f32<FP>;
    bytes = F32Layout<FP>::BYTES;
  }
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((R + C::RT - 1) / C::RT, (M + C::MT - 1) / C::MT,
                  ((F2 + FP - 1) / FP) * (f64 ? 2 : 1));
  kern<<<grid, threads, bytes, stream>>>(
      (const double*)rec_a, (const double*)rec_b, (const double*)seed_T,
      (const double*)k0_T, (const double*)z, (const T*)alm0, (const T*)alm1,
      (T*)he, (T*)ho, L, M, R, F2, fs);
  return cudaGetLastError();
}

template <typename T>
int launch(const void* rec_a, const void* rec_b, const void* seed_T,
           const void* k0_T, const void* z, const void* alm0,
           const void* alm1, void* he, void* ho, int L, int M, int R, int F2,
           int fs, int device, void* stream) {
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
            ? launch_tile<T, small>(rec_a, rec_b, seed_T, k0_T, z, alm0, alm1,
                                    he, ho, L, M, R, F2, fs, st)
            : launch_tile<T, big>(rec_a, rec_b, seed_T, k0_T, z, alm0, alm1,
                                  he, ho, L, M, R, F2, fs, st);
  return (int)err;
}

}  // namespace

extern "C" {

// Launch on `stream` (a cudaStream_t) of device `device`; returns the
// cudaError_t of the launch (0 on success).  The caller owns all buffers;
// every element of he and ho is written.  The tables are double (S=512,
// β=256); alm0/alm1 are float, planes-minor [L/2, M, fs] (fs ≥ F2 a
// multiple of 16 bytes, 16-byte aligned).
int cora_scan_contract(const void* rec_a, const void* rec_b,
                       const void* seed_T, const void* k0_T, const void* z,
                       const void* alm0, const void* alm1, void* he, void* ho,
                       int L, int M, int R, int F2, int fs, int device,
                       void* stream) {
  return launch<float>(rec_a, rec_b, seed_T, k0_T, z, alm0, alm1, he, ho, L,
                       M, R, F2, fs, device, stream);
}

// The same on double planes.
int cora_scan_contract_f64(const void* rec_a, const void* rec_b,
                           const void* seed_T, const void* k0_T,
                           const void* z, const void* alm0, const void* alm1,
                           void* he, void* ho, int L, int M, int R, int F2,
                           int fs, int device, void* stream) {
  return launch<double>(rec_a, rec_b, seed_T, k0_T, z, alm0, alm1, he, ho, L,
                        M, R, F2, fs, device, stream);
}

}  // extern "C"
