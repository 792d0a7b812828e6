// Fused Wigner-d recurrence + contraction (synthesis) and projection
// (adjoint) for the spin-weighted SHT, K3.
//
// Replaces the TPU kernel cora_tpu/ops/pallas_scan_legendre.py
// `wigner_apply_fused` (kernel body `_wig_kernel`, both directions).  Same
// function at the wrapper (cora_tpu_torch/ops/wigner.py):
//
//   coefs [3, L, M]   A, B, C recurrence rows (zero where ℓ <= l0)
//   seed_T [M, R]     d^{l0}_{-m,s}(θ_r), the seed row per (m, ring)
//   l0 [M] (int32)    seed row max(m, |s|) per m
//   z [R]             cosθ of the northern rings
//   synthesis: x [F2, L, M] a_lm planes   → G [F2, R, M] = Σ_ℓ λ_ℓ·x
//   adjoint:   x [F2, R, M] ring planes   → alm [F2, L, M] = Σ_r λ_ℓ·x
//   The input planes and the adjoint's output are planes-minor storage
//   ([L, M, fs] / [R, M, fs], fs = F2 rounded up to a whole 16-byte vector);
//   G is m-minor.  Every output element is written.
//
// d_ℓ = A_ℓ(z − B_ℓ)·d_{ℓ−1} + C_ℓ·d_{ℓ−2}, seeded at ℓ = l0 with no
// power-of-two rescaling (a seed below the type's range stays what the
// cast made it, as in the reference), and the emitted row is
// λ_ℓ = d_ℓ·(√((2ℓ+1)·(1/4π))·(−1)^m), the norm computed in the kernel's
// type as the Pallas kernel does.  Rows ℓ < l0 are exactly zero (their
// coefficients are zero and the carry starts at zero), so a block starts at
// the step that holds its first m.  Every ℓ is contracted on the northern
// rings (no ℓ-parity split).  Instantiated for float and double.
//
// What bounds it on an H100: per (f, ℓ, ring, m ≤ ℓ) one multiply-add plus
// about 6 operations of recurrence per (ℓ, ring, m); planes are read once
// and written once, so it is bound by its arithmetic: at L=1536, R=1024,
// F2=32 1.26 ms at 67 TFLOP/s in f32; in f64 (L=1537, F2=64) 2.31 ms of
// tensor-core products.
//
// What limited the first design (synthesis: a warp per m, a lane per ring,
// 16 planes a block in f32 and 8 in f64, x staged by plain loads between
// two barriers a step; adjoint: K2's first design, a block per m and 8
// planes with a transpose-reduction across the warp): 7.4 / 6.0 ms in f32
// and 26 / 24 ms in f64 (chip_smoke.py, H100 80GB HBM3, 700 W); the
// recurrence ran once per plane tile.
//
// This design (same card, same call, chip_smoke.py's kernel phases on both
// trees: synthesis 3.31–3.32 ms in f32 and 6.84–6.86 ms in f64, 38% and 34%
// of the bounds, against the first design's 7.42–7.46 and 26.0–26.2 ms;
// adjoint 4.91–5.07 and 12.9 ms, 25% and 18%, against 5.95–6.03 and
// 24.1–24.2 ms):
//  * Synthesis takes K1's (scan_legendre.cu): a block owns 4 m (8 in f64
//    at F2 ≤ 32) × 64 rings and all planes; each thread runs the recurrence
//    of its (m, ring) column and writes the emitted rows to a double-
//    buffered λ tile in shared memory, the rows of step j + 1 generated
//    inside the loop that contracts step j; the x rows (16-byte vectors
//    from planes-minor storage) and the A/B/C rows arrive by cp.async in a
//    ring of 3 stages, one barrier a step.  f32: a warp per (m, row parity)
//    with 8 planes × 8 rings a lane in IEEE FMAs, a fresh partial per step;
//    the two parities' sums are added once, in a fixed order, when G is
//    staged for its m-contiguous write.  f64: products on the FP64 tensor
//    cores (mma.sync m16n8k4), 32 planes × 64 rings a warp.
//  * The adjoint takes project_tiles.cuh (shared with K2): rings are the
//    inner dimension of a tile product, the blocks of one m group form a
//    cluster and add their partials in rank order through distributed
//    shared memory; at F2 ≤ 8 the first design's loop stays.  An odd L
//    leaves the last pair with one row, which is never written.
//  * The recurrence and the norm use explicitly rounded operations (no FMA
//    contraction), in the plain version's order:
//    ((A·(z − B))·d_{ℓ−1}) + (C·d_{ℓ−2}), then d_ℓ·(norm·sign).  Seeds in
//    the subnormal range lose bits at every step and the rows then grow by
//    many orders of magnitude, so any other rounding would be amplified
//    into visible differences; this way the kernel's λ rows are the plain
//    version's, bit for bit.  Built without fast-math, so subnormals are
//    kept as the plain version keeps them.  Only the order of the
//    contraction's sums differs; f32 products are IEEE FMAs (no TF32).

#include <cuda_runtime.h>
#include <cstddef>
#include <cstdint>

#include "hopper_tiles.cuh"
#include "project_tiles.cuh"

namespace {

using cora::kThreads;

// Correctly rounded operations the compiler may not contract into FMAs.
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }

// One step of the recurrence, rounded as the plain version rounds it.
template <typename T>
__device__ __forceinline__ T wig_step(T a, T b, T c, T z, T lp, T lpp) {
  return add_rn(mul_rn(mul_rn(a, sub_rn(z, b)), lp), mul_rn(c, lpp));
}

// √((2ℓ+1)·(1/4π)) in T, the reference kernel's arithmetic.
template <typename T>
__device__ __forceinline__ T row_norm(int l) {
  const T inv4pi = T(0.07957747154594767);
  return sqrt(mul_rn(T(2 * l + 1), inv4pi));
}

template <typename T>
struct WigTables {
  const T* coefs;
  const T* seed_T;
  const int* l0;
  const T* z;
};

// A coefficient slot: [3][LB][MT] (A, B, C rows of the block's m group) and
// the LB row norms (zero past L, so that rows past L are emitted as zeros).
template <int MT, int LB>
constexpr int wig_slot() { return 3 * LB * MT + LB; }

// Start the copies of rows [lb, lb + LB) into a slot (zero past L or M) and
// store the rows' norms.
template <typename T, int MT, int LB>
__device__ __forceinline__ void wig_load_rows(T* slot, const T* __restrict__ coefs,
                                              int lb, int m0, int L, int M) {
  constexpr int N = 3 * LB * MT;
  const size_t LM = (size_t)L * M;
  for (int e = threadIdx.x; e < N; e += kThreads) {
    const int mm = e % MT, row = (e / MT) % LB, c = e / (MT * LB);
    const int gm = m0 + mm, gl = lb + row;
    const bool ok = gm < M && gl < L;
    const T* src = ok ? coefs + c * LM + (size_t)gl * M + gm : coefs;
    cora::cp_async_el(slot + e, src, ok);
  }
  if (threadIdx.x < LB)
    slot[N + threadIdx.x] =
        lb + threadIdx.x < L ? row_norm<T>(lb + threadIdx.x) : T(0);
}

// The recurrence of one (m, ring) column.
template <typename T>
struct WigColumn {
  T zr, seed, lp, lpp, sgn;
  int lseed;

  __device__ __forceinline__ void init(const WigTables<T>& tb, int m, int r,
                                       int M, int R) {
    const bool live = m < M && r < R;
    zr = live ? tb.z[r] : T(0);
    seed = live ? tb.seed_T[(size_t)m * R + r] : T(0);
    lseed = m < M ? tb.l0[m] : -1;
    sgn = (m & 1) ? T(-1) : T(1);
    lp = lpp = T(0);
  }

  // The emitted rows l and l + 1 (rows 2p, 2p + 1 of the slot's step),
  // column mm of the block's m group.
  template <int MT, int LB>
  __device__ __forceinline__ void pair(const T* slot, int p, int mm, int l,
                                       T& o0, T& o1) {
    const T* c = slot + 2 * p * MT + mm;
    const T* n = slot + 3 * LB * MT + 2 * p;
    T lam = wig_step(c[0], c[LB * MT], c[2 * LB * MT], zr, lp, lpp);
    if (l == lseed) lam = seed;
    lpp = lp;
    lp = lam;
    o0 = mul_rn(lam, n[0] * sgn);
    lam = wig_step(c[MT], c[LB * MT + MT], c[2 * LB * MT + MT], zr, lp, lpp);
    if (l + 1 == lseed) lam = seed;
    lpp = lp;
    lp = lam;
    o1 = mul_rn(lam, n[1] * sgn);
  }
};

// Start the copies of NP plane rows row0, row0 + step, … (zero past L, M or
// the planes) into [NP][KS] (row: the m group of FPP planes) from
// planes-minor x [L, M, fs], as 16-byte vectors.
template <typename T, int MT, int NP, int FP, int FPP, int KS>
__device__ __forceinline__ void load_x_rows(T* dst, const T* __restrict__ x,
                                            int row0, int step, int m0, int f0,
                                            int L, int M, int fs) {
  constexpr int V = 16 / sizeof(T);
  constexpr int NQ = FP / V;
  constexpr int N = NP * MT * NQ;
#pragma unroll
  for (int j = 0; j < (N + kThreads - 1) / kThreads; ++j) {
    const int e = threadIdx.x + j * kThreads;
    if (N % kThreads != 0 && e >= N) break;
    const int q = e % NQ, mm = (e / NQ) % MT, pp = e / (NQ * MT);
    const int gm = m0 + mm, gl = row0 + pp * step, gf = f0 + q * V;
    const bool ok = gm < M && gl < L && gf < fs;
    const T* src = ok ? x + ((size_t)gl * M + gm) * fs + gf : x;
    cora::cp_async16(dst + pp * KS + mm * FPP + q * V, src, ok);
  }
}

// ------------------------------------------------------ synthesis, float --

// Block tile per planes a block FP: MT m × RT rings, LB rows a step, NS
// stages; a warp per (m, row parity), PG × (32/PG) lanes of TP × TR
// register tiles (K1's).
template <int FP> struct CTile32;
template <> struct CTile32<32> {
  static constexpr int MT = 4, RT = 64, LB = 32, NS = 3;
  static constexpr int PG = 4, TP = 8, TR = 8;
};
template <> struct CTile32<8> {
  static constexpr int MT = 4, RT = 64, LB = 32, NS = 3;
  static constexpr int PG = 2, TP = 4, TR = 4;
};

template <int FP>
struct C32Layout {
  using C = CTile32<FP>;
  static constexpr int NP = C::LB / 2;
  static constexpr int FPP = FP + 4, KS = C::MT * FPP;
  static constexpr int P_STAGE = 2 * NP * KS;          // [2][NP][KS]
  static constexpr int REC = wig_slot<C::MT, C::LB>();
  static constexpr int LAM = C::MT * C::LB * C::RT;    // [MT][LB][RT]
  static constexpr int TOTAL = C::NS * P_STAGE + (C::NS + 1) * REC + 2 * LAM;
  static constexpr int EPI = 2 * FP * C::RT * C::MT;   // [2][FP][RT][MT]
  static constexpr size_t BYTES = 4 * (TOTAL > EPI ? TOTAL : EPI);
};

template <int FP>
__global__ void __launch_bounds__(kThreads, FP <= 8 ? 2 : 1)
wigner_contract_f32(WigTables<float> tb, const float* __restrict__ x,
                    float* __restrict__ g, int L, int M, int R, int F2,
                    int fs) {
  using C = CTile32<FP>;
  using Y = C32Layout<FP>;
  constexpr int MT = C::MT, RT = C::RT, LB = C::LB, NP = Y::NP, NS = C::NS;
  constexpr int TP = C::TP, TR = C::TR, PG = C::PG, RG = 32 / PG;
  constexpr int VP = TP < 4 ? TP : 4, VR = TR < 4 ? TR : 4;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* const sP = reinterpret_cast<float*>(smem_raw);
  float* const sRec = sP + NS * Y::P_STAGE;
  float* const sLam = sRec + (NS + 1) * Y::REC;

  static_assert(MT * 2 * 32 == kThreads, "a warp per (m, row parity)");
  static_assert(MT * RT == kThreads, "one (m, ring) column a thread");
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int wm = w >> 1, wp = w & 1;  // this warp's m and row parity
  const int r0 = blockIdx.x * RT, m0 = blockIdx.y * MT, f0 = blockIdx.z * FP;
  const int lstart = (m0 / LB) * LB;
  const int nsteps = lstart < L ? (L - lstart + LB - 1) / LB : 0;

  // the recurrence of column (cm, cr): both parities' rows, read by the two
  // warps of that m after the next barrier
  const int cm = threadIdx.x / RT, cr = threadIdx.x % RT;
  WigColumn<float> rc;
  rc.init(tb, m0 + cm, r0 + cr, M, R);

  const int fp0 = VP * (lane % PG), rr0 = VR * (lane / PG);
  const int a_off = wp * NP * Y::KS + wm * Y::FPP + fp0;
  const int l_off = wm * LB * RT + wp * RT + rr0;

  auto fill = [&](int j) {  // group j: x rows of step j, coefficients of j + 1
    if (j < nsteps) {
      const int st = j % NS;
      const int lb = lstart + j * LB;
#pragma unroll
      for (int par = 0; par < 2; ++par)
        load_x_rows<float, MT, NP, FP, Y::FPP, Y::KS>(
            sP + (st * 2 + par) * NP * Y::KS, x, lb + par, 2, m0, f0, L, M, fs);
      if (j + 1 < nsteps)
        wig_load_rows<float, MT, LB>(sRec + st * Y::REC, tb.coefs, lb + LB, m0,
                                     L, M);
    }
    cora::cp_async_commit();
  };
  auto gen_pair = [&](int j, int p, const float* rec) {
    float o0, o1;
    rc.template pair<MT, LB>(rec, p, cm, lstart + j * LB + 2 * p, o0, o1);
    float* dst = sLam + ((j & 1) * MT + cm) * LB * RT + 2 * p * RT + cr;
    dst[0] = o0;
    dst[RT] = o1;
  };

  float acc[TP][TR];
#pragma unroll
  for (int i = 0; i < TP; ++i)
#pragma unroll
    for (int t = 0; t < TR; ++t) acc[i][t] = 0.f;

  if (nsteps > 0) {
    wig_load_rows<float, MT, LB>(sRec + NS * Y::REC, tb.coefs, lstart, m0, L, M);
    cora::cp_async_commit();
#pragma unroll
    for (int j = 0; j < NS - 1; ++j) fill(j);
    cora::cp_async_wait<NS - 1>();
    __syncthreads();
    for (int p = 0; p < NP; ++p) gen_pair(0, p, sRec + NS * Y::REC);
  }

  for (int s = 0; s < nsteps; ++s) {
    cora::cp_async_wait<NS - 2>();
    __syncthreads();  // x rows of s, coefficients of s + 1, λ of s in place
    fill(s + NS - 1);
    const bool more = s + 1 < nsteps;
    const float* P = sP + (s % NS) * 2 * NP * Y::KS;
    const float* lam = sLam + ((s & 1) * MT) * LB * RT;
    const float* rec = sRec + (s % NS) * Y::REC;
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
      if (more) gen_pair(s + 1, p, rec);
    }
#pragma unroll
    for (int i = 0; i < TP; ++i)
#pragma unroll
      for (int t = 0; t < TR; ++t) acc[i][t] += part[i][t];
  }

  // both parities' sums through shared memory [2][FP][RT][MT], added even
  // then odd and written m-contiguous
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
  for (int e = threadIdx.x; e < nf * RT * MT; e += kThreads) {
    const int mm = e % MT, r = (e / MT) % RT, f = e / (MT * RT);
    const int m = m0 + mm, gr = r0 + r;
    if (m < M && gr < R)
      g[((size_t)(f0 + f) * R + gr) * M + m] = E[e] + E[FP * RT * MT + e];
  }
}

// ----------------------------------------------------- synthesis, double --

// MT m × RT rings, NR rows a step, WPM warps per m of 32 planes each.
template <int FP> struct CTile64;
template <> struct CTile64<64> {
  static constexpr int MT = 4, RT = 64, NR = 16, NS = 3, WPM = 2;
};
template <> struct CTile64<32> {
  static constexpr int MT = 8, RT = 64, NR = 8, NS = 3, WPM = 1;
};

template <int FP>
struct C64Layout {
  using C = CTile64<FP>;
  static constexpr int FPP = FP, KS = cora::dmma_pitch(C::MT * FPP);
  static constexpr int RTP = cora::dmma_pitch(C::RT);
  static constexpr int P_STAGE = C::NR * KS;           // [NR][KS]
  static constexpr int REC = wig_slot<C::MT, C::NR>();
  static constexpr int LAM = C::MT * C::NR * RTP;      // [MT][NR][RTP]
  static constexpr int TOTAL = C::NS * P_STAGE + (C::NS + 1) * REC + 2 * LAM;
  static constexpr int EPI = FP * C::RT * C::MT;       // [FP][RT][MT]
  static constexpr size_t BYTES = 8 * (TOTAL > EPI ? TOTAL : EPI);
};

template <int FP>
__global__ void __launch_bounds__(kThreads, 1)
wigner_contract_f64(WigTables<double> tb, const double* __restrict__ x,
                    double* __restrict__ g, int L, int M, int R, int F2,
                    int fs) {
  using C = CTile64<FP>;
  using Y = C64Layout<FP>;
  constexpr int MT = C::MT, RT = C::RT, NR = C::NR, NS = C::NS;
  constexpr int CPT = MT * RT / kThreads, PT = 4, RTT = RT / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  double* const sP = reinterpret_cast<double*>(smem_raw);
  double* const sRec = sP + NS * Y::P_STAGE;
  double* const sLam = sRec + (NS + 1) * Y::REC;

  static_assert(MT * C::WPM * 32 == kThreads, "WPM warps per m");
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int r0 = blockIdx.x * RT, m0 = blockIdx.y * MT, f0 = blockIdx.z * FP;
  const int lstart = (m0 / NR) * NR;
  const int nsteps = lstart < L ? (L - lstart + NR - 1) / NR : 0;

  // column j of this thread: c = tid + j·256 of the block's MT × RT, m-major
  WigColumn<double> rc[CPT];
  int cmm[CPT], crl[CPT];
#pragma unroll
  for (int j = 0; j < CPT; ++j) {
    const int c = threadIdx.x + j * kThreads;
    cmm[j] = c / RT;
    crl[j] = c % RT;
    rc[j].init(tb, m0 + cmm[j], r0 + crl[j], M, R);
  }

  const int gq = lane >> 2, t = lane & 3;
  const int wm = w / C::WPM, fw = (w % C::WPM) * 32;
  const int a_off = t * Y::KS + wm * Y::FPP + fw + gq;
  const int l_off = (wm * NR + t) * Y::RTP + gq;

  auto fill = [&](int j) {
    if (j < nsteps) {
      const int st = j % NS;
      const int lb = lstart + j * NR;
      load_x_rows<double, MT, NR, FP, Y::FPP, Y::KS>(sP + st * Y::P_STAGE, x,
                                                     lb, 1, m0, f0, L, M, fs);
      if (j + 1 < nsteps)
        wig_load_rows<double, MT, NR>(sRec + st * Y::REC, tb.coefs, lb + NR,
                                      m0, L, M);
    }
    cora::cp_async_commit();
  };
  auto gen_pair = [&](int j, int p, const double* rec) {
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      double o0, o1;
      rc[c].template pair<MT, NR>(rec, p, cmm[c], lstart + j * NR + 2 * p, o0,
                                  o1);
      double* dst =
          sLam + (((j & 1) * MT + cmm[c]) * NR + 2 * p) * Y::RTP + crl[c];
      dst[0] = o0;
      dst[Y::RTP] = o1;
    }
  };

  double acc[PT][RTT][2];
#pragma unroll
  for (int i = 0; i < PT; ++i)
#pragma unroll
    for (int j = 0; j < RTT; ++j) acc[i][j][0] = acc[i][j][1] = 0.0;

  if (nsteps > 0) {
    wig_load_rows<double, MT, NR>(sRec + NS * Y::REC, tb.coefs, lstart, m0, L,
                                  M);
    cora::cp_async_commit();
#pragma unroll
    for (int j = 0; j < NS - 1; ++j) fill(j);
    cora::cp_async_wait<NS - 1>();
    __syncthreads();
    for (int p = 0; p < NR / 2; ++p) gen_pair(0, p, sRec + NS * Y::REC);
  }

  for (int s = 0; s < nsteps; ++s) {
    cora::cp_async_wait<NS - 2>();
    __syncthreads();
    fill(s + NS - 1);
    const bool more = s + 1 < nsteps;
    const double* P = sP + (s % NS) * Y::P_STAGE;
    const double* lam = sLam + (s & 1) * MT * NR * Y::RTP;
    const double* rec = sRec + (s % NS) * Y::REC;
#pragma unroll
    for (int kk = 0; kk < NR / 4; ++kk) {
      double a[PT], b[RTT];
#pragma unroll
      for (int i = 0; i < PT; ++i) a[i] = P[a_off + 4 * kk * Y::KS + 8 * i];
#pragma unroll
      for (int j = 0; j < RTT; ++j) b[j] = lam[l_off + 4 * kk * Y::RTP + 8 * j];
#pragma unroll
      for (int i = 0; i < PT; i += 2)
#pragma unroll
        for (int j = 0; j < RTT; ++j)
          cora::dmma16(acc[i][j], acc[i + 1][j], a[i], a[i + 1], b[j]);
      if (more) {
#pragma unroll
        for (int p = 2 * kk; p < 2 * kk + 2; ++p) gen_pair(s + 1, p, rec);
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
        const int f = fw + 8 * i + gq, r = 8 * j + 2 * t + u;
        E[(f * RT + r) * MT + wm] = acc[i][j][u];
      }
  __syncthreads();
  const int nf = min(FP, F2 - f0);
  for (int e = threadIdx.x; e < nf * RT * MT; e += kThreads) {
    const int mm = e % MT, r = (e / MT) % RT, f = e / (MT * RT);
    const int m = m0 + mm, gr = r0 + r;
    if (m < M && gr < R) g[((size_t)(f0 + f) * R + gr) * M + m] = E[e];
  }
}

template <typename T, int FP>
cudaError_t launch_contract_tile(const WigTables<T>& tb, const void* x,
                                 void* g, int L, int M, int R, int F2, int fs,
                                 cudaStream_t stream) {
  size_t bytes;
  int MT, RT;
  void (*kern)(WigTables<T>, const T*, T*, int, int, int, int, int);
  if constexpr (sizeof(T) == 8) {
    kern = wigner_contract_f64<FP>;
    bytes = C64Layout<FP>::BYTES;
    MT = CTile64<FP>::MT;
    RT = CTile64<FP>::RT;
  } else {
    kern = wigner_contract_f32<FP>;
    bytes = C32Layout<FP>::BYTES;
    MT = CTile32<FP>::MT;
    RT = CTile32<FP>::RT;
  }
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((R + RT - 1) / RT, (M + MT - 1) / MT, (F2 + FP - 1) / FP);
  kern<<<grid, kThreads, bytes, stream>>>(tb, (const T*)x, (T*)g, L, M, R, F2,
                                          fs);
  return cudaGetLastError();
}

// --------------------------------------------------------------- adjoint --

// The Wigner recurrence as project_tiles.cuh takes it: MT m values a block,
// CPT columns a thread.
template <typename Real, int MT_, int CPT_>
struct WigProj {
  using T = Real;
  using Rc = Real;
  static constexpr bool kParity = false;
  static constexpr int MT = MT_, CPT = CPT_;
  static constexpr int LB = sizeof(T) == 4 ? 32 : 16;
  static constexpr int SLOT = wig_slot<MT, LB>();
  using Tables = WigTables<T>;

  static __device__ __forceinline__ void load_rows(T* slot, const Tables& tb,
                                                   int lb, int m0, int L,
                                                   int M) {
    wig_load_rows<T, MT, LB>(slot, tb.coefs, lb, m0, L, M);
  }

  struct Column {
    WigColumn<T> rc[CPT];
    int mm[CPT];

    template <int RT>
    __device__ __forceinline__ void init(const Tables& tb, int m0, int r0,
                                         int M, int R, int) {
#pragma unroll
      for (int i = 0; i < CPT; ++i) {
        const int c = threadIdx.x + i * kThreads;
        mm[i] = c / RT;
        rc[i].init(tb, m0 + mm[i], r0 + c % RT, M, R);
      }
    }
    __device__ __forceinline__ void begin(const Tables&, int, bool) {}
    template <bool kFirst>
    __device__ __forceinline__ void pair(const Tables&, int l, const T* slot,
                                         int p, T (&o0)[CPT], T (&o1)[CPT]) {
#pragma unroll
      for (int i = 0; i < CPT; ++i)
        rc[i].template pair<MT, LB>(slot, p, mm[i], l, o0[i], o1[i]);
    }
  };
};

template <typename T>
int launch_contract(const void* coefs, const void* seed_T, const void* l0,
                    const void* z, const void* x, void* g, int L, int M,
                    int R, int F2, int fs, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (L <= 0 || M <= 0 || R <= 0 || F2 <= 0) return 0;
  if (fs < F2 || fs % (16 / (int)sizeof(T)) != 0 ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const WigTables<T> tb = {(const T*)coefs, (const T*)seed_T, (const int*)l0,
                           (const T*)z};
  cudaStream_t st = (cudaStream_t)stream;
  constexpr int small = sizeof(T) == 4 ? 8 : 32, big = sizeof(T) == 4 ? 32 : 64;
  err = F2 <= small
            ? launch_contract_tile<T, small>(tb, x, g, L, M, R, F2, fs, st)
            : launch_contract_tile<T, big>(tb, x, g, L, M, R, F2, fs, st);
  return (int)err;
}

template <typename T>
int launch_project(const void* coefs, const void* seed_T, const void* l0,
                   const void* z, const void* src, void* alm, int L, int M,
                   int R, int F2, int fs, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (L <= 0 || M <= 0 || R <= 0 || F2 <= 0) return 0;
  if (fs < F2 || fs % (16 / (int)sizeof(T)) != 0 ||
      reinterpret_cast<uintptr_t>(src) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  // F2 ≤ 8: project_small_kernel (4 or 8 planes a block, 4 rings a thread);
  // more planes: project_kernel with a plane tile of 32
  using Small = WigProj<T, 1, 4>;
  using Big = WigProj<T, cora::kProjMT, 1>;
  const WigTables<T> tb = {(const T*)coefs, (const T*)seed_T, (const int*)l0,
                           (const T*)z};
  cudaStream_t st = (cudaStream_t)stream;
  if (F2 <= 4)
    err = cora::launch_project_small<Small, 4>(tb, src, src, alm, alm, L, M, R,
                                               fs, st);
  else if (F2 <= 8)
    err = cora::launch_project_small<Small, 8>(tb, src, src, alm, alm, L, M, R,
                                               fs, st);
  else
    err = cora::launch_project_tile<Big, 32>(tb, src, src, alm, alm, L, M, R,
                                             fs, st);
  return (int)err;
}

}  // namespace

extern "C" {

// Each entry point launches on `stream` (a cudaStream_t) of device
// `device` and returns the cudaError_t of the launch (0 on success).  The
// caller owns all buffers; every output element is written.  x and the
// adjoint's alm are planes-minor (fs ≥ F2 a multiple of 16 bytes, 16-byte
// aligned).
int cora_wigner_contract(const void* coefs, const void* seed_T,
                         const void* l0, const void* z, const void* x,
                         void* g, int L, int M, int R, int F2, int fs,
                         int device, void* stream) {
  return launch_contract<float>(coefs, seed_T, l0, z, x, g, L, M, R, F2, fs,
                                device, stream);
}

int cora_wigner_contract_f64(const void* coefs, const void* seed_T,
                             const void* l0, const void* z, const void* x,
                             void* g, int L, int M, int R, int F2, int fs,
                             int device, void* stream) {
  return launch_contract<double>(coefs, seed_T, l0, z, x, g, L, M, R, F2, fs,
                                 device, stream);
}

int cora_wigner_project(const void* coefs, const void* seed_T,
                        const void* l0, const void* z, const void* src,
                        void* alm, int L, int M, int R, int F2, int fs,
                        int device, void* stream) {
  return launch_project<float>(coefs, seed_T, l0, z, src, alm, L, M, R, F2, fs,
                               device, stream);
}

int cora_wigner_project_f64(const void* coefs, const void* seed_T,
                            const void* l0, const void* z, const void* src,
                            void* alm, int L, int M, int R, int F2, int fs,
                            int device, void* stream) {
  return launch_project<double>(coefs, seed_T, l0, z, src, alm, L, M, R, F2,
                                fs, device, stream);
}

}  // extern "C"
