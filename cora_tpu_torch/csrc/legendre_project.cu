// Legendre projection onto a stored Λ table (the cached-Λ SHT mode's
// analysis), K7: the adjoint of K4 (legendre_contract.cu).
//
// Replaces no TPU kernel: the JAX package leaves this adjoint to an XLA
// einsum (cora_tpu/healpix/sht.py `_legendre_project_cached`, spin.py
// `_project_cached`), and the port ran one cuBLAS bmm per Λ chunk between
// permute-copies of the sources and strided adds into a zeroed output.  One
// launch covers every chunk of K4's descriptor (legendre_chunks.cuh):
//
//   lam                    chunk c at element offset off_c: [mw_c, nrows_c, R]
//   S0, S1 [F2, R, M]      sources, read planes-minor ([R, M, fs] storage)
//   out                    out[f, ℓ(row0_c + i), m] = Σ_r Λ_c[m, i, r] ·
//                                          S_t(c)[f, r, m]   (m < mw_c; 0 for
//                                          mw_c ≤ m < M)
//
// Every output element of a row some chunk covers is written once (no
// atomics, no zeroed output: the same bits every run).  ℓ(row) is the row
// itself, or with odd0 > 0 the scalar layout's parity packing undone (row
// < odd0: ℓ = 2·row; else ℓ = 2·(row − odd0) + 1), so the a_lm come back in
// ℓ order.  An output element (f, ℓ, m) sits at (f/2)·o_pair + (f%2)·o_c +
// ℓ·o_row + m·o_m: the planes [F2, LA, M], or the storage of complex a_lm
// [F2/2, L, M] with re/im minor.
//
// What bounds it on an H100: the same bytes as K4.  At the flagship call
// (nside=512, lmax=1535, F2=32, f32) Λ's triangle is 4.83 GB of the 5.39 GB
// the projection needs (1.609 ms at 3.35 TB/s) against 1.16 ms of IEEE FMAs
// at 67 TFLOP/s; in f64 at L=1537, F2=64 bytes again against DMMA products.
// The per-chunk bmm (6.95–7.34 ms with its copies in f32) read Λ once but
// moved each source three times more around it.
//
// This design mirrors K4's with the roles of rows and rings swapped:
//  * A block owns one row tile (64 rows of one chunk) × MT m values × all
//    planes of the call (32 in f32, 64 in f64; more as further grid tiles),
//    so Λ is read from device memory once; the contraction runs over the
//    rings, R = 2·nside with no ragged end at the flagship, and the block's
//    output tile stays in registers for the whole ring loop.  Row tiles of
//    the same m group are neighbours in the launch order, so the sources'
//    m columns are re-read from L2.
//  * A ring of shared-memory stages filled by cp.async, one __syncthreads a
//    stage: Λ as 16-byte copies along the rings of each row (LB rings a
//    stage), the sources as 16-byte copies along the planes.
//  * f32: one warp per m, the planes × rows tile as lanes of TP × TR
//    register tiles; four rings of a row per LDS.128, so the loads per FMA
//    are K4's (IEEE fmaf, no TF32).  Sums stay two-level: a fresh partial
//    every 32 rings, added to the accumulator, which keeps the f32 error at
//    the plain version's.  F2 ≤ 8 takes an 8-plane tile.
//  * f64: mma.sync m16n8k4 (DMMA) with planes as M, rows as N and rings as
//    K; Λ stages pitched at 12 doubles a row so a half warp's fragment
//    loads fall on distinct banks.
//  * The tile is staged in shared memory and written with the (plane pair,
//    m, re/im) order contiguous: 64-byte runs of the complex a_lm rows.
//    Blocks whose m group lies past their chunk's mw write zeros only.
//  * R must be a whole number of 16-byte vectors (the wrapper pads nside=1
//    in float32); offsets are 64-bit, the table exceeds 2^32 bytes.
//
// Measured (CUDA-event medians, NVIDIA H100 80GB HBM3, 700 W): the flagship
// f32 call 3.73–3.95 ms (41–43% of 1.609 ms; the per-chunk bmm path with
// its copies 5.07 ms), f64 at L=1537, F2=64 6.66 ms (53% of 3.55 ms; the
// bmm path 12.87 ms).  The narrow tiles, at nside=512 on random Λ: the
// spin layout (one source) at F2=4 2.31 ms on Tile<float, 8> against 3.81
// on Tile<float, 32> (plain 3.83); f64 at F2=8 4.59 ms on Tile<double, 32>
// against 5.94 on Tile<double, 64> (plain 5.54), at F2=32 5.36 against
// 6.20 (plain 8.06).
//
// What holds it back (cut-down copies of this source, same card): in f32
// its loads alone take 2.32–2.44 ms and its contraction alone 2.60–2.74
// ms, and at one block of 8 warps per SM (249 registers) the two overlap
// only in part, as in K4.  Tried and dropped: an L2::256B prefetch and 32
// rings a stage (both slower); skipping Λ's zeros above the diagonal (no
// change); 3 stages with the totals in shared memory (2–5% faster, within
// the spread of two cards); producer warps feeding an mbarrier ring —
// ptxas holds a 384-thread block to 168 registers, so the consumers spill
// (9.8 ms), and one producer warp cannot issue a stage's 3072 16-byte
// copies in time (33 ms).  A producer that moves a stage with one TMA copy
// is the untried step.

#include <cuda_runtime.h>
#include <cstddef>
#include <cstdint>

#include "hopper_tiles.cuh"
#include "legendre_chunks.cuh"

namespace {

using cora::Chunk;
using cora::kThreads;

constexpr int kRowTile = 64;  // rows a block (ops/legendre.py ROW_TILE)

// Block tile per (real type, planes a block FP): MT m values × RT rows × FP
// planes; LB rings a stage (LBP: a row's pitch in the stage), NS stages.
// f32: PG × (32/PG) lanes of TP planes × TR rows, partial sums flushed every
// FLUSH rings.  f64: WPM warps per m, each 32 planes.
template <typename T, int FP> struct Tile;
template <> struct Tile<float, 32> {
  static constexpr int MT = 8, RT = kRowTile, LB = 16, LBP = 16, NS = 4;
  static constexpr int FLUSH = 32, PG = 4, TP = 8, TR = 8;
};
template <> struct Tile<float, 8> {
  static constexpr int MT = 8, RT = kRowTile, LB = 16, LBP = 20, NS = 4;
  static constexpr int FLUSH = 32, PG = 2, TP = 4, TR = 4;
};
template <> struct Tile<double, 64> {
  static constexpr int MT = 4, RT = kRowTile, LB = 8, LBP = 12, NS = 4;
  static constexpr int WPM = 2;
};
template <> struct Tile<double, 32> {
  static constexpr int MT = 8, RT = kRowTile, LB = 8, LBP = 12, NS = 3;
  static constexpr int WPM = 1;
};

// Shared-memory layout (elements): stage s holds Λ [MT][RT][LBP] and the
// sources [LB][KS] (a ring: m group of FPP, planes minor); the epilogue
// reuses the stages as [FP/2][RT][MT][2].
template <typename T, int FP> struct Layout {
  using C = Tile<T, FP>;
  static constexpr bool kF64 = sizeof(T) == 8;
  static constexpr int FPP = kF64 ? FP : FP + 4;
  static constexpr int KS = kF64 ? cora::dmma_pitch(C::MT * FPP) : C::MT * FPP;
  static constexpr int L_STAGE = C::MT * C::RT * C::LBP;
  static constexpr int S_STAGE = C::LB * KS;
  static constexpr int STAGES = C::NS * (L_STAGE + S_STAGE);
  static constexpr int EPI = FP * C::RT * C::MT;
  static constexpr size_t BYTES = sizeof(T) * (STAGES > EPI ? STAGES : EPI);
  static_assert(BYTES <= 227 * 1024, "stages exceed shared memory");
};

// Start one stage's copies, all 16-byte vectors: rings [r0, r0 + LB) of the
// block's Λ rows (chunk ch, rows i0 .. i0 + RT, its m group) and the same
// rings of the source S, planes-minor [R, M, fs].
template <typename T, int FP>
__device__ __forceinline__ void load_step(T* sL, T* sS,
                                          const T* __restrict__ lam,
                                          const Chunk& ch, int i0, int r0,
                                          const T* __restrict__ S, int F2,
                                          int M, int R, int fs, int m0,
                                          int f0) {
  using C = Tile<T, FP>;
  using Y = Layout<T, FP>;
  constexpr int V = 16 / sizeof(T);
  const int tid = threadIdx.x;
  {
    constexpr int NQ = C::LB / V;
    constexpr int N = C::MT * C::RT * NQ;
    static_assert(N % kThreads == 0, "Λ copies must fill the block");
#pragma unroll
    for (int j = 0; j < N / kThreads; ++j) {
      const int e = tid + j * kThreads;
      const int q = e % NQ, i = (e / NQ) % C::RT, mm = e / (NQ * C::RT);
      const int m = m0 + mm, row = i0 + i, r = r0 + q * V;
      const bool ok = m < ch.mw && row < ch.nrows && r < R;
      const T* src =
          ok ? lam + ch.off + ((long long)m * ch.nrows + row) * R + r : lam;
      cora::cp_async16(sL + (mm * C::RT + i) * C::LBP + q * V, src, ok);
    }
  }
  constexpr int NQ = FP / V;
  constexpr int N = C::LB * C::MT * NQ;
  static_assert(N % kThreads == 0, "source copies must fill the block");
#pragma unroll
  for (int j = 0; j < N / kThreads; ++j) {
    const int e = tid + j * kThreads;
    const int q = e % NQ, mm = (e / NQ) % C::MT, k = e / (NQ * C::MT);
    const int m = m0 + mm, r = r0 + k, gf = f0 + q * V;
    const bool ok = m < ch.mw && r < R && gf < F2;
    const T* src = ok ? S + ((long long)r * M + m) * fs + gf : S;
    cora::cp_async16(sS + k * Y::KS + mm * Y::FPP + q * V, src, ok);
  }
}

// f32: per thread TP planes × TR rows of its warp's m, two-level sums.
template <int FP> struct ProjectF32 {
  using C = Tile<float, FP>;
  using Y = Layout<float, FP>;
  static constexpr int TP = C::TP, TR = C::TR, PG = C::PG, RG = 32 / PG;
  static constexpr int VP = TP < 4 ? TP : 4;
  float acc[TP][TR], part[TP][TR];
  int a_off, l_off, fp0, q;

  __device__ __forceinline__ void init() {
    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
    fp0 = VP * (lane % PG);
    q = lane / PG;  // rows q, q + RG, q + 2·RG, …
    a_off = w * Y::FPP + fp0;
    l_off = (w * C::RT + q) * C::LBP;
  }
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < TP; ++i)
#pragma unroll
      for (int j = 0; j < TR; ++j) acc[i][j] = part[i][j] = 0.f;
  }
  __device__ __forceinline__ void step(const float* sL, const float* sS) {
#pragma unroll
    for (int k4 = 0; k4 < C::LB / 4; ++k4) {
      float b[TR][4];
#pragma unroll
      for (int j = 0; j < TR; ++j) {
        const float4 x = *reinterpret_cast<const float4*>(
            sL + l_off + j * RG * C::LBP + 4 * k4);
        b[j][0] = x.x;
        b[j][1] = x.y;
        b[j][2] = x.z;
        b[j][3] = x.w;
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        float a[TP];
        cora::lds_vec<TP, VP>(a, sS + (4 * k4 + kk) * Y::KS + a_off, VP * PG);
#pragma unroll
        for (int i = 0; i < TP; ++i)
#pragma unroll
          for (int j = 0; j < TR; ++j)
            part[i][j] = fmaf(a[i], b[j][kk], part[i][j]);
      }
    }
  }
  __device__ __forceinline__ void flush() {
#pragma unroll
    for (int i = 0; i < TP; ++i)
#pragma unroll
      for (int j = 0; j < TR; ++j) {
        acc[i][j] += part[i][j];
        part[i][j] = 0.f;
      }
  }
  // this thread's accumulators into E [FP/2][RT][MT][2]
  __device__ __forceinline__ void stage(float* E) const {
    const int w = threadIdx.x >> 5;
#pragma unroll
    for (int i = 0; i < TP; ++i)
#pragma unroll
      for (int j = 0; j < TR; ++j) {
        const int f = (i / VP) * VP * PG + fp0 + i % VP;
        const int row = q + RG * j;
        E[(((f >> 1) * C::RT + row) * C::MT + w) * 2 + (f & 1)] = acc[i][j];
      }
  }
};

// f64: per warp 32 planes × RT rows of one m on the FP64 tensor cores.
template <int FP> struct ProjectF64 {
  using C = Tile<double, FP>;
  using Y = Layout<double, FP>;
  static constexpr int PT = 4, RTT = C::RT / 8;
  double acc[PT][RTT][2];
  int a_off, l_off, mm, fw;

  __device__ __forceinline__ void init() {
    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
    const int g = lane >> 2, t = lane & 3;
    mm = w / C::WPM;
    fw = (w % C::WPM) * 32;
    a_off = t * Y::KS + mm * Y::FPP + fw + g;  // plane fw + g, ring t
    l_off = (mm * C::RT + g) * C::LBP + t;     // row g, ring t
  }
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < PT; ++i)
#pragma unroll
      for (int j = 0; j < RTT; ++j) acc[i][j][0] = acc[i][j][1] = 0.0;
  }
  __device__ __forceinline__ void step(const double* sL, const double* sS) {
#pragma unroll
    for (int kk = 0; kk < C::LB / 4; ++kk) {
      double a[PT], b[RTT];
#pragma unroll
      for (int i = 0; i < PT; ++i) a[i] = sS[a_off + 4 * kk * Y::KS + 8 * i];
#pragma unroll
      for (int j = 0; j < RTT; ++j) b[j] = sL[l_off + 8 * j * C::LBP + 4 * kk];
#pragma unroll
      for (int i = 0; i < PT; i += 2)
#pragma unroll
        for (int j = 0; j < RTT; ++j)
          cora::dmma16(acc[i][j], acc[i + 1][j], a[i], a[i + 1], b[j]);
    }
  }
  __device__ __forceinline__ void flush() {}
  __device__ __forceinline__ void stage(double* E) const {
    const int lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int i = 0; i < PT; ++i)
#pragma unroll
      for (int j = 0; j < RTT; ++j)
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int f = fw + 8 * i + g, row = 8 * j + 2 * t + u;
          E[(((f >> 1) * C::RT + row) * C::MT + mm) * 2 + (f & 1)] =
              acc[i][j][u];
        }
  }
};

template <typename T, int FP> struct Project;
template <int FP> struct Project<float, FP> : ProjectF32<FP> {};
template <int FP> struct Project<double, FP> : ProjectF64<FP> {};

template <typename T, int FP>
__global__ void __launch_bounds__(kThreads, 1)
legendre_project_kernel(const T* __restrict__ lam,
                        const long long* __restrict__ desc, int nchunk,
                        const T* __restrict__ s0, const T* __restrict__ s1,
                        T* __restrict__ out, int F2, int M, int R, int fs,
                        int odd0, long long o_pair, long long o_c,
                        long long o_row, long long o_m) {
  using C = Tile<T, FP>;
  using Y = Layout<T, FP>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const sL = reinterpret_cast<T*>(smem_raw);
  T* const sS = sL + C::NS * Y::L_STAGE;
  int i0;
  const Chunk ch = cora::row_tile<C::RT>(desc, nchunk, blockIdx.x, i0);
  if (ch.c >= nchunk) return;
  const int m0 = blockIdx.y * C::MT;
  const int f0 = blockIdx.z * FP;

  Project<T, FP> con;
  con.init();
  con.zero();
  if (m0 < ch.mw) {  // past mw the block's output is zero
    const T* const S = cora::chunk_target(desc, ch.c) ? s1 : s0;
    const int nstep = (R + C::LB - 1) / C::LB;
    // the loads run NS - 1 stages ahead of the contraction
#pragma unroll
    for (int st = 0; st < C::NS - 1; ++st) {
      if (st < nstep)
        load_step<T, FP>(sL + st * Y::L_STAGE, sS + st * Y::S_STAGE, lam, ch,
                         i0, st * C::LB, S, F2, M, R, fs, m0, f0);
      cora::cp_async_commit();
    }
    for (int s = 0; s < nstep; ++s) {
      cora::cp_async_wait<C::NS - 2>();
      __syncthreads();  // stage s landed for all; stage s - 1 is free
      const int ls = s + C::NS - 1;
      if (ls < nstep)
        load_step<T, FP>(sL + (ls % C::NS) * Y::L_STAGE,
                         sS + (ls % C::NS) * Y::S_STAGE, lam, ch, i0,
                         ls * C::LB, S, F2, M, R, fs, m0, f0);
      cora::cp_async_commit();
      const int cs = s % C::NS;
      con.step(sL + cs * Y::L_STAGE, sS + cs * Y::S_STAGE);
      if constexpr (!Y::kF64) {
        if (s + 1 == nstep || ((s + 1) * C::LB) % C::FLUSH == 0) con.flush();
      }
    }
    cora::cp_async_wait<0>();
    __syncthreads();
  }
  T* const E = sL;
  con.stage(E);
  __syncthreads();
  // out = E: (plane pair, row, m, re/im) with the last two contiguous
  const int ni = min(C::RT, ch.nrows - i0);
  const int nf = min(FP, F2 - f0);
  const int n = ((nf + 1) / 2) * C::RT * C::MT * 2;
  for (int e = threadIdx.x; e < n; e += kThreads) {
    const int c = e & 1, mm = (e >> 1) % C::MT;
    const int i = (e / (2 * C::MT)) % C::RT, fp = e / (2 * C::MT * C::RT);
    const int m = m0 + mm;
    if (i >= ni || 2 * fp + c >= nf || m >= M) continue;
    const int row = ch.row0 + i0 + i;
    const int ell =
        odd0 > 0 ? (row < odd0 ? 2 * row : 2 * (row - odd0) + 1) : row;
    out[(long long)(f0 / 2 + fp) * o_pair + c * o_c + ell * o_row +
        m * o_m] = E[e];
  }
}

template <typename T, int FP>
cudaError_t launch_tile(const void* lam, const void* desc, int nchunk,
                        int ntiles, const void* s0, const void* s1, void* out,
                        int F2, int M, int R, int fs, int odd0,
                        long long o_pair, long long o_c, long long o_row,
                        long long o_m, cudaStream_t stream) {
  using C = Tile<T, FP>;
  using Y = Layout<T, FP>;
  auto kern = legendre_project_kernel<T, FP>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Y::BYTES);
  if (err != cudaSuccess) return err;
  const dim3 grid(ntiles, (M + C::MT - 1) / C::MT, (F2 + FP - 1) / FP);
  kern<<<grid, kThreads, Y::BYTES, stream>>>(
      (const T*)lam, (const long long*)desc, nchunk, (const T*)s0,
      (const T*)s1, (T*)out, F2, M, R, fs, odd0, o_pair, o_c, o_row, o_m);
  return cudaGetLastError();
}

template <typename T>
int launch(const void* lam, const void* desc, int nchunk, int ntiles,
           const void* s0, const void* s1, void* out, int F2, int M, int R,
           int fs, int odd0, long long o_pair, long long o_c, long long o_row,
           long long o_m, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (nchunk <= 0 || ntiles <= 0 || F2 <= 0 || M <= 0 || R <= 0) return 0;
  constexpr int V = 16 / sizeof(T);
  if (fs < F2 || fs % V != 0 || R % V != 0 ||
      reinterpret_cast<uintptr_t>(s0) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(s1) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(lam) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if constexpr (sizeof(T) == 4) {
    err = F2 <= 8
              ? launch_tile<float, 8>(lam, desc, nchunk, ntiles, s0, s1, out,
                                      F2, M, R, fs, odd0, o_pair, o_c, o_row,
                                      o_m, st)
              : launch_tile<float, 32>(lam, desc, nchunk, ntiles, s0, s1, out,
                                       F2, M, R, fs, odd0, o_pair, o_c, o_row,
                                       o_m, st);
  } else {
    err = F2 <= 32
              ? launch_tile<double, 32>(lam, desc, nchunk, ntiles, s0, s1, out,
                                        F2, M, R, fs, odd0, o_pair, o_c,
                                        o_row, o_m, st)
              : launch_tile<double, 64>(lam, desc, nchunk, ntiles, s0, s1, out,
                                        F2, M, R, fs, odd0, o_pair, o_c,
                                        o_row, o_m, st);
  }
  return (int)err;
}

}  // namespace

extern "C" {

// Launch on `stream` (a cudaStream_t) of device `device`; returns the
// cudaError_t of the launch (0 on success).  The caller owns all buffers;
// `desc` is a device pointer to K4's descriptor and `ntiles` the number of
// 64-row tiles of its chunks (Σ_c ⌈nrows_c / 64⌉).  S0 and S1 are
// planes-minor [R, M, fs] (fs ≥ F2 a multiple of 16 bytes; S1 may be null
// when no chunk targets it); R is a multiple of 16 bytes; lam,
// its chunk offsets and the sources are 16-byte aligned.  Every output
// element of the rows the chunks cover is written, at (f/2)·o_pair +
// (f%2)·o_c + ℓ·o_row + m·o_m, ℓ the row (odd0 = 0) or its ℓ in the
// parity-packed layout with odd ℓ from row odd0.
int cora_legendre_project_f32(const void* lam, const void* desc, int nchunk,
                              int ntiles, const void* s0, const void* s1,
                              void* out, int F2, int M, int R, int fs,
                              int odd0, long long o_pair, long long o_c,
                              long long o_row, long long o_m, int device,
                              void* stream) {
  return launch<float>(lam, desc, nchunk, ntiles, s0, s1, out, F2, M, R, fs,
                       odd0, o_pair, o_c, o_row, o_m, device, stream);
}

// The same on double Λ, sources and output.
int cora_legendre_project_f64(const void* lam, const void* desc, int nchunk,
                              int ntiles, const void* s0, const void* s1,
                              void* out, int F2, int M, int R, int fs,
                              int odd0, long long o_pair, long long o_c,
                              long long o_row, long long o_m, int device,
                              void* stream) {
  return launch<double>(lam, desc, nchunk, ntiles, s0, s1, out, F2, M, R, fs,
                        odd0, o_pair, o_c, o_row, o_m, device, stream);
}

}  // extern "C"
