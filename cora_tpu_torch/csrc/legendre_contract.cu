// Legendre contraction from a stored Λ table (the cached-Λ SHT mode), K4.
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
// What bounds it on an H100: Λ is read once and dominates the bytes.  The
// flagship call (nside=512, lmax=1535, F2=32, f32) moves 5.94 GB, 1.77 ms at
// 3.35 TB/s, against 83.8 GFLOP of FMAs, 1.25 ms at 67 TFLOP/s; in f64 at
// L=1537, F2=64, 13.3 GB (3.97 ms) against 168 GFLOP of DMMA (2.50 ms).
// Both are bound by bytes, and the FMAs need a third or more of the f32
// peak to keep pace with them.
//
// What limited the first design (one warp per m and a lane per ring, 16
// planes a block in f32 and 8 in f64, each step's 32 Λ rows loaded into
// registers, then the planes staged by plain loads between two barriers, one
// LDS.128 per 4 FMAs): 9.521 ms at the flagship, 25.872 ms in f64, behind
// the per-chunk cuBLAS bmm (7.048 / 22.259 ms; chip_smoke.py on an H100
// 80GB HBM3, 700 W).  Probed on the same card by two rewrites of its step
// loop (9.357 ms whole): its Λ loads alone took 4.414 ms (1.35 TB/s:
// latency-bound, nothing in flight while a step was contracted), its FMAs
// and plane staging alone 6.861 ms (128 registers with spill); each Λ row
// was read by F2/16 (f32) or F2/8 (f64) blocks.
//
// This design (chip_smoke.py, same card, two runs: 4.060–4.477 ms f32,
// 9.012–9.151 ms f64, 40–44% of each bound; the bmm 6.952–7.336 /
// 22.186–22.201 ms in the same runs):
//  * All planes in one block (32 in f32, 64 in f64; more only for F2 above
//    that, as further grid tiles), so Λ is read from device memory once.  A
//    block owns 8 m values (4 in f64) × 64 rings × its planes.
//  * A ring of 4 shared-memory stages filled by cp.async, one __syncthreads
//    per stage: the next three steps' loads are in flight while a step is
//    contracted.  Λ rows go as 16-byte .cg copies along the rings.  The
//    planes go as 16-byte copies from planes-minor storage ([LA, M, fs],
//    fs = F2 rounded up to a whole vector; the transforms build it
//    directly, ops.scan_legendre.kernel_planes): gathering the m-minor
//    [F2, LA, M] one element at a time cost more than all of Λ's traffic
//    (2.5 ms of the first version of this design).
//  * f32: one warp per m, 32 planes × 64 rings as 4 × 8 lanes of 8 × 8
//    register tiles (4 LDS.128 per 64 IEEE FMAs, broadcast over the lanes of
//    a plane or ring group; no TF32).  Sums stay two-level: a fresh partial
//    per 32 rows of a chunk, added to the accumulator at its end, which
//    keeps the f32 error at the plain version's.  F2 ≤ 8 takes an 8-plane
//    tile (4 × 4 per thread).
//  * f64: the products on the tensor cores, mma.sync m16n8k4 (DMMA; the
//    m8n8k4 shape of the previous generation ran 1.2× slower here), two
//    warps per m each holding 32 planes × 64 rings of accumulators;
//    fragments read from stages padded so a half warp hits distinct banks.
//    F2 ≤ 32 takes one warp per m and 8 m a block.
//  * The two targets are two passes over the chunks of each, so one set of
//    accumulators lives in registers; each pass ends by staging its tile in
//    shared memory and adding it to H with m-contiguous reads and writes,
//    16 in flight per thread.  Each output element is written once per
//    target, no atomics: the same output every run.
//  * Chunks with mw_c <= m0 are skipped by the whole block (λ_ℓm = 0 for
//    m > ℓ); ragged chunks, R or M off the tiles and odd L are zero-filled
//    at the copy, so need no padding.  Offsets are 64-bit: the table
//    exceeds 2^32 bytes.  R (2·nside rings) must be a whole number of
//    16-byte vectors.
//
// What holds it back (probed on the same card by cut-down variants of this
// source): in f32 its loads alone take 2.96 ms and its contraction alone
// 3.14 ms, and at one block of 8 warps per SM (255 registers) the two
// overlap only in part; the loop itself is dense (1024 FFMA beside 64
// LDS.128 a stage in the SASS), so the stalls lie in latency, not in
// instruction count.  In f64 the loads alone take 7.4 ms: Λ and the
// planes, which each ring tile reads again.

#include <cuda_runtime.h>
#include <cstddef>
#include <cstdint>

#include "hopper_tiles.cuh"

namespace {

using cora::kThreads;

constexpr int kDesc = 5;  // descriptor entries per chunk

// Block tile per (real type, planes a block FP): MT m values × RT rings × FP
// planes; LB Λ rows a stage, NS stages.  f32: PG × (32/PG) lanes of TP × TR
// register tiles, partial sums flushed every FLUSH rows.  f64: WPM warps per
// m, each 32 planes.
template <typename T, int FP> struct Tile;
template <> struct Tile<float, 32> {
  static constexpr int MT = 8, RT = 64, LB = 16, NS = 4, FLUSH = 32;
  static constexpr int PG = 4, TP = 8, TR = 8;
};
template <> struct Tile<float, 8> {
  static constexpr int MT = 8, RT = 64, LB = 16, NS = 4, FLUSH = 32;
  static constexpr int PG = 2, TP = 4, TR = 4;
};
template <> struct Tile<double, 64> {
  static constexpr int MT = 4, RT = 64, LB = 8, NS = 4, WPM = 2;
};
template <> struct Tile<double, 32> {
  static constexpr int MT = 8, RT = 64, LB = 8, NS = 4, WPM = 1;
};

// Shared-memory layout (elements): stage s holds Λ [MT][LB][RTP] and the
// planes [LB][KS] (plane row: m group of FPP, f minor); the epilogue reuses
// the stages as [FP][RT][MT].
template <typename T, int FP> struct Layout {
  using C = Tile<T, FP>;
  static constexpr bool kF64 = sizeof(T) == 8;
  static constexpr int RTP = kF64 ? cora::dmma_pitch(C::RT) : C::RT;
  static constexpr int FPP = kF64 ? FP : FP + 4;
  static constexpr int KS = kF64 ? cora::dmma_pitch(C::MT * FPP) : C::MT * FPP;
  static constexpr int L_STAGE = C::MT * C::LB * RTP;
  static constexpr int A_STAGE = C::LB * KS;
  static constexpr int STAGES = C::NS * (L_STAGE + A_STAGE);
  static constexpr int EPI = FP * C::RT * C::MT;
  static constexpr size_t BYTES = sizeof(T) * (STAGES > EPI ? STAGES : EPI);
};

// A chunk's descriptor entries, kept in registers by a cursor (c = nchunk:
// past the last chunk).
struct Chunk {
  int c;
  long long off;
  int nrows, mw, row0;
};

// The first chunk at or after c that targets `tgt` and reaches past m0.
__device__ __forceinline__ Chunk next_chunk(const long long* __restrict__ desc,
                                            int nchunk, int c, int tgt,
                                            int m0) {
  for (; c < nchunk; ++c) {
    const long long* d = desc + (size_t)c * kDesc;
    if (d[4] == tgt && d[2] > m0 && d[1] > 0)
      return Chunk{c, d[0], (int)d[1], (int)d[2], (int)d[3]};
  }
  return Chunk{nchunk, 0, 0, 0, 0};
}

// Start one stage's copies, all 16-byte vectors: Λ rows [i0, i0 + LB) of
// chunk ch for the block's m group and ring tile, and the matching plane
// rows from planes-minor A [LA, M, fs].
template <typename T, int FP>
__device__ __forceinline__ void load_step(T* sL, T* sA,
                                          const T* __restrict__ lam,
                                          const Chunk& ch, int i0,
                                          const T* __restrict__ A, int F2,
                                          int M, int R, int fs, int r0,
                                          int m0, int f0) {
  using C = Tile<T, FP>;
  using Y = Layout<T, FP>;
  constexpr int V = 16 / sizeof(T);
  const long long off = ch.off;
  const int nrows = ch.nrows, mw = ch.mw, row0 = ch.row0;
  const int tid = threadIdx.x;
  {
    constexpr int NQ = C::RT / V;
    constexpr int N = C::MT * C::LB * NQ;
    static_assert(N % kThreads == 0, "Λ copies must fill the block");
#pragma unroll
    for (int j = 0; j < N / kThreads; ++j) {
      const int e = tid + j * kThreads;
      const int q = e % NQ, k = (e / NQ) % C::LB, mm = e / (NQ * C::LB);
      const int m = m0 + mm, i = i0 + k, r = r0 + q * V;
      const bool ok = m < mw && i < nrows && r < R;
      const T* src = ok ? lam + off + ((long long)m * nrows + i) * R + r : lam;
      cora::cp_async16(sL + (mm * C::LB + k) * Y::RTP + q * V, src, ok);
    }
  }
  constexpr int NQ = FP / V;
  constexpr int N = C::LB * C::MT * NQ;
  static_assert(N % kThreads == 0, "plane copies must fill the block");
#pragma unroll
  for (int j = 0; j < N / kThreads; ++j) {
    const int e = tid + j * kThreads;
    const int q = e % NQ, mm = (e / NQ) % C::MT, k = e / (NQ * C::MT);
    const int m = m0 + mm, i = i0 + k, gf = f0 + q * V;
    const bool ok = m < mw && i < nrows && gf < F2;
    const T* src = ok ? A + ((long long)(row0 + i) * M + m) * fs + gf : A;
    cora::cp_async16(sA + k * Y::KS + mm * Y::FPP + q * V, src, ok);
  }
}

// f32: per thread TP planes × TR rings of its warp's m, two-level sums.
template <int FP> struct ContractF32 {
  using C = Tile<float, FP>;
  using Y = Layout<float, FP>;
  static constexpr int TP = C::TP, TR = C::TR, PG = C::PG, RG = 32 / PG;
  static constexpr int VP = TP < 4 ? TP : 4, VR = TR < 4 ? TR : 4;
  float acc[TP][TR], part[TP][TR];
  int a_off, l_off, fp0, rr0;

  __device__ __forceinline__ void init() {
    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
    const int p = lane % PG, q = lane / PG;
    fp0 = VP * p;
    rr0 = VR * q;
    a_off = w * Y::FPP + fp0;
    l_off = w * C::LB * Y::RTP + rr0;
  }
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < TP; ++i)
#pragma unroll
      for (int j = 0; j < TR; ++j) acc[i][j] = part[i][j] = 0.f;
  }
  __device__ __forceinline__ void step(const float* sL, const float* sA) {
#pragma unroll
    for (int k = 0; k < C::LB; ++k) {
      float a[TP], b[TR];
      cora::lds_vec<TP, VP>(a, sA + k * Y::KS + a_off, VP * PG);
      cora::lds_vec<TR, VR>(b, sL + k * Y::RTP + l_off, VR * RG);
      cora::outer_fma(part, a, b);
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
  // this thread's accumulators into E [FP][RT][MT]
  __device__ __forceinline__ void stage(float* E) const {
    const int w = threadIdx.x >> 5;
#pragma unroll
    for (int i = 0; i < TP; ++i)
#pragma unroll
      for (int j = 0; j < TR; ++j) {
        const int f = (i / VP) * VP * PG + fp0 + i % VP;
        const int r = (j / VR) * VR * RG + rr0 + j % VR;
        E[(f * C::RT + r) * C::MT + w] = acc[i][j];
      }
  }
};

// f64: per warp 32 planes × RT rings of one m on the FP64 tensor cores.
template <int FP> struct ContractF64 {
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
    a_off = t * Y::KS + mm * Y::FPP + fw + g;
    l_off = (mm * C::LB + t) * Y::RTP + g;
  }
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < PT; ++i)
#pragma unroll
      for (int j = 0; j < RTT; ++j) acc[i][j][0] = acc[i][j][1] = 0.0;
  }
  __device__ __forceinline__ void step(const double* sL, const double* sA) {
#pragma unroll
    for (int kk = 0; kk < C::LB / 4; ++kk) {
      double a[PT], b[RTT];
#pragma unroll
      for (int i = 0; i < PT; ++i) a[i] = sA[a_off + 4 * kk * Y::KS + 8 * i];
#pragma unroll
      for (int j = 0; j < RTT; ++j) b[j] = sL[l_off + 4 * kk * Y::RTP + 8 * j];
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
          const int f = fw + 8 * i + g, r = 8 * j + 2 * t + u;
          E[(f * C::RT + r) * C::MT + mm] = acc[i][j][u];
        }
  }
};

template <typename T, int FP> struct Contract;
template <int FP> struct Contract<float, FP> : ContractF32<FP> {};
template <int FP> struct Contract<double, FP> : ContractF64<FP> {};

template <typename T, int FP>
__global__ void __launch_bounds__(kThreads, 1)
legendre_contract_kernel(const T* __restrict__ lam,
                         const long long* __restrict__ desc, int nchunk,
                         const T* __restrict__ A, T* __restrict__ h0,
                         T* __restrict__ h1, int F2, int M, int R, int fs) {
  using C = Tile<T, FP>;
  using Y = Layout<T, FP>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const sL = reinterpret_cast<T*>(smem_raw);
  T* const sA = sL + C::NS * Y::L_STAGE;
  const int r0 = blockIdx.x * C::RT;
  const int m0 = blockIdx.y * C::MT;
  const int f0 = blockIdx.z * FP;

  Contract<T, FP> con;
  con.init();
  for (int tgt = 0; tgt < (h1 != nullptr ? 2 : 1); ++tgt) {
    Chunk cc = next_chunk(desc, nchunk, 0, tgt, m0);
    if (cc.c >= nchunk) continue;  // nothing reaches this m group: H += 0
    con.zero();
    // load cursor (chunk lc, row li0) runs NS - 1 stages ahead of the
    // compute cursor (cc, ci0)
    Chunk lc = cc;
    int li0 = 0, ci0 = 0;
    auto fill = [&](int st) {
      if (lc.c < nchunk) {
        load_step<T, FP>(sL + st * Y::L_STAGE, sA + st * Y::A_STAGE, lam, lc,
                         li0, A, F2, M, R, fs, r0, m0, f0);
        li0 += C::LB;
        if (li0 >= lc.nrows) {
          lc = next_chunk(desc, nchunk, lc.c + 1, tgt, m0);
          li0 = 0;
        }
      }
      cora::cp_async_commit();
    };
#pragma unroll
    for (int st = 0; st < C::NS - 1; ++st) fill(st);
    for (int s = 0; cc.c < nchunk; ++s) {
      cora::cp_async_wait<C::NS - 2>();
      __syncthreads();  // stage s landed for all; stage s - 1 is free
      fill((s + C::NS - 1) % C::NS);
      const int cs = s % C::NS;
      con.step(sL + cs * Y::L_STAGE, sA + cs * Y::A_STAGE);
      ci0 += C::LB;
      const bool end = ci0 >= cc.nrows;
      if constexpr (!Y::kF64) {
        if (end || ci0 % C::FLUSH == 0) con.flush();
      }
      if (end) {
        cc = next_chunk(desc, nchunk, cc.c + 1, tgt, m0);
        ci0 = 0;
      }
    }
    cora::cp_async_wait<0>();
    __syncthreads();
    T* const E = sL;
    con.stage(E);
    __syncthreads();
    // H += E, U independent read-modify-writes in flight per thread
    T* const H = tgt ? h1 : h0;
    const int n = min(FP, F2 - f0) * C::RT * C::MT;
    constexpr int U = 16;
    for (int e0 = threadIdx.x; e0 < n; e0 += U * kThreads) {
      T* o[U];
      T v[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int e = e0 + u * kThreads;
        const int mm = e % C::MT, r = (e / C::MT) % C::RT,
                  f = e / (C::MT * C::RT);
        const int m = m0 + mm, gr = r0 + r;
        o[u] = (e < n && m < M && gr < R)
                   ? H + ((size_t)(f0 + f) * R + gr) * M + m
                   : nullptr;
        v[u] = o[u] ? *o[u] : T(0);
      }
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (o[u]) *o[u] = v[u] + E[e0 + u * kThreads];
    }
    __syncthreads();  // E is the next pass's stages
  }
}

template <typename T, int FP>
cudaError_t launch_tile(const void* lam, const void* desc, int nchunk,
                        const void* A, void* h0, void* h1, int F2, int M,
                        int R, int fs, cudaStream_t stream) {
  using C = Tile<T, FP>;
  using Y = Layout<T, FP>;
  auto kern = legendre_contract_kernel<T, FP>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Y::BYTES);
  if (err != cudaSuccess) return err;
  const dim3 grid((R + C::RT - 1) / C::RT, (M + C::MT - 1) / C::MT,
                  (F2 + FP - 1) / FP);
  kern<<<grid, kThreads, Y::BYTES, stream>>>(
      (const T*)lam, (const long long*)desc, nchunk, (const T*)A, (T*)h0,
      (T*)h1, F2, M, R, fs);
  return cudaGetLastError();
}

template <typename T>
int launch(const void* lam, const void* desc, int nchunk, const void* A,
           void* h0, void* h1, int F2, int M, int R, int fs, int device,
           void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (nchunk <= 0 || F2 <= 0 || M <= 0 || R <= 0) return 0;
  constexpr int V = 16 / sizeof(T);
  if (fs < F2 || fs % V != 0 || R % V != 0 ||
      reinterpret_cast<uintptr_t>(A) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(lam) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if constexpr (sizeof(T) == 4) {
    err = F2 <= 8 ? launch_tile<float, 8>(lam, desc, nchunk, A, h0, h1, F2,
                                          M, R, fs, st)
                  : launch_tile<float, 32>(lam, desc, nchunk, A, h0, h1, F2,
                                           M, R, fs, st);
  } else {
    err = F2 <= 32 ? launch_tile<double, 32>(lam, desc, nchunk, A, h0, h1,
                                             F2, M, R, fs, st)
                   : launch_tile<double, 64>(lam, desc, nchunk, A, h0, h1,
                                             F2, M, R, fs, st);
  }
  return (int)err;
}

}  // namespace

extern "C" {

// Launch on `stream` (a cudaStream_t) of device `device`; returns the
// cudaError_t of the launch (0 on success).  The caller owns all buffers;
// `desc` is a device pointer; `h1` may be null when no chunk targets it.
// A is planes-minor [LA, M, fs] (fs ≥ F2 a multiple of 16 bytes); R is a
// multiple of 16 bytes; lam, its chunk offsets and A are 16-byte aligned.
int cora_legendre_contract_f32(const void* lam, const void* desc, int nchunk,
                               const void* A, void* h0, void* h1, int F2,
                               int M, int R, int fs, int device,
                               void* stream) {
  return launch<float>(lam, desc, nchunk, A, h0, h1, F2, M, R, fs, device,
                       stream);
}

// The same on double Λ, planes and accumulators.
int cora_legendre_contract_f64(const void* lam, const void* desc, int nchunk,
                               const void* A, void* h0, void* h1, int F2,
                               int M, int R, int fs, int device,
                               void* stream) {
  return launch<double>(lam, desc, nchunk, A, h0, h1, F2, M, R, fs, device,
                        stream);
}

}  // extern "C"
