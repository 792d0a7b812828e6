// The adjoint ("projection") loops shared by K2 (scan_project.cu, scaled
// Legendre rows) and the adjoint of K3 (wigner_apply.cu, Wigner-d rows):
//
//   out[f, ℓ, m] = Σ_r λ_ℓ[m, r] · src[f, r, m]
//
// Sources [R, M, fs] and outputs [rows, M, fs] are planes-minor (fs = F2
// rounded up to a whole 16-byte vector); every output element is written.
// The rows of a step are split by ℓ parity into two classes q: K2 pairs
// each with its own source and output, K3 shares one of each.
//
// project_kernel (more than 8 planes).  Per m the adjoint is a matrix
// product out[ℓ, f] = λ[ℓ, r]·src[r, f] whose inner dimension is the rings.
// A block owns 2 m × 128 rings and all planes of its plane tile: its
// sources stay in shared memory for the whole ℓ loop (they do not depend
// on ℓ); each thread runs the recurrence of one (m, ring) column and writes
// the emitted rows of a step of LB rows to a double-buffered λ tile in
// shared memory, the rows of step s + 1 generated inside the loop that
// contracts step s; threads own outputs (row, plane) and loop over the
// rings, so no shuffle is left.  A warp per (m, q, half of the block's
// rings):
//  * float: a lane holds 4 rows × 4 planes; per 4 rings it reads 4 λ
//    vectors and 4 source vectors (LDS.128) for 64 IEEE FMAs (no TF32);
//  * double: the products run on the FP64 tensor cores (mma.sync m16n8k4:
//    16 planes × 8 rows += src[4 rings × 16]·λ[4 × 8]) from pitches of
//    dmma_pitch; the recurrence stays on the FP64 units.
// The ring sum is finished across blocks without atomics: the R/128 blocks
// of one m group form a thread-block cluster (at most 8).  At a step's end
// each warp publishes its partial in its block's shared memory and the
// block arrives at the cluster's barrier; it waits for that barrier only
// inside the next step's product, fetches its slice of the step's (row,
// m, plane) values from every rank through distributed shared memory
// beside that product, adds them over the ranks and ring halves in rank
// order and writes them once, 16 planes or more contiguous: the same bits
// from run to run.  The partials are double-buffered.  The arrival that
// releases the partials to the cluster waits for the block's writes to
// become visible; a ninth warp that computes nothing does it, so the
// computing warps do not stall.  More rings than a cluster holds are walked in passes, each
// adding to the output its cluster owns; rows below the first step that
// holds the block's m are written as zeros, so the caller zeroes nothing.
//
// project_small_kernel (F2 ≤ 8, where a λ tile in shared memory and a
// barrier across blocks cost more than the few products): one block owns
// all rings of one m, a lane is a ring (CPT rings a thread, carry and
// sources in registers), the 2·FT values of a row pair leave a warp
// through a transpose-reduction (each shuffle step halves the values a
// lane keeps), and the warps' sums are added in warp order once per step.
// FT = 4 or 8 planes a block; steps start at the row pair that holds m (so a
// policy must take band starts inside a step).
//
// What holds project_kernel back (cut-down variants of this source timed on
// an H100 80GB HBM3, 700 W, at K3's L=1536, R=1024, F2=32 in f32, 4.9–5.1 ms
// whole): the products with their loads alone take 2.95 ms, the recurrence
// alone 2.2 ms, and at one block of 8 computing warps per SM they overlap
// only in part; a releasing arrival on the computing warps cost 0.57 ms
// more (hence the ninth warp), the remote loads 0.2 ms.  In f64 two
// sources of 32 planes do not fit beside the λ tiles, so K2 takes plane
// tiles of 16 and repeats the recurrence four times at F2=64.
//
// A policy P supplies the recurrence and the row layout:
//   T          float or double
//   kParity    true (K2): class q has its own source src_q and output
//              out_q [L/2, M, fs], row j; false (K3): one source, one
//              output [L, M, fs], row 2j + q
//   MT, CPT    m values a block; (m, ring) columns a thread
//   LB, SLOT   rows a step; elements of one coefficient slot
//   Tables     the recurrence tables, passed by value
//   load_rows(slot, tb, lb, m0, L, M)   start the copies of the coefficient
//              rows [lb, lb + LB) of the block's m group (no commit)
//   Column     a thread's columns c = tid + i·256 of the block's MT × RT,
//              m-major: init<RT>(tb, m0, r0, M, R, lstart), begin(tb, lb,
//              first) before a step's rows are generated, pair(tb, l, slot,
//              p, o0, o1): the emitted rows l, l + 1 of each column

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cstddef>
#include <cstdint>

#include "hopper_tiles.cuh"

namespace cora {

namespace cg = cooperative_groups;

constexpr int kProjMT = 2;    // project_kernel: m values a block
constexpr int kProjRT = 128;  // rings a block: one (m, ring) column a thread
constexpr int kProjNS = 3;    // coefficient-row slots
constexpr int kMaxCluster = 8;
// project_kernel's block: 8 warps that compute and one that only releases
// the block's partial sums to the cluster (see the kernel)
constexpr int kProjThreads = kThreads + 32;

// The cluster's barrier, split: every thread of the cluster's blocks
// arrives and later waits (acquiring what the releasing arrivals ordered).
// A releasing arrival waits until the thread's earlier writes (and those it
// has observed through a block barrier) are visible to the cluster, which
// costs several hundred cycles; a relaxed one orders nothing.
__device__ __forceinline__ void cluster_arrive_release() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

template <typename T, int FP, int LB, int SLOT, bool kTwo>
struct ProjLayout {
  static constexpr int MT = kProjMT, RT = kProjRT, NJ = LB / 2;
  static constexpr bool f64 = sizeof(T) == 8;
  static constexpr int FPP = f64 ? dmma_pitch(FP) : FP;
  static constexpr int RTP = f64 ? dmma_pitch(RT) : RT + 4;
  static constexpr int NSRC = kTwo ? 2 : 1;
  static constexpr int SRC = NSRC * MT * RT * FPP;   // [NSRC][MT][RT][FPP]
  static constexpr int LAM = MT * 2 * NJ * RTP;      // [MT][2][NJ][RTP]
  static constexpr int E = MT * 2 * NJ * FP;         // [MT][2][NJ][FP]
  static constexpr int PART = 2 * E;                 // [2 halves][E]
  static constexpr int REC = (SLOT + 3) / 4 * 4;
  static constexpr int TOTAL = SRC + 2 * LAM + 2 * PART + kProjNS * REC;
  static constexpr size_t BYTES = sizeof(T) * TOTAL;
};

// Where the value of class q, pair j, column m, plane f goes (nullptr past
// the last row, column or plane).
template <class P>
__device__ __forceinline__ typename P::T* proj_out(typename P::T* out0,
                                                   typename P::T* out1, int q,
                                                   int j, int m, int f, int L,
                                                   int M, int fs) {
  const int row = P::kParity ? j : 2 * j + q;
  const int nrow = P::kParity ? L / 2 : L;
  if (row >= nrow || m >= M || f >= fs) return nullptr;
  return (P::kParity && q ? out1 : out0) + ((size_t)row * M + m) * fs + f;
}

template <class P, int FP>
__global__ void __launch_bounds__(kProjThreads, 1)
project_kernel(typename P::Tables tb, const typename P::T* __restrict__ src0,
               const typename P::T* __restrict__ src1,
               typename P::T* __restrict__ out0,
               typename P::T* __restrict__ out1, int L, int M, int R, int fs) {
  using T = typename P::T;
  using Y = ProjLayout<T, FP, P::LB, P::SLOT, P::kParity>;
  constexpr int MT = Y::MT, RT = Y::RT, LB = P::LB, NJ = Y::NJ, HR = RT / 2;
  constexpr int V = 16 / sizeof(T);
  static_assert(P::MT == MT && P::CPT == 1 && MT * RT == kThreads,
                "one (m, ring) column a thread");
  static_assert(MT * 2 * 2 * 32 == kThreads, "a warp per (m, class, half)");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const sSrc = reinterpret_cast<T*>(smem_raw);
  T* const sLam = sSrc + Y::SRC;
  T* const sPart = sLam + 2 * Y::LAM;
  T* const sRec = sPart + 2 * Y::PART;

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int C = (int)cluster.num_blocks();
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int wm = w >> 2, wq = (w >> 1) & 1, wh = w & 1;
  const int m0 = blockIdx.y * MT, f0 = blockIdx.z * FP;
  const int cm = tid / RT, cr = tid % RT;  // this thread's column
  const int lstart = (m0 / LB) * LB;
  const int nsteps = (L - lstart + LB - 1) / LB;
  const int npass = (R + C * RT - 1) / (C * RT);

  // The ninth warp takes the block through every barrier of the loop below
  // and does the step's releasing arrival: the computing warps have made
  // their partial sums visible to it by the block's barrier, so its release
  // orders them for the cluster while they go on with the next step, their
  // own arrivals relaxed.
  if (tid >= kThreads) {
    for (int pass = 0; pass < npass; ++pass) {
      __syncthreads();
      __syncthreads();
      for (int s = 0; s < nsteps; ++s) {
        __syncthreads();
        cluster_arrive_release();
        cluster_wait();
      }
      cluster.sync();
    }
    return;
  }

  // rows below the block's first step: zeros, split over the cluster
  {
    const int Z = (lstart / 2) * 2 * MT * FP;
    for (int i = rank * kThreads + tid; i < Z; i += C * kThreads) {
      const int f = i % FP, mm = (i / FP) % MT, q = (i / (FP * MT)) % 2,
                j = i / (FP * MT * 2);
      T* o = proj_out<P>(out0, out1, q, j, m0 + mm, f0 + f, L, M, fs);
      if (o != nullptr) *o = T(0);
    }
  }

  for (int pass = 0; pass < npass; ++pass) {
    const int r0 = (pass * C + rank) * RT;
    typename P::Column rc;
    rc.template init<RT>(tb, m0, r0, M, R, lstart);

    // the coefficient rows of the first two steps, then the block's sources
    // [NSRC][MT][RT][FPP] from planes-minor [R, M, fs]: the first step's
    // rows are generated while the sources are still arriving
    P::load_rows(sRec, tb, lstart, m0, L, M);
    P::load_rows(sRec + Y::REC, tb, lstart + LB, m0, L, M);
    cp_async_commit();
    {
      constexpr int NQ = FP / V;
      constexpr int N = Y::NSRC * MT * RT * NQ;
      for (int e = tid; e < N; e += kThreads) {
        const int q4 = e % NQ, mm = (e / NQ) % MT, r = (e / (NQ * MT)) % RT,
                  sx = e / (NQ * MT * RT);
        const int gm = m0 + mm, gr = r0 + r, gf = f0 + q4 * V;
        const bool ok = gm < M && gr < R && gf < fs;
        const T* base = sx ? src1 : src0;
        const T* src = ok ? base + ((size_t)gr * M + gm) * fs + gf : base;
        cp_async16(sSrc + ((sx * MT + mm) * RT + r) * Y::FPP + q4 * V, src, ok);
      }
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    // λ rows of pair p of step j into buffer j & 1
    auto gen_pair = [&](int j, int p) {
      T o0[1], o1[1];
      rc.pair(tb, lstart + j * LB + 2 * p, sRec + (j % kProjNS) * Y::REC, p,
              o0, o1);
      T* dst = sLam + (j & 1) * Y::LAM + ((cm * 2) * NJ + p) * Y::RTP + cr;
      dst[0] = o0[0];
      dst[NJ * Y::RTP] = o1[0];
    };
    // This block's slice of step s's outputs, once every rank's partials
    // are in place: ranks, then ring halves, in order.  red_load starts the
    // loads of the slice's element e (one a thread when the cluster is
    // full); red_sum adds them up; red_store writes the sum.
    auto red_load = [&](int s, int e, T (&v)[2 * kMaxCluster]) {
      const T* mine = sPart + (s & 1) * Y::PART;
#pragma unroll
      for (int k = 0; k < kMaxCluster; ++k) {
        v[2 * k] = v[2 * k + 1] = T(0);
        if (k < C && e < Y::E) {
          const T* rp = cluster.map_shared_rank(mine, k);
          v[2 * k] = rp[e];
          v[2 * k + 1] = rp[Y::E + e];
        }
      }
    };
    auto red_sum = [&](const T (&v)[2 * kMaxCluster]) {
      T sum = v[0];
#pragma unroll
      for (int k = 1; k < 2 * kMaxCluster; ++k) sum += v[k];
      return sum;
    };
    auto red_store = [&](int s, int e, T sum) {
      if (e >= Y::E) return;
      const int f = e % FP, j = (e / FP) % NJ, q = (e / (FP * NJ)) % 2,
                mm = e / (FP * NJ * 2);
      T* o = proj_out<P>(out0, out1, q, (lstart + s * LB) / 2 + j, m0 + mm,
                         f0 + f, L, M, fs);
      if (o != nullptr) *o = pass == 0 ? sum : *o + sum;
    };
    // the slice's elements beyond the first (clusters of fewer than 8)
    auto red_rest = [&](int s) {
      for (int e = (rank + C) * kThreads + tid; e < Y::E; e += C * kThreads) {
        T v[2 * kMaxCluster];
        red_load(s, e, v);
        red_store(s, e, red_sum(v));
      }
    };
    const int e0 = rank * kThreads + tid;

    rc.begin(tb, lstart, true);
    for (int p = 0; p < NJ; ++p) gen_pair(0, p);
    cp_async_wait<0>();
    __syncthreads();

    for (int s = 0; s < nsteps; ++s) {
      // λ of s and the coefficient rows of s + 1 are in place
      const bool more = s + 1 < nsteps;
      if (s + 2 < nsteps)
        P::load_rows(sRec + ((s + 2) % kProjNS) * Y::REC, tb,
                     lstart + (s + 2) * LB, m0, L, M);
      cp_async_commit();
      if (more) rc.begin(tb, lstart + (s + 1) * LB, false);
      const T* lam = sLam + (s & 1) * Y::LAM + (wm * 2 + wq) * NJ * Y::RTP +
                     wh * HR;
      const T* src = sSrc + ((P::kParity ? wq * MT : 0) + wm) * RT * Y::FPP +
                     wh * HR * Y::FPP;
      T* part = sPart + (s & 1) * Y::PART + wh * Y::E + (wm * 2 + wq) * NJ * FP;
      T red[2 * kMaxCluster];  // step s − 1's values, fetched beside the product

      if constexpr (!Y::f64) {
        // lane (jg, fg): rows j = jg + NJG·i, planes 4·fg .. 4·fg + 3
        constexpr int NFG = FP / 4, NJG = 32 / NFG, TJ = NJ / NJG;
        static_assert(TJ >= 1 && NJ % NJG == 0, "rows split over the lanes");
        static_assert(NJ == HR / 4, "a row pair of step s + 1 per 4 rings");
        const int fg = lane % NFG, jg = lane / NFG;
        float acc[TJ][4];
#pragma unroll
        for (int i = 0; i < TJ; ++i)
#pragma unroll
          for (int u = 0; u < 4; ++u) acc[i][u] = 0.f;
#pragma unroll
        for (int k4 = 0; k4 < HR / 4; ++k4) {
          if (k4 == HR / 8 && s > 0) {  // step s − 1's barrier: long complete
            cluster_wait();
            red_load(s - 1, e0, red);
          }
          float lv[TJ][4];
#pragma unroll
          for (int i = 0; i < TJ; ++i) {
            const float4 x = *reinterpret_cast<const float4*>(
                lam + (jg + NJG * i) * Y::RTP + 4 * k4);
            lv[i][0] = x.x;
            lv[i][1] = x.y;
            lv[i][2] = x.z;
            lv[i][3] = x.w;
          }
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const float4 sv = *reinterpret_cast<const float4*>(
                src + (4 * k4 + u) * Y::FPP + 4 * fg);
#pragma unroll
            for (int i = 0; i < TJ; ++i) {
              acc[i][0] = fmaf(lv[i][u], sv.x, acc[i][0]);
              acc[i][1] = fmaf(lv[i][u], sv.y, acc[i][1]);
              acc[i][2] = fmaf(lv[i][u], sv.z, acc[i][2]);
              acc[i][3] = fmaf(lv[i][u], sv.w, acc[i][3]);
            }
          }
          if (more) gen_pair(s + 1, k4);
        }
#pragma unroll
        for (int i = 0; i < TJ; ++i)
          *reinterpret_cast<float4*>(part + (jg + NJG * i) * FP + 4 * fg) =
              make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      } else {
        // D[16 planes × 8 rows] += src^T[16 × 4 rings]·λ^T[4 × 8]
        static_assert(NJ == 8 && FP % 16 == 0, "one DMMA column tile of rows");
        constexpr int NFT = FP / 16, GEN = (HR / 4) / NJ;
        const int g = lane >> 2, t = lane & 3;
        double acc[NFT][2][2];
#pragma unroll
        for (int i = 0; i < NFT; ++i)
          acc[i][0][0] = acc[i][0][1] = acc[i][1][0] = acc[i][1][1] = 0.0;
#pragma unroll
        for (int k4 = 0; k4 < HR / 4; ++k4) {
          if (k4 == HR / 8 && s > 0) {
            cluster_wait();
            red_load(s - 1, e0, red);
          }
          const double b = lam[g * Y::RTP + 4 * k4 + t];
#pragma unroll
          for (int i = 0; i < NFT; ++i) {
            const double* a = src + (4 * k4 + t) * Y::FPP + 16 * i + g;
            dmma16(acc[i][0], acc[i][1], a[0], a[8], b);
          }
          if (more && k4 % GEN == 0) gen_pair(s + 1, k4 / GEN);
        }
#pragma unroll
        for (int i = 0; i < NFT; ++i)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh)
#pragma unroll
            for (int u = 0; u < 2; ++u)
              part[(2 * t + u) * FP + 16 * i + 8 * hh + g] = acc[i][hh][u];
      }

      // Every read of step s − 1's partials is complete before the arrival
      // (the ranks overwrite them after it).  After the block's barrier the
      // partials of s, λ of s + 1 and the rows of s + 2 are in place, and
      // the ninth warp releases the partials to the cluster.
      T sum = T(0);
      if (s > 0) {
        red_rest(s - 1);
        sum = red_sum(red);
      }
      cp_async_wait<0>();
      __syncthreads();
      cluster_arrive_relaxed();
      if (s > 0) red_store(s - 1, e0, sum);
    }
    cluster_wait();
    {
      T red[2 * kMaxCluster];
      red_load(nsteps - 1, e0, red);
      red_store(nsteps - 1, e0, red_sum(red));
      red_rest(nsteps - 1);
    }
    cluster.sync();  // nobody reads this block's partials any more
  }
}

// Launch project_kernel<P, FP> over (cluster of ring tiles, m groups, plane
// tiles).
template <class P, int FP>
cudaError_t launch_project_tile(const typename P::Tables& tb, const void* src0,
                                const void* src1, void* out0, void* out1,
                                int L, int M, int R, int fs,
                                cudaStream_t stream) {
  using T = typename P::T;
  using Y = ProjLayout<T, FP, P::LB, P::SLOT, P::kParity>;
  auto kern = project_kernel<P, FP>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Y::BYTES);
  if (err != cudaSuccess) return err;
  int C = (R + Y::RT - 1) / Y::RT;
  if (C > kMaxCluster) C = kMaxCluster;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C, (M + Y::MT - 1) / Y::MT, (fs + FP - 1) / FP);
  cfg.blockDim = dim3(kProjThreads);
  cfg.dynamicSmemBytes = Y::BYTES;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kern, tb, (const T*)src0, (const T*)src1,
                            (T*)out0, (T*)out1, L, M, R, fs);
}

// ------------------------------------------------------------- F2 ≤ 8 --

// One transpose-reduction step: lanes whose `off` bit is set keep the upper
// half of v, the others the lower half; each adds its partner's copy.
template <int N, typename T>
__device__ __forceinline__ void fold(T* v, int lane, int off) {
  const bool hi = (lane & off) != 0;
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    const T send = hi ? v[i] : v[i + N / 2];
    const T keep = hi ? v[i + N / 2] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, off);
  }
}

// The warp's sum of each of v's NV values (8 or 16): value q ends in v[0]
// of the lanes with lane / (32 / NV) == q.
template <int NV, typename T>
__device__ __forceinline__ void warp_sums(T* v, int lane) {
  static_assert(NV == 8 || NV == 16, "2·FT values a row pair");
  if constexpr (NV == 16) {
    fold<16>(v, lane, 16);
    fold<8>(v, lane, 8);
    fold<4>(v, lane, 4);
    fold<2>(v, lane, 2);
  } else {
    fold<8>(v, lane, 16);
    fold<4>(v, lane, 8);
    fold<2>(v, lane, 4);
    v[0] += __shfl_xor_sync(0xffffffffu, v[0], 2);
  }
  v[0] += __shfl_xor_sync(0xffffffffu, v[0], 1);
}

template <class P, int FT>
__global__ void __launch_bounds__(kThreads, sizeof(typename P::T) == 4 ? 2 : 1)
project_small_kernel(typename P::Tables tb,
                     const typename P::T* __restrict__ src0,
                     const typename P::T* __restrict__ src1,
                     typename P::T* __restrict__ out0,
                     typename P::T* __restrict__ out1, int L, int M, int R,
                     int fs) {
  using T = typename P::T;
  constexpr int CPT = P::CPT, LB = P::LB, NJ = LB / 2, NV = 2 * FT;
  constexpr int RT = kThreads * CPT, NW = kThreads / 32;
  constexpr int NSRC = P::kParity ? 2 : 1;
  constexpr int REC = (P::SLOT + 3) / 4 * 4;
  static_assert(P::MT == 1, "one m a block");
  __shared__ __align__(16) T s_rec[kProjNS * REC];
  __shared__ T s_red[NW][NJ][NV];

  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int m = blockIdx.x, f0 = blockIdx.y * FT;
  const int lstart = m & ~1;  // the first row pair that holds ℓ = m
  const int nsteps = (L - lstart + LB - 1) / LB;

  for (int i = tid; i < (lstart / 2) * NV; i += kThreads) {
    T* o = proj_out<P>(out0, out1, (i / FT) % 2, i / NV, m, f0 + i % FT, L, M,
                       fs);
    if (o != nullptr) *o = T(0);
  }

  for (int r0 = 0; r0 < R; r0 += RT) {  // ring chunks, in order
    typename P::Column rc;
    rc.template init<RT>(tb, m, r0, M, R, lstart);
    T s[NSRC][CPT][FT];
#pragma unroll
    for (int sx = 0; sx < NSRC; ++sx)
#pragma unroll
      for (int i = 0; i < CPT; ++i) {
        const int r = r0 + tid + i * kThreads;
        const T* p = (sx ? src1 : src0) + ((size_t)r * M + m) * fs + f0;
#pragma unroll
        for (int f = 0; f < FT; ++f)
          s[sx][i][f] = (r < R && f0 + f < fs) ? p[f] : T(0);
      }

    __syncthreads();  // the previous chunk's s_rec and s_red are consumed
    P::load_rows(s_rec, tb, lstart, m, L, M);
    P::load_rows(s_rec + REC, tb, lstart + LB, m, L, M);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();

    for (int st = 0; st < nsteps; ++st) {
      const int lb = lstart + st * LB;
      if (st + 2 < nsteps)
        P::load_rows(s_rec + ((st + 2) % kProjNS) * REC, tb, lb + 2 * LB, m, L,
                     M);
      cp_async_commit();
      rc.begin(tb, lb, st == 0);
      const T* slot = s_rec + (st % kProjNS) * REC;
      for (int p = 0; p < NJ; ++p) {
        T o[2][CPT];
        rc.pair(tb, lb + 2 * p, slot, p, o[0], o[1]);
        T v[NV];
#pragma unroll
        for (int q = 0; q < 2; ++q)
#pragma unroll
          for (int f = 0; f < FT; ++f) {
            T acc = o[q][0] * s[q % NSRC][0][f];
#pragma unroll
            for (int i = 1; i < CPT; ++i)
              acc = fma(o[q][i], s[q % NSRC][i][f], acc);
            v[q * FT + f] = acc;
          }
        warp_sums<NV>(v, lane);
        if (lane % (32 / NV) == 0) s_red[w][p][lane / (32 / NV)] = v[0];
      }
      cp_async_wait<0>();
      __syncthreads();

      // warp sums in order, into the output this block alone owns
      for (int i = tid; i < NJ * NV; i += kThreads) {
        const int p = i / NV, q = i % NV;
        T sum = s_red[0][p][q];
#pragma unroll
        for (int ww = 1; ww < NW; ++ww) sum += s_red[ww][p][q];
        T* o = proj_out<P>(out0, out1, q / FT, lb / 2 + p, m, f0 + q % FT, L,
                           M, fs);
        if (o != nullptr) *o = r0 == 0 ? sum : *o + sum;
      }
      __syncthreads();
    }
  }
}

template <class P, int FT>
cudaError_t launch_project_small(const typename P::Tables& tb,
                                 const void* src0, const void* src1,
                                 void* out0, void* out1, int L, int M, int R,
                                 int fs, cudaStream_t stream) {
  using T = typename P::T;
  const dim3 grid(M, (fs + FT - 1) / FT);
  project_small_kernel<P, FT><<<grid, kThreads, 0, stream>>>(
      tb, (const T*)src0, (const T*)src1, (T*)out0, (T*)out1, L, M, R, fs);
  return cudaGetLastError();
}

}  // namespace cora
