// Fused scaled-Legendre recurrence + projection (the analysis adjoint of
// the scan-mode SHT).
//
// Replaces the TPU kernel cora_tpu/ops/pallas_scan_legendre.py
// `scan_project_fused` (kernel body `_adj_kernel`).  Same function, same
// layout at the wrapper (cora_tpu_torch/ops/scan_legendre.py):
//
//   rec_a, rec_b [L, M]     recurrence rows a_lm, b_lm
//   seed_T, k0_T [M, R]     pre-scaled λ_mm seeds and their 2^60 scale counts
//   z            [R]        cosθ of the northern rings
//   ck_T [nband, 2, M, R]   checkpoint rows (λ_{l0-2}, λ_{l0-1}) per band
//   src0, src1 [F2, R, M]   sources of the even-ℓ / odd-ℓ rows
//   alm0, alm1 [F2, L/2, M] alm0[f,j,m] = Σ_r λ_{2j}[m,r]·src0[f,r,m],
//                           alm1 likewise over odd rows; zeroed by the
//                           caller, accumulated here
//
// The λ recurrence is that of scan_legendre.cu (K1): seed and scale count
// injected at ℓ = m, a row emitted only where k == 0, one 2^-60 rescale per
// row pair, re-seed from checkpoint rows at band starts.  λ never leaves
// registers.
//
// What bounds it on an H100: per (f, ℓ, ring, m) one FMA and ~6
// instructions of recurrence per (ℓ, ring, m) and plane tile, plus the
// cross-lane reduction, all f32 on the CUDA cores; sources are read once
// per block and alm written once, so it is bound by instruction issue.
//
// Design, against what the TPU version relied on:
//  * The Pallas kernel made rings the innermost (sequential) grid axis,
//    kept one recurrence carry per ring tile in VMEM and accumulated each
//    output block across ring tiles.  Blocks on Hopper run in no order, so
//    here one block owns all the rings of one m (for kFT planes): the ring
//    sum is finished inside the block, with no atomics and a fixed order,
//    so the output is the same from run to run.
//  * Each thread carries the recurrence for kRPT rings and holds their
//    sources for both row parities in registers (they do not depend on ℓ).
//    Per row pair it sums its rings' products (2·kFT values), then a
//    transpose-reduction across the warp (each shuffle step halves the
//    values a lane keeps) leaves lane pair (2q, 2q+1) with value q summed
//    over the warp's 32 lanes: 16 shuffles for 16 values.  The warps'
//    sums go to shared memory and are added in warp order once per
//    ℓ-block of kPB row pairs.
//  * More rings than the block's threads·kRPT are walked in chunks, in
//    order, each adding into the output.  Rows below the first pair that
//    holds m are skipped (λ is zero there and leaves the carry at zero).
//  * Pure f32 FMA: no tensor cores, no TF32.

#include <cuda_runtime.h>
#include <climits>
#include <cstddef>

namespace {

constexpr int kRPT = 4;                   // rings per thread
constexpr int kMaxWarps = 8;
constexpr int kMaxThreads = kMaxWarps * 32;
constexpr int kFT = 8;                    // planes per block
constexpr int kNV = 2 * kFT;              // values per row pair (even, odd)
constexpr int kPB = 16;                   // row pairs per ℓ-block

constexpr float kThresh = 1073741824.0f;           // 2^30
constexpr float kDown = 8.6736173798840355e-19f;   // 2^-60
constexpr float kCkUse = 9.5367431640625e-07f;     // 2^-20

// One transpose-reduction step: lanes whose `off` bit is set keep the upper
// half of v, the others the lower half; each adds its partner's copy.
template <int N>
__device__ __forceinline__ void fold(float* v, int lane, int off) {
  const bool hi = (lane & off) != 0;
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    const float send = hi ? v[i] : v[i + N / 2];
    const float keep = hi ? v[i + N / 2] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, off);
  }
}

__global__ void __launch_bounds__(kMaxThreads, 2)
scan_project_kernel(const float* __restrict__ rec_a,
                    const float* __restrict__ rec_b,
                    const float* __restrict__ seed_T,
                    const float* __restrict__ k0_T,
                    const float* __restrict__ z,
                    const float* __restrict__ ck_T, int nband,
                    const float* __restrict__ src0,
                    const float* __restrict__ src1,
                    float* __restrict__ alm0, float* __restrict__ alm1,
                    int L, int M, int R, int F2, int band_rows) {
  __shared__ float s_red[kMaxWarps][kPB][kNV];
  __shared__ float s_rec[2][2 * kPB];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int w = tid >> 5;
  const int nthr = blockDim.x;
  const int nw = nthr >> 5;
  const int m = blockIdx.x;
  const int f0 = blockIdx.y * kFT;
  const int Lh = L / 2;
  const size_t MR = (size_t)M * R;
  const int lstart = m & ~1;  // first row pair holding ℓ = m

  for (int rc = 0; rc < R; rc += nthr * kRPT) {  // ring chunks, in order
    int rr[kRPT];
    float zr[kRPT], lp[kRPT], lpp[kRPT], k[kRPT];
    float s0[kRPT][kFT], s1[kRPT][kFT];
#pragma unroll
    for (int i = 0; i < kRPT; ++i) {
      rr[i] = rc + i * nthr + tid;
      const bool live = rr[i] < R;
      zr[i] = live ? z[rr[i]] : 0.f;
      lp[i] = 0.f;
      lpp[i] = 0.f;
      k[i] = 0.f;
#pragma unroll
      for (int f = 0; f < kFT; ++f) {
        const bool ok = live && (f0 + f < F2);
        const size_t o = ((size_t)(f0 + f) * R + rr[i]) * M + m;
        s0[i][f] = ok ? src0[o] : 0.f;
        s1[i][f] = ok ? src1[o] : 0.f;
      }
    }

    int next_ck = INT_MAX;
    if (nband > 1) {
      next_ck = ((lstart + band_rows - 1) / band_rows) * band_rows;
      if (next_ck < band_rows) next_ck = band_rows;
    }

    for (int lb0 = lstart; lb0 < L; lb0 += 2 * kPB) {
      __syncthreads();  // the previous ℓ-block's s_red / s_rec are consumed
      for (int i = tid; i < 4 * kPB; i += nthr) {
        const int row = i % (2 * kPB);
        const int gl = lb0 + row;
        s_rec[i / (2 * kPB)][row] =
            gl < L ? (i < 2 * kPB ? rec_a : rec_b)[(size_t)gl * M + m] : 0.f;
      }
      __syncthreads();

      const int npair = min(kPB, (L - lb0) / 2);
      for (int p = 0; p < npair; ++p) {
        const int l = lb0 + 2 * p;
        if (l == next_ck) {  // band start: restart from checkpoint rows
          const int b = l / band_rows;
          if (b < nband) {
#pragma unroll
            for (int i = 0; i < kRPT; ++i) {
              if (rr[i] < R) {
                const size_t off = (size_t)b * 2 * MR + (size_t)m * R + rr[i];
                const float c0 = ck_T[off];
                const float c1 = ck_T[off + MR];
                if (fabsf(c0) > kCkUse && fabsf(c1) > kCkUse) {
                  lpp[i] = c0;
                  lp[i] = c1;
                  k[i] = 0.f;
                }
              }
            }
          }
          next_ck += band_rows;
        }

        float v[kNV];
#pragma unroll
        for (int par = 0; par < 2; ++par) {
          const int row = l + par;
          const float a = s_rec[0][2 * p + par];
          const float bb = s_rec[1][2 * p + par];
          float out[kRPT];
#pragma unroll
          for (int i = 0; i < kRPT; ++i) {
            float lam = a * (zr[i] * lp[i]) + bb * lpp[i];
            if (m == row) {  // block-uniform: seed row of this m
              const bool live = rr[i] < R;
              lam = live ? seed_T[(size_t)m * R + rr[i]] : 0.f;
              k[i] = live ? k0_T[(size_t)m * R + rr[i]] : 1.f;
            }
            out[i] = (k[i] == 0.f) ? lam : 0.f;
            lpp[i] = lp[i];
            lp[i] = lam;
          }
#pragma unroll
          for (int f = 0; f < kFT; ++f) {  // par is a constant once unrolled
            float acc = out[0] * (par ? s1[0][f] : s0[0][f]);
#pragma unroll
            for (int i = 1; i < kRPT; ++i)
              acc = fmaf(out[i], par ? s1[i][f] : s0[i][f], acc);
            v[par * kFT + f] = acc;
          }
        }
        // rescale once per row pair
#pragma unroll
        for (int i = 0; i < kRPT; ++i) {
          if (fabsf(lp[i]) > kThresh && k[i] > 0.f) {
            lp[i] *= kDown;
            lpp[i] *= kDown;
            k[i] -= 1.f;
          }
        }

        fold<16>(v, lane, 16);
        fold<8>(v, lane, 8);
        fold<4>(v, lane, 4);
        fold<2>(v, lane, 2);
        v[0] += __shfl_xor_sync(0xffffffffu, v[0], 1);
        if ((lane & 1) == 0) s_red[w][p][lane >> 1] = v[0];
      }
      __syncthreads();

      // warp sums in order, added into the output this block alone owns
      for (int i = tid; i < npair * kNV; i += nthr) {
        const int p = i / kNV;
        const int q = i % kNV;
        const int f = q % kFT;
        if (f0 + f < F2) {
          float s = s_red[0][p][q];
          for (int ww = 1; ww < nw; ++ww) s += s_red[ww][p][q];
          float* o = (q < kFT ? alm0 : alm1) +
                     ((size_t)(f0 + f) * Lh + lb0 / 2 + p) * M + m;
          *o += s;
        }
      }
    }
  }
}

}  // namespace

extern "C" {

// Launch on `stream` (a cudaStream_t) of device `device`; returns the
// cudaError_t of the launch (0 on success).  The caller owns all buffers
// and zeroes alm0/alm1.  The signature is that of cora_scan_contract.
int cora_scan_project(const void* rec_a, const void* rec_b,
                      const void* seed_T, const void* k0_T, const void* z,
                      const void* ck_T, int nband, const void* src0,
                      const void* src1, void* alm0, void* alm1, int L, int M,
                      int R, int F2, int band_rows, int device,
                      void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (L <= 0 || M <= 0 || R <= 0 || F2 <= 0) return 0;
  int threads = ((R + kRPT - 1) / kRPT + 31) / 32 * 32;
  if (threads > kMaxThreads) threads = kMaxThreads;
  const dim3 grid(M, (F2 + kFT - 1) / kFT);
  scan_project_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      (const float*)rec_a, (const float*)rec_b, (const float*)seed_T,
      (const float*)k0_T, (const float*)z, (const float*)ck_T, nband,
      (const float*)src0, (const float*)src1, (float*)alm0, (float*)alm1, L,
      M, R, F2, band_rows);
  return (int)cudaGetLastError();
}

}  // extern "C"
