// Fused scaled-Legendre recurrence + projection (the analysis adjoint of
// the scan-mode SHT).
//
// Replaces the TPU kernel cora_tpu/ops/pallas_scan_legendre.py
// `scan_project_fused` (kernel body `_adj_kernel`).  Same function, same
// layout at the wrapper (cora_tpu_torch/ops/scan_legendre.py):
//
//   rec_a, rec_b [L, M]     recurrence rows a_lm, b_lm
//   seed_T, k0_T [M, R]     pre-scaled λ_mm seeds and their 2^S scale counts
//   z            [R]        cosθ of the northern rings
//   ck_T [nband, 2, M, R]   checkpoint rows (λ_{l0-2}, λ_{l0-1}) per band
//   src0, src1 [F2, R, M]   sources of the even-ℓ / odd-ℓ rows
//   alm0, alm1 [F2, L/2, M] alm0[f,j,m] = Σ_r λ_{2j}[m,r]·src0[f,r,m],
//                           alm1 likewise over odd rows; zeroed by the
//                           caller, accumulated here
//
// The λ recurrence is that of scan_legendre.cu (K1): seed and scale count
// injected at ℓ = m, a row emitted only where k == 0, one 2^-S rescale per
// row pair, re-seed from checkpoint rows at band starts.  λ never leaves
// registers.  Two instantiations, as K1's: float (S=60, β=30) and double
// (S=512, β=256).
//
// What bounds it on an H100: per (f, ℓ, ring, m) one FMA and ~6
// instructions of recurrence per (ℓ, ring, m) and plane tile, plus the
// cross-lane reduction, all on the CUDA cores; sources are read once per
// block and alm written once, so it is bound by instruction issue in f32
// and by the f64 FMA rate in double.
//
// Design, against what the TPU version relied on:
//  * The Pallas kernel made rings the innermost (sequential) grid axis,
//    kept one recurrence carry per ring tile in VMEM and accumulated each
//    output block across ring tiles.  Blocks on Hopper run in no order, so
//    here one block owns all the rings of one m (for kFT planes): the ring
//    sum is finished inside the block, with no atomics and a fixed order,
//    so the output is the same from run to run.
//  * Each thread carries the recurrence for RPT rings (4 in f32, 2 in
//    f64, so the double sources stay in registers) and holds their
//    sources for both row parities in registers (they do not depend on ℓ).
//    Per row pair it sums its rings' products (2·kFT values), then a
//    transpose-reduction across the warp (each shuffle step halves the
//    values a lane keeps) leaves lane pair (2q, 2q+1) with value q summed
//    over the warp's 32 lanes: 16 shuffles for 16 values.  The warps'
//    sums go to shared memory and are added in warp order once per
//    ℓ-block of kPB row pairs.
//  * More rings than the block's threads·RPT are walked in chunks, in
//    order, each adding into the output.  Rows below the first pair that
//    holds m are skipped (λ is zero there and leaves the carry at zero).
//  * Plain FMA on the CUDA cores: no tensor cores, no TF32.

#include <cuda_runtime.h>
#include <climits>
#include <cstddef>

namespace {

constexpr int kMaxWarps = 8;
constexpr int kMaxThreads = kMaxWarps * 32;
constexpr int kFT = 8;                    // planes per block
constexpr int kNV = 2 * kFT;              // values per row pair (even, odd)
constexpr int kPB = 16;                   // row pairs per ℓ-block

// Scaling constants, rings per thread and blocks per SM per real type.
template <typename T> struct Proj;
template <> struct Proj<float> {
  static constexpr int RPT = 4;
  static constexpr int min_blocks = 2;
  static constexpr float thresh = 0x1p30f;
  static constexpr float down = 0x1p-60f;
  static constexpr float ck_use = 0x1p-20f;
};
template <> struct Proj<double> {
  static constexpr int RPT = 2;
  static constexpr int min_blocks = 1;
  static constexpr double thresh = 0x1p256;
  static constexpr double down = 0x1p-512;
  static constexpr double ck_use = 0x1p-20;
};

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

template <typename T>
__global__ void __launch_bounds__(kMaxThreads, Proj<T>::min_blocks)
scan_project_kernel(const T* __restrict__ rec_a,
                    const T* __restrict__ rec_b,
                    const T* __restrict__ seed_T,
                    const T* __restrict__ k0_T,
                    const T* __restrict__ z,
                    const T* __restrict__ ck_T, int nband,
                    const T* __restrict__ src0,
                    const T* __restrict__ src1,
                    T* __restrict__ alm0, T* __restrict__ alm1,
                    int L, int M, int R, int F2, int band_rows) {
  constexpr int kRPT = Proj<T>::RPT;
  __shared__ T s_red[kMaxWarps][kPB][kNV];
  __shared__ T s_rec[2][2 * kPB];

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
    T zr[kRPT], lp[kRPT], lpp[kRPT], k[kRPT];
    T s0[kRPT][kFT], s1[kRPT][kFT];
#pragma unroll
    for (int i = 0; i < kRPT; ++i) {
      rr[i] = rc + i * nthr + tid;
      const bool live = rr[i] < R;
      zr[i] = live ? z[rr[i]] : T(0);
      lp[i] = 0;
      lpp[i] = 0;
      k[i] = 0;
#pragma unroll
      for (int f = 0; f < kFT; ++f) {
        const bool ok = live && (f0 + f < F2);
        const size_t o = ((size_t)(f0 + f) * R + rr[i]) * M + m;
        s0[i][f] = ok ? src0[o] : T(0);
        s1[i][f] = ok ? src1[o] : T(0);
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
            gl < L ? (i < 2 * kPB ? rec_a : rec_b)[(size_t)gl * M + m] : T(0);
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
                const T c0 = ck_T[off];
                const T c1 = ck_T[off + MR];
                if (fabs(c0) > Proj<T>::ck_use && fabs(c1) > Proj<T>::ck_use) {
                  lpp[i] = c0;
                  lp[i] = c1;
                  k[i] = 0;
                }
              }
            }
          }
          next_ck += band_rows;
        }

        T v[kNV];
#pragma unroll
        for (int par = 0; par < 2; ++par) {
          const int row = l + par;
          const T a = s_rec[0][2 * p + par];
          const T bb = s_rec[1][2 * p + par];
          T out[kRPT];
#pragma unroll
          for (int i = 0; i < kRPT; ++i) {
            T lam = a * (zr[i] * lp[i]) + bb * lpp[i];
            if (m == row) {  // block-uniform: seed row of this m
              const bool live = rr[i] < R;
              lam = live ? seed_T[(size_t)m * R + rr[i]] : T(0);
              k[i] = live ? k0_T[(size_t)m * R + rr[i]] : T(1);
            }
            out[i] = (k[i] == 0) ? lam : T(0);
            lpp[i] = lp[i];
            lp[i] = lam;
          }
#pragma unroll
          for (int f = 0; f < kFT; ++f) {  // par is a constant once unrolled
            T acc = out[0] * (par ? s1[0][f] : s0[0][f]);
#pragma unroll
            for (int i = 1; i < kRPT; ++i)
              acc = fma(out[i], par ? s1[i][f] : s0[i][f], acc);
            v[par * kFT + f] = acc;
          }
        }
        // rescale once per row pair
#pragma unroll
        for (int i = 0; i < kRPT; ++i) {
          if (fabs(lp[i]) > Proj<T>::thresh && k[i] > 0) {
            lp[i] *= Proj<T>::down;
            lpp[i] *= Proj<T>::down;
            k[i] -= 1;
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
          T s = s_red[0][p][q];
          for (int ww = 1; ww < nw; ++ww) s += s_red[ww][p][q];
          T* o = (q < kFT ? alm0 : alm1) +
                     ((size_t)(f0 + f) * Lh + lb0 / 2 + p) * M + m;
          *o += s;
        }
      }
    }
  }
}

template <typename T>
int launch(const void* rec_a, const void* rec_b, const void* seed_T,
           const void* k0_T, const void* z, const void* ck_T, int nband,
           const void* src0, const void* src1, void* alm0, void* alm1, int L,
           int M, int R, int F2, int band_rows, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (L <= 0 || M <= 0 || R <= 0 || F2 <= 0) return 0;
  constexpr int kRPT = Proj<T>::RPT;
  int threads = ((R + kRPT - 1) / kRPT + 31) / 32 * 32;
  if (threads > kMaxThreads) threads = kMaxThreads;
  const dim3 grid(M, (F2 + kFT - 1) / kFT);
  scan_project_kernel<T><<<grid, threads, 0, (cudaStream_t)stream>>>(
      (const T*)rec_a, (const T*)rec_b, (const T*)seed_T, (const T*)k0_T,
      (const T*)z, (const T*)ck_T, nband, (const T*)src0, (const T*)src1,
      (T*)alm0, (T*)alm1, L, M, R, F2, band_rows);
  return (int)cudaGetLastError();
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
  return launch<float>(rec_a, rec_b, seed_T, k0_T, z, ck_T, nband, src0,
                       src1, alm0, alm1, L, M, R, F2, band_rows, device,
                       stream);
}

// The same on double tables (S=512, β=256) and sources.
int cora_scan_project_f64(const void* rec_a, const void* rec_b,
                          const void* seed_T, const void* k0_T,
                          const void* z, const void* ck_T, int nband,
                          const void* src0, const void* src1, void* alm0,
                          void* alm1, int L, int M, int R, int F2,
                          int band_rows, int device, void* stream) {
  return launch<double>(rec_a, rec_b, seed_T, k0_T, z, ck_T, nband, src0,
                        src1, alm0, alm1, L, M, R, F2, band_rows, device,
                        stream);
}

}  // extern "C"
