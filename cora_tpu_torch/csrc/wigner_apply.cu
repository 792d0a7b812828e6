// Fused Wigner-d recurrence + contraction (synthesis) and projection
// (adjoint) for the spin-weighted SHT.
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
//                                           (zeroed by the caller)
//
// d_ℓ = A_ℓ(z − B_ℓ)·d_{ℓ−1} + C_ℓ·d_{ℓ−2}, seeded at ℓ = l0 with no
// power-of-two rescaling (a seed below the type's range stays what the
// cast made it, as in the reference), and the emitted row is
// λ_ℓ = d_ℓ·(√((2ℓ+1)·(1/4π))·(−1)^m), the norm computed in the kernel's
// type as the Pallas kernel does.  Rows ℓ < l0 are exactly zero (their
// coefficients are zero and the carry starts at zero), so a block skips
// the ℓ-blocks that lie wholly before its first m.  Every ℓ is contracted
// on the northern rings (no ℓ-parity split: twice K1's rows per ring).
// Instantiated for float and double.
//
// What bounds it on an H100: per (f, ℓ, ring, m) one FMA, plus ~6
// instructions of recurrence per (ℓ, ring, m) and plane tile, on the CUDA
// cores; planes are read once per tile and written once.  Issue-bound in
// f32, bound by the f64 FMA rate in double.
//
// Design, against what the TPU version relied on:
//  * Synthesis takes K1's layout: one warp per m, one lane per ring, the
//    carry in registers, FT planes per block as a grid axis (16 in f32, 8
//    in f64); the TPU's sequential ℓ grid axis becomes a loop inside the
//    block.  The x rows of a 32-row ℓ-block are staged in shared memory as
//    [row][m][f], so each vector read is a broadcast within the warp; a
//    fresh partial sum per ℓ-block keeps the f32 error near that of the
//    blocked plain version.
//  * The adjoint takes K2's layout: the ring sum is the reduction, so one
//    block owns all rings of one m (for 8 planes), each thread carries 4
//    rings, and rows go in pairs (ℓ, ℓ+1) so 16 values a step leave a warp
//    through K2's transpose-reduction; warp sums are added in warp order,
//    with no atomics, so the output is the same from run to run.  An odd L
//    leaves the last pair with one row, which is never written.
//  * The recurrence and the norm use explicitly rounded operations
//    (no FMA contraction), in the plain version's order:
//    ((A·(z − B))·d_{ℓ−1}) + (C·d_{ℓ−2}), then d_ℓ·(norm·sign).  Seeds in
//    the subnormal range lose bits at every step and the rows then grow
//    by many orders of magnitude, so any other rounding would be amplified
//    into visible differences; this way the kernel's λ rows are the plain
//    version's, bit for bit.  Built without fast-math, so subnormals are
//    kept as the plain version keeps them.  The contractions are plain FMA
//    on the CUDA cores: no tensor cores, no TF32.

#include <cuda_runtime.h>
#include <cstddef>

namespace {

constexpr int kWarps = 8;              // synthesis: m values per block
constexpr int kThreads = kWarps * 32;  // synthesis: one lane per ring
constexpr int kLB = 32;                // synthesis: ℓ rows staged per step
constexpr int kMaxWarps = 8;           // adjoint: warps per block, at most
constexpr int kMaxThreads = kMaxWarps * 32;
constexpr int kRPT = 4;                // adjoint: rings per thread
constexpr int kPFT = 8;                // adjoint: planes per block
constexpr int kNV = 2 * kPFT;          // adjoint: values per row pair
constexpr int kPB = 16;                // adjoint: row pairs per ℓ-block

template <typename T> struct Wig;
template <> struct Wig<float> {
  static constexpr int FT = 16;        // synthesis planes per block
  static constexpr int min_blocks = 2;
};
template <> struct Wig<double> {
  static constexpr int FT = 8;
  static constexpr int min_blocks = 1;
};

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

template <int FT>
__device__ __forceinline__ void fma_row(float* acc, const float* row,
                                        float out) {
  const float4* r4 = reinterpret_cast<const float4*>(row);
#pragma unroll
  for (int q = 0; q < FT / 4; ++q) {
    const float4 v = r4[q];
    acc[4 * q + 0] = fmaf(out, v.x, acc[4 * q + 0]);
    acc[4 * q + 1] = fmaf(out, v.y, acc[4 * q + 1]);
    acc[4 * q + 2] = fmaf(out, v.z, acc[4 * q + 2]);
    acc[4 * q + 3] = fmaf(out, v.w, acc[4 * q + 3]);
  }
}

template <int FT>
__device__ __forceinline__ void fma_row(double* acc, const double* row,
                                        double out) {
  const double2* r2 = reinterpret_cast<const double2*>(row);
#pragma unroll
  for (int q = 0; q < FT / 2; ++q) {
    const double2 v = r2[q];
    acc[2 * q + 0] = fma(out, v.x, acc[2 * q + 0]);
    acc[2 * q + 1] = fma(out, v.y, acc[2 * q + 1]);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
wigner_contract_kernel(const T* __restrict__ coefs,
                       const T* __restrict__ seed_T,
                       const int* __restrict__ l0,
                       const T* __restrict__ z,
                       const T* __restrict__ x, T* __restrict__ g,
                       int L, int M, int R, int F2) {
  constexpr int FT = Wig<T>::FT;
  __shared__ __align__(16) T s_x[kLB][kWarps][FT];
  __shared__ T s_c[3][kLB][kWarps];
  __shared__ T s_n[kLB];

  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int r = blockIdx.x * 32 + lane;
  const int m0 = blockIdx.y * kWarps;
  const int m = m0 + w;
  const int f0 = blockIdx.z * FT;
  const bool live = (r < R) && (m < M);
  const size_t LM = (size_t)L * M;

  T zr = 0, seed = 0;
  if (live) {
    zr = z[r];
    seed = seed_T[(size_t)m * R + r];
  }
  const int lseed = m < M ? l0[m] : -1;
  const T sgn = (m & 1) ? T(-1) : T(1);

  T acc[FT];
#pragma unroll
  for (int f = 0; f < FT; ++f) acc[f] = 0;
  T lp = 0, lpp = 0;

  for (int lb0 = (m0 / kLB) * kLB; lb0 < L; lb0 += kLB) {
    __syncthreads();
    for (int i = threadIdx.x; i < kLB * FT * kWarps; i += kThreads) {
      const int mm = i % kWarps;
      const int t = i / kWarps;
      const int f = t % FT;
      const int row = t / FT;
      const int gm = m0 + mm, gf = f0 + f, gl = lb0 + row;
      T v = 0;
      if (gm < M && gf < F2 && gl < L) v = x[(size_t)gf * LM + (size_t)gl * M + gm];
      s_x[row][mm][f] = v;
    }
    for (int i = threadIdx.x; i < 3 * kLB * kWarps; i += kThreads) {
      const int mm = i % kWarps;
      const int row = (i / kWarps) % kLB;
      const int c = i / (kWarps * kLB);
      const int gm = m0 + mm, gl = lb0 + row;
      s_c[c][row][mm] =
          (gm < M && gl < L) ? coefs[(size_t)c * LM + (size_t)gl * M + gm] : T(0);
    }
    if (threadIdx.x < kLB) s_n[threadIdx.x] = row_norm<T>(lb0 + threadIdx.x);
    __syncthreads();

    T part[FT];
#pragma unroll
    for (int f = 0; f < FT; ++f) part[f] = 0;
    const int nrow = min(kLB, L - lb0);
    for (int j = 0; j < nrow; ++j) {
      T lam = wig_step(s_c[0][j][w], s_c[1][j][w], s_c[2][j][w], zr, lp, lpp);
      if (lb0 + j == lseed) lam = seed;
      lpp = lp;
      lp = lam;
      fma_row<FT>(part, s_x[j][w], mul_rn(lam, s_n[j] * sgn));
    }
#pragma unroll
    for (int f = 0; f < FT; ++f) acc[f] += part[f];
  }

  if (live) {
#pragma unroll
    for (int f = 0; f < FT; ++f)
      if (f0 + f < F2) g[((size_t)(f0 + f) * R + r) * M + m] = acc[f];
  }
}

// One transpose-reduction step (K2's): lanes whose `off` bit is set keep
// the upper half of v, the others the lower half; each adds its partner's.
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
__global__ void __launch_bounds__(kMaxThreads, Wig<T>::min_blocks)
wigner_project_kernel(const T* __restrict__ coefs,
                      const T* __restrict__ seed_T,
                      const int* __restrict__ l0,
                      const T* __restrict__ z,
                      const T* __restrict__ src, T* __restrict__ alm,
                      int L, int M, int R, int F2) {
  __shared__ T s_red[kMaxWarps][kPB][kNV];
  __shared__ T s_c[3][2 * kPB];
  __shared__ T s_n[2 * kPB];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int w = tid >> 5;
  const int nthr = blockDim.x;
  const int nw = nthr >> 5;
  const int m = blockIdx.x;
  const int f0 = blockIdx.y * kPFT;
  const size_t LM = (size_t)L * M;
  const int lseed = l0[m];
  if (lseed < 0) return;  // no seed row: every output row stays zero
  const int lstart = lseed & ~1;  // first row pair holding the seed row
  const T sgn = (m & 1) ? T(-1) : T(1);

  for (int rc = 0; rc < R; rc += nthr * kRPT) {  // ring chunks, in order
    int rr[kRPT];
    T zr[kRPT], lp[kRPT], lpp[kRPT];
    T s[kRPT][kPFT];
#pragma unroll
    for (int i = 0; i < kRPT; ++i) {
      rr[i] = rc + i * nthr + tid;
      const bool live = rr[i] < R;
      zr[i] = live ? z[rr[i]] : T(0);
      lp[i] = 0;
      lpp[i] = 0;
#pragma unroll
      for (int f = 0; f < kPFT; ++f) {
        const bool ok = live && (f0 + f < F2);
        s[i][f] = ok ? src[((size_t)(f0 + f) * R + rr[i]) * M + m] : T(0);
      }
    }

    for (int lb0 = lstart; lb0 < L; lb0 += 2 * kPB) {
      __syncthreads();  // the previous ℓ-block's s_red / s_c are consumed
      for (int i = tid; i < 3 * 2 * kPB; i += nthr) {
        const int row = i % (2 * kPB);
        const int gl = lb0 + row;
        s_c[i / (2 * kPB)][row] =
            gl < L ? coefs[(size_t)(i / (2 * kPB)) * LM + (size_t)gl * M + m]
                   : T(0);
      }
      if (tid < 2 * kPB) s_n[tid] = row_norm<T>(lb0 + tid);
      __syncthreads();

      const int npair = min(kPB, (L - lb0 + 1) / 2);
      for (int p = 0; p < npair; ++p) {
        T v[kNV];
#pragma unroll
        for (int par = 0; par < 2; ++par) {
          const int j = 2 * p + par;
          const T a = s_c[0][j], b = s_c[1][j], c = s_c[2][j];
          const T ns = s_n[j] * sgn;
          T out[kRPT];
#pragma unroll
          for (int i = 0; i < kRPT; ++i) {
            T lam = wig_step(a, b, c, zr[i], lp[i], lpp[i]);
            if (lb0 + j == lseed)  // block-uniform: the seed row of this m
              lam = rr[i] < R ? seed_T[(size_t)m * R + rr[i]] : T(0);
            lpp[i] = lp[i];
            lp[i] = lam;
            out[i] = mul_rn(lam, ns);
          }
#pragma unroll
          for (int f = 0; f < kPFT; ++f) {
            T acc = out[0] * s[0][f];
#pragma unroll
            for (int i = 1; i < kRPT; ++i) acc = fma(out[i], s[i][f], acc);
            v[par * kPFT + f] = acc;
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
        const int f = q % kPFT;
        const int row = lb0 + 2 * p + q / kPFT;
        if (f0 + f < F2 && row < L) {
          T sum = s_red[0][p][q];
          for (int ww = 1; ww < nw; ++ww) sum += s_red[ww][p][q];
          alm[(size_t)(f0 + f) * LM + (size_t)row * M + m] += sum;
        }
      }
    }
  }
}

template <typename T>
int launch_contract(const void* coefs, const void* seed_T, const void* l0,
                    const void* z, const void* x, void* g, int L, int M,
                    int R, int F2, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (L <= 0 || M <= 0 || R <= 0 || F2 <= 0) return 0;
  constexpr int FT = Wig<T>::FT;
  const dim3 grid((R + 31) / 32, (M + kWarps - 1) / kWarps,
                  (F2 + FT - 1) / FT);
  wigner_contract_kernel<T><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const T*)coefs, (const T*)seed_T, (const int*)l0, (const T*)z,
      (const T*)x, (T*)g, L, M, R, F2);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_project(const void* coefs, const void* seed_T, const void* l0,
                   const void* z, const void* src, void* alm, int L, int M,
                   int R, int F2, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (L <= 0 || M <= 0 || R <= 0 || F2 <= 0) return 0;
  int threads = ((R + kRPT - 1) / kRPT + 31) / 32 * 32;
  if (threads > kMaxThreads) threads = kMaxThreads;
  const dim3 grid(M, (F2 + kPFT - 1) / kPFT);
  wigner_project_kernel<T><<<grid, threads, 0, (cudaStream_t)stream>>>(
      (const T*)coefs, (const T*)seed_T, (const int*)l0, (const T*)z,
      (const T*)src, (T*)alm, L, M, R, F2);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Each entry point launches on `stream` (a cudaStream_t) of device
// `device` and returns the cudaError_t of the launch (0 on success).  The
// caller owns all buffers and zeroes the adjoint's output.
int cora_wigner_contract(const void* coefs, const void* seed_T,
                         const void* l0, const void* z, const void* x,
                         void* g, int L, int M, int R, int F2, int device,
                         void* stream) {
  return launch_contract<float>(coefs, seed_T, l0, z, x, g, L, M, R, F2,
                                device, stream);
}

int cora_wigner_contract_f64(const void* coefs, const void* seed_T,
                             const void* l0, const void* z, const void* x,
                             void* g, int L, int M, int R, int F2, int device,
                             void* stream) {
  return launch_contract<double>(coefs, seed_T, l0, z, x, g, L, M, R, F2,
                                 device, stream);
}

int cora_wigner_project(const void* coefs, const void* seed_T,
                        const void* l0, const void* z, const void* src,
                        void* alm, int L, int M, int R, int F2, int device,
                        void* stream) {
  return launch_project<float>(coefs, seed_T, l0, z, src, alm, L, M, R, F2,
                               device, stream);
}

int cora_wigner_project_f64(const void* coefs, const void* seed_T,
                            const void* l0, const void* z, const void* src,
                            void* alm, int L, int M, int R, int F2,
                            int device, void* stream) {
  return launch_project<double>(coefs, seed_T, l0, z, src, alm, L, M, R, F2,
                                device, stream);
}

}  // extern "C"
