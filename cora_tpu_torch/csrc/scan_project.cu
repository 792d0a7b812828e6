// Fused scaled-Legendre recurrence + projection (the analysis adjoint of
// the scan-mode SHT), K2.
//
// Replaces the TPU kernel cora_tpu/ops/pallas_scan_legendre.py
// `scan_project_fused` (kernel body `_adj_kernel`).  Same function at the
// wrapper (cora_tpu_torch/ops/scan_legendre.py):
//
//   rec_a, rec_b [L, M]     recurrence rows a_lm, b_lm
//   seed_T, k0_T [M, R]     pre-scaled λ_mm seeds and their 2^S scale counts
//   z            [R]        cosθ of the northern rings
//   ck_T [nband, 2, M, R]   checkpoint rows (λ_{l0-2}, λ_{l0-1}) per band
//   src0, src1 [F2, R, M]   sources of the even-ℓ / odd-ℓ rows, planes-minor
//                           storage [R, M, fs]
//   alm0, alm1 [F2, L/2, M] alm0[f,j,m] = Σ_r λ_{2j}[m,r]·src0[f,r,m],
//                           alm1 likewise over odd rows; planes-minor
//                           storage [L/2, M, fs], every element written
//
// The λ recurrence is K1's, from the header both include
// (scan_recurrence.cuh): seed and scale count injected at ℓ = m, a row
// emitted only where k == 0, one 2^-S rescale per row pair, re-seed from
// checkpoint rows at band starts.  Two instantiations, as K1's: float
// (S=60, β=30) and double (S=512, β=256).
//
// What bounds it on an H100: per (f, ℓ, ring, m ≤ ℓ) one multiply-add plus
// about 4 operations of recurrence per (ℓ, ring, m); the sources are read
// once and the alm written once, so it is bound by its arithmetic: at the
// flagship call (L=1536, R=1024, F2=32) 1.23 ms at 67 TFLOP/s in f32, in
// f64 (F2=64) 2.31 ms of tensor-core products.
//
// What limited the first design (one block per m and 8 planes, a lane per
// ring, the warp's ring sum by a transpose-reduction of 31 shuffles per row
// pair): 7.2 ms in f32 and 42 ms in f64 (chip_smoke.py, H100 80GB HBM3,
// 700 W).  The recurrence ran once per plane tile (4× at F2=32, 8× at
// F2=64), a tile of 2 planes cost as much as one of 8, and every output
// crossed the warp.
//
// This design (project_tiles.cuh): rings are the inner dimension of a tile
// product.  A block owns 2 m × 128 rings and all planes (32 in f32; 16 in
// f64, where both parities' sources must fit in shared memory), the λ rows
// pass through shared memory, threads own outputs, and the blocks of one m
// group — a thread-block cluster — add their partial sums in rank order
// through distributed shared memory.  No shuffle, no atomics, no zeroed
// output; f64 products on the tensor cores (DMMA).  At F2 ≤ 8 the few
// products do not pay for the λ tile and the cluster's barrier: there the
// first design's loop stays (project_small_kernel), with a tile of 4
// planes beside the one of 8.  A re-seed cadence that does not divide the
// step takes the per-pair check of K1 (kMid).  Same card, same call
// (chip_smoke.py's kernel phases on both trees): 5.05–5.07 ms in f32 (first
// design 7.12–7.20), 22.0–22.2 ms in f64 at L=1537, F2=64 (41.9–42.0), 1.43–
// 1.48 ms at F2=2 (1.68–1.76): 24% and 10% of the bounds.  What holds it
// back is in project_tiles.cuh.

#include <cuda_runtime.h>
#include <cstddef>
#include <cstdint>

#include "hopper_tiles.cuh"
#include "project_tiles.cuh"
#include "scan_recurrence.cuh"

namespace {

// The scan recurrence as project_tiles.cuh takes it: MT m values a block,
// CPT columns a thread.
template <typename Real, bool kMid, int MT_, int CPT_>
struct ScanProj {
  using T = Real;
  static constexpr bool kParity = true;
  static constexpr int MT = MT_, CPT = CPT_;
  static constexpr int LB = sizeof(T) == 4 ? 32 : 16;
  static constexpr int SLOT = 2 * LB * MT;  // [2][LB][MT]: a_lm then b_lm

  struct Tables {
    const T *rec_a, *rec_b, *seed_T, *k0_T, *z, *ck_T;
    int nband, band_rows;
  };

  static __device__ __forceinline__ void load_rows(T* slot, const Tables& tb,
                                                   int lb, int m0, int L,
                                                   int M) {
    cora::load_rec<T, MT, LB>(slot, tb.rec_a, tb.rec_b, lb, m0, L, M);
  }

  struct Column {
    cora::Recurrence<T, CPT> rc;
    int M, R;

    template <int RT>
    __device__ __forceinline__ void init(const Tables& tb, int m0, int r0,
                                         int M_, int R_, int lstart) {
      M = M_;
      R = R_;
      rc.template init<RT>(tb.seed_T, tb.k0_T, tb.z, m0, r0, M, R, tb.nband,
                           tb.band_rows, lstart);
    }

    // Before the rows of the step at lb are generated: fetch the checkpoint
    // rows of a band start a step ahead (inside the step with kMid), and
    // re-seed at lb when a band starts there.
    __device__ __forceinline__ void begin(const Tables& tb, int lb,
                                          bool first) {
      if (kMid) {
        rc.prefetch(tb.ck_T, tb.nband, tb.band_rows, lb, LB, M, R);
      } else {
        if (first) rc.prefetch(tb.ck_T, tb.nband, tb.band_rows, lb, LB, M, R);
        rc.start(tb.ck_T, tb.nband, tb.band_rows, M, R, lb);
        rc.prefetch(tb.ck_T, tb.nband, tb.band_rows, lb + LB, LB, M, R);
      }
    }

    __device__ __forceinline__ void pair(const Tables& tb, int l,
                                         const T* slot, int p, T (&o0)[CPT],
                                         T (&o1)[CPT]) {
      rc.template pair<kMid>(tb.ck_T, tb.nband, tb.band_rows, M, R, l,
                             slot + 2 * p * MT, slot + LB * MT + 2 * p * MT,
                             MT, o0, o1);
    }
  };
};

// F2 ≤ 8 takes project_small_kernel (FT = 4 or 8 planes a block; 4 rings a
// thread in f32, 2 in f64, where both parities' sources stay in registers),
// more planes project_kernel with a plane tile of FP.
template <typename T, bool kMid>
cudaError_t launch_mid(const void* rec_a, const void* rec_b,
                       const void* seed_T, const void* k0_T, const void* z,
                       const void* ck_T, int nband, const void* src0,
                       const void* src1, void* alm0, void* alm1, int L, int M,
                       int R, int F2, int band_rows, int fs,
                       cudaStream_t stream) {
  constexpr bool f64 = sizeof(T) == 8;
  using Small = ScanProj<T, true, 1, f64 ? 2 : 4>;  // steps start at any pair
  using Big = ScanProj<T, kMid, cora::kProjMT, 1>;
  const typename Small::Tables ts = {(const T*)rec_a, (const T*)rec_b,
                                     (const T*)seed_T, (const T*)k0_T,
                                     (const T*)z, (const T*)ck_T, nband,
                                     band_rows};
  if (F2 <= 4)
    return cora::launch_project_small<Small, 4>(ts, src0, src1, alm0, alm1, L,
                                                M, R, fs, stream);
  if (F2 <= 8)
    return cora::launch_project_small<Small, 8>(ts, src0, src1, alm0, alm1, L,
                                                M, R, fs, stream);
  const typename Big::Tables tb = {ts.rec_a, ts.rec_b, ts.seed_T, ts.k0_T,
                                   ts.z, ts.ck_T, nband, band_rows};
  return cora::launch_project_tile<Big, f64 ? 16 : 32>(tb, src0, src1, alm0,
                                                        alm1, L, M, R, fs,
                                                        stream);
}

template <typename T>
int launch(const void* rec_a, const void* rec_b, const void* seed_T,
           const void* k0_T, const void* z, const void* ck_T, int nband,
           const void* src0, const void* src1, void* alm0, void* alm1, int L,
           int M, int R, int F2, int band_rows, int fs, int device,
           void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (L <= 0 || M <= 0 || R <= 0 || F2 <= 0) return 0;
  if (fs < F2 || fs % (16 / (int)sizeof(T)) != 0 ||
      reinterpret_cast<uintptr_t>(src0) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(src1) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  // band starts inside a step need the per-pair check
  constexpr int LB = sizeof(T) == 4 ? 32 : 16;
  err = nband > 1 && band_rows % LB != 0
            ? launch_mid<T, true>(rec_a, rec_b, seed_T, k0_T, z, ck_T, nband,
                                  src0, src1, alm0, alm1, L, M, R, F2,
                                  band_rows, fs, st)
            : launch_mid<T, false>(rec_a, rec_b, seed_T, k0_T, z, ck_T, nband,
                                   src0, src1, alm0, alm1, L, M, R, F2,
                                   band_rows, fs, st);
  return (int)err;
}

}  // namespace

extern "C" {

// Launch on `stream` (a cudaStream_t) of device `device`; returns the
// cudaError_t of the launch (0 on success).  The caller owns all buffers;
// every element of alm0 and alm1 is written.  src0/src1 [R, M, fs] and
// alm0/alm1 [L/2, M, fs] are planes-minor (fs ≥ F2 a multiple of 16 bytes,
// 16-byte aligned).  The signature is that of cora_scan_contract.
int cora_scan_project(const void* rec_a, const void* rec_b,
                      const void* seed_T, const void* k0_T, const void* z,
                      const void* ck_T, int nband, const void* src0,
                      const void* src1, void* alm0, void* alm1, int L, int M,
                      int R, int F2, int band_rows, int fs, int device,
                      void* stream) {
  return launch<float>(rec_a, rec_b, seed_T, k0_T, z, ck_T, nband, src0, src1,
                       alm0, alm1, L, M, R, F2, band_rows, fs, device, stream);
}

// The same on double tables (S=512, β=256) and sources.
int cora_scan_project_f64(const void* rec_a, const void* rec_b,
                          const void* seed_T, const void* k0_T,
                          const void* z, const void* ck_T, int nband,
                          const void* src0, const void* src1, void* alm0,
                          void* alm1, int L, int M, int R, int F2,
                          int band_rows, int fs, int device, void* stream) {
  return launch<double>(rec_a, rec_b, seed_T, k0_T, z, ck_T, nband, src0,
                        src1, alm0, alm1, L, M, R, F2, band_rows, fs, device,
                        stream);
}

}  // extern "C"
