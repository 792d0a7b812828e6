// The ring stage of the parity synthesis: three kernels around cuFFT that
// take the per-ℓ-parity accumulators (H0, H1) of the Legendre kernels (K4,
// K1) to the dense ring grid.
//
// Replaces no TPU kernel: the JAX package leaves this stage to XLA's fusion
// of `_rings_to_grid_parity` (cora_tpu/healpix/sht.py:1554).  The port ran
// it as about 50 torch launches a frequency chunk (complex joins, m-parity
// routing, concatenations, phase products, padding, Hermitian packing,
// N/S combinations, flips), most of them full passes over [B, ~nh, 1536 to
// 16384] complex buffers; on an H100 80GB HBM3 at 700 W it was the largest
// stage of every cell (0.47 ms a map at nside 512).  Here the torch passes
// become one pack kernel before the transforms, one product between the
// caps' forward and inverse transforms, and one unpack kernel after them:
//
//   ring_pack_kernel   reads each accumulator plane once and writes
//                      (a) the equatorial band's Hermitian-packed spectra
//                          Z [B, 2·ne − 1, W/2] in grid-ring order (north
//                          rows lo..nh−1, then the south mirrors), whose
//                          C2C inverse at W/2, read as reals, is each
//                          ring's W samples;
//                      (b) the caps' chirp-premultiplied Bluestein input
//                          X [B, 2·lo, nfft2] (north sums, then the south
//                          differences), zero past L.
//   ring_bluestein_mul X *= Bf row by row, in place, between cuFFT's
//                      forward and inverse transforms at nfft2.
//   ring_unpack_kernel writes the grid [B, nring, W]: north cap rows
//                      2/nfft2·Re(C·conv) of the sums, the equatorial rows
//                      copied from the band's transform, south cap rows
//                      from the differences, mirrored; zero past each
//                      ring's n_r (C is zero there) and past nq_cap.
//
// The algebra.  With H0c, H1c the complex accumulators of even and odd ℓ
// (planes 2b and 2b + 1: real and imaginary parts of batch element b), the
// even/odd (north ± south) spectra are Ge = H0c, Go = H1c on even m and the
// reverse on odd m, so the two combinations the rings need take no routing:
//
//   N = Ge + Go = H0c + H1c,     S = Ge − Go = (−1)^m (H0c − H1c).
//
// A ring's samples are f_j = 2 Re Σ_m G'_m e^{im(φ0 + 2πj/n)}, where G' is
// G with its m = 0 term replaced by Re(G_0)/2 (the DC fold: it subtracts
// the Re G_0 that the factor 2 counts twice, so no later pass does).  On
// the equatorial band (n = W) the phased spectrum, aliased mod W, gives
// B_k = A_k + conj(A_{W−k}) and Z_k = (B_k + B_{k+W/2}) + i·e^{2πik/W}
// (B_k − B_{k+W/2}); the unnormalised inverse of Z at W/2 is the ring's
// (f_{2j} + i·f_{2j+1}).  A thread makes Z_k and Z_{W/2−k} from the same
// four A values.
//
// What bounds it: bytes.  At nside 512 (B = 16, L = 1536, nfft2 = 4096)
// the planes are 0.40 GB and the grid 0.27 GB, but the caps' buffer is
// 0.54 GB and passes through the pack, cuFFT twice and the product; 4.7 GB
// a chunk in all, 1.40 ms at 3.35 TB/s.  On an H100 80GB HBM3 at 700 W the
// stage takes 1.97 ms there (71% of that bound; the torch passes took
// 8.3 ms), each kernel moving 2.5–3.1 TB/s.  Every access is coalesced:
// the equatorial reads run forwards and backwards over consecutive m, the
// caps' as 8-byte vectors; each thread keeps its tables (phases, twiddles,
// Bf, C) in registers over the batch.  The sums are IEEE products in the
// working precision, the same bits from run to run (no atomics).

#include <cuda_runtime.h>
#include <cstddef>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int kThreads = 256;

template <typename T>
using cx = typename std::conditional<std::is_same<T, float>::value, float2,
                                     double2>::type;

template <typename T>
__device__ __forceinline__ cx<T> mk(T re, T im) {
  cx<T> z;
  z.x = re;
  z.y = im;
  return z;
}
template <typename T>
__device__ __forceinline__ cx<T> cadd(cx<T> a, cx<T> b) {
  return mk<T>(a.x + b.x, a.y + b.y);
}
template <typename T>
__device__ __forceinline__ cx<T> csub(cx<T> a, cx<T> b) {
  return mk<T>(a.x - b.x, a.y - b.y);
}
template <typename T>
__device__ __forceinline__ cx<T> conj(cx<T> a) {
  return mk<T>(a.x, -a.y);
}
template <typename T>
__device__ __forceinline__ cx<T> cmul(cx<T> a, cx<T> b) {
  return mk<T>(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// The N and S spectra at m from the accumulators' values (a = H0c, b =
// H1c), with the DC fold at m = 0.
template <typename T>
__device__ __forceinline__ void ns_spectra(int m, T a_re, T a_im, T b_re,
                                           T b_im, cx<T>& n, cx<T>& s) {
  n = mk<T>(a_re + b_re, a_im + b_im);
  s = mk<T>(a_re - b_re, a_im - b_im);
  if (m & 1) s = mk<T>(-s.x, -s.y);
  if (m == 0) {
    n = mk<T>(n.x * T(0.5), T(0));
    s = mk<T>(s.x * T(0.5), T(0));
  }
}

// One accumulator row r of batch element b: the real planes of H0 and H1
// (imaginary planes `plane` elements further).
template <typename T>
struct Row {
  const T* h0;
  const T* h1;
  size_t plane;
  __device__ __forceinline__ void spectra(int m, cx<T>& n, cx<T>& s) const {
    ns_spectra<T>(m, h0[m], h0[plane + m], h1[m], h1[plane + m], n, s);
  }
};

// (Z_k, Z_{W2−k}) from A_k, A_{W−k}, A_{k+W2}, A_{W2−k}.
template <typename T>
__device__ __forceinline__ void hermitian_pair(cx<T> a, cx<T> b, cx<T> c,
                                               cx<T> d, cx<T> tw, cx<T> tw2,
                                               cx<T>& zk, cx<T>& zk2) {
  const cx<T> bk = cadd<T>(a, conj<T>(b));
  const cx<T> bk2 = cadd<T>(c, conj<T>(d));
  const cx<T> sum = cadd<T>(bk, bk2);
  const cx<T> dif = csub<T>(bk, bk2);
  const cx<T> t = cmul<T>(tw, dif);            // Z_k = sum + i·t
  zk = mk<T>(sum.x - t.y, sum.y + t.x);
  const cx<T> t2 = cmul<T>(tw2, conj<T>(dif));  // Z_{W2−k} = conj(sum) − i·t2
  zk2 = mk<T>(sum.x + t2.y, -sum.y - t2.x);
}

// The group of k on one band row: the four A indices q = k, W − k, k + W2,
// W2 − k (mod W), the ring's phases e^{iqφ0} there (zero for q ≥ L) and
// the twiddles of k and W2 − k, read once and held over the batch.
template <typename T>
struct Group {
  int q[4];
  cx<T> p[4];
  cx<T> tw, tw2;

  __device__ __forceinline__ void init(const cx<T>* __restrict__ P,
                                       const cx<T>* __restrict__ twid, int k,
                                       int L, int W2) {
    const int W = 2 * W2;
    q[0] = k;
    q[1] = (W - k) % W;
    q[2] = k + W2;
    q[3] = W2 - k;
#pragma unroll
    for (int i = 0; i < 4; ++i) p[i] = q[i] < L ? P[q[i]] : mk<T>(0, 0);
    tw = twid[k];
    tw2 = twid[(W2 - k) % W2];
  }

  // (Z_k, Z_{W2−k}) of the N and S spectra of one row: A_q sums the
  // phased spectrum over m ≡ q (mod W), m < L (one term unless L > W).
  __device__ __forceinline__ void z(const Row<T>& row,
                                    const cx<T>* __restrict__ P, int L, int W2,
                                    cx<T> (&zn)[2], cx<T> (&zs)[2]) const {
    const int W = 2 * W2;
    cx<T> an[4], as[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      an[i] = mk<T>(0, 0);
      as[i] = mk<T>(0, 0);
      if (q[i] < L) {
        cx<T> n, s;
        row.spectra(q[i], n, s);
        an[i] = cmul<T>(n, p[i]);
        as[i] = cmul<T>(s, p[i]);
        for (int m = q[i] + W; m < L; m += W) {
          row.spectra(m, n, s);
          const cx<T> pm = P[m];
          an[i] = cadd<T>(an[i], cmul<T>(n, pm));
          as[i] = cadd<T>(as[i], cmul<T>(s, pm));
        }
      }
    }
    hermitian_pair<T>(an[0], an[1], an[2], an[3], tw, tw2, zn[0], zn[1]);
    hermitian_pair<T>(as[0], as[1], as[2], as[3], tw, tw2, zs[0], zs[1]);
  }
};

// Blocks [0, eq_blocks): the band, one thread a k ∈ [0, W2/2) of one north
// row lo + rr, writing Z_k and Z_{W2−k} (k = 0: Z_0 and Z_{W2/2}).
// Blocks past them: the caps, one thread NV consecutive m of one north cap
// row (8 bytes of each plane), every m < nfft2.
template <typename T>
__global__ void __launch_bounds__(kThreads)
ring_pack_kernel(const T* __restrict__ H0, const T* __restrict__ H1,
                 const cx<T>* __restrict__ eq_phase,
                 const cx<T>* __restrict__ eq_twid,
                 const cx<T>* __restrict__ cap_A, cx<T>* __restrict__ Z,
                 cx<T>* __restrict__ X, int B, int nh, int L, int lo, int W2,
                 int nfft2, int eq_blocks, int kb, int cb, int vec) {
  const size_t plane = (size_t)nh * L;
  const int blk = blockIdx.x;
  if (blk < eq_blocks) {
    const int rr = blk / kb;
    const int k = (blk % kb) * kThreads + threadIdx.x;
    if (k >= W2 / 2) return;
    const int r = lo + rr;
    const int ne = nh - lo;
    const size_t nz = 2 * (size_t)ne - 1;              // band rows of Z
    const size_t qn = rr, qs = nz - 1 - rr;            // north, south rows
    const bool south = r < nh - 1;                     // the equator has none
    const cx<T>* P = eq_phase + (size_t)rr * L;
    const int k2 = k == 0 ? W2 / 2 : W2 - k;  // k = 0: Z_{W2/2}, its own group
    Group<T> g0, g1;
    g0.init(P, eq_twid, k, L, W2);
    if (k == 0) g1.init(P, eq_twid, k2, L, W2);
    for (int b = 0; b < B; ++b) {
      const Row<T> row{H0 + (2 * (size_t)b * nh + r) * L,
                       H1 + (2 * (size_t)b * nh + r) * L, plane};
      cx<T>* zb = Z + (size_t)b * nz * W2;
      cx<T> zn[2], zs[2];
      g0.z(row, P, L, W2, zn, zs);
      zb[qn * W2 + k] = zn[0];
      if (south) zb[qs * W2 + k] = zs[0];
      if (k == 0) {
        g1.z(row, P, L, W2, zn, zs);
      } else {
        zn[0] = zn[1];
        zs[0] = zs[1];
      }
      if (k2 != k) {
        zb[qn * W2 + k2] = zn[0];
        if (south) zb[qs * W2 + k2] = zs[0];
      }
    }
    return;
  }

  constexpr int NV = 8 / (int)sizeof(T);  // m a thread: 8 bytes of a plane
  const int c = blk - eq_blocks;
  const int r = c / cb;
  const int m0 = ((c % cb) * kThreads + threadIdx.x) * NV;
  if (m0 >= nfft2) return;
  cx<T> a[NV];
#pragma unroll
  for (int j = 0; j < NV; ++j)
    a[j] = m0 + j < L ? cap_A[(size_t)r * L + m0 + j] : mk<T>(0, 0);
  const size_t rows = 2 * (size_t)lo;
  for (int b = 0; b < B; ++b) {
    const T* p0 = H0 + (2 * (size_t)b * nh + r) * L;
    const T* p1 = H1 + (2 * (size_t)b * nh + r) * L;
    T v[4][NV];  // H0 re, H0 im, H1 re, H1 im at m0..m0+NV
    if (m0 >= L) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NV; ++j) v[i][j] = T(0);
    } else if (vec && m0 + NV <= L) {
      const T* src[4] = {p0 + m0, p0 + plane + m0, p1 + m0, p1 + plane + m0};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if constexpr (NV == 2) {
          const float2 x = *reinterpret_cast<const float2*>(src[i]);
          v[i][0] = x.x;
          v[i][1] = x.y;
        } else {
          v[i][0] = *src[i];
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        const int m = m0 + j;
        const bool ok = m < L;
        v[0][j] = ok ? p0[m] : T(0);
        v[1][j] = ok ? p0[plane + m] : T(0);
        v[2][j] = ok ? p1[m] : T(0);
        v[3][j] = ok ? p1[plane + m] : T(0);
      }
    }
    cx<T> xn[NV], xs[NV];
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      cx<T> n, s;
      ns_spectra<T>(m0 + j, v[0][j], v[1][j], v[2][j], v[3][j], n, s);
      xn[j] = cmul<T>(n, a[j]);
      xs[j] = cmul<T>(s, a[j]);
    }
    cx<T>* xb = X + (size_t)b * rows * nfft2;
    cx<T>* dn = xb + (size_t)r * nfft2 + m0;
    cx<T>* ds = xb + ((size_t)lo + r) * nfft2 + m0;
    if constexpr (NV == 2) {  // 16-byte stores of two complex64
      *reinterpret_cast<float4*>(dn) = make_float4(xn[0].x, xn[0].y, xn[1].x, xn[1].y);
      *reinterpret_cast<float4*>(ds) = make_float4(xs[0].x, xs[0].y, xs[1].x, xs[1].y);
    } else {
      dn[0] = xn[0];
      ds[0] = xs[0];
    }
  }
}

// X[b, row, k] *= Bf[row mod lo, k]: one thread 16 bytes of a row, the
// kernel's values held over the batch.
template <typename T>
__global__ void __launch_bounds__(kThreads)
ring_bluestein_mul_kernel(cx<T>* __restrict__ X, const cx<T>* __restrict__ Bf,
                          int B, int lo, int nfft2) {
  constexpr int NC = 16 / (int)sizeof(cx<T>);  // complex values a thread
  const int row = blockIdx.y;
  const int k0 = (blockIdx.x * kThreads + threadIdx.x) * NC;
  if (k0 >= nfft2) return;
  const cx<T>* bf = Bf + (size_t)(row % lo) * nfft2 + k0;
  cx<T> kv[NC];
#pragma unroll
  for (int j = 0; j < NC; ++j) kv[j] = bf[j];
  const size_t stride = 2 * (size_t)lo * nfft2;
  cx<T>* x = X + (size_t)row * nfft2 + k0;
  for (int b = 0; b < B; ++b, x += stride) {
    if constexpr (NC == 2) {
      const float4 v = *reinterpret_cast<const float4*>(x);
      const cx<T> p0 = cmul<T>(mk<T>(v.x, v.y), kv[0]);
      const cx<T> p1 = cmul<T>(mk<T>(v.z, v.w), kv[1]);
      *reinterpret_cast<float4*>(x) = make_float4(p0.x, p0.y, p1.x, p1.y);
    } else {
      x[0] = cmul<T>(x[0], kv[0]);
    }
  }
}

// grid[b, ring, j], one thread 16 bytes of a ring (V samples), over the
// batch: cap rings from the convolution Y [B, 2·lo, nfft2] (north ring r
// reads row r, south ring nring−1−r row lo + r), band rings from the
// band's transform Zt [B, nring − 2·lo, W] (reals).
template <typename T>
__global__ void __launch_bounds__(kThreads)
ring_unpack_kernel(const cx<T>* __restrict__ Y, const T* __restrict__ Zt,
                   const cx<T>* __restrict__ cap_C, T* __restrict__ grid,
                   int B, int nring, int lo, int W, int nq_cap, int nfft2,
                   T cap_scale) {
  constexpr int V = 16 / (int)sizeof(T);
  using Vec = typename std::conditional<V == 4, float4, double2>::type;
  const int ring = blockIdx.y;
  const int j0 = (blockIdx.x * kThreads + threadIdx.x) * V;
  if (j0 >= W) return;
  const size_t gstride = (size_t)nring * W;
  T* g = grid + (size_t)ring * W + j0;
  const int hi = nring - lo;
  if (ring >= lo && ring < hi) {
    const size_t zstride = (size_t)(hi - lo) * W;
    const T* z = Zt + (size_t)(ring - lo) * W + j0;
    for (int b = 0; b < B; ++b)
      *reinterpret_cast<Vec*>(g + b * gstride) =
          *reinterpret_cast<const Vec*>(z + b * zstride);
    return;
  }
  const int r = ring < lo ? ring : nring - 1 - ring;  // its north cap row
  const size_t yrow = ring < lo ? (size_t)r : (size_t)lo + r;
  cx<T> c[V];
#pragma unroll
  for (int j = 0; j < V; ++j)
    c[j] = j0 + j < nq_cap ? cap_C[(size_t)r * nq_cap + j0 + j] : mk<T>(0, 0);
  const size_t ystride = 2 * (size_t)lo * nfft2;
  const cx<T>* y = Y + yrow * nfft2 + j0;
  for (int b = 0; b < B; ++b) {
    T out[V];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      T v = T(0);
      if (j0 + j < nq_cap) {
        const cx<T> yv = y[b * ystride + j];
        v = cap_scale * (yv.x * c[j].x - yv.y * c[j].y);
      }
      out[j] = v;
    }
    Vec o;
    if constexpr (V == 4) {
      o = make_float4(out[0], out[1], out[2], out[3]);
    } else {
      o = make_double2(out[0], out[1]);
    }
    *reinterpret_cast<Vec*>(g + b * gstride) = o;
  }
}

template <typename T>
int pack(const void* H0, const void* H1, const void* eq_phase,
         const void* eq_twid, const void* cap_A, void* Z, void* X, int B,
         int nh, int L, int lo, int W2, int nfft2, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B <= 0) return 0;
  constexpr int NV = 8 / (int)sizeof(T);
  if (nh <= lo || L <= 0 || W2 < 2 || W2 % 2 || (lo > 0 && nfft2 % NV))
    return (int)cudaErrorInvalidValue;
  const int kb = (W2 / 2 + kThreads - 1) / kThreads;
  const long long eq_blocks = (long long)(nh - lo) * kb;
  const int cb = lo > 0 ? (nfft2 / NV + kThreads - 1) / kThreads : 0;
  const long long blocks = eq_blocks + (long long)lo * cb;
  if (blocks >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  const int vec = L % NV == 0 &&
                  reinterpret_cast<uintptr_t>(H0) % 8 == 0 &&
                  reinterpret_cast<uintptr_t>(H1) % 8 == 0;
  ring_pack_kernel<T><<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const T*)H0, (const T*)H1, (const cx<T>*)eq_phase,
      (const cx<T>*)eq_twid, (const cx<T>*)cap_A, (cx<T>*)Z, (cx<T>*)X, B, nh,
      L, lo, W2, nfft2, (int)eq_blocks, kb, cb, vec);
  return (int)cudaGetLastError();
}

template <typename T>
int bluestein_mul(void* X, const void* Bf, int B, int lo, int nfft2,
                  int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B <= 0 || lo <= 0) return 0;
  constexpr int NC = 16 / (int)sizeof(cx<T>);
  if (nfft2 % NC || 2 * lo > 65535 ||
      reinterpret_cast<uintptr_t>(X) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((nfft2 / NC + kThreads - 1) / kThreads, 2 * lo);
  ring_bluestein_mul_kernel<T><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (cx<T>*)X, (const cx<T>*)Bf, B, lo, nfft2);
  return (int)cudaGetLastError();
}

template <typename T>
int unpack(const void* Y, const void* Zt, const void* cap_C, void* grid,
           int B, int nring, int lo, int W, int nq_cap, int nfft2,
           double cap_scale, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B <= 0) return 0;
  constexpr int V = 16 / (int)sizeof(T);
  if (W % V || nring > 65535 || 2 * lo >= nring || nq_cap > W ||
      reinterpret_cast<uintptr_t>(grid) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(Zt) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const dim3 g((W / V + kThreads - 1) / kThreads, nring);
  ring_unpack_kernel<T><<<g, kThreads, 0, (cudaStream_t)stream>>>(
      (const cx<T>*)Y, (const T*)Zt, (const cx<T>*)cap_C, (T*)grid, B, nring,
      lo, W, nq_cap, nfft2, (T)cap_scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch on `stream` (a cudaStream_t) of device `device`; each returns the
// cudaError_t of its launch (0 on success).
//
// pack: H0, H1 [2B, nh, L] contiguous; eq_phase [nh − lo, L], eq_twid
// [W2], cap_A [lo, L] complex contiguous (the north rows of the ring
// tables); writes Z [B, 2(nh − lo) − 1, W2] and, when lo > 0, X [B, 2·lo,
// nfft2] (complex, contiguous) whole.
int cora_ring_pack_f32(const void* H0, const void* H1, const void* eq_phase,
                       const void* eq_twid, const void* cap_A, void* Z,
                       void* X, int B, int nh, int L, int lo, int W2,
                       int nfft2, int device, void* stream) {
  return pack<float>(H0, H1, eq_phase, eq_twid, cap_A, Z, X, B, nh, L, lo, W2,
                     nfft2, device, stream);
}
int cora_ring_pack_f64(const void* H0, const void* H1, const void* eq_phase,
                       const void* eq_twid, const void* cap_A, void* Z,
                       void* X, int B, int nh, int L, int lo, int W2,
                       int nfft2, int device, void* stream) {
  return pack<double>(H0, H1, eq_phase, eq_twid, cap_A, Z, X, B, nh, L, lo,
                      W2, nfft2, device, stream);
}

// bluestein_mul: X [B, 2·lo, nfft2] *= Bf [lo, nfft2] (row mod lo), in
// place; X 16-byte aligned.
int cora_ring_bluestein_mul_f32(void* X, const void* Bf, int B, int lo,
                                int nfft2, int device, void* stream) {
  return bluestein_mul<float>(X, Bf, B, lo, nfft2, device, stream);
}
int cora_ring_bluestein_mul_f64(void* X, const void* Bf, int B, int lo,
                                int nfft2, int device, void* stream) {
  return bluestein_mul<double>(X, Bf, B, lo, nfft2, device, stream);
}

// unpack: Y [B, 2·lo, nfft2] complex (unused when lo = 0), Zt [B, nring −
// 2·lo, W] real, cap_C [lo, nq_cap] complex; writes grid [B, nring, W]
// whole; Zt and grid 16-byte aligned, W a whole number of 16-byte vectors.
int cora_ring_unpack_f32(const void* Y, const void* Zt, const void* cap_C,
                         void* grid, int B, int nring, int lo, int W,
                         int nq_cap, int nfft2, double cap_scale, int device,
                         void* stream) {
  return unpack<float>(Y, Zt, cap_C, grid, B, nring, lo, W, nq_cap, nfft2,
                       cap_scale, device, stream);
}
int cora_ring_unpack_f64(const void* Y, const void* Zt, const void* cap_C,
                         void* grid, int B, int nring, int lo, int W,
                         int nq_cap, int nfft2, double cap_scale, int device,
                         void* stream) {
  return unpack<double>(Y, Zt, cap_C, grid, B, nring, lo, W, nq_cap, nfft2,
                        cap_scale, device, stream);
}

}  // extern "C"
