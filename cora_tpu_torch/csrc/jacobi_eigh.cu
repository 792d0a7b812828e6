// Batched float64 symmetric eigensolver and matrix root, K5: blocked
// two-sided cyclic Jacobi, one thread block per matrix.
//
// Replaces no Pallas kernel.  The JAX package takes its covariance roots
// from XLA's eigh (cora_tpu/util/linalg.py `batch_matrix_root`, reached from
// cora_tpu/signal/clfast.py `_roots_from_cla_jit`); the port's
// torch.linalg.eigh on a CUDA batch of n > 32 calls cuSOLVER's syevd once per
// matrix, one after another, and at the getsky shape (1536 matrices of
// 256², nside 512) that loop was 91% of a cube's wall time.  This kernel
// diagonalises every matrix of a call in one launch:
//
//   A [L, n, n]  symmetric, the working matrix; out: Rᵀ, R = V·√Λ₊ (root
//                mode) or V (vector mode) with columns in ascending order
//                of the eigenvalues, as torch.linalg.eigh orders them
//   V [L, n, n]  scratch (the eigenvectors while they are accumulated)
//   evals [L, nv] out, optional: the eigenvalues, ascending
//
// n is a multiple of 32 up to 256; the leading nv ≤ n rows and columns are
// the matrix, the rest zero padding (never coupled to the matrix: a
// rotation of an index with a padded one always meets a zero element and is
// skipped), so only the leading nv × nv of V is meaningful.
//
// What bounds it on an H100: counted from shapes alone (LAPACK's count less
// the tridiagonal solver), 4/3·n³ flops per matrix on the FP64 units and
// then 2·n³ on the tensor cores, against reading C and writing R
// (2·L·n²·8 bytes): 1.78 ms of operations and 0.48 ms of bytes for 1536
// matrices of 256².  Jacobi does many times LAPACK's operations; what it
// buys is a solver whose every step is a product of small orthogonal
// blocks, parallel inside one matrix and over the batch, and V orthogonal
// by construction.  What bounds this design is device memory: A and V
// (1 MB a matrix) do not fit a block's shared memory, so every round moves
// up to 1.8 MB of them.
//
// The design:
//  * Columns form blocks of 16; a sweep is n/16 − 1 rounds of the circle
//    method over the blocks, each round pairing them into n/32 disjoint
//    pairs.  Warp k owns pair k: it loads the pair's 32×32 subproblem from
//    A into shared memory and sweeps it once with scalar Jacobi, 16
//    disjoint rotations a step, each step one fused two-sided update of
//    the subproblem's upper triangle.  A sweep's first round runs the full
//    cyclic inner sweep (31 steps, every pair of the subproblem); the other
//    rounds only the 16 steps of the pairs between the two blocks, so that
//    over an outer sweep every index pair is met once or more.
//  * Uᵀ is accumulated in registers, a column a lane: its rows sit in slots
//    that follow each step's pairing (pair j in slots 2j, 2j + 1, moved by
//    a fixed permutation between steps), so each rotation of Uᵀ has fixed
//    register indices and touches no shared memory.
//  * The round's orthogonal transform is then applied outside the pairs'
//    diagonal blocks: every off-diagonal 32×32 tile of A becomes U_kᵀ·T·U_m
//    (written both ways, so A stays exactly symmetric) and every 32×32
//    chunk of V's pair columns V·U_k, on the FP64 tensor cores (mma.sync
//    m16n8k4) from shared-memory tiles whose pitch (36) puts the fragments
//    of a half warp on distinct banks.  Tiles arrive by 16-byte cp.async,
//    the next task's while the current one is multiplied; a pair that made
//    no rotation skips its products.
//  * A rotation is skipped when |a_pq| ≤ max(n·ε·√|a_pp·a_qq|, ε²·‖A‖_F):
//    the relative test keeps small eigenvalues accurate, the absolute floor
//    ends the sweeps of matrices with zero or indefinite diagonals.  The
//    matrix has converged after a sweep without a rotation.  A matrix
//    still rotating after max_sweeps reports max_sweeps + 1.
//  * Eigenvalues are ranked (ties by index), clipped below threshold · max
//    as batch_matrix_root does, and V is written permuted, scaled and
//    transposed into A: the caller's R has column-major matrices, as
//    torch.linalg.eigh's eigenvectors have (the draw's products with R were
//    up to 6% slower on row-major roots).  Every sum has a fixed order and no atomic adds
//    a value, so a matrix gives the same bits at every call; the sweep
//    count is the only atomic (a max).
//
// Measured (chip_smoke.py phase 3e, NVIDIA H100 80GB HBM3, 700 W, the
// engine's grid of 1536 matrices of 256², 8–13 sweeps): the first version
// (subproblem and Uᵀ both swept in shared memory, every round a full inner
// sweep, tiles loaded eight rows at a time) 249.8 ms; with cp.async tiles
// 149.4 ms, of which the inner sweeps took 69% (limited by shared-memory
// wavefronts, about 510 a step per warp); this design 123.0 ms, the inner
// sweeps 36% and the products, bound by device memory, 64%.
// torch.linalg.eigh: 3176 ms.

#include <cfloat>

#include "hopper_tiles.cuh"

namespace {

constexpr int kBS = 16;                  // columns of a block
constexpr int kPW = 2 * kBS;             // width of a pair's subproblem
constexpr int kMaxN = 256;
constexpr int kMaxPairs = kMaxN / kPW;   // 8
constexpr int kWarps = kMaxPairs;        // a warp per pair
constexpr int kThreads = 32 * kWarps;
constexpr int kGP = cora::dmma_pitch(kPW);  // 36: tile pitch (DMMA operands)
constexpr int kTile = kPW * kGP;         // doubles of a 32×32 tile
constexpr int kTri = 136;                // 2×2 blocks (u ≤ v) of 16 pairs
constexpr int kMaxTasks = 16;            // products a warp takes in a round

struct Smem {
  double S[kWarps][kTile];  // each pair's subproblem; in the products, a
                            // warp's second staging tile
  double W[kWarps][kTile];  // Uᵀ of each pair's transform
  double X[kWarps][kTile];  // each warp's first staging tile
  double2 cs[kWarps][kBS];  // a step's rotations: (c, s) for p < q,
  double2 cw[kWarps][kBS];  // (c, ±s) in the slot order of Uᵀ's registers,
  double2 dg[kWarps][kBS];  // the new (a_pp, a_qq)
  int pq[kWarps][kBS];      // p | q << 8 | made << 16
  int tasks[kWarps][kMaxTasks];
  double red[kWarps];       // block reductions
  int rotated[kWarps];      // pair k rotated in this round
  int any;                  // a rotation in this sweep
};

// Pair k of round r of the circle method over m (even) players.
__device__ __forceinline__ void circle_pair(int m, int r, int k, int& a,
                                            int& b) {
  if (k == 0) {
    a = 0;
    b = 1 + r;
  } else {
    a = 1 + (r + k) % (m - 1);
    b = 1 + (r - k + (m - 1)) % (m - 1);
  }
}

// The rotation that zeroes a_pq: c, s, t = s/c = tan φ, with
// t = sgn(d)·e / (|d| + hypot(d, e)), d = a_qq − a_pp, e = 2·a_pq (Rutishauser's
// smaller root without the quotient θ = d/e); or false where |a_pq| is at or
// below the threshold (c = 1, s = 0).
__device__ __forceinline__ bool jacobi_rotation(double app, double aqq,
                                                double apq, double tol,
                                                double flo, double& c,
                                                double& s, double& t) {
  const double lim = fmax(tol * sqrt(fabs(app * aqq)), flo);
  if (!(fabs(apq) > lim)) {
    c = 1.0;
    s = 0.0;
    t = 0.0;
    return false;
  }
  const double d = aqq - app, e = 2.0 * apq;
  t = (d < 0.0 ? -e : e) / (fabs(d) + hypot(d, e));
  c = rsqrt(1.0 + t * t);
  s = t * c;
  return true;
}

// Row i (0..31) of a tile whose rows are the 16-row segments r0, r1.
__device__ __forceinline__ int seg_row(int r0, int r1, int i) {
  return (i < kBS ? r0 : r1 - kBS) + i;
}

// dst[i][j] (pitch kGP) ← src[row(i)·n + col(j)], rows the segments r0, r1
// and columns the 16-column segments c0, c1: 16-byte cp.async copies, 16
// per lane, all in flight together.
__device__ __forceinline__ void load_tile(double* dst, const double* src,
                                          int n, int r0, int r1, int c0,
                                          int c1, int lane) {
#pragma unroll
  for (int u = 0; u < 16; ++u) {
    const int ch = lane + 32 * u, i = ch >> 4, k = ch & 15;
    const int col = (k < 8 ? c0 : c1 - kBS) + 2 * k;
    cora::cp_async16(dst + i * kGP + 2 * k,
                     src + (size_t)seg_row(r0, r1, i) * n + col, true);
  }
}

// The same tile written back from shared memory, 16 bytes a store.
__device__ __forceinline__ void store_tile(double* dst, const double* src,
                                           int n, int r0, int r1, int c0,
                                           int c1, int lane) {
#pragma unroll
  for (int u = 0; u < 16; ++u) {
    const int ch = lane + 32 * u, i = ch >> 4, k = ch & 15;
    const int col = (k < 8 ? c0 : c1 - kBS) + 2 * k;
    *reinterpret_cast<double2*>(dst + (size_t)seg_row(r0, r1, i) * n + col) =
        *reinterpret_cast<const double2*>(src + i * kGP + 2 * k);
  }
}

// The player at slot s (0..31) of a pair sweep's first step.  Slots 2j and
// 2j + 1 hold pair j.  Full sweep: the circle method over the 32 indices
// (pair 0 = (0, 1 + r), pair k = (1 + (r + k) mod 31, 1 + (r − k) mod 31)).
// Cross sweep: the 256 pairs between the two blocks, (j, 16 + (j + t) mod 16).
template <bool kFull>
__device__ __forceinline__ constexpr int slot_player(int s) {
  if (!kFull) return (s & 1) ? kBS + (s >> 1) : (s >> 1);
  if (s < 2) return s;
  return (s & 1) ? kPW - (s >> 1) : 1 + (s >> 1);
}

// Slot of the full sweep's player at distance d = (x − 1 − step) mod 31.
__device__ __forceinline__ constexpr int full_slot(int d) {
  return d == 0 ? 1 : (d < kBS ? 2 * d : 2 * (kPW - 1 - d) + 1);
}

// Move the register slots from one step's pairing to the next one's.
template <bool kFull>
__device__ __forceinline__ void next_slots(double (&w)[kPW]) {
  double o[kPW];
#pragma unroll
  for (int i = 0; i < kPW; ++i) o[i] = w[i];
  if (kFull) {
#pragma unroll
    for (int d = 0; d < kPW - 1; ++d)
      w[full_slot((d + kPW - 2) % (kPW - 1))] = o[full_slot(d)];
  } else {
#pragma unroll
    for (int j = 0; j < kBS; ++j) w[2 * ((j + kBS - 1) % kBS) + 1] = o[2 * j + 1];
  }
}

// Address of element (i, j) of a subproblem kept as its upper triangle.
__device__ __forceinline__ int sym(int i, int j) {
  return min(i, j) * kGP + max(i, j);
}

// One sweep of scalar Jacobi on the warp's subproblem S (its upper
// triangle): the full cyclic sweep (31 steps) or the cross sweep (16
// steps, the pairs between the two blocks).  Uᵀ stays in registers, a
// column a lane, its rows in slots that follow each step's pairing, so
// every rotation of Uᵀ has fixed register indices; at the end the slots
// are back in their first order and Uᵀ goes to W.  True if any rotation
// was made.
template <bool kFull>
__device__ bool inner_sweep(Smem& sm, int k, int lane, double tol,
                            double flo) {
  constexpr int kSteps = kFull ? kPW - 1 : kBS;
  double* S = sm.S[k];
  double2* cs = sm.cs[k];
  double2* cw = sm.cw[k];
  double2* dg = sm.dg[k];
  int* pq = sm.pq[k];
  double w[kPW];
#pragma unroll
  for (int i = 0; i < kPW; ++i) w[i] = slot_player<kFull>(i) == lane ? 1.0 : 0.0;
  const int u = lane & (kBS - 1);
  bool any = false;
  for (int step = 0; step < kSteps; ++step) {
    bool d = false;
    if (lane < kBS) {
      int a, b;
      if (kFull) {
        circle_pair(kPW, step, lane, a, b);
      } else {
        a = lane;
        b = kBS + ((lane + step) & (kBS - 1));
      }
      const int p = min(a, b), q = max(a, b);
      const double app = S[p * kGP + p], aqq = S[q * kGP + q],
                   apq = S[p * kGP + q];
      double c, s, t;
      d = jacobi_rotation(app, aqq, apq, tol, flo, c, s, t);
      cs[lane] = make_double2(c, s);
      cw[lane] = make_double2(c, a < b ? s : -s);
      dg[lane] = d ? make_double2(app - t * apq, aqq + t * apq)
                   : make_double2(app, aqq);
      pq[lane] = p | (q << 8) | ((int)d << 16);
    }
    const bool step_any = __any_sync(0xffffffffu, d);
    __syncwarp();
    if (step_any) {
      any = true;
      // S ← Jᵀ S J over the unordered pairs of 2×2 blocks (u, v = u + dd
      // mod 16): this lane's u is fixed, dd steps by 2
      const int pqu = pq[u];
      const int pu = pqu & 255, qu = (pqu >> 8) & 255;
      const bool du = pqu >> 16;
      const double2 ru = cs[u];
      for (int dd = lane >> 4; dd < 8 || (dd == 8 && u < 8); dd += 2) {
        if (dd == 0) {
          if (du) {
            const double2 nd = dg[u];
            S[pu * kGP + pu] = nd.x;
            S[qu * kGP + qu] = nd.y;
            S[pu * kGP + qu] = 0.0;
          }
          continue;
        }
        const int pqv = pq[(u + dd) & (kBS - 1)];
        if (!(du | (pqv >> 16))) continue;
        const int pv = pqv & 255, qv = (pqv >> 8) & 255;
        const double2 rv = cs[(u + dd) & (kBS - 1)];
        const double x11 = S[sym(pu, pv)], x12 = S[sym(pu, qv)];
        const double x21 = S[sym(qu, pv)], x22 = S[sym(qu, qv)];
        const double y11 = rv.x * x11 - rv.y * x12, y12 = rv.y * x11 + rv.x * x12;
        const double y21 = rv.x * x21 - rv.y * x22, y22 = rv.y * x21 + rv.x * x22;
        S[sym(pu, pv)] = ru.x * y11 - ru.y * y21;
        S[sym(qu, pv)] = ru.y * y11 + ru.x * y21;
        S[sym(pu, qv)] = ru.x * y12 - ru.y * y22;
        S[sym(qu, qv)] = ru.y * y12 + ru.x * y22;
      }
      // Uᵀ ← Jᵀ Uᵀ: rows p, q of this lane's column, in slots 2j, 2j + 1
#pragma unroll
      for (int j = 0; j < kBS; ++j) {
        const double2 r = cw[j];
        const double x = w[2 * j], y = w[2 * j + 1];
        w[2 * j] = r.x * x - r.y * y;
        w[2 * j + 1] = r.y * x + r.x * y;
      }
      __syncwarp();
    }
    next_slots<kFull>(w);
  }
#pragma unroll
  for (int i = 0; i < kPW; ++i) sm.W[k][slot_player<kFull>(i) * kGP + lane] = w[i];
  return any;
}

// acc = Aop · Bop over 32×32 tiles on the FP64 tensor cores; a(i, k) and
// b(k, j) read shared memory.  acc[rt][ct][h][e] is row 16·rt + 8·h + g,
// column 8·ct + 2·t + e (lane = 4·g + t).
template <class FA, class FB>
__device__ __forceinline__ void mm32(double (&acc)[2][4][2][2], FA a, FB b,
                                     int g, int t) {
#pragma unroll
  for (int rt = 0; rt < 2; ++rt)
#pragma unroll
    for (int ct = 0; ct < 4; ++ct)
#pragma unroll
      for (int h = 0; h < 2; ++h) acc[rt][ct][h][0] = acc[rt][ct][h][1] = 0.0;
#pragma unroll
  for (int ks = 0; ks < kPW / 4; ++ks) {
    double a0[2], a1[2], bb[4];
#pragma unroll
    for (int rt = 0; rt < 2; ++rt) {
      a0[rt] = a(16 * rt + g, 4 * ks + t);
      a1[rt] = a(16 * rt + 8 + g, 4 * ks + t);
    }
#pragma unroll
    for (int ct = 0; ct < 4; ++ct) bb[ct] = b(4 * ks + t, 8 * ct + g);
#pragma unroll
    for (int rt = 0; rt < 2; ++rt)
#pragma unroll
      for (int ct = 0; ct < 4; ++ct)
        cora::dmma16(acc[rt][ct][0], acc[rt][ct][1], a0[rt], a1[rt], bb[ct]);
  }
}

// Deterministic block reduction (fixed shuffle tree, warps in order).
template <bool kMax>
__device__ double block_reduce(Smem& sm, double v, int tid) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const double w = __shfl_xor_sync(0xffffffffu, v, o);
    v = kMax ? fmax(v, w) : v + w;
  }
  __syncthreads();
  if ((tid & 31) == 0) sm.red[tid >> 5] = v;
  __syncthreads();
  double r = sm.red[0];
  for (int w = 1; w < kWarps; ++w) r = kMax ? fmax(r, sm.red[w]) : r + sm.red[w];
  return r;
}

__global__ void __launch_bounds__(kThreads, 1)
    jacobi_eigh_kernel(double* A_all, double* V_all,
                       double* __restrict__ evals_all, int n, int nv,
                       double threshold, double tol, int max_sweeps,
                       int root_mode, int* __restrict__ sweeps_out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const size_t nn = (size_t)n * n;
  double* A = A_all + blockIdx.x * nn;
  double* V = V_all + blockIdx.x * nn;
  const int nb = n / kBS;     // blocks
  const int np = nb / 2;      // pairs a round
  const int nchunk = n / kPW; // 32-row chunks of V

  // V = I and the absolute floor ε²·‖A‖_F
  double ss = 0.0;
  for (int e = tid; e < n * n; e += kThreads) {
    const double x = A[e];
    ss = fma(x, x, ss);
    V[e] = (e / n == e % n) ? 1.0 : 0.0;
  }
  const double flo = DBL_EPSILON * DBL_EPSILON * sqrt(block_reduce<false>(sm, ss, tid));

  int sweeps = 0;
  bool converged = false;
  while (!converged && sweeps < max_sweeps) {
    if (tid == 0) sm.any = 0;
    for (int r = 0; r < nb - 1; ++r) {
      // each warp k < np: load, sweep and store its pair's subproblem
      if (warp < np) {
        int a, b;
        circle_pair(nb, r, warp, a, b);
        double* S = sm.S[warp];
        load_tile(S, A, n, a * kBS, b * kBS, a * kBS, b * kBS, lane);
        cora::cp_async_commit();
        cora::cp_async_wait<0>();
        __syncwarp();
        // a sweep's first round runs the full inner sweep (every pair of
        // the subproblem), the others only the pairs between their blocks
        const bool rot = r == 0 ? inner_sweep<true>(sm, warp, lane, tol, flo)
                                : inner_sweep<false>(sm, warp, lane, tol, flo);
        if (rot) {
          __syncwarp();
#pragma unroll 8
          for (int i = 0; i < kPW; ++i)
            if (i > lane) S[i * kGP + lane] = S[lane * kGP + i];
          __syncwarp();
          store_tile(A, S, n, a * kBS, b * kBS, a * kBS, b * kBS, lane);
        }
        if (lane == 0) sm.rotated[warp] = rot;
      }
      __syncthreads();
      if (tid == 0)
        for (int k = 0; k < np; ++k) sm.any |= sm.rotated[k];

      // this warp's products, in a fixed order: off-diagonal tiles of A
      // (code k·8 + m), then V's 32-row chunks of pair k (64 + k·8 + c)
      int nt = 0;
      {
        int task = 0;
        for (int k = 0; k < np; ++k)
          for (int m = k + 1; m < np; ++m, ++task)
            if (task % kWarps == warp && (sm.rotated[k] | sm.rotated[m])) {
              if (lane == 0) sm.tasks[warp][nt] = k * 8 + m;
              ++nt;
            }
        for (int k = 0; k < np; ++k)
          for (int c = 0; c < nchunk; ++c, ++task)
            if (task % kWarps == warp && sm.rotated[k]) {
              if (lane == 0) sm.tasks[warp][nt] = 64 + k * 8 + c;
              ++nt;
            }
      }
      __syncwarp();
      const int* tl = sm.tasks[warp];
      auto fetch = [&](int code, double* dst) {
        int ka, kb, ma, mb;
        if (code < 64) {
          circle_pair(nb, r, code >> 3, ka, kb);
          circle_pair(nb, r, code & 7, ma, mb);
          load_tile(dst, A, n, ka * kBS, kb * kBS, ma * kBS, mb * kBS, lane);
        } else {
          circle_pair(nb, r, (code - 64) >> 3, ka, kb);
          const int r0 = (code & 7) * kPW;
          load_tile(dst, V, n, r0, r0 + kBS, ka * kBS, kb * kBS, lane);
        }
      };
      if (nt) fetch(tl[0], sm.X[warp]);
      cora::cp_async_commit();
      double acc[2][4][2][2];
      for (int it = 0; it < nt; ++it) {
        if (it + 1 < nt) fetch(tl[it + 1], (it & 1) ? sm.X[warp] : sm.S[warp]);
        cora::cp_async_commit();
        cora::cp_async_wait<1>();
        __syncwarp();
        double* T = (it & 1) ? sm.S[warp] : sm.X[warp];
        const int code = tl[it];
        if (code < 64) {
          // A[k, m] ← U_kᵀ A[k, m] U_m, written as it is and transposed
          const int k = code >> 3, m = code & 7;
          int ka, kb, ma, mb;
          circle_pair(nb, r, k, ka, kb);
          circle_pair(nb, r, m, ma, mb);
          const double* Wk = sm.W[k];
          const double* Wm = sm.W[m];
          mm32(acc, [&](int i, int q) { return T[i * kGP + q]; },
               [&](int q, int j) { return Wm[j * kGP + q]; }, g, t);
          __syncwarp();
#pragma unroll
          for (int rt = 0; rt < 2; ++rt)
#pragma unroll
            for (int ct = 0; ct < 4; ++ct)
#pragma unroll
              for (int h = 0; h < 2; ++h)
                *reinterpret_cast<double2*>(
                    T + (16 * rt + 8 * h + g) * kGP + 8 * ct + 2 * t) =
                    make_double2(acc[rt][ct][h][0], acc[rt][ct][h][1]);
          __syncwarp();
          mm32(acc, [&](int i, int q) { return Wk[i * kGP + q]; },
               [&](int q, int j) { return T[q * kGP + j]; }, g, t);
#pragma unroll
          for (int rt = 0; rt < 2; ++rt)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int gi = seg_row(ka * kBS, kb * kBS, 16 * rt + 8 * h + g);
#pragma unroll
              for (int ct = 0; ct < 4; ++ct) {
                const int gj = seg_row(ma * kBS, mb * kBS, 8 * ct + 2 * t);
                const double z0 = acc[rt][ct][h][0], z1 = acc[rt][ct][h][1];
                *reinterpret_cast<double2*>(A + (size_t)gi * n + gj) =
                    make_double2(z0, z1);
                A[(size_t)gj * n + gi] = z0;
                A[(size_t)(gj + 1) * n + gi] = z1;
              }
            }
        } else {
          // V[c, k] ← V[c, k] U_k
          const int k = (code - 64) >> 3, r0 = (code & 7) * kPW;
          int ka, kb;
          circle_pair(nb, r, k, ka, kb);
          const double* Wk = sm.W[k];
          mm32(acc, [&](int i, int q) { return T[i * kGP + q]; },
               [&](int q, int j) { return Wk[j * kGP + q]; }, g, t);
#pragma unroll
          for (int rt = 0; rt < 2; ++rt)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              double* Vr = V + (size_t)(r0 + 16 * rt + 8 * h + g) * n;
#pragma unroll
              for (int ct = 0; ct < 4; ++ct)
                *reinterpret_cast<double2*>(
                    Vr + seg_row(ka * kBS, kb * kBS, 8 * ct + 2 * t)) =
                    make_double2(acc[rt][ct][h][0], acc[rt][ct][h][1]);
            }
        }
        __syncwarp();
      }
      cora::cp_async_wait<0>();
      __syncthreads();
    }
    ++sweeps;
    converged = !sm.any;
    __syncthreads();
  }
  if (!converged) sweeps = max_sweeps + 1;
  if (tid == 0) atomicMax(sweeps_out, sweeps);

  // eigenvalues in ascending order (ties by index), clipped for the root
  double* ev = sm.S[0];
  double* sq = sm.S[1];
  int* rank = reinterpret_cast<int*>(sm.S[2]);
  double emax = -DBL_MAX;
  for (int i = tid; i < nv; i += kThreads) {
    ev[i] = A[(size_t)i * n + i];
    emax = fmax(emax, ev[i]);
  }
  emax = block_reduce<true>(sm, emax, tid);
  for (int i = tid; i < nv; i += kThreads) {
    const double x = ev[i];
    int rk = 0;
    for (int j = 0; j < nv; ++j) {
      const double y = ev[j];
      rk += (y < x) | ((y == x) & (j < i));
    }
    rank[i] = rk;
    sq[i] = root_mode ? (x > emax * threshold ? sqrt(x) : 0.0) : 1.0;
    if (evals_all) evals_all[(size_t)blockIdx.x * nv + rk] = x;
  }
  __syncthreads();
  // R (or V) written transposed into A, which is free now: A[rank_j][i] =
  // V[i][j]·√λ_j, through a warp's 32×32 tile of shared memory so that V
  // is read and A written a whole row segment at a time.  The caller views
  // A as R with column-major matrices, the layout torch.linalg.eigh gives.
  double* T = sm.X[warp];
  for (int task = warp; task < nchunk * nchunk; task += kWarps) {
    const int i0 = (task / nchunk) * kPW, j0 = (task % nchunk) * kPW;
#pragma unroll 8
    for (int i = 0; i < kPW; ++i)
      T[i * (kPW + 1) + lane] = V[(size_t)(i0 + i) * n + j0 + lane];
    __syncwarp();
    if (i0 + lane < nv) {
      for (int c = 0; c < kPW && j0 + c < nv; ++c)
        A[(size_t)rank[j0 + c] * n + i0 + lane] = T[lane * (kPW + 1) + c] * sq[j0 + c];
    }
    __syncwarp();
  }
}

}  // namespace

extern "C" {

// Launch on `stream` (a cudaStream_t) of device `device`; returns the
// cudaError_t of the launch (0 on success).  A and V are [L, n, n] float64,
// n a multiple of 32 up to 256, nv ≤ n the matrix's own size; A is the
// input and receives Rᵀ in its leading nv × nv (V is scratch); evals (may
// be null) is [L, nv]; sweeps is one int on the device, raised (atomicMax)
// to the largest sweep count of the call.  root_mode 1 gives R = V·√Λ₊
// (eigenvalues ≤ threshold · max zeroed), 0 gives V.
int cora_jacobi_eigh_f64(void* A, void* V, void* evals, int L, int n, int nv,
                         double threshold, double tol, int max_sweeps,
                         int root_mode, void* sweeps, int device,
                         void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (L <= 0) return 0;
  if (n <= 0 || n > kMaxN || n % kPW != 0 || nv < 1 || nv > n)
    return (int)cudaErrorInvalidValue;
  const int bytes = (int)sizeof(Smem);
  err = cudaFuncSetAttribute(jacobi_eigh_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err != cudaSuccess) return (int)err;
  jacobi_eigh_kernel<<<L, kThreads, bytes, (cudaStream_t)stream>>>(
      (double*)A, (double*)V, (double*)evals, n, nv, threshold, tol,
      max_sweeps, root_mode, (int*)sweeps);
  return (int)cudaGetLastError();
}

}  // extern "C"
