// The cached Λ's chunk descriptor, shared by K4 (legendre_contract.cu, the
// contraction) and K7 (legendre_project.cu, its adjoint).
//
//   desc [nchunk, 5] int64   (off_c, nrows_c, mw_c, row0_c, target_c)
//
// Chunk c is Λ_c = lam[off_c : off_c + mw_c·nrows_c·R] as [mw_c, nrows_c, R]
// (m-major, rings minor): rows row0_c .. row0_c + nrows_c of the a_lm planes,
// m < mw_c, routed to accumulator or source target_c (0 or 1).

#pragma once

namespace cora {

constexpr int kDesc = 5;  // descriptor entries per chunk

// A chunk's descriptor entries, kept in registers by a cursor (c = nchunk:
// past the last chunk).
struct Chunk {
  int c;
  long long off;
  int nrows, mw, row0;
};

__device__ __forceinline__ Chunk chunk_at(const long long* __restrict__ desc,
                                          int c) {
  const long long* d = desc + (size_t)c * kDesc;
  return Chunk{c, d[0], (int)d[1], (int)d[2], (int)d[3]};
}

__device__ __forceinline__ int chunk_target(const long long* __restrict__ desc,
                                            int c) {
  return (int)desc[(size_t)c * kDesc + 4];
}

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

// Row tile `x` of the chunks cut into tiles of RT rows, in descriptor order:
// its chunk (c = nchunk past the last tile) and, in `i0`, its first row.
template <int RT>
__device__ __forceinline__ Chunk row_tile(const long long* __restrict__ desc,
                                          int nchunk, int x, int& i0) {
  for (int c = 0; c < nchunk; ++c) {
    const int n = (int)((desc[(size_t)c * kDesc + 1] + RT - 1) / RT);
    if (x < n) {
      i0 = x * RT;
      return chunk_at(desc, c);
    }
    x -= n;
  }
  i0 = 0;
  return Chunk{nchunk, 0, 0, 0, 0};
}

}  // namespace cora
