// The work split and the block reduction shared by backward.cu and
// surfel_backward.cu.
//
// Units: a tile's depth-sorted range [tile_start[t], tile_start[t+1]) is
//   cut at every multiple of kUnit that lies strictly inside it when the
//   tile holds more than kUnit instances; a shorter tile is one unit.
//   Every unit holds at most kUnit columns and runs in its own block,
//   which first walks the tile from its start to the unit's with the
//   forward's operations alone. The grid has num_tiles + ceil(I / kUnit)
//   blocks (grid_blocks), sized without reading tile_start on the host:
//   blocks [0, M), M = ceil(I / kUnit), take the unit that starts at
//   column (M-1-b) kUnit, if one does (the deepest first, so the longest
//   prefix walks start earliest); blocks [M, M + num_tiles) take each
//   tile's first unit. Blocks without a unit leave at once. units.cu
//   writes each block's unit, for a check against the plain version of
//   the schedule (raster/units.py).
// Reduction: a warp transposes and sums the R rows of its 32 lanes' terms
//   in R - 1 + 5 - log2 R shuffles (R / 2 values exchanged at offset 16,
//   R / 4 at 8, ...) instead of 5 R, and lane l ends with row
//   l >> (5 - log2 R).
#pragma once
#include <cuda_runtime.h>
#include <cuda_pipeline.h>
#include <stdint.h>

namespace units {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kChunk = 64;   // instance columns staged per pass (one
                             // 64-bit applied mask per warp)
constexpr int kGroup = 4;    // prefix columns a thread evaluates together
// instances per unit at most, chosen by measurement (PERF.md, section 6);
// raster/units.py reads it from here
constexpr int32_t kUnit = 4096;

struct Unit {
  int64_t s0;     // the tile's first column
  int64_t start;  // the unit's columns [start, end)
  int64_t end;
  int32_t tile;
};

__host__ __device__ inline int64_t grid_blocks(int32_t num_tiles,
                                                int64_t num_inst) {
  return num_tiles + (num_inst + kUnit - 1) / kUnit;
}

// The unit of block b of a backward grid -> whether it has one.
__device__ __forceinline__ bool find(int64_t b,
                                     const int32_t* __restrict__ tile_start,
                                     int32_t num_tiles, int64_t num_inst,
                                     Unit& u) {
  const int64_t m_blocks = (num_inst + kUnit - 1) / kUnit;
  if (b >= m_blocks) {
    const int32_t t = (int32_t)(b - m_blocks);
    const int64_t s = tile_start[t], e = tile_start[t + 1];
    if (e <= s) return false;
    u.tile = t;
    u.s0 = u.start = s;
    u.end = e - s <= kUnit ? e : min(e, (s / kUnit + 1) * kUnit);
    return true;
  }
  const int64_t start = (m_blocks - 1 - b) * kUnit;
  if (start < tile_start[0] || start >= tile_start[num_tiles]) return false;
  int32_t lo = 0, hi = num_tiles;   // tile_start[lo] <= start < [hi]
  while (hi - lo > 1) {
    const int32_t mid = (lo + hi) >> 1;
    if (tile_start[mid] <= start) lo = mid; else hi = mid;
  }
  const int64_t s = tile_start[lo], e = tile_start[lo + 1];
  if (s == start || e - s <= kUnit) return false;
  u.tile = lo;
  u.s0 = s;
  u.start = start;
  u.end = min(e, start + kUnit);
  return true;
}

// The sequential part of the forward's step on a pair that passed its
// culls (`ok`), written with selects so that a caller can interleave pairs:
// the pixel stops at a pair with T (1 - alpha) < t_eps, which is not
// applied; an applied pair advances T and the running w cdot. -> whether
// it was applied; t_ex = T before it, w = alpha t_ex.
__device__ __forceinline__ bool advance(bool ok, float alpha, float one_m,
                                        float cdot, float t_eps, float& T,
                                        float& c_dot, bool& done,
                                        float& t_ex, float& w) {
  ok = ok && !done;
  const float q = __fmul_rn(T, one_m);
  const bool stop = ok && q < t_eps;
  const bool app = ok && !stop;
  t_ex = T;
  w = __fmul_rn(alpha, T);
  c_dot = app ? __fadd_rn(c_dot, __fmul_rn(w, cdot)) : c_dot;
  T = app ? q : T;
  done = done || stop;
  return app;
}

// One step of warp_transpose_sum: each lane keeps the half of its C values
// selected by its lane bit `off` and adds the partner's copy of that half.
template <int C, int R>
__device__ __forceinline__ void transpose_halve(float (&v)[R], int lane) {
  if constexpr (C > 1) {
    constexpr int off = 16 * C / R;
    const bool up = lane & off;
#pragma unroll
    for (int i = 0; i < C / 2; ++i) {
      const float send = up ? v[i] : v[i + C / 2];
      const float keep = up ? v[i + C / 2] : v[i];
      v[i] = keep + __shfl_xor_sync(kFull, send, off);
    }
    transpose_halve<C / 2>(v, lane);
  }
}

// Sums v[0..R) over the warp; lane l returns row l >> (5 - log2 R).
// Every index is a constant, so v stays in registers.
template <int R>
__device__ __forceinline__ float warp_transpose_sum(float (&v)[R],
                                                    int lane) {
  static_assert(R >= 1 && R <= 32 && (R & (R - 1)) == 0, "R: 2^k <= 32");
  transpose_halve<R>(v, lane);
  float s = v[0];
#pragma unroll
  for (int off = 16 / R; off > 0; off >>= 1)
    s += __shfl_xor_sync(kFull, s, off);
  return s;
}

// Copies columns [base, base + n) of the table's first `rows` rows into
// dst (rows x kChunk) without waiting, as one committed batch.
__device__ __forceinline__ void stage(float* dst,
                                      const float* __restrict__ table,
                                      int64_t num_inst, int rows,
                                      int64_t base, int n) {
  for (int i = threadIdx.x; i < rows * n; i += blockDim.x) {
    const int r = i / n, j = i - r * n;
    __pipeline_memcpy_async(dst + r * kChunk + j,
                            table + (int64_t)r * num_inst + base + j,
                            sizeof(float));
  }
  __pipeline_commit();
}

// The pass `i` of a unit: the prefix [s0, start) in chunks of kChunk, then
// the unit [start, end) -> (first column, columns, whether in the prefix).
struct Passes {
  int64_t s0, start, end;
  int n_prefix, n_total;
  __device__ explicit Passes(const Unit& u)
      : s0(u.s0), start(u.start), end(u.end),
        n_prefix((int)((u.start - u.s0 + kChunk - 1) / kChunk)),
        n_total(n_prefix + (int)((u.end - u.start + kChunk - 1) / kChunk)) {}
  __device__ bool prefix(int i) const { return i < n_prefix; }
  __device__ int64_t base(int i) const {
    return i < n_prefix ? s0 + (int64_t)i * kChunk
                        : start + (int64_t)(i - n_prefix) * kChunk;
  }
  __device__ int count(int i) const {
    return (int)min((int64_t)kChunk, (i < n_prefix ? start : end) - base(i));
  }
};

// Writes zeros to rows [0, ngrad) of columns [from, end).
__device__ __forceinline__ void zero_columns(float* __restrict__ grads,
                                             int64_t num_inst, int ngrad,
                                             int64_t from, int64_t end) {
  const int64_t m = end - from;
  for (int64_t i = threadIdx.x; i < (int64_t)ngrad * m; i += blockDim.x) {
    const int k = (int)(i / m);
    grads[(int64_t)k * num_inst + from + (i - (int64_t)k * m)] = 0.0f;
  }
}

// Dynamic shared memory of a backward block: two staging buffers of
// `rows`, per warp `nred` reduced rows and npix per column, and one
// applied mask per warp.
__host__ __device__ inline size_t smem_bytes(int rows, int nred, int nwarps) {
  return sizeof(float) * (size_t)kChunk * (2 * rows + nwarps * (nred + 1))
         + sizeof(unsigned long long) * (size_t)nwarps;
}

}  // namespace units
