// The work split and the block reduction shared by backward.cu and
// surfel_backward.cu, and the two launches shared by forward.cu and
// surfel_forward.cu.
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
// Forward cull: the table's columns fall into regions of kFwdUnit,
//   region j = [j kFwdUnit, (j+1) kFwdUnit). A tile of more than
//   kFwdLong = kFwdLongRegions kFwdUnit instances ("long") is cut at the
//   region bounds into segments. The forwards' first launch (tile_kernel)
//   walks every tile in one pass but the long tiles that the probe
//   (dense_tile) finds sparse ("culled"): a long tile marks the regions
//   its segments lie in (mark_long), and a culled one zeroes a counter.
//   The second launch (cull_walk_kernel) culls each marked segment, one
//   bit per (pixel, column), set where the pair passes the forward's
//   culls: bit b of the segment's word k is its column start + 32 k + b,
//   stored at `cull[(word + k) npx + pixel]` ([word][pixel], so that a
//   warp reads a word of its 32 pixels at once); the block that culls a
//   tile's last segment walks the tile. A region holds at most two
//   segments of long tiles (each spans more than a region): one that
//   starts at the region's first column, in the region's words from its
//   first on, and the first segment of a tile that starts inside it, in
//   the words up to the region's last; with kFwdUnit / 32 + 1 words a
//   region the two never share a word. Bits past a segment's end are 0;
//   words of no segment are never written. Short tiles write no mark: a
//   mark counts only where it names the long tile that holds the region's
//   column, which then wrote it in this call (read_mark), so the
//   workspace needs no initialisation. A tile whose pixels are likely to
//   stop early is better walked in one pass than culled whole; the result
//   never depends on the probe.
#pragma once
#include <cuda_runtime.h>
#include <cuda_pipeline.h>
#include <stdint.h>
#include <algorithm>

namespace units {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kChunk = 64;   // instance columns staged per pass (one
                             // 64-bit applied mask per warp)
constexpr int kGroup = 4;    // prefix columns a thread evaluates together
// instances per unit at most, chosen by measurement (PERF.md, section 6);
// raster/units.py reads it from here
constexpr int32_t kUnit = 4096;

// columns a forward cull region spans, chosen by measurement (PERF.md,
// section 6); raster/units.py reads it from here
constexpr int32_t kFwdUnit = 512;
constexpr int32_t kFwdLongRegions = 4;   // a longer tile may be culled
constexpr int32_t kFwdLong = kFwdLongRegions * kFwdUnit;
constexpr int32_t kRegionWords = kFwdUnit / 32;     // a region's columns
constexpr int32_t kFwdWords = kRegionWords + 1;     // mask words a region
static_assert(kFwdUnit % 32 == 0 && kFwdLong >= kFwdUnit, "kFwdUnit");
// pixels a tile holds at most for the cull: larger tiles would not fit the
// walk's stages, and are all walked in one pass
constexpr int kCullMaxPx = 256;
// the probe of a long tile: of 32 sample pixels (every npx / 32-th), at
// least kProbeDense pass the cull on at least kProbeBusy of the tile's
// first kProbeCols columns -> dense
constexpr int kProbeCols = 32;
constexpr int kProbeBusy = 4;
constexpr int kProbeDense = 8;

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

// ---------------------------------------------------------------------------
// The forwards' two launches, over a pair model M (forward.cu,
// surfel_forward.cu):
//   M::kCullRows     the table rows the culls read (the first ones);
//   M::kChRow        the first channel row: a column holds kChRow + nch;
//   M::kInterleave   pairs a thread culls together;
//   M::passes(c, stride, j, q)  whether pixel q's pair with staged column
//                    j (row r at c[r * stride + j]) passes every cull,
//                    evaluated without branches;
//   M::Chain         one pixel's state: `done`; visit(c, stride, j, q,
//                    nch, t_eps) evaluates the pair and takes the step
//                    where it passes -> whether the pixel stops there (the
//                    check stays on the path of a pair that passes);
//                    store(o, npx, nch) writes the rows.

constexpr int kChunkCols = 256;  // columns of a walk chunk
constexpr int kChunkWords = kChunkCols / 32;   // its mask words
constexpr int kWalkStages = 3;   // walk chunks in shared memory
constexpr int kWalkBlocksPerSM = 2;
constexpr int kMaxWalks = 16;    // deferred walks a block lists

// Regions of the forward cull over a table of num_inst columns: none when
// no tile can be long.
__host__ __device__ inline int64_t cull_regions(int64_t num_inst) {
  return num_inst > kFwdLong ? (num_inst + kFwdUnit - 1) / kFwdUnit : 0;
}

// Words of the survivor mask over num_inst columns: kFwdWords a region, the
// last region only those its columns need (it holds no tile's first
// segment), so that the mask holds 32 (1 + 32 / kFwdUnit) bytes a column
// at 256 pixels.
__host__ __device__ inline int64_t cull_words(int64_t num_inst) {
  const int64_t m = cull_regions(num_inst);
  return m ? (m - 1) * kFwdWords + (num_inst - (m - 1) * kFwdUnit + 31) / 32
           : 0;
}

// int32 words of the forwards' workspace, none for tiles of more than
// kCullMaxPx pixels: the survivor mask (cull_words x npx), then per region
// the mark of a long tile that holds its first column, of one that holds
// its last, and the counter of the culled tile that starts in it. At 16x16
// tiles it holds at most 34.1 bytes a column, under the table's 4 (6 + nch)
// for 3DGS at nch >= 3 and for surfels.
__host__ __device__ inline int64_t work_words(int64_t num_inst, int npx) {
  return npx <= kCullMaxPx
             ? cull_words(num_inst) * npx + 3 * cull_regions(num_inst)
             : 0;
}

// The current device's SMs (read once).
inline int sm_count() {
  static int sms = 0;
  if (!sms) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  return sms > 0 ? sms : 1;
}

struct Segment {
  int64_t start, end;   // columns [start, end)
  int64_t word;         // the mask word of its first 32 columns
};

// The segment of the long tile [s, e) that starts at column c, which is s
// or the first column of a region inside the tile.
__host__ __device__ inline Segment segment(int64_t s, int64_t e, int64_t c) {
  const int64_t j = c / kFwdUnit;
  const int64_t r_end = (j + 1) * kFwdUnit;
  Segment g;
  g.start = c;
  g.end = e < r_end ? e : r_end;
  g.word = j * kFwdWords +
           (c == j * kFwdUnit ? 0 : kFwdWords - (g.end - c + 31) / 32);
  return g;
}

// Segments a long tile [s, e) is cut into.
__device__ __forceinline__ int64_t tile_segments(int64_t s, int64_t e) {
  return (e - 1) / kFwdUnit - s / kFwdUnit + 1;
}

// The first launch's marks of long tile t = [s, e): for every region whose
// first column lies in the tile, the tile if culled (else -1); for every
// region whose last column lies in it, the tile if culled and starting
// inside that region (else -1); a culled tile's counter starts at 0.
// Called by every thread of the block.
__device__ __forceinline__ void mark_long(int64_t s, int64_t e, int32_t t,
                                          bool culled, int64_t regions,
                                          int32_t* __restrict__ map) {
  for (int64_t j = (s + kFwdUnit - 1) / kFwdUnit + threadIdx.x;
       j < (e + kFwdUnit - 1) / kFwdUnit && j < regions; j += blockDim.x)
    map[j] = culled ? t : -1;
  for (int64_t j = s / kFwdUnit + threadIdx.x; j < e / kFwdUnit && j < regions;
       j += blockDim.x)
    map[regions + j] = culled && s > j * kFwdUnit ? t : -1;
  if (culled && threadIdx.x == 0) map[2 * regions + s / kFwdUnit] = 0;
}

// The mark at map[i] of the region column `col` (its first or its last):
// the tile it names if that is the long tile holding col, which wrote it
// in this call; else -1 (a culled tile's mark, or what an earlier use of
// the memory left there).
__device__ __forceinline__ int32_t read_mark(
    const int32_t* __restrict__ map, int64_t i,
    const int32_t* __restrict__ tile_start, int32_t num_tiles, int64_t col) {
  const int32_t t = map[i];
  if (t < 0 || t >= num_tiles) return -1;
  const int64_t s = tile_start[t], e = tile_start[t + 1];
  return s <= col && col < e && e - s > kFwdLong ? t : -1;
}

// The centre of pixel p of tile t.
__device__ __forceinline__ float2 pixel(int32_t t, int p, int32_t tiles_x,
                                        int32_t tile_size) {
  return make_float2(
      (float)((t % tiles_x) * tile_size + p % tile_size) + 0.5f,
      (float)((t / tiles_x) * tile_size + p / tile_size) + 0.5f);
}

// Copies rows [0, rows) of table column `col` to dst[r * stride] without
// waiting, one cp.async each, so that every row's load is in flight at
// once; the caller commits and waits.
__device__ __forceinline__ void stage_column(float* dst, int stride,
                                             const float* __restrict__ table,
                                             int64_t num_inst, int rows,
                                             int64_t col) {
  for (int r = 0; r < rows; ++r)
    __pipeline_memcpy_async(dst + r * stride, table + r * num_inst + col,
                            sizeof(float));
}

// Whether the long tile t starting at column s is dense (the probe above):
// warp 0 stages the tile's first kProbeCols columns' culled rows in
// `scratch` (row r of column c at scratch[r * kProbeCols + c]) and counts
// the pairs of its sample pixels that pass. Called by every thread of the
// block, before it uses `scratch` otherwise.
template <class M>
__device__ __forceinline__ bool dense_tile(int32_t t, int64_t s,
                                           int32_t tiles_x, int32_t tile_size,
                                           float* scratch,
                                           const float* __restrict__ table,
                                           int64_t num_inst) {
  static_assert(kProbeCols == 32, "one column a lane");
  __shared__ int dense;
  if (threadIdx.x < 32) {
    // every row in flight at once, without a register per address
#pragma unroll 1
    for (int r = 0; r < M::kCullRows; ++r)
      __pipeline_memcpy_async(scratch + r * kProbeCols + threadIdx.x,
                              table + r * num_inst + s + threadIdx.x,
                              sizeof(float));
    __pipeline_commit();
    __pipeline_wait_prior(0);
    __syncwarp();
    const float2 q = pixel(t, threadIdx.x * (tile_size * tile_size / 32),
                           tiles_x, tile_size);
    int busy = 0;
#pragma unroll 1
    for (int c = 0; c < kProbeCols; ++c)
      busy += M::passes(scratch, kProbeCols, c, q) ? 1 : 0;
    const unsigned m = __ballot_sync(kFull, busy >= kProbeBusy);
    if (threadIdx.x == 0) dense = __popc(m) >= kProbeDense;
  }
  __syncthreads();
  const bool out = dense;
  __syncthreads();   // before scratch or `dense` is written again
  return out;
}

// The chunks of a culled tile [s, e) that the walk stages one at a time:
// kChunkCols columns each, cut at its segments' ends, so that a chunk's
// columns, and its mask words, are consecutive. Chunk i starts at column
// col(i), holds cols(i) columns and mask words from word(i) on.
struct TileChunks {
  static constexpr int kPerRegion = kFwdUnit / kChunkCols;
  int64_t s, e, c1, w0, w1;
  int64_t n0, n;   // chunks of the first segment, and of the tile

  __device__ TileChunks(int64_t s_, int64_t e_) : s(s_), e(e_) {
    const Segment g = segment(s, e, s);
    w0 = g.word;
    c1 = g.end;                      // the next region's first column
    w1 = c1 / kFwdUnit * kFwdWords;
    n0 = (c1 - s + kChunkCols - 1) / kChunkCols;
    n = n0 + (e - c1 + kChunkCols - 1) / kChunkCols;
  }
  __device__ int64_t col(int64_t i) const {
    return i < n0 ? s + kChunkCols * i : c1 + kChunkCols * (i - n0);
  }
  __device__ int cols(int64_t i) const {
    const int64_t end = i < n0 ? c1
        : min(e, c1 + ((i - n0) / kPerRegion + 1) * (int64_t)kFwdUnit);
    return (int)min((int64_t)kChunkCols, end - col(i));
  }
  __device__ int64_t word(int64_t i) const {
    if (i < n0) return w0 + i * kChunkWords;
    const int64_t r = i - n0;
    return w1 + r / kPerRegion * kFwdWords + r % kPerRegion * kChunkWords;
  }
};

// Pass 1 over a marked segment g of tile t: its survivor bits, the
// columns' culled rows staged in `buf` (2 x kCullRows x kChunk floats)
// with double buffering.
template <class M>
__device__ __forceinline__ void cull_segment(
    const Segment& g, int32_t t, const float* __restrict__ table,
    int64_t num_inst, int32_t tiles_x, int32_t tile_size, float* buf,
    uint32_t* __restrict__ cull) {
  constexpr int rows = M::kCullRows;
  const int p = threadIdx.x;
  const int npx = blockDim.x;
  const float2 q0 = pixel(t, p, tiles_x, tile_size);
  const int n_pass = (int)((g.end - g.start + kChunk - 1) / kChunk);
  stage(buf, table, num_inst, rows, g.start,
        (int)min((int64_t)kChunk, g.end - g.start));
  for (int q = 0; q < n_pass; ++q) {
    const int64_t base = g.start + (int64_t)q * kChunk;
    const int n = (int)min((int64_t)kChunk, g.end - base);
    const float* chunk = buf + (q & 1) * rows * kChunk;
    if (q + 1 < n_pass) {
      const int64_t next = base + kChunk;
      stage(buf + ((q + 1) & 1) * rows * kChunk, table, num_inst, rows, next,
            (int)min((int64_t)kChunk, g.end - next));
      __pipeline_wait_prior(1);
    } else {
      __pipeline_wait_prior(0);
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kChunk / 32; ++k) {
      if (32 * k >= n) break;
      uint32_t w = 0u;
#pragma unroll 1
      for (int b0 = 0; b0 < 32; b0 += M::kInterleave) {
#pragma unroll
        for (int i = 0; i < M::kInterleave; ++i) {
          const int b = b0 + i;
          if (M::passes(chunk, kChunk, 32 * k + b, q0) && 32 * k + b < n)
            w |= 1u << b;
        }
      }
      cull[(g.word + 2 * q + k) * npx + p] = w;
    }
    // before the next stage overwrites this buffer
    __syncthreads();
  }
}

// Pass 2 over culled long tile t = [s0, e0): each pixel walks the
// survivors of its mask words, chunk by chunk (TileChunks), the columns
// and mask words of the next kWalkStages - 1 chunks copied into a ring of
// stages in `ring` while one is walked.
template <class M>
__device__ __forceinline__ void walk_tile(
    int32_t t, int64_t s0, int64_t e0, const float* __restrict__ table,
    int64_t num_inst, int32_t tiles_x, int32_t tile_size, int32_t nch,
    float t_eps, const uint32_t* __restrict__ cull, float* ring,
    float* __restrict__ out) {
  const int p = threadIdx.x;
  const int npx = blockDim.x;
  const int rows = M::kChRow + nch;
  const float2 q0 = pixel(t, p, tiles_x, tile_size);
  typename M::Chain c;
  const TileChunks tc(s0, e0);
  // a stage: the chunk's columns (rows x kChunkCols), then its mask words
  // (kChunkWords x npx)
  const int stage_floats = rows * kChunkCols + kChunkWords * npx;
  auto stage_of = [&](int64_t i) {
    return ring + (i % kWalkStages) * stage_floats;
  };
  // chunk i's columns, consecutive in every row, and its mask words,
  // consecutive too (16 bytes a copy; the cp.async reads them from L2,
  // where the other blocks of this launch wrote them)
  auto issue = [&](int64_t i) {
    if (i < tc.n) {
      const int n = tc.cols(i);
      for (int k = p; k < n; k += npx)
        stage_column(stage_of(i) + k, kChunkCols, table, num_inst, rows,
                     tc.col(i) + k);
      const int per_word = npx / 4;
      const uint32_t* src = cull + tc.word(i) * npx;
      float* dst = stage_of(i) + rows * kChunkCols;
      for (int k = p; k < (n + 31) / 32 * per_word; k += npx)
        __pipeline_memcpy_async(dst + 4 * k, src + 4 * k, 16);
    }
    __pipeline_commit();
  };
  for (int i = 0; i < kWalkStages - 1; ++i) issue(i);
  for (int64_t i = 0; i < tc.n; ++i) {
    issue(i + kWalkStages - 1);
    __pipeline_wait_prior(kWalkStages - 1);
    __syncthreads();
    const float* ch = stage_of(i);
    const int nw = (tc.cols(i) + 31) / 32;
    const uint32_t* staged =
        reinterpret_cast<const uint32_t*>(ch + rows * kChunkCols) + p;
    uint32_t bits[kChunkWords];
#pragma unroll
    for (int w = 0; w < kChunkWords; ++w)
      bits[w] = !c.done && w < nw ? staged[w * npx] : 0u;
#pragma unroll
    for (int w = 0; w < kChunkWords; ++w) {
      while (bits[w] && !c.done) {
        const int j = 32 * w + __ffs(bits[w]) - 1;
        bits[w] &= bits[w] - 1u;
        c.visit(ch, kChunkCols, j, q0, nch, t_eps);
      }
    }
    // also the barrier before a later chunk overwrites this one
    if (__syncthreads_and(c.done)) break;
  }
  __pipeline_wait_prior(0);
  c.store(out + (int64_t)t * 8 * npx + p, npx, nch);
}

// The first launch: block t walks tile t in one pass, chunks of blockDim
// columns staged in shared memory with coalesced row reads, every pixel
// walking a chunk in order and the block leaving once every pixel has
// stopped (__syncthreads_and); a long tile that the probe finds sparse is
// marked for the second launch instead.
template <class M>
__global__ void tile_kernel(const float* __restrict__ table,
                            int64_t num_inst,
                            const int32_t* __restrict__ tile_start,
                            int32_t tiles_x, int32_t tile_size, int32_t nch,
                            float t_eps, int64_t regions,
                            int32_t* __restrict__ map,
                            float* __restrict__ out) {
  extern __shared__ float chunk[];  // (kChRow + nch) rows x blockDim
  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const int npx = blockDim.x;
  const int rows = M::kChRow + nch;
  const int32_t s0 = tile_start[t];
  const int32_t e0 = tile_start[t + 1];
  if (regions > 0 && e0 - s0 > kFwdLong) {
    const bool culled = !dense_tile<M>(t, s0, tiles_x, tile_size, chunk,
                                       table, num_inst);
    mark_long(s0, e0, t, culled, regions, map);
    if (culled) return;
  }

  const float2 q0 = pixel(t, p, tiles_x, tile_size);
  typename M::Chain c;
  for (int32_t base = s0; base < e0; base += npx) {
    const int32_t k = base + p;
    if (k < e0)
      for (int r = 0; r < rows; ++r)
        chunk[r * npx + p] = table[(int64_t)r * num_inst + k];
    __syncthreads();
    const int n = min(npx, e0 - base);
    if (!c.done)
      for (int j = 0; j < n; ++j)
        if (c.visit(chunk, npx, j, q0, nch, t_eps)) break;
    // also the barrier before the next chunk overwrites shared memory
    if (__syncthreads_and(c.done)) break;
  }
  c.store(out + (int64_t)t * 8 * npx + p, npx, nch);
}

// The second launch: a few blocks per SM (kWalkBlocksPerSM), block b
// reading the marks of regions b, b + gridDim.x, ... at once (no block per
// region: at 1M splats most of the 32,768 regions hold no marked tile),
// culling each marked segment and then walking each tile whose last
// segment it culled (at once should its list be full).
template <class M>
__global__ void cull_walk_kernel(const float* __restrict__ table,
                                 int64_t num_inst,
                                 const int32_t* __restrict__ tile_start,
                                 int32_t num_tiles, int32_t tiles_x,
                                 int32_t tile_size, int32_t nch, float t_eps,
                                 int64_t regions, int32_t* __restrict__ work,
                                 float* __restrict__ out) {
  extern __shared__ float smem[];
  __shared__ int32_t todo[2 * 2 * kCullMaxPx];   // (region, 2 tile + slot)
  __shared__ int32_t walks[kMaxWalks];           // tiles this block walks
  __shared__ int ntodo, last, nwalks;
  if (threadIdx.x == 0) nwalks = 0;
  const int npx = blockDim.x;
  uint32_t* cull = reinterpret_cast<uint32_t*>(work);
  int32_t* map = work + cull_words(num_inst) * npx;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  auto walk = [&](int32_t t) {
    __threadfence();
    walk_tile<M>(t, tile_start[t], tile_start[t + 1], table, num_inst,
                 tiles_x, tile_size, nch, t_eps, cull, smem, out);
    __syncthreads();
  };
  for (int64_t base = blockIdx.x; base < regions; base += stride) {
    const int64_t j = base + (int64_t)threadIdx.x * gridDim.x;
    int32_t a = -1, b = -1;
    if (j < regions) {
      a = read_mark(map, j, tile_start, num_tiles, j * kFwdUnit);
      b = read_mark(map, regions + j, tile_start, num_tiles,
                    (j + 1) * kFwdUnit - 1);
    }
    if (threadIdx.x == 0) ntodo = 0;
    if (!__syncthreads_or(a >= 0 || b >= 0)) continue;
    if (a >= 0) {
      const int k = atomicAdd(&ntodo, 1);
      todo[2 * k] = (int32_t)j;
      todo[2 * k + 1] = 2 * a;
    }
    if (b >= 0) {
      const int k = atomicAdd(&ntodo, 1);
      todo[2 * k] = (int32_t)j;
      todo[2 * k + 1] = 2 * b + 1;
    }
    __syncthreads();
    const int n = ntodo;
    for (int k = 0; k < n; ++k) {
      const int64_t jj = todo[2 * k];
      const int32_t t = todo[2 * k + 1] >> 1;
      const int64_t s = tile_start[t], e = tile_start[t + 1];
      const Segment g =
          segment(s, e, todo[2 * k + 1] & 1 ? s : jj * kFwdUnit);
      cull_segment<M>(g, t, table, num_inst, tiles_x, tile_size, smem, cull);
      __threadfence();
      __syncthreads();
      if (threadIdx.x == 0) {
        last = atomicAdd(map + 2 * regions + s / kFwdUnit, 1) ==
               tile_segments(s, e) - 1;
        if (last && nwalks < kMaxWalks) {
          walks[nwalks++] = t;
          last = 0;
        }
      }
      __syncthreads();
      if (last) walk(t);   // the list is full: now
      __syncthreads();
    }
  }
  // the walks last, so that no other tile's segment waits for them
  __syncthreads();
  for (int k = 0; k < nwalks; ++k) walk(walks[k]);
}

// The two launches of a forward over model M, for the C entries: the
// first always, the second when a tile can be long; `work` holds
// work_words(num_inst, tile_size^2) int32 (null when that is 0).
template <class M>
int launch_forward(const float* table, int64_t num_inst,
                   const int32_t* tile_start, int32_t num_tiles,
                   int32_t tiles_x, int32_t tile_size, int32_t nch,
                   float t_eps, float* out, int32_t* work, void* stream) {
  if (num_tiles <= 0) return (int)cudaSuccess;
  const int threads = tile_size * tile_size;
  const int64_t regions =
      threads <= kCullMaxPx ? cull_regions(num_inst) : 0;
  if (threads % 32 || threads > 1024 || (regions > 0 && work == nullptr))
    return (int)cudaErrorInvalidValue;
  int32_t* map = regions ? work + cull_words(num_inst) * threads : nullptr;
  const size_t rows = M::kChRow + nch;
  const size_t smem = sizeof(float) * rows * threads;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        tile_kernel<M>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  tile_kernel<M><<<num_tiles, threads, smem, (cudaStream_t)stream>>>(
      table, num_inst, tile_start, tiles_x, tile_size, nch, t_eps, regions,
      map, out);
  if (regions > 0) {
    const int64_t blocks = std::min<int64_t>(
        regions, (int64_t)kWalkBlocksPerSM * sm_count());
    const size_t smem2 =
        sizeof(float) *
        std::max(kWalkStages * (rows * (size_t)kChunkCols +
                                kChunkWords * (size_t)threads),
                 (size_t)2 * M::kCullRows * kChunk);
    // the walk's stages need more than 48 KB: set once for the largest
    // size asked so far
    static size_t smem2_set = 0;
    if (smem2 > smem2_set) {
      const cudaError_t err = cudaFuncSetAttribute(
          cull_walk_kernel<M>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)smem2);
      if (err != cudaSuccess) return (int)err;
      smem2_set = smem2;
    }
    cull_walk_kernel<M><<<(unsigned)blocks, threads, smem2,
                          (cudaStream_t)stream>>>(
        table, num_inst, tile_start, num_tiles, tiles_x, tile_size, nch,
        t_eps, regions, work, out);
  }
  return (int)cudaGetLastError();
}

}  // namespace units
