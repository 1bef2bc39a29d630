// Per-gaussian sums of a backward kernel's per-instance rows, CUDA C++ for
// sm_90a, in two launches: a stage and a reduce.
//
// Replaces no Pallas kernel. JAX sums these rows in XLA
//   (divshot_tpu/raster/pallas_bin.py, `segment_rows_sorted` and
//   `reduce_grads_sorted`) as the difference E[g] - E[g-1] of two entries of
//   one cumsum over the whole instance capacity. On the card a float32
//   cumsum groups its additions by the timing of its blocks, so that sum
//   differed from run to run, and each gaussian's sum carried the rounding
//   of the prefix before it (about eps x the prefix, which grows with the
//   capacity). These launches give each gaussian the sum of its own terms
//   only, in an order the code fixes, the same on every launch.
// Computes: out[r][g] = the sum, over the expansion slots s of gaussian g,
//   [offsets[g], offsets[g] + counts[g]) cut at the capacity icap, of
//   grads[row0 + r * row_step][j] for the sorted position j with perm[j] =
//   s; a position at or past tile_start[num_tiles] (culled instances and
//   the capacity tail, which no backward kernel writes) counts as 0.
//   tile_start[num_tiles] is read here, on the card. offsets is the
//   exclusive prefix sum of counts, so the segments cover the slots [0,
//   lim), lim = min(offsets[n-1] + counts[n-1], icap), read on the card
//   too; perm is a sort's permutation that keeps every slot past lim past
//   position lim, as both binnings' do (a stable sort in which the empty
//   slots' key, the largest, ties with the culled ones'): the positions [0,
//   lim) hold exactly the slots [0, lim). A gaussian without instances
//   gets 0; a NaN in a live term gives NaN.
// Bound on the H100: device-memory bytes; the arithmetic is one add a
//   term. A splat's instances lie in different tiles, so in the sorted rows
//   its terms are scattered: read where they lie, each 4-byte term would
//   cost a 32-byte sector. The stage therefore moves every position's rows
//   once, with whole-line reads, into an instance-major record in expansion
//   order, and the reduce reads each splat's records as one contiguous run.
// Launch A, stage_kernel: one wave of blocks walks the positions [0, lim)
//   (never the capacity past the demand) in chunks of kStageThreads, a
//   thread a position. A chunk's rows are read with neighbouring threads
//   on neighbouring addresses of each feature-major row, its slots perm[j]
//   beside them, turned in shared memory, and each record (stride floats,
//   a multiple of 8: whole 32-byte sectors, 16-byte aligned) written with
//   16-byte stores, a record's pieces by neighbouring threads. A live
//   position's record holds its rows and zeros in the padding; a culled
//   one gets zeros, so the reduce needs no slot index and a NaN in a culled
//   row cannot leak.
// Launch B, reduce_kernel: no float atomics, no cumsum. A block takes
//   kTiles tiles of kGroups consecutive gaussians, whose segments it loads
//   at once (a warp a tile, each tile's classes by ballot), so that a
//   splat without instances costs neither a load nor a barrier of its own.
//   Each gaussian is summed by a team whose width depends on its count
//   alone: up to kShort slots by a group of kGroupLanes lanes (most splats
//   cover a few tiles, so a whole warp would idle), up to kLong by a warp,
//   past kLong (a large splat on the XLA binning, which covers thousands of
//   tiles) by the whole block. A team's threads stride the segment (thread
//   t adds slots t, t + width, ... in order), kRows rows at a time, each
//   record's rows read with 16-byte loads, so a team's lanes read
//   neighbouring records; then a fixed __shfl_xor_sync butterfly adds a
//   group's or a warp's lanes, and for a block one thread adds the warp
//   sums in warp order. Every launch therefore adds the same terms in the
//   same order (a culled term adds +0.0 to a sum that starts at +0.0 and
//   so is never -0.0, and a butterfly over lanes that hold +0.0 but one
//   changes no bit: neither is skipped or taken by anything but the
//   counts). The block's sums wait in shared memory and are written row by
//   row, kTiles * kGroups neighbouring gaussians at a time.
#include <cuda_runtime.h>
#include <stdint.h>
#include "api.h"

namespace {

constexpr unsigned kFull = 0xffffffffu;
// the stage: positions a chunk, and the widest record (floats)
constexpr int kStageThreads = 256;
constexpr int kMaxStride = 32;
// the reduce
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// a short segment's team: kGroupLanes lanes, kGroups of them a tile (one
// warp loads a tile's segments), kTiles tiles a block
constexpr int kGroupLanes = 8;
constexpr int kGroups = kThreads / kGroupLanes;
constexpr int kTiles = kWarps;
constexpr int kBlockGaussians = kTiles * kGroups;
static_assert(kGroups == 32 && kBlockGaussians == kThreads,
              "a warp loads a tile, a thread a gaussian");
// rows summed in one pass over a segment (their accumulators in registers)
constexpr int kRows = 16;
static_assert(kRows % 4 == 0 && kMaxStride % kRows == 0, "16-byte pieces");
// segments up to kShort slots go to a group, up to kLong to a warp, longer
// ones to the block
constexpr int32_t kShort = 64;
constexpr int32_t kLong = 512;
// a tile's classes
constexpr int kHasShort = 1, kHasMedium = 2, kHasLong = 4;

// The end of the slots that the segments cover: the demand cut at icap.
__device__ __forceinline__ int64_t covered(const int32_t* offsets,
                                           const int32_t* counts, int32_t n,
                                           int64_t icap) {
  return min((int64_t)offsets[n - 1] + max(counts[n - 1], 0), icap);
}

struct StageArgs {
  const float* __restrict__ grads;
  int64_t icap;
  int32_t row0, row_step, nrows;
  const int32_t* __restrict__ tile_start;
  int32_t num_tiles;
  const int64_t* __restrict__ perm;
  const int32_t* __restrict__ offsets;
  const int32_t* __restrict__ counts;
  int32_t n;
  float* __restrict__ records;
  int32_t stride;
};

__global__ void __launch_bounds__(kStageThreads, 4)
stage_kernel(StageArgs a) {
  // a chunk's rows, turned: row r of position t at r * kPitch + t (the odd
  // pitch keeps the turned reads off each other's banks)
  constexpr int kPitch = kStageThreads + 1;
  extern __shared__ float turned[];
  __shared__ int64_t dest[kStageThreads];
  const int t = threadIdx.x;
  const int64_t kept = a.tile_start[a.num_tiles];
  const int64_t lim = covered(a.offsets, a.counts, a.n, a.icap);
  const int per = a.stride / 4;
  // the first selected row, and the step to the next
  const float* rows = a.grads + (int64_t)a.row0 * a.icap;
  const int64_t step = (int64_t)a.row_step * a.icap;

  for (int64_t base = (int64_t)blockIdx.x * kStageThreads; base < lim;
       base += (int64_t)gridDim.x * kStageThreads) {
    const int64_t j = base + t;
    int64_t slot = -1;
    bool live = false;
    if (j < lim) {
      const int64_t s = a.perm[j];
      if (s >= 0 && s < lim) {
        slot = s;
        live = j < kept;
      }
    }
    // the rows' loads all in flight, each address one step past the last
    // (no product a row kept across chunks)
    float v[kMaxStride];
    const float* src = rows + j;
#pragma unroll
    for (int r = 0; r < kMaxStride; ++r) {
      v[r] = 0.0f;
      if (live && r < a.nrows) v[r] = *src;
      src += step;
    }
#pragma unroll
    for (int r = 0; r < kMaxStride; ++r)
      if (r < a.stride) turned[r * kPitch + t] = v[r];
    dest[t] = slot;
    __syncthreads();

    // each 16-byte piece of a record by one thread, a record's pieces by
    // neighbouring threads
    for (int p = t; p < kStageThreads * per; p += kStageThreads) {
      const int k = p / per;
      const int q = p - k * per;
      const int64_t s = dest[k];
      if (s < 0) continue;
      const float* col = turned + 4 * q * kPitch + k;
      const float4 piece = make_float4(col[0], col[kPitch], col[2 * kPitch],
                                       col[3 * kPitch]);
      reinterpret_cast<float4*>(a.records + s * a.stride)[q] = piece;
    }
    // the next chunk reuses the shared arrays
    __syncthreads();
  }
}

struct ReduceArgs {
  const float* __restrict__ records;
  int32_t stride, nrows;
  const int32_t* __restrict__ offsets;
  const int32_t* __restrict__ counts;
  int32_t n;
  int64_t icap;
  float* __restrict__ out;
};

// Gaussian g's slots [lo, hi), cut at the capacity; empty for a gaussian
// without instances or past the last one.
__device__ __forceinline__ void segment(const ReduceArgs& a, int32_t g,
                                        int64_t& lo, int64_t& hi) {
  lo = hi = 0;
  if (g >= a.n) return;
  const int64_t off = a.offsets[g];
  const int64_t cnt = a.counts[g];
  lo = off;
  hi = cnt > 0 ? min(off + cnt, a.icap) : off;
  if (hi < lo) hi = lo;
}

// This thread's partial sums of rows [r0, r0 + kRows) over the slots lo +
// t, lo + t + step, ... below hi, in that order (the rows past nrows stay
// 0).
__device__ __forceinline__ void partial(const ReduceArgs& a, int64_t lo,
                                        int64_t hi, int t, int step, int r0,
                                        float (&acc)[kRows]) {
#pragma unroll
  for (int k = 0; k < kRows; ++k) acc[k] = 0.0f;
  // the 16-byte pieces that hold rows [r0, min(r0 + kRows, nrows)); the
  // stride covers them
  const int pieces = (min(kRows, a.nrows - r0) + 3) / 4;
  for (int64_t i = lo + t; i < hi; i += step) {
    const float4* rec =
        reinterpret_cast<const float4*>(a.records + i * a.stride + r0);
#pragma unroll
    for (int q = 0; q < kRows / 4; ++q) {
      if (q < pieces) {
        const float4 x = __ldg(rec + q);
        acc[4 * q] += x.x;
        acc[4 * q + 1] += x.y;
        acc[4 * q + 2] += x.z;
        acc[4 * q + 3] += x.w;
      }
    }
  }
}

// The sum over aligned teams of kWidth lanes (a power of two up to 32) of
// each accumulator of rows below nrows, by a fixed butterfly; every lane of
// a team ends with the same bits. Every lane of the warp calls it.
template <int kWidth>
__device__ __forceinline__ void team_tree(float (&acc)[kRows], int r0,
                                          int nrows) {
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    if (r0 + k >= nrows) break;
#pragma unroll
    for (int s = kWidth >> 1; s > 0; s >>= 1)
      acc[k] += __shfl_xor_sync(kFull, acc[k], s);
  }
}

// The block's sums of its gaussian q, rows [r0, r0 + kRows), into shared
// memory.
__device__ __forceinline__ void keep(const ReduceArgs& a,
                                     float (*sums)[kMaxStride + 1], int q,
                                     int r0, const float (&acc)[kRows]) {
#pragma unroll
  for (int k = 0; k < kRows; ++k)
    if (r0 + k < a.nrows) sums[q][r0 + k] = acc[k];
}

__global__ void __launch_bounds__(kThreads, 4)
reduce_kernel(ReduceArgs a) {
  __shared__ float warp_sum[kWarps][kRows];
  // the block's sums, [gaussian][row] (the odd pitch keeps a row's reads
  // off each other's banks)
  __shared__ float sums[kBlockGaussians][kMaxStride + 1];
  // the block's gaussians' segments: the first slot and the length (-1 past
  // the last gaussian), and each tile's classes
  __shared__ int64_t seg_lo[kBlockGaussians];
  __shared__ int32_t seg_len[kBlockGaussians];
  __shared__ int tile_class[kTiles];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int32_t first = blockIdx.x * kBlockGaussians;

  {
    const int32_t g = first + threadIdx.x;
    int64_t lo, hi;
    segment(a, g, lo, hi);
    const int64_t len = g < a.n ? hi - lo : -1;
    seg_lo[threadIdx.x] = lo;
    seg_len[threadIdx.x] = (int32_t)min(len, (int64_t)INT32_MAX);
    // warp w loads tile w
    const int cls =
        (__any_sync(kFull, len > 0 && len <= kShort) ? kHasShort : 0) |
        (__any_sync(kFull, len > kShort && len <= kLong) ? kHasMedium : 0) |
        (__any_sync(kFull, len > kLong) ? kHasLong : 0);
    if (lane == 0) tile_class[warp] = cls;
  }
  __syncthreads();

  for (int tile = 0; tile < kTiles; ++tile) {
    const int cls = tile_class[tile];
    const int q0 = tile * kGroups;

    // the short segments: a group of kGroupLanes lanes each (a group whose
    // gaussian is not short, or empty, adds nothing and keeps nothing)
    if (cls & kHasShort) {
      const int q = q0 + threadIdx.x / kGroupLanes;
      const int t = threadIdx.x % kGroupLanes;
      const int32_t len = seg_len[q];
      const bool mine = len > 0 && len <= kShort;
      // a warp whose segments hold at most one slot each needs no
      // butterfly: its lanes past the first hold +0.0
      const bool tree = __any_sync(kFull, mine && len > 1);
      if (__any_sync(kFull, mine)) {
        const int64_t lo = seg_lo[q];
        const int64_t hi = mine ? lo + len : lo;
        for (int r0 = 0; r0 < a.nrows; r0 += kRows) {
          float acc[kRows];
          partial(a, lo, hi, t, kGroupLanes, r0, acc);
          if (tree) team_tree<kGroupLanes>(acc, r0, a.nrows);
          if (mine && t == 0) keep(a, sums, q, r0, acc);
        }
      }
    }

    // the medium segments: warp w takes the tile's gaussians w, w +
    // kWarps, ... whose segments are past kShort and up to kLong
    if (cls & kHasMedium) {
      for (int q = q0 + warp; q < q0 + kGroups; q += kWarps) {
        const int32_t len = seg_len[q];
        if (len <= kShort || len > kLong) continue;
        const int64_t lo = seg_lo[q];
        for (int r0 = 0; r0 < a.nrows; r0 += kRows) {
          float acc[kRows];
          partial(a, lo, lo + len, lane, 32, r0, acc);
          team_tree<32>(acc, r0, a.nrows);
          if (lane == 0) keep(a, sums, q, r0, acc);
        }
      }
    }

    // the long segments: the whole block, one after another (the tests
    // read shared memory, the same in every thread, so the barriers are
    // reached by all)
    if (cls & kHasLong) {
      for (int q = q0; q < q0 + kGroups; ++q) {
        const int32_t len = seg_len[q];
        if (len <= kLong) continue;
        const int64_t lo = seg_lo[q];
        for (int r0 = 0; r0 < a.nrows; r0 += kRows) {
          float acc[kRows];
          partial(a, lo, lo + len, threadIdx.x, kThreads, r0, acc);
          team_tree<32>(acc, r0, a.nrows);
          if (lane == 0) {
#pragma unroll
            for (int k = 0; k < kRows; ++k) warp_sum[warp][k] = acc[k];
          }
          __syncthreads();
          if (threadIdx.x == 0) {
#pragma unroll
            for (int k = 0; k < kRows; ++k) {
              float sum = 0.0f;
              for (int v = 0; v < kWarps; ++v) sum += warp_sum[v][k];
              acc[k] = sum;
            }
            keep(a, sums, q, r0, acc);
          }
          __syncthreads();
        }
      }
    }
  }

  // the sums, row by row: the block's kBlockGaussians neighbouring
  // gaussians a row (0 for one without instances, whose sums no team kept)
  __syncthreads();
  for (int idx = threadIdx.x; idx < a.nrows * kBlockGaussians;
       idx += kThreads) {
    const int r = idx / kBlockGaussians;
    const int q = idx - r * kBlockGaussians;
    if (first + q < a.n)
      a.out[(int64_t)r * a.n + first + q] = seg_len[q] > 0 ? sums[q][r]
                                                           : 0.0f;
  }
}

bool bad_stride(int32_t stride, int32_t nrows) {
  return stride % 8 != 0 || stride < nrows || stride > kMaxStride ||
         stride - nrows >= 8;
}

}  // namespace

extern "C" int divshot_segment_stage(const float* grads, int64_t icap,
                                     int32_t row0, int32_t row_step,
                                     int32_t nrows, const int32_t* tile_start,
                                     int32_t num_tiles, const int64_t* perm,
                                     const int32_t* offsets,
                                     const int32_t* counts, int32_t n,
                                     float* records, int32_t stride,
                                     void* stream) {
  if (icap < 0 || nrows <= 0 || num_tiles < 0 || n < 0 ||
      bad_stride(stride, nrows))
    return (int)cudaErrorInvalidValue;
  if (n == 0 || icap == 0) return (int)cudaSuccess;
  StageArgs a{grads, icap, row0, row_step, nrows, tile_start, num_tiles,
              perm, offsets, counts, n, records, stride};
  const size_t smem = (size_t)stride * (kStageThreads + 1) * sizeof(float);
  // one wave of blocks (the demand, read on the card, sets the work), or
  // fewer where the capacity is small
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, stage_kernel, kStageThreads, smem);
  if (err != cudaSuccess) return (int)err;
  const int64_t chunks = (icap + kStageThreads - 1) / kStageThreads;
  const int64_t blocks = min(chunks, (int64_t)max(sms * per_sm, 1));
  stage_kernel<<<(unsigned)blocks, kStageThreads, smem,
                 (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

extern "C" int divshot_segment_reduce(const float* records, int32_t stride,
                                      int32_t nrows, const int32_t* offsets,
                                      const int32_t* counts, int32_t n,
                                      int64_t icap, float* out,
                                      void* stream) {
  if (icap < 0 || nrows <= 0 || n < 0 || bad_stride(stride, nrows))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  ReduceArgs a{records, stride, nrows, offsets, counts, n, icap, out};
  const unsigned blocks =
      (unsigned)((n + kBlockGaussians - 1) / kBlockGaussians);
  reduce_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
