// Per-gaussian sums of a backward kernel's per-instance rows, CUDA C++ for
// sm_90a.
//
// Replaces no Pallas kernel. JAX sums these rows in XLA
//   (divshot_tpu/raster/pallas_bin.py, `segment_rows_sorted` and
//   `reduce_grads_sorted`) as the difference E[g] - E[g-1] of two entries of
//   one cumsum over the whole instance capacity. On the card a float32
//   cumsum groups its additions by the timing of its blocks, so that sum
//   differed from run to run, and each gaussian's sum carried the rounding
//   of the prefix before it (about eps x the prefix, which grows with the
//   capacity). This kernel gives each gaussian the sum of its own terms
//   only, in an order the code fixes, the same on every launch.
// Computes: out[r][g] = sum of grads[row0 + r * row_step][exp2sorted[i]]
//   over the expansion slots i of gaussian g, [offsets[g], offsets[g] +
//   counts[g]) cut at the capacity icap, skipping every sorted position at
//   or past tile_start[num_tiles] (culled instances and the capacity tail,
//   which no backward kernel writes). tile_start[num_tiles] is read here, on
//   the card. A gaussian without instances gets 0; a NaN in a live term
//   gives NaN.
// Bound on the H100: device-memory bytes. Each live instance's selected
//   rows are read once (a gather: the instances of a gaussian lie in
//   different tiles, so each 4-byte read costs a 32-byte sector), its slot's
//   index once, each gaussian's offset and count once, and each sum is
//   written once; the arithmetic is one add a term.
// Design: no float atomics, no cumsum, no read of the count on the host.
//   A block of kThreads threads takes kGroups consecutive gaussians. Each
//   gaussian is summed by a team whose width depends on its count alone:
//   up to kShort slots by a group of kGroupLanes lanes (most splats cover a
//   few tiles, so a whole warp would idle), up to kLong by a warp, past
//   kLong (a large splat on the XLA binning, which covers thousands of
//   tiles) by the whole block. A team's threads stride the segment (thread
//   t adds slots t, t + width, ... in order), kRows rows at a time, so a
//   slot's index is loaded once for those rows and their gathers are in
//   flight together; then a fixed __shfl_xor_sync butterfly adds a group's
//   or a warp's lanes, and for a block one thread adds the warp sums in
//   warp order. Every launch therefore adds the same terms in the same
//   order.
#include <cuda_runtime.h>
#include <stdint.h>
#include "api.h"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// a short segment's team: kGroupLanes lanes, kGroups of them a block
constexpr int kGroupLanes = 8;
constexpr int kGroups = kThreads / kGroupLanes;
static_assert(kGroups <= kThreads, "one thread loads each segment");
// rows summed in one pass over a segment (their accumulators in registers)
constexpr int kRows = 16;
// segments up to kShort slots go to a group, up to kLong to a warp, longer
// ones to the block
constexpr int32_t kShort = 64;
constexpr int32_t kLong = 512;

struct Args {
  const float* __restrict__ grads;
  int64_t icap;
  int32_t row0, row_step, nrows;
  const int32_t* __restrict__ tile_start;
  int32_t num_tiles;
  const int32_t* __restrict__ exp2sorted;
  const int32_t* __restrict__ offsets;
  const int32_t* __restrict__ counts;
  int32_t n;
  float* __restrict__ out;
};

// Gaussian g's slots [lo, hi), cut at the capacity; empty for a gaussian
// without instances or past the last one.
__device__ __forceinline__ void segment(const Args& a, int32_t g,
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
// t, lo + t + stride, ... below hi, in that order.
__device__ __forceinline__ void partial(const Args& a, int32_t kept,
                                        int64_t lo, int64_t hi, int t,
                                        int stride, int r0,
                                        float (&acc)[kRows]) {
#pragma unroll
  for (int k = 0; k < kRows; ++k) acc[k] = 0.0f;
  for (int64_t i = lo + t; i < hi; i += stride) {
    const int32_t j = a.exp2sorted[i];
    if (j >= kept) continue;
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      if (r0 + k < a.nrows) {
        const int64_t row = a.row0 + (int64_t)(r0 + k) * a.row_step;
        acc[k] += a.grads[row * a.icap + j];
      }
    }
  }
}

// The sum over aligned teams of kWidth lanes (a power of two up to 32) of
// each accumulator, by a fixed butterfly; every lane of a team ends with
// the same bits. Every lane of the warp calls it.
template <int kWidth>
__device__ __forceinline__ void team_tree(float (&acc)[kRows]) {
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
#pragma unroll
    for (int s = kWidth >> 1; s > 0; s >>= 1)
      acc[k] += __shfl_xor_sync(kFull, acc[k], s);
  }
}

__device__ __forceinline__ void store(const Args& a, int32_t g, int r0,
                                      const float (&acc)[kRows]) {
#pragma unroll
  for (int k = 0; k < kRows; ++k)
    if (r0 + k < a.nrows) a.out[(int64_t)(r0 + k) * a.n + g] = acc[k];
}

__global__ void __launch_bounds__(kThreads)
segment_kernel(Args a) {
  __shared__ float warp_sum[kWarps][kRows];
  // the block's gaussians' segments: the first slot and the length (-1 past
  // the last gaussian)
  __shared__ int64_t seg_lo[kGroups];
  __shared__ int32_t seg_len[kGroups];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int32_t base = blockIdx.x * kGroups;
  const int32_t kept = a.tile_start[a.num_tiles];

  bool medium = false, longer = false;
  if (threadIdx.x < kGroups) {
    const int32_t g = base + threadIdx.x;
    int64_t lo, hi;
    segment(a, g, lo, hi);
    const int64_t len = g < a.n ? hi - lo : -1;
    seg_lo[threadIdx.x] = lo;
    seg_len[threadIdx.x] = (int32_t)min(len, (int64_t)INT32_MAX);
    medium = len > kShort && len <= kLong;
    longer = len > kLong;
  }
  // barriers that also tell every thread whether the block has a medium
  // or a long segment
  const bool any_medium = __syncthreads_or(medium);
  const bool any_long = __syncthreads_or(longer);

  // the short segments: a group of kGroupLanes lanes each (a group whose
  // gaussian is not short adds nothing and stores nothing)
  {
    const int group = threadIdx.x / kGroupLanes;
    const int t = threadIdx.x % kGroupLanes;
    const int32_t len = seg_len[group];
    const bool mine = len >= 0 && len <= kShort;
    const int64_t lo = seg_lo[group];
    const int64_t hi = mine ? lo + len : lo;
    for (int r0 = 0; r0 < a.nrows; r0 += kRows) {
      float acc[kRows];
      partial(a, kept, lo, hi, t, kGroupLanes, r0, acc);
      team_tree<kGroupLanes>(acc);
      if (mine && t == 0) store(a, base + group, r0, acc);
    }
  }

  // the medium segments: warp w takes the block's gaussians w, w + kWarps,
  // ... whose segments are past kShort and up to kLong
  if (any_medium) {
    for (int q = warp; q < kGroups; q += kWarps) {
      const int32_t len = seg_len[q];
      if (len <= kShort || len > kLong) continue;
      const int64_t lo = seg_lo[q];
      for (int r0 = 0; r0 < a.nrows; r0 += kRows) {
        float acc[kRows];
        partial(a, kept, lo, lo + len, lane, 32, r0, acc);
        team_tree<32>(acc);
        if (lane == 0) store(a, base + q, r0, acc);
      }
    }
  }

  // the long segments: the whole block, one after another (the test reads
  // shared memory, the same in every thread, so the barriers are reached
  // by all)
  if (any_long) {
    for (int q = 0; q < kGroups; ++q) {
      const int32_t len = seg_len[q];
      if (len <= kLong) continue;
      const int64_t lo = seg_lo[q];
      for (int r0 = 0; r0 < a.nrows; r0 += kRows) {
        float acc[kRows];
        partial(a, kept, lo, lo + len, threadIdx.x, kThreads, r0, acc);
        team_tree<32>(acc);
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
          store(a, base + q, r0, acc);
        }
        __syncthreads();
      }
    }
  }
}

}  // namespace

extern "C" int divshot_segment_rows(const float* grads, int64_t icap,
                                    int32_t row0, int32_t row_step,
                                    int32_t nrows, const int32_t* tile_start,
                                    int32_t num_tiles,
                                    const int32_t* exp2sorted,
                                    const int32_t* offsets,
                                    const int32_t* counts, int32_t n,
                                    float* out, void* stream) {
  if (icap < 0 || nrows < 0 || num_tiles < 0 || n < 0)
    return (int)cudaErrorInvalidValue;
  if (n == 0 || nrows == 0) return (int)cudaSuccess;
  Args a{grads, icap, row0, row_step, nrows, tile_start, num_tiles,
         exp2sorted, offsets, counts, n, out};
  const unsigned blocks = (unsigned)((n + kGroups - 1) / kGroups);
  segment_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
