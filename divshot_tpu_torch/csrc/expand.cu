// Instance expansion for tile binning, CUDA C++ for sm_90a.
//
// Replaces: the Pallas TPU kernel `_expand_kernel` in
//   divshot_tpu/raster/pallas_bin.py (called by `expand_sorted`).
// Computes: for each instance slot i < cap, the owning gaussian g (the last
//   g with offsets[g] <= i), its local index j = i - offsets[g], the tile
//   (tmin_x + j % nx, tmin_y + j / nx), a corner cull (keep iff the squared
//   distance from (u, v) to the tile rectangle is <= rad2; a NaN u, v or
//   rad2 is culled), and the sort key: the 32-bit (tile << depth_bits) |
//   depth_key[g] with its top bit flipped, stored as int32, so that a
//   signed sort orders the keys as unsigned ones; a culled slot gets
//   0x7FFFFFFF (0xFFFFFFFF flipped), which sorts last. Slots >= total get
//   that key and owner 0x7FFFFFFF. With total > cap the first cap slots
//   are written.
// Bound on the H100: device-memory bytes. Each slot writes 8 bytes and
//   each gaussian that owns slots is read once; the arithmetic is a few
//   operations a slot. Where the demand is far below the capacity, most of
//   the time is the capacity tail's stores.
// Design: a load-balanced expansion. The gaussians and the cap slots are
//   merged into one sequence, a gaussian before its slots and the slots
//   past the demand (the tail) after every gaussian: gaussian g sits at
//   g + min(offsets[g], cap), slot i < S = min(total, cap) at i + (the
//   gaussians with offsets <= i), tail slot i at n + i. The sequence is
//   cut into pieces of kPiece items, so a piece's work is bounded however
//   the counts fall: runs of zero-count gaussians (culled splats, dead
//   capacity) use up items as slots do. Block b takes piece b. For a
//   piece that holds instances, one warp finds its first gaussian and one
//   its end (merge_start: a 32-way search of the gaussians' places between
//   d - S and d, ~4 dependent loads where the first port's binary search
//   per slot made ~20); the block stages its gaussians' places in shared
//   memory with coalesced loads; each thread walks kItems items there in
//   order, a slot taking the last gaussian passed as its owner (no search
//   per slot); then each thread computes the keys of kItems slots a
//   block's width apart, loading its owners' fields with independent loads
//   and storing with the warp's slots side by side. A piece of only
//   zero-count gaussians stops after the search; a piece of the tail only
//   stores, 16 bytes a store. The TPU kernel's one-hot matmul decode, bf16
//   splits, 7-bit offset transport and fixed window of gaussians per block
//   are gone. The cull uses explicitly rounded operations (no fused
//   multiply-add) so it decides exactly as the plain PyTorch version does.
#include <cuda_runtime.h>
#include "api.h"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
// items a thread walks; 4 against 8 measured faster at every cell but the
// 1M-splat frame (PERF.md, section 6)
constexpr int kItems = 4;
// merged items of a piece; raster/bin.py reads it from here
constexpr int32_t kPiece = 1024;
static_assert(kPiece == kThreads * kItems, "a block's piece");
static_assert((kPiece & (kPiece - 1)) == 0,
              "the binary lifting over a piece needs a power of two");
constexpr int kSkewed = kPiece + kPiece / 32;
constexpr int32_t kCulledKey = 0x7FFFFFFF;
constexpr int32_t kNoOwner = 0x7FFFFFFF;

struct Inputs {
  const int32_t* __restrict__ offsets;
  const int32_t* __restrict__ tmin_x;
  const int32_t* __restrict__ tmin_y;
  const int32_t* __restrict__ nx;
  const int32_t* __restrict__ depth_key;
  const float* __restrict__ u;
  const float* __restrict__ v;
  const float* __restrict__ rad2;
  int32_t n, cap, tiles_x, tile_size, depth_bits;
  int32_t* __restrict__ key_out;
  int32_t* __restrict__ owner_out;
};

struct Shared {
  // place[k]: the place of gaussian g0 + k, counted from the piece's first
  // item; own[s]: the piece's gaussians before its slot s, whose owner is
  // then g0 - 1 + own[s]; both at skew(index)
  int32_t place[kSkewed];
  int32_t own[kSkewed];
  // the piece's first gaussian g0, the next piece's, and the first slot of
  // g0 - 1 counted from the piece's first slot
  int32_t bounds[3];
};

// shared-memory index of item s, one word of padding per 32, so that
// threads kItems words apart hit distinct banks
__device__ __forceinline__ int skew(int s) { return s + (s >> 5); }

// the place of gaussian g in the merged sequence; offsets[g] <= total, so
// the clamp at cap is the clamp at S
__device__ __forceinline__ int64_t place(const int32_t* __restrict__ offsets,
                                         int32_t g, int32_t cap) {
  return (int64_t)g + min(__ldg(offsets + g), cap);
}

// The gaussians among the first d items of the merged sequence (the first
// g whose place is >= d, or n), found by a whole warp: each round its 32
// lanes probe 32 points of the range that holds the answer and keep the
// stretch where the comparison turns. The answer lies in [d - S, d] (at
// most S slots come before a gaussian) and in [0, n]; every lane returns
// it.
__device__ int32_t merge_start(const int32_t* __restrict__ offsets,
                               int32_t n, int32_t cap, int32_t slots,
                               int64_t d, int lane) {
  int32_t hi = (int32_t)min(d, (int64_t)n);
  int32_t lo = (int32_t)min(max((int64_t)0, d - slots), (int64_t)hi);
  // invariant: the answer is in [lo, hi], and hi is n or holds place >= d
  while (hi - lo > 32) {
    const int32_t p =
        lo + (int32_t)(((int64_t)(hi - lo) * (lane + 1)) >> 5);
    const bool ge = p >= hi || place(offsets, p, cap) >= d;
    const int f = __ffs(__ballot_sync(kFull, ge)) - 1;   // lane 31 holds
    const int32_t below = __shfl_sync(kFull, p, max(f - 1, 0));
    hi = __shfl_sync(kFull, p, f);
    if (f > 0) lo = below + 1;
  }
  const int32_t p = lo + lane;
  const unsigned ge =
      __ballot_sync(kFull, p >= hi || place(offsets, p, cap) >= d);
  return ge ? lo + __ffs(ge) - 1 : hi;
}

// p[a, b) = value, 16 bytes a store from the first 16-byte boundary on
__device__ void fill_words(int32_t* __restrict__ p, int32_t value, int32_t a,
                           int32_t b) {
  const int32_t head = (int32_t)((0u - (uint32_t)(
      reinterpret_cast<uintptr_t>(p + a) >> 2)) & 3u);
  const int32_t a4 = min(a + head, b);
  const int32_t b4 = a4 + ((b - a4) & ~3);
  for (int32_t s = a + (int32_t)threadIdx.x; s < a4; s += kThreads)
    p[s] = value;
  const int4 v4 = make_int4(value, value, value, value);
  for (int32_t s = a4 + 4 * (int32_t)threadIdx.x; s < b4; s += 4 * kThreads)
    *reinterpret_cast<int4*>(p + s) = v4;
  for (int32_t s = b4 + (int32_t)threadIdx.x; s < b; s += kThreads)
    p[s] = value;
}

// the cull and key of slot j of gaussian g (j < its count)
__device__ __forceinline__ int32_t slot_key(const Inputs& in, int32_t g,
                                            int32_t j) {
  const int32_t w = max(__ldg(in.nx + g), 1);
  const int32_t jy = j / w;
  const int32_t tx = __ldg(in.tmin_x + g) + (j - jy * w);
  const int32_t ty = __ldg(in.tmin_y + g) + jy;
  const float ts = (float)in.tile_size;
  const float ug = __ldg(in.u + g), vg = __ldg(in.v + g);
  const float ttx = __fmul_rn((float)tx, ts);
  const float tty = __fmul_rn((float)ty, ts);
  const float dx = fmaxf(fmaxf(__fsub_rn(ttx, ug),
                               __fsub_rn(ug, __fadd_rn(ttx, ts))), 0.0f);
  const float dy = fmaxf(fmaxf(__fsub_rn(tty, vg),
                               __fsub_rn(vg, __fadd_rn(tty, ts))), 0.0f);
  // fmaxf drops a NaN operand where the plain version's maximum keeps it,
  // so a NaN centre is culled explicitly; a NaN rad2 fails the compare
  const bool keep = !isnan(ug) && !isnan(vg) &&
                    __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)) <=
                        __ldg(in.rad2 + g);
  const uint32_t tile = (uint32_t)(ty * in.tiles_x + tx);
  return keep ? (int32_t)(((tile << in.depth_bits) |
                           (uint32_t)__ldg(in.depth_key + g)) ^ 0x80000000u)
              : kCulledKey;
}

// The slots among the merged sequence's items [d0, d0 + kPiece); `slots`
// is S. Every thread of the block calls it, and it returns to all of them
// at once.
__device__ void expand_piece(const Inputs& in, int64_t d0, int32_t slots,
                             Shared& sh) {
  const int tid = threadIdx.x;
  const int64_t d1 = min(d0 + kPiece, (int64_t)in.n + in.cap);
  if (d0 >= (int64_t)in.n + slots) {
    // every item is a tail slot, slot i at item n + i
    const int32_t a = (int32_t)(d0 - in.n), b = (int32_t)(d1 - in.n);
    fill_words(in.key_out, kCulledKey, a, b);
    fill_words(in.owner_out, kNoOwner, a, b);
    return;
  }
  if (tid < 64) {
    const int32_t g = merge_start(in.offsets, in.n, in.cap, slots,
                                  tid < 32 ? d0 : d1, tid & 31);
    if ((tid & 31) == 0) sh.bounds[tid >> 5] = g;
  }
  __syncthreads();
  const int32_t g0 = sh.bounds[0];
  const int32_t ng = sh.bounds[1] - g0;            // the piece's gaussians
  const int32_t i0 = (int32_t)(d0 - g0);           // its first slot
  const int32_t ns = (int32_t)(d1 - d0) - ng;      // and its slots
  if (ns == 0) return;                             // zero-count gaussians
  for (int32_t k = tid; k < ng; k += kThreads)
    sh.place[skew(k)] = k + min(__ldg(in.offsets + g0 + k), in.cap) - i0;
  if (tid == 0)   // the first slot of g0 - 1, which owns the first slots
    sh.bounds[2] = g0 > 0 ? __ldg(in.offsets + g0 - 1) - i0 : 0;
  __syncthreads();

  // each thread walks its items [it, it + kItems) in order: a gaussian's
  // item passes it, a slot's takes the last one passed as its owner
  {
    const int32_t it = tid * kItems;
    int32_t k = 0;   // the gaussians before it
    for (int32_t step = kPiece; step > 0; step >>= 1)
      if (k + step <= ng && sh.place[skew(k + step - 1)] < it) k += step;
    int32_t s = it - k;
    const int32_t end = min(it + kItems, ns + ng);
    for (int32_t pos = it; pos < end; ++pos) {
      if (k < ng && sh.place[skew(k)] == pos)
        ++k;
      else
        sh.own[skew(s++)] = k;
    }
  }
  __syncthreads();

  // then the slots' keys, a warp's slots side by side
  const int32_t live = min(ns, slots - i0);        // slots below S
#pragma unroll
  for (int r = 0; r < kItems; ++r) {
    const int32_t s = tid + r * kThreads;
    if (s >= ns) break;
    int32_t key = kCulledKey, owner = kNoOwner;
    if (s < live) {
      const int32_t k = sh.own[skew(s)];
      // the max keeps a malformed input (offsets[0] > 0) in bounds
      owner = max(g0 + k - 1, 0);
      key = slot_key(in, owner,
                     s - (k > 0 ? sh.place[skew(k - 1)] - (k - 1)
                                : sh.bounds[2]));
    }
    in.key_out[i0 + s] = key;
    in.owner_out[i0 + s] = owner;
  }
}

__device__ __forceinline__ int32_t total_slots(
    const int32_t* __restrict__ offsets, const int32_t* __restrict__ counts,
    int32_t n, int32_t cap) {
  return n > 0 ? min(__ldg(offsets + n - 1) + __ldg(counts + n - 1), cap)
               : 0;
}

__host__ __device__ int32_t grid_pieces(int32_t n, int32_t cap) {
  return (int32_t)(((int64_t)n + cap + kPiece - 1) / kPiece);
}

// block b takes piece b
__global__ void __launch_bounds__(kThreads)
expand_kernel(Inputs in, const int32_t* __restrict__ counts) {
  __shared__ Shared sh;
  expand_piece(in, (int64_t)blockIdx.x * kPiece,
               total_slots(in.offsets, counts, in.n, in.cap), sh);
}

// merge_start at each piece's first item, for the check against the plain
// version of the split (raster/bin.py, expand_partition_plain): one warp a
// piece
__global__ void partition_kernel(const int32_t* __restrict__ offsets,
                                 const int32_t* __restrict__ counts,
                                 int32_t n, int32_t cap, int32_t pieces,
                                 int32_t* __restrict__ out) {
  const int32_t c = (int32_t)((blockIdx.x * blockDim.x + threadIdx.x) >> 5);
  if (c > pieces) return;   // whole warps leave together
  const int32_t g = merge_start(
      offsets, n, cap, total_slots(offsets, counts, n, cap),
      min((int64_t)c * kPiece, (int64_t)n + cap), threadIdx.x & 31);
  if ((threadIdx.x & 31) == 0) out[c] = g;
}

}  // namespace

extern "C" int divshot_expand(const int32_t* offsets, const int32_t* counts,
                              const int32_t* tmin_x, const int32_t* tmin_y,
                              const int32_t* nx, const int32_t* depth_key,
                              const float* u, const float* v,
                              const float* rad2, int32_t n, int32_t cap,
                              int32_t tiles_x, int32_t tile_size,
                              int32_t depth_bits, int32_t* key_out,
                              int32_t* owner_out, void* stream) {
  if (n < 0 || cap < 0 || (int64_t)n + cap + kPiece >= ((int64_t)1 << 31))
    return (int)cudaErrorInvalidValue;
  if (cap == 0) return (int)cudaSuccess;
  const Inputs in{offsets, tmin_x,  tmin_y,    nx,         depth_key,
                  u,       v,       rad2,      n,          cap,
                  tiles_x, tile_size, depth_bits, key_out, owner_out};
  expand_kernel<<<grid_pieces(n, cap), kThreads, 0, (cudaStream_t)stream>>>(
      in, counts);
  return (int)cudaGetLastError();
}

extern "C" int divshot_expand_partition(const int32_t* offsets,
                                        const int32_t* counts, int32_t n,
                                        int32_t cap, int32_t pieces,
                                        int32_t* out, void* stream) {
  if (n < 0 || cap < 0 || (int64_t)n + cap + kPiece >= ((int64_t)1 << 31) ||
      pieces != grid_pieces(n, cap))
    return (int)cudaErrorInvalidValue;
  const int64_t threads = 32 * ((int64_t)pieces + 1);
  partition_kernel<<<(unsigned)((threads + kThreads - 1) / kThreads),
                     kThreads, 0, (cudaStream_t)stream>>>(offsets, counts, n,
                                                          cap, pieces, out);
  return (int)cudaGetLastError();
}
