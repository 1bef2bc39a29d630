// Backward alpha compositing per tile (the forward kernel's VJP), CUDA C++
// for sm_90a.
//
// Replaces: the Pallas TPU kernel `_backward_kernel` in
//   divshot_tpu/raster/pallas_raster.py (called by `rasterize_backward`).
// Computes: for tile t, one front-to-back sweep over its depth-sorted
//   instances [tile_start[t], tile_start[t+1]) of the feature-major table
//   (rows u v a b c log_op ch0..ch{nch-1}). The forward is recomputed with
//   forward.cu's rounded operations in forward.cu's order, so every cull,
//   alpha clamp and stop decision is the forward's. With the cotangent
//   tiles `cot` (T, 8, px) (channel cotangents in rows 0..nch-1,
//   g_T = g_alpha - g_img . bg in row 7) and the forward's output `fwd`
//   (T, 8, px) (final colours C_fin, final transmittance T_fin in row 7),
//   per (pixel, instance) applied before the pixel's stop:
//     cdot  = sum_ch g_ch c_ch,   w = alpha T_excl,
//     rear  = sum_ch g_ch (C_fin - C_incl)   (colour behind the instance),
//     dalpha = cdot T_excl + (g_T T_fin - rear) / (1 - alpha),
//     ds = dalpha alpha if log-alpha s < log 0.999 (not clamped), else 0,
//   and per instance the sums over the tile's pixels of
//     du = ds (a dx + b dy), dv = ds (b dx + c dy), da = -ds dx^2 / 2,
//     db = -ds dx dy, dc = -ds dy^2 / 2, dlog_op = ds, dch = g_ch w,
//     |du|, |dv| (AbsGS, only with `with_absgrad`), npix = count of ds
//     terms (PixelGS),
//   with dop = dlog_op exp(-max(log_op, -80)). Output (9 + nch, I) rows
//   [du dv da db dc dop dch.. |du| |dv| npix]: every column of the tile's
//   range is written once (zeros past the stop of every pixel); columns at
//   or past tile_start[T] are not written.
// Bound on the H100: the float32 arithmetic of the (pixel, instance) pairs
//   before each pixel's stop, ~2.5x the forward's per pair, and on a tile
//   whose pixels never stop the forward's walk of that tile (the deepest
//   unit's prefix).
// Design, against the three limits of the first port (one block per tile;
//   every instance reduced by a 5-step shuffle butterfly per row on every
//   warp that touched it; a barrier pair every 32 instances):
//   - the per-instance reduction: one thread per pixel; a warp that
//     applied the instance transposes and sums its 16 reduced rows
//     across its lanes (units.cuh: 16 shuffles, not 5 per row), the rows
//     in fixed places (the channels last, so that no index depends on
//     nch); npix is a ballot count; the warp stores its partials only for
//     an instance it applied, and its 64-bit applied mask tells the
//     cross-warp sum which to read; the AbsGS rows are neither computed
//     nor summed without `with_absgrad`. Two pixels a thread, which
//     halves the warps to reduce, measured slower: the walk's latency
//     bounds the long tiles, not the reduction (PERF.md, section 6);
//   - the barriers: kChunk = 64 columns a pass, the next pass's columns
//     copied in with cp.async while this one is walked;
//   - long tiles: a tile is cut into units of at most kUnit instances,
//     each in its own block, which first re-walks the tile's prefix with
//     the forward's operations alone (units.cuh), kGroup columns at a
//     time, their log-alphas first without branches so that they
//     interleave; the re-walk takes the same rounded operations in the
//     same order, so T, the running w cdot and the stops enter the unit
//     bitwise as in one sequential walk.
//   No float atomics: an instance belongs to one unit, its column is
//   written once, with the warp partials summed in warp order, so the
//   result is deterministic. A NaN instance is culled (the compare is
//   written so that NaN fails it) and contributes exact zeros.
#include <cuda_runtime.h>
#include "api.h"
#include "units.cuh"

namespace {

using units::kChunk;
using units::kFull;
using units::kGroup;

constexpr int kMaxCh = 7;
constexpr int kRows = 16;   // reduced rows du dv da db dc dlog_op |du|
                            // |dv| dch.., padded to a power of two
// float32 roundings of log(1/255) and log(0.999)
constexpr float kLogAlphaMin = -5.541263580322266f;
constexpr float kLogAlphaMax = -0.0010005002841353416f;
constexpr float kLogOpFloor = -80.0f;

struct Pixel {
  float x, y, cf, gt_tfin, T, c_dot;
  float g[kMaxCh];
  bool done;
};

// The forward's operations on a pair that do not depend on T.
struct Pair {
  float dx, dy, s, alpha, one_m, cdot;
};

// dx, dy and the log-alpha s of the pair (pixel p, column `col` of the
// staged chunk), in forward.cu's rounded order; the pair passes the cull
// when s >= log(1/255) (a NaN s fails).
__device__ __forceinline__ void eval_s(const float* __restrict__ col,
                                       const Pixel& p, Pair& e) {
  e.dx = __fsub_rn(p.x, col[0]);
  e.dy = __fsub_rn(p.y, col[kChunk]);
  const float qa = __fmul_rn(__fmul_rn(col[2 * kChunk], e.dx), e.dx);
  const float qb = __fmul_rn(__fmul_rn(__fmul_rn(2.0f, col[3 * kChunk]),
                                       e.dx), e.dy);
  const float qc = __fmul_rn(__fmul_rn(col[4 * kChunk], e.dy), e.dy);
  const float quad = __fadd_rn(__fadd_rn(qa, qb), qc);
  e.s = __fsub_rn(col[5 * kChunk], __fmul_rn(0.5f, quad));
}

// alpha, 1 - alpha and cdot = sum_ch g_ch c_ch of the pair.
__device__ __forceinline__ void eval_alpha(const float* __restrict__ col,
                                           int nch, const Pixel& p,
                                           Pair& e) {
  e.alpha = expf(fminf(e.s, kLogAlphaMax));
  e.one_m = __fsub_rn(1.0f, e.alpha);
  float cdot = 0.0f;
#pragma unroll
  for (int ch = 0; ch < kMaxCh; ++ch)
    if (ch < nch)
      cdot = __fadd_rn(cdot, __fmul_rn(p.g[ch], col[(6 + ch) * kChunk]));
  e.cdot = cdot;
}

__global__ void backward_kernel(const float* __restrict__ table,
                                int64_t num_instances,
                                const int32_t* __restrict__ tile_start,
                                int32_t num_tiles, int32_t tiles_x,
                                int32_t tile_size, int32_t nch, float t_eps,
                                int32_t absgrad,
                                const float* __restrict__ cot,
                                const float* __restrict__ fwd,
                                float* __restrict__ grads) {
  units::Unit u;
  if (!units::find(blockIdx.x, tile_start, num_tiles, num_instances, u))
    return;
  extern __shared__ float smem[];
  const int tid = threadIdx.x;
  const int npx = tile_size * tile_size;
  const int nwarps = blockDim.x >> 5;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int rows = 6 + nch;
  const int ngrad = 9 + nch;
  // per warp the reduced rows du dv da db dc dlog_op |du| |dv| dch..
  float* part = smem + 2 * rows * kChunk;        // nwarps x (8+nch) x kChunk
  float* npart = part + nwarps * (8 + nch) * kChunk;   // nwarps x kChunk
  unsigned long long* masks =
      reinterpret_cast<unsigned long long*>(npart + nwarps * kChunk);

  // this thread's pixel, its cotangents and forward results
  const int t = u.tile;
  Pixel p;
  p.x = (float)((t % tiles_x) * tile_size + tid % tile_size) + 0.5f;
  p.y = (float)((t / tiles_x) * tile_size + tid / tile_size) + 0.5f;
  const float* cp = cot + (int64_t)t * 8 * npx + tid;
  const float* fp = fwd + (int64_t)t * 8 * npx + tid;
  p.cf = 0.0f;
#pragma unroll
  for (int ch = 0; ch < kMaxCh; ++ch) {
    p.g[ch] = ch < nch ? cp[ch * npx] : 0.0f;
    if (ch < nch) p.cf += p.g[ch] * fp[ch * npx];
  }
  p.gt_tfin = cp[7 * npx] * fp[7 * npx];
  p.T = 1.0f;
  p.c_dot = 0.0f;
  p.done = false;

  const units::Passes passes(u);
  units::stage(smem, table, num_instances, rows, passes.base(0),
               passes.count(0));
  for (int i = 0; i < passes.n_total; ++i) {
    const int64_t base = passes.base(i);
    const int n = passes.count(i);
    const float* chunk = smem + (i & 1) * rows * kChunk;
    if (i + 1 < passes.n_total) {
      units::stage(smem + ((i + 1) & 1) * rows * kChunk, table,
                   num_instances, rows, passes.base(i + 1),
                   passes.count(i + 1));
      __pipeline_wait_prior(1);
    } else {
      __pipeline_wait_prior(0);
    }
    __syncthreads();
    if (passes.prefix(i)) {
      // the tile's prefix: the forward's operations alone, kGroup columns
      // at a time: their log-alphas first, without branches, so that they
      // interleave; then, in order, the pairs that pass the cull
      for (int j = 0; j < n; j += kGroup) {
        Pair e[kGroup];
#pragma unroll
        for (int jj = 0; jj < kGroup; ++jj) eval_s(chunk + j + jj, p, e[jj]);
#pragma unroll
        for (int jj = 0; jj < kGroup; ++jj) {
          if (j + jj >= n || p.done || !(e[jj].s >= kLogAlphaMin)) continue;
          eval_alpha(chunk + j + jj, nch, p, e[jj]);
          float t_ex, w;
          units::advance(true, e[jj].alpha, e[jj].one_m, e[jj].cdot, t_eps,
                         p.T, p.c_dot, p.done, t_ex, w);
        }
      }
    } else {
      unsigned long long applied_mask = 0ull;
      for (int j = 0; j < n; ++j) {
        float acc[kRows];
#pragma unroll
        for (int k = 0; k < kRows; ++k) acc[k] = 0.0f;
        bool applied = false, live = false;
        Pair e;
        eval_s(chunk + j, p, e);
        float t_ex, w;
        if (!p.done && e.s >= kLogAlphaMin) {
          eval_alpha(chunk + j, nch, p, e);
          applied = units::advance(true, e.alpha, e.one_m, e.cdot, t_eps,
                                   p.T, p.c_dot, p.done, t_ex, w);
        }
        if (applied) {
          // gradient terms (g is 0 past nch)
#pragma unroll
          for (int ch = 0; ch < kMaxCh; ++ch) acc[8 + ch] += p.g[ch] * w;
          if (e.s < kLogAlphaMax) {
            live = true;
            const float a = chunk[2 * kChunk + j];
            const float b = chunk[3 * kChunk + j];
            const float c = chunk[4 * kChunk + j];
            const float rear = p.cf - p.c_dot;
            const float dalpha = e.cdot * t_ex + (p.gt_tfin - rear) / e.one_m;
            const float ds = dalpha * e.alpha;
            const float du = ds * (a * e.dx + b * e.dy);
            const float dv = ds * (b * e.dx + c * e.dy);
            acc[0] += du;
            acc[1] += dv;
            acc[2] += -0.5f * ds * e.dx * e.dx;
            acc[3] += -ds * e.dx * e.dy;
            acc[4] += -0.5f * ds * e.dy * e.dy;
            acc[5] += ds;
            if (absgrad) {
              acc[6] += fabsf(du);
              acc[7] += fabsf(dv);
            }
          }
          // end of the gradient terms
        }
        if (__any_sync(kFull, applied)) {
          const int count = __popc(__ballot_sync(kFull, live));
          const float v = units::warp_transpose_sum<kRows>(acc, lane);
          const int row = lane >> 1;
          if (!(lane & 1) && row < 8 + nch)
            part[(warp * (8 + nch) + row) * kChunk + j] = v;
          if (lane == 0) npart[warp * kChunk + j] = (float)count;
          applied_mask |= 1ull << j;
        }
      }
      if (lane == 0) masks[warp] = applied_mask;
      __syncthreads();
      // sum the partials of the warps that applied each instance, in warp
      // order, and write each column once
      for (int idx = tid; idx < ngrad * n; idx += blockDim.x) {
        const int k = idx / n, j = idx - k * n;
        // the reduced row of output row k (-1: zero, or npix)
        const int r = k < 6 ? k : k < 6 + nch ? k + 2 : k == ngrad - 1 ? -1
                      : absgrad ? k - nch : -2;
        float v = 0.0f;
        if (r >= -1) {
          const float* src = r >= 0 ? part + r * kChunk + j : npart + j;
          const int stride = r >= 0 ? (8 + nch) * kChunk : kChunk;
          for (int w = 0; w < nwarps; ++w)
            if ((masks[w] >> j) & 1ull) v += src[w * stride];
        }
        if (k == 5) v *= expf(-fmaxf(chunk[5 * kChunk + j], kLogOpFloor));
        grads[(int64_t)k * num_instances + base + j] = v;
      }
    }
    // also the barrier before the next pass overwrites shared memory
    if (__syncthreads_and(p.done)) {
      __pipeline_wait_prior(0);
      units::zero_columns(grads, num_instances, ngrad,
                          passes.prefix(i) ? u.start : base + n, u.end);
      return;
    }
  }
}

}  // namespace

extern "C" int divshot_backward(const float* table, int64_t num_instances,
                                const int32_t* tile_start, int32_t num_tiles,
                                int32_t tiles_x, int32_t tile_size,
                                int32_t nch, float t_eps, int32_t absgrad,
                                const float* cot, const float* fwd,
                                float* grads, void* stream) {
  if (num_tiles <= 0 || num_instances <= 0) return (int)cudaSuccess;
  const int threads = tile_size * tile_size;
  if (threads % 32 || threads > 1024)
    return (int)cudaErrorInvalidValue;
  const size_t smem = units::smem_bytes(6 + nch, 8 + nch, threads / 32);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        backward_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int64_t blocks = units::grid_blocks(num_tiles, num_instances);
  backward_kernel<<<(unsigned)blocks, threads, smem, (cudaStream_t)stream>>>(
      table, num_instances, tile_start, num_tiles, tiles_x, tile_size, nch,
      t_eps, absgrad, cot, fwd, grads);
  return (int)cudaGetLastError();
}
