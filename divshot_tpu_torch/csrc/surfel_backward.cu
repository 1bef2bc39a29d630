// Exact-2DGS (surfel) backward compositing per tile (the VJP of
// surfel_forward.cu), CUDA C++ for sm_90a.
//
// Replaces: the Pallas TPU kernel `_backward_kernel` in
//   divshot_tpu/raster/pallas_surfel.py (called by `surfel_backward`).
// Computes: for tile t, one front-to-back sweep over its depth-sorted
//   instances, the forward recomputed by surfel.cuh's eval_pair, so every
//   cull, clamp and stop is the forward's. With the cotangent tiles `cot`
//   (T, 8, px) (channels in rows 0..nch-1, g_z row 5, g_z2 row 6,
//   g_T = g_alpha - g_rgb . bg row 7) and the forward's output `fwd`, per
//   (pixel, instance) applied before the pixel's stop:
//     w = alpha T_excl, cdot = sum_ch g_ch ch, rear = sum_ch g_ch (C_fin -
//     C_incl) over the weight-coupled channels only (the depth weights are
//     detached), d_z = w (g_z + 2 z g_z2);
//     live = a < 0.999 (alpha not clamped): d_alpha = cdot T_excl +
//     (g_T T_fin - rear) / (1 - alpha), else 0;
//     d_op = d_alpha G, g_rho = -d_alpha alpha / 2,
//     d_u = [sel] 2 u g_rho + zp0 d_z, d_v likewise, d_dx = 4 dx g_rho on
//     the 2-D branch; g_p = (d_u, d_v, -(u d_u + v d_v)) / p2,
//     d_hu = hv x g_p, d_hv = g_p x hu;
//   and per instance the sums over the tile's pixels of the rows
//     dT0..2 = -d_hu, dT3..5 = -d_hv, dT6..8 = x d_hu + y d_hv,
//     dzp = (u d_z, v d_z, d_z), dc2d = -(d_dx, d_dy), dop = d_op,
//     dch = w g_ch, ds = -(T[6:9] . d_hu + d_dx, T[6:9] . d_hv + d_dy)
//     (the gradient of a screen shift of the splat), |ds| per pixel
//     (AbsGS), npix = count of live pairs.
//   Selects, never a multiplication by a mask, so an edge-on surfel's
//   huge u does not turn an unselected branch into NaN. Output
//   (20 + nch, I): every column of the tile's range is written once
//   (zeros past the stop of every pixel); columns at or past tile_start[T]
//   are not written.
// Bound on the H100: the float32 arithmetic of the (pixel, instance) pairs
//   before each pixel's stop (~45 a pair to recompute, ~110 more for an
//   applied pair), and on a tile whose pixels never stop the forward's
//   walk of that tile (the deepest unit's prefix).
// Design, as backward.cu's (units.cuh): one thread per pixel; a warp that
//   applied the instance transposes and sums its 19 + nch reduced rows,
//   padded to 32, in 31 shuffles (not 5 per row), the channels last so
//   that no index depends on nch; npix is a ballot count; a warp stores
//   its partials only for an instance it applied, its 64-bit applied mask
//   telling the cross-warp sum which to read; kChunk = 64 columns a pass,
//   the next pass's copied in with cp.async; a long tile is cut into
//   units of at most kUnit instances, each in its own block, which
//   first re-walks the tile's prefix with the forward's operations alone,
//   kGroup columns at a time (eval_pair<true>, without branches, so that
//   they interleave), the same rounded operations in the same order, so
//   the unit's entry state is bitwise the sequential walk's. No float
//   atomics: an instance's column is written once, the warp partials
//   summed in warp order, so the result is deterministic. The TPU
//   kernel's bf16 prefix matmuls, `tri` matrices, DMA double buffers and
//   per-tile boundary blocks are gone. A culled pair (NaN rows included)
//   adds exact zeros.
#include <cuda_runtime.h>
#include "api.h"
#include "surfel.cuh"
#include "units.cuh"

namespace {

using units::kChunk;
using units::kFull;
using units::kGroup;

constexpr int kMaxCh = 5;
constexpr int kRows = 32;   // reduced rows dT dzp dc2d dop ds |ds| dch..
                            // (19 + nch), padded to a power of two

struct Pixel {
  float x, y, cf, g_z, g_z2, gt_tfin, T, c_dot;
  float g[kMaxCh];
  bool done;
};

// cdot = sum_ch g_ch ch of column j of the staged chunk.
__device__ __forceinline__ float eval_cdot(const float* __restrict__ chunk,
                                           int j, int nch, const Pixel& p) {
  float cdot = 0.0f;
#pragma unroll
  for (int ch = 0; ch < kMaxCh; ++ch)
    if (ch < nch)
      cdot = __fadd_rn(cdot, __fmul_rn(
          p.g[ch], chunk[(surfel::kRowCh + ch) * kChunk + j]));
  return cdot;
}

__global__ void surfel_backward_kernel(const float* __restrict__ table,
                                       int64_t num_instances,
                                       const int32_t* __restrict__ tile_start,
                                       int32_t num_tiles, int32_t tiles_x,
                                       int32_t tile_size, int32_t nch,
                                       float t_eps,
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
  const int rows = surfel::kRowCh + nch;
  const int ngrad = 20 + nch;
  // per warp the 19 + nch reduced rows dT dzp dc2d dop ds |ds| dch..
  float* part = smem + 2 * rows * kChunk;
  float* npart = part + nwarps * (19 + nch) * kChunk;   // nwarps x kChunk
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
  p.g_z = cp[5 * npx];
  p.g_z2 = cp[6 * npx];
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
      // at a time: their pair evaluations first, without branches, so that
      // they interleave; then, in order, the pairs that pass the culls
      for (int j = 0; j < n; j += kGroup) {
        surfel::Pair e[kGroup];
        bool ok[kGroup];
#pragma unroll
        for (int jj = 0; jj < kGroup; ++jj)
          ok[jj] = surfel::eval_pair<true>(chunk, kChunk, j + jj, p.x, p.y,
                                           e[jj]);
#pragma unroll
        for (int jj = 0; jj < kGroup; ++jj) {
          if (j + jj >= n || p.done || !ok[jj]) continue;
          float t_ex, w;
          units::advance(true, e[jj].alpha, __fsub_rn(1.0f, e[jj].alpha),
                         eval_cdot(chunk, j + jj, nch, p), t_eps, p.T,
                         p.c_dot, p.done, t_ex, w);
        }
      }
    } else {
      unsigned long long applied_mask = 0ull;
      for (int j = 0; j < n; ++j) {
        float acc[kRows];
#pragma unroll
        for (int k = 0; k < kRows; ++k) acc[k] = 0.0f;
        bool applied = false, live = false;
        surfel::Pair s;
        float one_m, cdot, t_ex, w;
        if (!p.done && surfel::eval_pair(chunk, kChunk, j, p.x, p.y, s)) {
          one_m = __fsub_rn(1.0f, s.alpha);
          cdot = eval_cdot(chunk, j, nch, p);
          applied = units::advance(true, s.alpha, one_m, cdot, t_eps, p.T,
                                   p.c_dot, p.done, t_ex, w);
        }
        if (applied) {
          // gradient terms
          const float* col = chunk + j;
          live = s.a < surfel::kAlphaMax;
          const float d_alpha =
              live ? cdot * t_ex + (p.gt_tfin - (p.cf - p.c_dot)) / one_m
                   : 0.0f;
          const float d_z = w * (p.g_z + 2.0f * s.z * p.g_z2);
          const float g_rho = -0.5f * d_alpha * s.alpha;
          const float d_u = (s.sel ? 2.0f * s.u * g_rho : 0.0f)
                            + col[surfel::kRowZp * kChunk] * d_z;
          const float d_v = (s.sel ? 2.0f * s.v * g_rho : 0.0f)
                            + col[(surfel::kRowZp + 1) * kChunk] * d_z;
          const float g2d = s.sel ? 0.0f : g_rho;
          const float d_dx = 4.0f * s.dx * g2d;
          const float d_dy = 4.0f * s.dy * g2d;
          const float gp0 = d_u / s.p2;
          const float gp1 = d_v / s.p2;
          const float gp2 = -(s.u * d_u + s.v * d_v) / s.p2;
          const float dhu[3] = {s.hv[1] * gp2 - s.hv[2] * gp1,
                                s.hv[2] * gp0 - s.hv[0] * gp2,
                                s.hv[0] * gp1 - s.hv[1] * gp0};
          const float dhv[3] = {gp1 * s.hu[2] - gp2 * s.hu[1],
                                gp2 * s.hu[0] - gp0 * s.hu[2],
                                gp0 * s.hu[1] - gp1 * s.hu[0]};
#pragma unroll
          for (int r = 0; r < 3; ++r) {
            acc[r] += -dhu[r];
            acc[3 + r] += -dhv[r];
            acc[6 + r] += p.x * dhu[r] + p.y * dhv[r];
          }
          acc[9] += s.u * d_z;
          acc[10] += s.v * d_z;
          acc[11] += d_z;
          acc[12] += -d_dx;
          acc[13] += -d_dy;
          acc[14] += d_alpha * s.G;
          const float t6 = col[6 * kChunk], t7 = col[7 * kChunk],
                      t8 = col[8 * kChunk];
          const float ds_x = -((t6 * dhu[0] + t7 * dhu[1] + t8 * dhu[2])
                               + d_dx);
          const float ds_y = -((t6 * dhv[0] + t7 * dhv[1] + t8 * dhv[2])
                               + d_dy);
          acc[15] += ds_x;
          acc[16] += ds_y;
          acc[17] += fabsf(ds_x);
          acc[18] += fabsf(ds_y);
#pragma unroll
          for (int ch = 0; ch < kMaxCh; ++ch) acc[19 + ch] += p.g[ch] * w;
          // end of the gradient terms
        }
        if (__any_sync(kFull, applied)) {
          const int count = __popc(__ballot_sync(kFull, live));
          const float v = units::warp_transpose_sum<kRows>(acc, lane);
          if (lane < 19 + nch)
            part[(warp * (19 + nch) + lane) * kChunk + j] = v;
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
        // the reduced row of output row k (-1: npix)
        const int r = k < 15 ? k : k < 15 + nch ? k + 4
                      : k < ngrad - 1 ? k - nch : -1;
        const float* src = r >= 0 ? part + r * kChunk + j : npart + j;
        const int stride = r >= 0 ? (19 + nch) * kChunk : kChunk;
        float v = 0.0f;
        for (int w = 0; w < nwarps; ++w)
          if ((masks[w] >> j) & 1ull) v += src[w * stride];
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

extern "C" int divshot_surfel_backward(const float* table,
                                       int64_t num_instances,
                                       const int32_t* tile_start,
                                       int32_t num_tiles, int32_t tiles_x,
                                       int32_t tile_size, int32_t nch,
                                       float t_eps, const float* cot,
                                       const float* fwd, float* grads,
                                       void* stream) {
  if (num_tiles <= 0 || num_instances <= 0) return (int)cudaSuccess;
  const int threads = tile_size * tile_size;
  if (threads % 32 || threads > 1024)
    return (int)cudaErrorInvalidValue;
  const size_t smem =
      units::smem_bytes(surfel::kRowCh + nch, 19 + nch, threads / 32);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        surfel_backward_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int64_t blocks = units::grid_blocks(num_tiles, num_instances);
  surfel_backward_kernel<<<(unsigned)blocks, threads, smem,
                           (cudaStream_t)stream>>>(
      table, num_instances, tile_start, num_tiles, tiles_x, tile_size, nch,
      t_eps, cot, fwd, grads);
  return (int)cudaGetLastError();
}
