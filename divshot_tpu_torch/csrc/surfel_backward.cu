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
//   (zeros past the block's stop); columns at or past tile_start[T] are
//   not written.
// Bound on the H100: the float32 arithmetic of the (pixel, instance) pairs
//   before each pixel's stop (~45 a pair to recompute, ~110 more for an
//   applied pair), plus the per-instance block reductions of 20 + nch
//   rows.
// Design: one block per tile, one thread per pixel, as backward.cu. A
//   chunk of kChunk instance columns is staged in shared memory; every
//   thread walks it in order, each instance's per-pixel terms are reduced
//   over the block by warp shuffles (skipped when no lane of the warp
//   applied the instance), the warp partials go to shared memory and are
//   summed in warp order. No float atomics: an instance belongs to one
//   tile, so its column is written once, deterministically. The TPU
//   kernel's bf16 prefix matmuls, `tri` matrices, DMA double buffers and
//   per-tile boundary blocks are gone. A culled pair (NaN rows included)
//   adds exact zeros.
#include <cuda_runtime.h>
#include "api.h"
#include "surfel.cuh"

namespace {

constexpr int kMaxCh = 5;
constexpr int kMaxRows = 20 + kMaxCh;  // gradient rows at nch = 5
constexpr int kChunk = 32;             // instances staged per pass
constexpr unsigned kFull = 0xffffffffu;

__global__ void surfel_backward_kernel(const float* __restrict__ table,
                                       int64_t num_instances,
                                       const int32_t* __restrict__ tile_start,
                                       int32_t tiles_x, int32_t tile_size,
                                       int32_t nch, float t_eps,
                                       const float* __restrict__ cot,
                                       const float* __restrict__ fwd,
                                       float* __restrict__ grads) {
  extern __shared__ float smem[];
  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const int npx = blockDim.x;
  const int nwarps = npx >> 5;
  const int warp = p >> 5;
  const int lane = p & 31;
  const int rows = surfel::kRowCh + nch;
  const int ngrad = 20 + nch;
  float* chunk = smem;                       // rows x kChunk
  float* part = smem + rows * kChunk;        // nwarps x ngrad x kChunk
  const int32_t s0 = tile_start[t];
  const int32_t e0 = tile_start[t + 1];

  const float px = (float)((t % tiles_x) * tile_size + p % tile_size) + 0.5f;
  const float py = (float)((t / tiles_x) * tile_size + p / tile_size) + 0.5f;

  // this pixel's cotangents and forward results
  const float* cp = cot + (int64_t)t * 8 * npx + p;
  const float* fp = fwd + (int64_t)t * 8 * npx + p;
  float g[kMaxCh];
  float cf = 0.0f;
#pragma unroll
  for (int ch = 0; ch < kMaxCh; ++ch) {
    g[ch] = ch < nch ? cp[ch * npx] : 0.0f;
    if (ch < nch) cf += g[ch] * fp[ch * npx];
  }
  const float g_z = cp[5 * npx];
  const float g_z2 = cp[6 * npx];
  const float gt_tfin = cp[7 * npx] * fp[7 * npx];

  float T = 1.0f;
  float c_dot = 0.0f;   // sum of w cdot over the applied instances so far
  bool done = false;

  for (int32_t base = s0; base < e0; base += kChunk) {
    const int n = min(kChunk, e0 - base);
    for (int i = p; i < rows * n; i += npx) {
      const int r = i / n, j = i - r * n;
      chunk[r * kChunk + j] = table[(int64_t)r * num_instances + base + j];
    }
    __syncthreads();
    for (int j = 0; j < n; ++j) {
      float val[kMaxRows];
#pragma unroll
      for (int k = 0; k < kMaxRows; ++k) val[k] = 0.0f;
      bool applied = false;
      surfel::Pair s;
      if (!done && surfel::eval_pair(chunk, kChunk, j, px, py, s)) {
        const float one_m = __fsub_rn(1.0f, s.alpha);
        const float q = __fmul_rn(T, one_m);
        if (q < t_eps) {
          done = true;
        } else {
          applied = true;
          const float* col = chunk + j;
          const float w = __fmul_rn(s.alpha, T);
          float cdot = 0.0f;
#pragma unroll
          for (int ch = 0; ch < kMaxCh; ++ch)
            if (ch < nch)
              cdot += g[ch] * col[(surfel::kRowCh + ch) * kChunk];
          c_dot += w * cdot;
          const bool live = s.a < surfel::kAlphaMax;
          const float d_alpha =
              live ? cdot * T + (gt_tfin - (cf - c_dot)) / one_m : 0.0f;
          const float d_z = w * (g_z + 2.0f * s.z * g_z2);
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
          for (int i = 0; i < 3; ++i) {
            val[i] = -dhu[i];
            val[3 + i] = -dhv[i];
            val[6 + i] = px * dhu[i] + py * dhv[i];
          }
          val[9] = s.u * d_z;
          val[10] = s.v * d_z;
          val[11] = d_z;
          val[12] = -d_dx;
          val[13] = -d_dy;
          val[14] = d_alpha * s.G;
          const float t6 = col[6 * kChunk], t7 = col[7 * kChunk],
                      t8 = col[8 * kChunk];
          const float ds_x = -((t6 * dhu[0] + t7 * dhu[1] + t8 * dhu[2])
                               + d_dx);
          const float ds_y = -((t6 * dhv[0] + t7 * dhv[1] + t8 * dhv[2])
                               + d_dy);
          // rows 15.. hold the channels, then ds |ds| npix (a constant
          // index per unrolled k, so val stays in registers)
#pragma unroll
          for (int k = surfel::kRowCh; k < kMaxRows; ++k) {
            const int c = k - surfel::kRowCh;
            if (c < nch) val[k] = g[c < kMaxCh ? c : 0] * w;
            if (c == nch) val[k] = ds_x;
            if (c == nch + 1) val[k] = ds_y;
            if (c == nch + 2) val[k] = fabsf(ds_x);
            if (c == nch + 3) val[k] = fabsf(ds_y);
            if (c == nch + 4) val[k] = live ? 1.0f : 0.0f;
          }
          T = q;
        }
      }
      // block reduction of this instance's terms: warp shuffles, then one
      // partial per warp in shared memory
      if (__any_sync(kFull, applied)) {
#pragma unroll
        for (int k = 0; k < kMaxRows; ++k) {
          if (k < ngrad) {
            float v = val[k];
#pragma unroll
            for (int off = 16; off > 0; off >>= 1)
              v += __shfl_xor_sync(kFull, v, off);
            val[k] = v;
          }
        }
      }
      if (lane == 0) {
#pragma unroll
        for (int k = 0; k < kMaxRows; ++k)
          if (k < ngrad) part[(warp * ngrad + k) * kChunk + j] = val[k];
      }
    }
    __syncthreads();
    // sum the warp partials in warp order and write each column once
    for (int i = p; i < ngrad * n; i += npx) {
      const int k = i / n, j = i - k * n;
      float v = 0.0f;
      for (int w = 0; w < nwarps; ++w) v += part[(w * ngrad + k) * kChunk + j];
      grads[(int64_t)k * num_instances + base + j] = v;
    }
    // also the barrier before the next chunk overwrites shared memory
    if (__syncthreads_and(done)) {
      const int32_t m = e0 - base - n;   // columns after the stop
      for (int64_t i = p; i < (int64_t)ngrad * m; i += npx) {
        const int k = (int)(i / m);
        const int32_t j = (int32_t)(i - (int64_t)k * m);
        grads[(int64_t)k * num_instances + base + n + j] = 0.0f;
      }
      break;
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
  if (num_tiles <= 0) return (int)cudaSuccess;
  const int threads = tile_size * tile_size;
  const size_t smem =
      sizeof(float) * (size_t)kChunk *
      ((surfel::kRowCh + nch) + (size_t)(threads / 32) * (20 + nch));
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        surfel_backward_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  surfel_backward_kernel<<<num_tiles, threads, smem,
                           (cudaStream_t)stream>>>(
      table, num_instances, tile_start, tiles_x, tile_size, nch, t_eps, cot,
      fwd, grads);
  return (int)cudaGetLastError();
}
