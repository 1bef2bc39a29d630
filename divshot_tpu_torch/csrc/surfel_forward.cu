// Exact-2DGS (surfel) forward compositing per tile, CUDA C++ for sm_90a.
//
// Replaces: the Pallas TPU kernel `_forward_kernel` in
//   divshot_tpu/raster/pallas_surfel.py (called by `surfel_forward`).
// Computes: for tile t, front to back over its depth-sorted instances
//   [tile_start[t], tile_start[t+1]) of the feature-major table (rows T(9)
//   zplane(3) center2d(2) opacity ch0..ch{nch-1}, `num_instances`
//   columns), each pixel's ray-splat intersection (surfel.cuh); a culled
//   pair is skipped; a pixel stops at the first instance with
//   T (1 - alpha) < t_eps, which is not applied. Each applied instance
//   adds w = alpha T to its channels, w z to the depth and w z z to the
//   depth's square, with z the pixel's own intersection depth. Output
//   (T, 8, px): the channels in rows 0..nch-1, zeros up to row 4, z in
//   row 5, z^2 in row 6, the final T in row 7.
// Bound on the H100: the float32 arithmetic of the (pixel, instance) pairs
//   a tile evaluates before all its pixels stop (~45 operations a pair,
//   a division and an exp among them); the table is read once per tile
//   that holds the instance, a few bytes per pair.
// Design: one block per tile, one thread per pixel (tile_size^2 threads),
//   as in forward.cu. The block stages a chunk of blockDim instance
//   columns (15 + nch rows) in shared memory with coalesced row reads,
//   every thread walks the chunk in order, and the block leaves as soon
//   as every pixel has stopped (__syncthreads_and). The TPU kernel's bf16
//   split prefix products, `tri` matrices, DMA double buffer and lane
//   masking are replaced by this direct per-pixel loop in plain float32.
#include <cuda_runtime.h>
#include "api.h"
#include "surfel.cuh"

namespace {

constexpr int kMaxCh = 5;

__global__ void surfel_forward_kernel(const float* __restrict__ table,
                                      int64_t num_instances,
                                      const int32_t* __restrict__ tile_start,
                                      int32_t tiles_x, int32_t tile_size,
                                      int32_t nch, float t_eps,
                                      float* __restrict__ out) {
  extern __shared__ float chunk[];  // (15 + nch) rows x blockDim columns
  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const int npx = blockDim.x;
  const int rows = surfel::kRowCh + nch;
  const int32_t s0 = tile_start[t];
  const int32_t e0 = tile_start[t + 1];

  const float px = (float)((t % tiles_x) * tile_size + p % tile_size) + 0.5f;
  const float py = (float)((t / tiles_x) * tile_size + p / tile_size) + 0.5f;

  float T = 1.0f;
  float acc[kMaxCh];
#pragma unroll
  for (int c = 0; c < kMaxCh; ++c) acc[c] = 0.0f;
  float zacc = 0.0f, z2acc = 0.0f;
  bool done = false;

  for (int32_t base = s0; base < e0; base += npx) {
    const int32_t k = base + p;
    if (k < e0) {
      for (int r = 0; r < rows; ++r)
        chunk[r * npx + p] = table[(int64_t)r * num_instances + k];
    }
    __syncthreads();
    const int n = min(npx, e0 - base);
    if (!done) {
      for (int j = 0; j < n; ++j) {
        surfel::Pair s;
        if (!surfel::eval_pair(chunk, npx, j, px, py, s)) continue;
        const float q = __fmul_rn(T, __fsub_rn(1.0f, s.alpha));
        if (q < t_eps) {
          done = true;
          break;
        }
        const float w = __fmul_rn(s.alpha, T);
#pragma unroll
        for (int ch = 0; ch < kMaxCh; ++ch)
          if (ch < nch)
            acc[ch] = __fadd_rn(
                acc[ch],
                __fmul_rn(w, chunk[(surfel::kRowCh + ch) * npx + j]));
        const float wz = __fmul_rn(w, s.z);
        zacc = __fadd_rn(zacc, wz);
        z2acc = __fadd_rn(z2acc, __fmul_rn(wz, s.z));
        T = q;
      }
    }
    // also the barrier before the next chunk overwrites shared memory
    if (__syncthreads_and(done)) break;
  }

  float* o = out + (int64_t)t * 8 * npx + p;
#pragma unroll
  for (int r = 0; r < kMaxCh; ++r) o[r * npx] = r < nch ? acc[r] : 0.0f;
  o[5 * npx] = zacc;
  o[6 * npx] = z2acc;
  o[7 * npx] = T;
}

}  // namespace

extern "C" int divshot_surfel_forward(const float* table,
                                      int64_t num_instances,
                                      const int32_t* tile_start,
                                      int32_t num_tiles, int32_t tiles_x,
                                      int32_t tile_size, int32_t nch,
                                      float t_eps, float* out,
                                      void* stream) {
  if (num_tiles <= 0) return (int)cudaSuccess;
  const int threads = tile_size * tile_size;
  const size_t smem =
      sizeof(float) * (size_t)(surfel::kRowCh + nch) * threads;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        surfel_forward_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  surfel_forward_kernel<<<num_tiles, threads, smem, (cudaStream_t)stream>>>(
      table, num_instances, tile_start, tiles_x, tile_size, nch, t_eps, out);
  return (int)cudaGetLastError();
}
