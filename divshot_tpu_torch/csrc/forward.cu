// Forward alpha compositing per tile, CUDA C++ for sm_90a.
//
// Replaces: the Pallas TPU kernel `_forward_kernel` in
//   divshot_tpu/raster/pallas_raster.py (called by `rasterize_forward`).
// Computes: for tile t, front to back over its depth-sorted instances
//   [tile_start[t], tile_start[t+1]) of the feature-major table
//   (rows u v a b c log_op ch0..ch{nch-1}, `num_instances` columns):
//     s = log_op - 0.5 (a dx^2 + 2 b dx dy + c dy^2), pixel centres at +0.5;
//     an instance is culled when s < log(1/255); alpha = exp(min(s,
//     log 0.999)); a pixel stops at the first instance with
//     T (1 - alpha) < t_eps, which is not applied. Output (T, 8, px): the
//     channels in rows 0..nch-1, zeros up to row 6, the final T in row 7.
// Bound on the H100: the float32 arithmetic of the (pixel, instance) pairs a
//   tile evaluates before all its pixels stop; the table is read once per
//   tile that holds the instance, a few bytes per pair.
// Design: one block per tile, one thread per pixel (tile_size^2 threads).
//   The block stages a chunk of blockDim instance columns in shared memory
//   with coalesced row reads, every thread walks the chunk in order, and
//   the block leaves as soon as every pixel has stopped (__syncthreads_and).
//   The TPU kernel's quadratic-feature matmul, bf16 prefix-sum splits,
//   `tri` matrix and mega-chunk DMA are replaced by this direct per-pixel
//   loop in plain float32. All arithmetic is explicitly rounded (no fused
//   multiply-add) in the order of the plain PyTorch version, so the two
//   take the same cull and stop decisions.
#include <cuda_runtime.h>
#include "api.h"

namespace {

constexpr int kMaxCh = 7;
// float32 roundings of log(1/255) and log(0.999)
constexpr float kLogAlphaMin = -5.541263580322266f;
constexpr float kLogAlphaMax = -0.0010005002841353416f;

__global__ void forward_kernel(const float* __restrict__ table,
                               int64_t num_instances,
                               const int32_t* __restrict__ tile_start,
                               int32_t tiles_x, int32_t tile_size,
                               int32_t nch, float t_eps,
                               float* __restrict__ out) {
  extern __shared__ float chunk[];  // (6 + nch) rows x blockDim columns
  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const int npx = blockDim.x;
  const int rows = 6 + nch;
  const int32_t s0 = tile_start[t];
  const int32_t e0 = tile_start[t + 1];

  const float px = (float)((t % tiles_x) * tile_size + p % tile_size) + 0.5f;
  const float py = (float)((t / tiles_x) * tile_size + p / tile_size) + 0.5f;

  float T = 1.0f;
  float acc[kMaxCh];
#pragma unroll
  for (int c = 0; c < kMaxCh; ++c) acc[c] = 0.0f;
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
        const float dx = __fsub_rn(px, chunk[j]);
        const float dy = __fsub_rn(py, chunk[npx + j]);
        const float a = chunk[2 * npx + j];
        const float b = chunk[3 * npx + j];
        const float c = chunk[4 * npx + j];
        const float qa = __fmul_rn(__fmul_rn(a, dx), dx);
        const float qb = __fmul_rn(__fmul_rn(__fmul_rn(2.0f, b), dx), dy);
        const float qc = __fmul_rn(__fmul_rn(c, dy), dy);
        const float quad = __fadd_rn(__fadd_rn(qa, qb), qc);
        const float s = __fsub_rn(chunk[5 * npx + j], __fmul_rn(0.5f, quad));
        if (s < kLogAlphaMin) continue;
        const float alpha = expf(fminf(s, kLogAlphaMax));
        const float q = __fmul_rn(T, __fsub_rn(1.0f, alpha));
        if (q < t_eps) {
          done = true;
          break;
        }
        const float w = __fmul_rn(alpha, T);
#pragma unroll
        for (int ch = 0; ch < kMaxCh; ++ch)
          if (ch < nch)
            acc[ch] = __fadd_rn(acc[ch],
                                __fmul_rn(w, chunk[(6 + ch) * npx + j]));
        T = q;
      }
    }
    // also the barrier before the next chunk overwrites shared memory
    if (__syncthreads_and(done)) break;
  }

  float* o = out + (int64_t)t * 8 * npx + p;
#pragma unroll
  for (int r = 0; r < kMaxCh; ++r) o[r * npx] = r < nch ? acc[r] : 0.0f;
  o[7 * npx] = T;
}

}  // namespace

extern "C" int divshot_forward(const float* table, int64_t num_instances,
                               const int32_t* tile_start, int32_t num_tiles,
                               int32_t tiles_x, int32_t tile_size,
                               int32_t nch, float t_eps, float* out,
                               void* stream) {
  if (num_tiles <= 0) return (int)cudaSuccess;
  const int threads = tile_size * tile_size;
  const size_t smem = sizeof(float) * (size_t)(6 + nch) * threads;
  forward_kernel<<<num_tiles, threads, smem, (cudaStream_t)stream>>>(
      table, num_instances, tile_start, tiles_x, tile_size, nch, t_eps, out);
  return (int)cudaGetLastError();
}
