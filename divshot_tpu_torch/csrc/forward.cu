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
// Design: two launches, because a trained model's longest tiles hold ~10^5
//   instances whose pixels never stop, and one block walked such a tile on
//   one SM while the others idled; almost every pair fails the cull, and
//   the cull does not depend on T.
//   The launches are units.cuh's, over this file's pair model (Gauss):
//   - tile_kernel: one block per tile, one thread per pixel, the first
//     port's walk: chunks of blockDim columns staged in shared memory with
//     coalesced row reads, every pixel walking a chunk in order and
//     evaluating every pair, the block leaving once every pixel has
//     stopped (__syncthreads_and). A long tile (units::kFwdLong) that the
//     probe finds sparse is left to the second launch: the block marks
//     its regions (units::mark_long) and leaves.
//   - cull_walk_kernel: a few blocks per SM, each reading the region marks
//     of its share of the regions at once. For each marked segment the
//     block evaluates its (pixel, column) pairs, one thread per pixel, the
//     columns staged with cp.async double buffering, and sets one bit
//     where s passes the cull in the survivor mask. The block that culls a
//     tile's last segment (a counter per tile, started at 0 by the first
//     launch) walks the tile once it has culled all its own segments:
//     chunk after chunk, the columns and mask words of the next two chunks
//     copied with cp.async while one is walked, each pixel evaluating only
//     its survivors.
//   Every s comes from one function (eval_s) with explicitly rounded
//   operations (no fused multiply-add) in the plain PyTorch version's
//   order, and the chain applies the same rounded steps in column order,
//   so every cull, stop and sum is bitwise the single-pass walk's. Nothing
//   is read back on the host, and no block waits for another. The TPU
//   kernel's quadratic-feature matmul, bf16 prefix-sum splits, `tri`
//   matrix and mega-chunk DMA have no counterpart: plain float32.
#include <cuda_runtime.h>
#include <stdint.h>
#include "api.h"
#include "units.cuh"

namespace {

constexpr int kMaxCh = 7;
// float32 roundings of log(1/255) and log(0.999)
constexpr float kLogAlphaMin = -5.541263580322266f;
constexpr float kLogAlphaMax = -0.0010005002841353416f;

// The log-alpha s of pixel (px, py) against the column at `col` (row r at
// col[r * stride]); the pair passes the cull when s >= log(1/255), written
// so that a NaN s fails it, as in the plain version.
__device__ __forceinline__ float eval_s(const float* __restrict__ col,
                                        int64_t stride, float px, float py) {
  const float dx = __fsub_rn(px, col[0]);
  const float dy = __fsub_rn(py, col[stride]);
  const float a = col[2 * stride];
  const float b = col[3 * stride];
  const float c = col[4 * stride];
  const float qa = __fmul_rn(__fmul_rn(a, dx), dx);
  const float qb = __fmul_rn(__fmul_rn(__fmul_rn(2.0f, b), dx), dy);
  const float qc = __fmul_rn(__fmul_rn(c, dy), dy);
  const float quad = __fadd_rn(__fadd_rn(qa, qb), qc);
  return __fsub_rn(col[5 * stride], __fmul_rn(0.5f, quad));
}

// The 3DGS pair model of units.cuh's launches.
struct Gauss {
  static constexpr int kCullRows = 6;   // u v a b c log_op
  static constexpr int kChRow = 6;
  static constexpr int kInterleave = 8;

  __device__ static bool passes(const float* c, int stride, int j,
                                float2 q) {
    return eval_s(c + j, stride, q.x, q.y) >= kLogAlphaMin;
  }

  // One pixel's compositing state.
  struct Chain {
    float T = 1.0f;
    float acc[kMaxCh] = {};
    bool done = false;

    // A pair that passes the cull gets alpha = exp(min(s, log 0.999)); the
    // pixel stops, without applying it, where T (1 - alpha) < t_eps.
    __device__ __forceinline__ bool visit(const float* __restrict__ c,
                                          int stride, int j, float2 q,
                                          int nch, float t_eps) {
      const float s = eval_s(c + j, stride, q.x, q.y);
      if (!(s >= kLogAlphaMin)) return false;
      const float alpha = expf(fminf(s, kLogAlphaMax));
      const float nt = __fmul_rn(T, __fsub_rn(1.0f, alpha));
      if (nt < t_eps) {
        done = true;
        return true;
      }
      const float w = __fmul_rn(alpha, T);
      const float* ch = c + kChRow * stride + j;
#pragma unroll
      for (int k = 0; k < kMaxCh; ++k)
        if (k < nch) acc[k] = __fadd_rn(acc[k], __fmul_rn(w, ch[k * stride]));
      T = nt;
      return false;
    }

    __device__ __forceinline__ void store(float* __restrict__ o, int npx,
                                          int nch) const {
#pragma unroll
      for (int r = 0; r < kMaxCh; ++r) o[r * npx] = r < nch ? acc[r] : 0.0f;
      o[7 * npx] = T;
    }
  };
};

}  // namespace

extern "C" int divshot_forward(const float* table, int64_t num_instances,
                               const int32_t* tile_start, int32_t num_tiles,
                               int32_t tiles_x, int32_t tile_size,
                               int32_t nch, float t_eps, float* out,
                               int32_t* work, void* stream) {
  return units::launch_forward<Gauss>(table, num_instances, tile_start,
                                      num_tiles, tiles_x, tile_size, nch,
                                      t_eps, out, work, stream);
}
