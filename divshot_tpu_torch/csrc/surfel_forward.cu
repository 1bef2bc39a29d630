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
// Design: the two launches of forward.cu (units.cuh's, over this file's
//   pair model Surfel), for the same reason (a trained model's longest
//   tiles, ~7 x 10^4 instances, walked on one SM; almost every pair
//   culled): tile_kernel walks every tile in one pass as the first port
//   did, but the long tiles the probe finds sparse, whose regions it
//   marks; cull_walk_kernel culls the marked segments (each pair evaluated
//   without branches, surfel::eval_pair<true>, so that pairs interleave; a
//   bit where it passes the three culls) and the block that culls a tile's
//   last segment walks the tile, the next chunks in flight, each pixel
//   evaluating only its survivors. Every pair is evaluated with
//   surfel::eval_pair's rounded operations and the chain keeps the same
//   rounded steps in column order, so the output is bitwise the
//   single-pass walk's. The TPU kernel's bf16 split prefix products, `tri`
//   matrices, DMA double buffer and lane masking have no counterpart:
//   plain float32.
#include <cuda_runtime.h>
#include <stdint.h>
#include "api.h"
#include "surfel.cuh"
#include "units.cuh"

namespace {

constexpr int kMaxCh = 5;

// The surfel pair model of units.cuh's launches.
struct Surfel {
  static constexpr int kCullRows = surfel::kRowCh;   // T zplane c2d op
  static constexpr int kChRow = surfel::kRowCh;
  static constexpr int kInterleave = 2;

  __device__ static bool passes(const float* c, int stride, int j,
                                float2 q) {
    surfel::Pair s;
    return surfel::eval_pair<true>(c, stride, j, q.x, q.y, s);
  }

  // One pixel's compositing state.
  struct Chain {
    float T = 1.0f;
    float acc[kMaxCh] = {};
    float zacc = 0.0f, z2acc = 0.0f;
    bool done = false;

    // A pair that passes the culls: the pixel stops, without applying it,
    // where T (1 - alpha) < t_eps; else it adds w = alpha T to the
    // channels, w z and w z z to the depth sums.
    __device__ __forceinline__ bool visit(const float* __restrict__ c,
                                          int stride, int j, float2 q,
                                          int nch, float t_eps) {
      surfel::Pair s;
      if (!surfel::eval_pair(c, stride, j, q.x, q.y, s)) return false;
      const float nt = __fmul_rn(T, __fsub_rn(1.0f, s.alpha));
      if (nt < t_eps) {
        done = true;
        return true;
      }
      const float w = __fmul_rn(s.alpha, T);
      const float* ch = c + kChRow * stride + j;
#pragma unroll
      for (int k = 0; k < kMaxCh; ++k)
        if (k < nch) acc[k] = __fadd_rn(acc[k], __fmul_rn(w, ch[k * stride]));
      const float wz = __fmul_rn(w, s.z);
      zacc = __fadd_rn(zacc, wz);
      z2acc = __fadd_rn(z2acc, __fmul_rn(wz, s.z));
      T = nt;
      return false;
    }

    __device__ __forceinline__ void store(float* __restrict__ o, int npx,
                                          int nch) const {
#pragma unroll
      for (int r = 0; r < kMaxCh; ++r) o[r * npx] = r < nch ? acc[r] : 0.0f;
      o[5 * npx] = zacc;
      o[6 * npx] = z2acc;
      o[7 * npx] = T;
    }
  };
};

}  // namespace

extern "C" int divshot_surfel_forward(const float* table,
                                      int64_t num_instances,
                                      const int32_t* tile_start,
                                      int32_t num_tiles, int32_t tiles_x,
                                      int32_t tile_size, int32_t nch,
                                      float t_eps, float* out, int32_t* work,
                                      void* stream) {
  return units::launch_forward<Surfel>(table, num_instances, tile_start,
                                       num_tiles, tiles_x, tile_size, nch,
                                       t_eps, out, work, stream);
}
