// Instance expansion for tile binning, CUDA C++ for sm_90a.
//
// Replaces: the Pallas TPU kernel `_expand_kernel` in
//   divshot_tpu/raster/pallas_bin.py (called by `expand_sorted`).
// Computes: for each instance slot i < cap, the owning gaussian g (the last
//   g with offsets[g] <= i), its local index j = i - offsets[g], the tile
//   (tmin_x + j % nx, tmin_y + j / nx), a corner cull (keep iff the squared
//   distance from (u, v) to the tile rectangle is <= rad2), and the 32-bit
//   sort key (tile << depth_bits) | depth_key[g], or 0xFFFFFFFF when culled.
//   Slots >= total get key 0xFFFFFFFF and owner 0x7FFFFFFF.
// Bound on the H100: device-memory bytes. Each slot writes 8 bytes and
//   reads a handful of per-gaussian words; the arithmetic is a ~20-step
//   binary search and a few compares.
// Design: one thread per slot, so the key and owner stores of a warp are
//   contiguous. Neighbouring slots mostly share their owner, so the binary
//   search and the per-gaussian reads hit the same cache lines across the
//   warp. The TPU kernel's one-hot matmul decode, bf16 splits and 7-bit
//   offset transport are not needed here and are gone. The cull uses
//   explicitly rounded operations (no fused multiply-add) so it decides
//   exactly as the plain PyTorch version does.
#include <cuda_runtime.h>
#include "api.h"

namespace {

__global__ void expand_kernel(const int32_t* __restrict__ offsets,
                              const int32_t* __restrict__ counts,
                              const int32_t* __restrict__ tmin_x,
                              const int32_t* __restrict__ tmin_y,
                              const int32_t* __restrict__ nx,
                              const int32_t* __restrict__ depth_key,
                              const float* __restrict__ u,
                              const float* __restrict__ v,
                              const float* __restrict__ rad2,
                              int32_t n, int32_t cap, int32_t tiles_x,
                              int32_t tile_size, int32_t depth_bits,
                              uint32_t* __restrict__ key_out,
                              int32_t* __restrict__ owner_out) {
  const int32_t i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= cap) return;
  const int32_t total = n > 0 ? offsets[n - 1] + counts[n - 1] : 0;
  if (i >= total) {
    key_out[i] = 0xFFFFFFFFu;
    owner_out[i] = 0x7FFFFFFF;
    return;
  }
  // last g with offsets[g] <= i (zero-count gaussians share the offset of
  // the next one, so the last match is the one whose range holds i)
  int32_t lo = 0, hi = n - 1;
  while (lo < hi) {
    const int32_t mid = (lo + hi + 1) >> 1;
    if (offsets[mid] <= i) lo = mid; else hi = mid - 1;
  }
  const int32_t g = lo;
  const int32_t j = i - offsets[g];
  const int32_t w = max(nx[g], 1);
  const int32_t jy = j / w;
  const int32_t tx = tmin_x[g] + (j - jy * w);
  const int32_t ty = tmin_y[g] + jy;

  const float ts = (float)tile_size;
  const float ttx = __fmul_rn((float)tx, ts);
  const float tty = __fmul_rn((float)ty, ts);
  const float ug = u[g], vg = v[g];
  const float dx = fmaxf(fmaxf(__fsub_rn(ttx, ug),
                               __fsub_rn(ug, __fadd_rn(ttx, ts))), 0.0f);
  const float dy = fmaxf(fmaxf(__fsub_rn(tty, vg),
                               __fsub_rn(vg, __fadd_rn(tty, ts))), 0.0f);
  const bool keep = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)) <= rad2[g];

  const uint32_t tile = (uint32_t)(ty * tiles_x + tx);
  key_out[i] = keep ? ((tile << depth_bits) | (uint32_t)depth_key[g])
                    : 0xFFFFFFFFu;
  owner_out[i] = g;
}

}  // namespace

extern "C" int divshot_expand(const int32_t* offsets, const int32_t* counts,
                              const int32_t* tmin_x, const int32_t* tmin_y,
                              const int32_t* nx, const int32_t* depth_key,
                              const float* u, const float* v,
                              const float* rad2, int32_t n, int32_t cap,
                              int32_t tiles_x, int32_t tile_size,
                              int32_t depth_bits, uint32_t* key_out,
                              int32_t* owner_out, void* stream) {
  if (cap <= 0) return (int)cudaSuccess;
  const int threads = 256;
  const int blocks = (cap + threads - 1) / threads;
  expand_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      offsets, counts, tmin_x, tmin_y, nx, depth_key, u, v, rad2, n, cap,
      tiles_x, tile_size, depth_bits, key_out, owner_out);
  return (int)cudaGetLastError();
}
