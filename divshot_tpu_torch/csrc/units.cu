// The backward kernels' work split (units.cuh) written out on the card, so
// that the schedule the kernels run can be held against its plain version
// (raster/units.py, backward_schedule_plain). No kernel of the render or
// training path calls it.
#include <cuda_runtime.h>
#include "api.h"
#include "units.cuh"

namespace {

__global__ void schedule_kernel(const int32_t* __restrict__ tile_start,
                                int32_t num_tiles, int64_t num_instances,
                                int64_t blocks, int64_t* __restrict__ out) {
  const int64_t b = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= blocks) return;
  units::Unit u;
  int64_t* row = out + 4 * b;
  if (units::find(b, tile_start, num_tiles, num_instances, u)) {
    row[0] = u.tile;
    row[1] = u.s0;
    row[2] = u.start;
    row[3] = u.end;
  } else {
    row[0] = -1;
    row[1] = row[2] = row[3] = 0;
  }
}

}  // namespace

extern "C" int divshot_backward_schedule(const int32_t* tile_start,
                                         int32_t num_tiles,
                                         int64_t num_instances,
                                         int64_t blocks, int64_t* out,
                                         void* stream) {
  if (num_tiles < 0 || num_instances < 0 ||
      blocks != units::grid_blocks(num_tiles, num_instances))
    return (int)cudaErrorInvalidValue;
  if (blocks == 0) return (int)cudaSuccess;
  const int threads = 256;
  schedule_kernel<<<(unsigned)((blocks + threads - 1) / threads), threads, 0,
                    (cudaStream_t)stream>>>(tile_start, num_tiles,
                                            num_instances, blocks, out);
  return (int)cudaGetLastError();
}
