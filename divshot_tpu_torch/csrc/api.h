// Plain C interface of the port's CUDA kernels, loaded from Python with
// ctypes (divshot_tpu_torch/_build.py). Every pointer is device memory
// allocated by the Python wrapper; every function launches on `stream`,
// does not synchronise, and returns the cudaError_t of the launch
// (0 = cudaSuccess).
#pragma once
#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

// Run-length expansion of per-gaussian tile rectangles into `cap`
// per-tile instance slots: one int32 sort key (the unsigned (tile |
// depth) word with its top bit flipped) and one owner a slot; see
// expand.cu. Needs n + cap + 2048 < 2^31.
int divshot_expand(const int32_t* offsets, const int32_t* counts,
                   const int32_t* tmin_x, const int32_t* tmin_y,
                   const int32_t* nx, const int32_t* depth_key,
                   const float* u, const float* v, const float* rad2,
                   int32_t n, int32_t cap, int32_t tiles_x,
                   int32_t tile_size, int32_t depth_bits,
                   int32_t* key_out, int32_t* owner_out, void* stream);

// The split of divshot_expand's work, as its blocks find it: for each of
// its `pieces` pieces the first gaussian of the piece's items, then n,
// into `out` (pieces + 1); `pieces` must be the kernel's grid, ceil((n +
// cap) / kPiece): see expand.cu.
int divshot_expand_partition(const int32_t* offsets, const int32_t* counts,
                             int32_t n, int32_t cap, int32_t pieces,
                             int32_t* out, void* stream);

// Front-to-back alpha compositing of depth-sorted instances per tile, in
// two launches: see forward.cu. `work` is a workspace of
// units::work_words(num_instances, tile_size^2) int32 (null when that is
// 0) that needs no initialisation; after the call its first
// units::cull_words(num_instances) x tile_size^2 words hold the survivor
// mask of the culled long tiles (units.cuh).
int divshot_forward(const float* table, int64_t num_instances,
                    const int32_t* tile_start, int32_t num_tiles,
                    int32_t tiles_x, int32_t tile_size, int32_t nch,
                    float t_eps, float* out, int32_t* work, void* stream);

// The VJP of divshot_forward: per-instance gradient rows
// [du dv da db dc dop dch.. |du| |dv| npix] of shape (9 + nch, I) from the
// cotangent and forward tiles (T, 8, px), each tile cut into units of at
// most units::kUnit instances (units.cuh): see backward.cu.
int divshot_backward(const float* table, int64_t num_instances,
                     const int32_t* tile_start, int32_t num_tiles,
                     int32_t tiles_x, int32_t tile_size, int32_t nch,
                     float t_eps, int32_t absgrad, const float* cot,
                     const float* fwd, float* grads, void* stream);

// Exact-2DGS (surfel) ray-splat compositing of depth-sorted instances per
// tile -> (T, 8, px): channels, z, z^2, T, with the workspace `work` as
// in divshot_forward: see surfel_forward.cu.
int divshot_surfel_forward(const float* table, int64_t num_instances,
                           const int32_t* tile_start, int32_t num_tiles,
                           int32_t tiles_x, int32_t tile_size, int32_t nch,
                           float t_eps, float* out, int32_t* work,
                           void* stream);

// The VJP of divshot_surfel_forward: per-instance rows
// [dT(9) dzp(3) dc2d(2) dop dch.. ds_x ds_y |ds_x| |ds_y| npix] of shape
// (20 + nch, I), in the same units: see surfel_backward.cu.
int divshot_surfel_backward(const float* table, int64_t num_instances,
                            const int32_t* tile_start, int32_t num_tiles,
                            int32_t tiles_x, int32_t tile_size, int32_t nch,
                            float t_eps, const float* cot, const float* fwd,
                            float* grads, void* stream);

// Per-gaussian sums of selected rows of a backward kernel's per-instance
// output `grads` (rows x icap, in sorted order), in two launches: see
// segment.cu. The stage writes, for each sorted position j below icap whose
// slot perm[j] (the sort's permutation: sorted position -> expansion slot)
// lies in a segment, the record records[perm[j]] (`stride` floats: the
// nrows rows grads[row0 + r * row_step][j], or zeros at or past
// tile_start[num_tiles], then zeros to the stride); stride is nrows
// rounded up to 8, at most 32. The reduce writes out (nrows x n): row r,
// gaussian g, the sum of row r of the records of g's expansion slots
// [offsets[g], offsets[g] + counts[g]) below icap, in an order fixed by the
// code, the same on every launch. offsets must be the exclusive prefix sum
// of counts.
int divshot_segment_stage(const float* grads, int64_t icap, int32_t row0,
                          int32_t row_step, int32_t nrows,
                          const int32_t* tile_start, int32_t num_tiles,
                          const int64_t* perm, const int32_t* offsets,
                          const int32_t* counts, int32_t n, float* records,
                          int32_t stride, void* stream);
int divshot_segment_reduce(const float* records, int32_t stride,
                           int32_t nrows, const int32_t* offsets,
                           const int32_t* counts, int32_t n, int64_t icap,
                           float* out, void* stream);

// The work split of the two backward kernels: for each of the `blocks`
// blocks of a backward grid over these tiles, the unit that units::find
// gives it, as rows (tile, s0, start, end) of `out` (blocks x 4), tile -1
// for a block without one; `blocks` must be units::grid_blocks: see
// units.cu.
int divshot_backward_schedule(const int32_t* tile_start, int32_t num_tiles,
                              int64_t num_instances, int64_t blocks,
                              int64_t* out, void* stream);

#ifdef __cplusplus
}
#endif
