// The exact-2DGS ray-splat evaluation shared by surfel_forward.cu and
// surfel_backward.cu, so that the backward's recomputed forward takes the
// forward's decisions bit for bit.
//
// Per (pixel (x, y), instance), from the table rows T(9) zplane(3)
// center2d(2) opacity held in shared memory (row r of column j at
// c[r * stride + j]):
//   hu = x T[6:9] - T[0:3], hv = y T[6:9] - T[3:6], p = hu x hv,
//   (u, v) = (p0, p1) / p2 (IEEE division), rho3d = u^2 + v^2,
//   rho2d = 2 (dx^2 + dy^2) (the 2-D low-pass), rho = the smaller,
//   z = zplane . (u, v, 1), G = exp(-rho / 2), a = op G,
//   alpha = min(a, 0.999).
// The pair is culled unless |p2| > 1e-9, a >= 1/255 and z > 0.01, each
// compare written so that a NaN fails it. Every product and sum is
// explicitly rounded (no fused multiply-add) in the order of the plain
// PyTorch version (raster/surfel_raster.py, _chunk_terms). With kAll the
// function evaluates every field without branching and only then returns
// whether the pair passes the culls, so that a caller can interleave
// several pairs; the fields of a pair that passes are the same.
#pragma once
#include <cuda_runtime.h>

namespace surfel {

constexpr float kAlphaMin = 1.0f / 255.0f;
constexpr float kAlphaMax = 0.999f;
constexpr float kZMin = 0.01f;
constexpr float kPzMin = 1e-9f;
constexpr int kRowZp = 9;
constexpr int kRowC2d = 12;
constexpr int kRowOp = 14;
constexpr int kRowCh = 15;

struct Pair {
  float hu[3], hv[3];
  float p2, u, v, dx, dy, z, G, a, alpha;
  bool sel;  // rho took the 3-D branch
};

template <bool kAll = false>
__device__ __forceinline__ bool eval_pair(const float* __restrict__ c,
                                          int stride, int j, float x,
                                          float y, Pair& s) {
  const float* t = c + j;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    s.hu[i] = __fsub_rn(__fmul_rn(x, t[(6 + i) * stride]), t[i * stride]);
    s.hv[i] = __fsub_rn(__fmul_rn(y, t[(6 + i) * stride]),
                        t[(3 + i) * stride]);
  }
  const float p0 = __fsub_rn(__fmul_rn(s.hu[1], s.hv[2]),
                             __fmul_rn(s.hu[2], s.hv[1]));
  const float p1 = __fsub_rn(__fmul_rn(s.hu[2], s.hv[0]),
                             __fmul_rn(s.hu[0], s.hv[2]));
  s.p2 = __fsub_rn(__fmul_rn(s.hu[0], s.hv[1]),
                   __fmul_rn(s.hu[1], s.hv[0]));
  const bool p2_ok = fabsf(s.p2) > kPzMin;
  if (!kAll && !p2_ok) return false;
  s.u = __fdiv_rn(p0, s.p2);
  s.v = __fdiv_rn(p1, s.p2);
  const float rho3d = __fadd_rn(__fmul_rn(s.u, s.u), __fmul_rn(s.v, s.v));
  s.dx = __fsub_rn(x, t[kRowC2d * stride]);
  s.dy = __fsub_rn(y, t[(kRowC2d + 1) * stride]);
  const float rho2d = __fmul_rn(
      2.0f, __fadd_rn(__fmul_rn(s.dx, s.dx), __fmul_rn(s.dy, s.dy)));
  s.sel = rho3d <= rho2d;
  const float rho = s.sel ? rho3d : rho2d;
  s.z = __fadd_rn(__fadd_rn(__fmul_rn(t[kRowZp * stride], s.u),
                            __fmul_rn(t[(kRowZp + 1) * stride], s.v)),
                  t[(kRowZp + 2) * stride]);
  s.G = expf(__fmul_rn(-0.5f, rho));
  s.a = __fmul_rn(t[kRowOp * stride], s.G);
  const bool ok = p2_ok && s.a >= kAlphaMin && s.z > kZMin;
  if (!kAll && !ok) return false;
  s.alpha = fminf(s.a, kAlphaMax);
  return ok;
}

}  // namespace surfel
