"""Exact-2DGS (surfel) projection (counterpart of
``divshot_tpu/raster/surfel.py:52-132``).

Per splat the (u, v, 1) -> pixel-homogeneous map is the 3x3 matrix

    T = K' . [s_u R r1 | s_v R r2 | R mu + t],  K' = [[fx,0,cx],[0,fy,cy],[0,0,1]]

A pixel (x, y) meets the splat's plane at (u, v) = (p_x, p_y) / p_z with
``p = (x T_row3 - T_row1) x (y T_row3 - T_row2)`` (2DGS paper, eq. 9-10);
the compositing kernels (``raster/surfel_raster.py``) evaluate that per
pixel. This module gives them their per-splat inputs: ``Tmat``, the
view-depth plane ``zplane`` (z = zplane . (u, v, 1)), the centre, the
dual-conic AABB radius and the camera-facing normal. Plain autograd
tensors, with the JAX function's float32 operations in its order.

The JAX package's XLA scan compositor (``_make_surfel_compositor``) is
not ported: the plain versions of the surfel kernels take its place.
"""

from __future__ import annotations

import torch

from divshot_tpu_torch.splat.camera import Camera
from divshot_tpu_torch.splat.math import matvec3, quat_rotmat_components

ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.999
T_EPS = 1e-4
FILTER_INV_SQ = 2.0        # 2DGS low-pass: rho2d = 2 |d|^2
Z_MIN = 0.01               # per-pixel intersection depth cull

_ZERO3 = (0.0, 0.0, 0.0)


def _sum3(a, b, c):
    return (a + b) + c


def project_surfels(means: torch.Tensor, log_scales: torch.Tensor,
                    quats: torch.Tensor, camera: Camera, *,
                    near: float = 0.01, far: float = 1e10
                    ) -> dict[str, torch.Tensor]:
    """-> dict of per-splat ``Tmat`` (N, 3, 3), ``zplane`` (N, 3),
    ``center2d`` (N, 2), ``depths`` (N,) centre view z, ``radii`` (N,)
    (0 = culled) and ``normal_cam`` (N, 3), the unit normal in camera space
    flipped toward the camera. Only the first two scale axes are used."""
    R = camera.rotation
    r = quat_rotmat_components(quats)          # row-major rotation entries
    su = torch.exp(log_scales[:, 0])
    sv = torch.exp(log_scales[:, 1])
    # view-space tangent frame and centre
    tu = matvec3(R, torch.stack([r[0], r[3], r[6]], -1), _ZERO3) \
        * su[:, None]
    tv = matvec3(R, torch.stack([r[1], r[4], r[7]], -1), _ZERO3) \
        * sv[:, None]
    cv = matvec3(R, means, camera.translation)

    fx, fy, cx, cy = camera.fx, camera.fy, camera.cx, camera.cy

    def kp(p):  # K' . p for view-space p: (N, 3) -> (N, 3)
        return torch.stack([fx * p[:, 0] + cx * p[:, 2],
                            fy * p[:, 1] + cy * p[:, 2], p[:, 2]], 1)

    Tmat = torch.stack([kp(tu), kp(tv), kp(cv)], 2)       # columns u, v, 1
    zplane = torch.stack([tu[:, 2], tv[:, 2], cv[:, 2]], 1)

    # dual-conic AABB (2DGS computeAABB): M* = T diag(1, 1, -1) T^T
    T0, T1, T2 = Tmat[:, 0, :], Tmat[:, 1, :], Tmat[:, 2, :]
    w = (1.0, 1.0, -1.0)

    def wsum(a, b, f=w):
        return _sum3(*(a[:, k] * b[:, k] * f[k] for k in range(3)))

    dist = wsum(T2, T2)
    dist_ok = torch.abs(dist) > 1e-7
    dist_safe = torch.where(dist_ok, dist, torch.ones_like(dist))
    f = [wk / dist_safe for wk in w]
    cx2 = _sum3(*(f[k] * T0[:, k] * T2[:, k] for k in range(3)))
    cy2 = _sum3(*(f[k] * T1[:, k] * T2[:, k] for k in range(3)))
    ex = cx2 * cx2 - _sum3(*(f[k] * T0[:, k] * T0[:, k] for k in range(3)))
    ey = cy2 * cy2 - _sum3(*(f[k] * T1[:, k] * T1[:, k] for k in range(3)))
    ext = torch.clamp_min(torch.maximum(ex, ey), 0.0)
    # the low-pass disc reaches ~2.4 px (alpha cutoff at rho2d = 11)
    radius = torch.ceil(torch.clamp_min(3.0 * torch.sqrt(ext), 2.5))

    z = cv[:, 2]
    W, H = camera.width, camera.height
    inside = ((cx2 + radius > 0) & (cx2 - radius < W)
              & (cy2 + radius > 0) & (cy2 - radius < H))
    valid = (z > near) & (z < far) & dist_ok & (ext > 0) & inside
    radii = torch.where(valid, radius, torch.zeros((), device=z.device))

    # camera-facing normal (third rotation column), camera space
    n_cam = matvec3(R, torch.stack([r[2], r[5], r[8]], -1), _ZERO3)
    flip = torch.sign(-(n_cam * cv).sum(1, keepdim=True))
    flip = torch.where(flip == 0, torch.ones_like(flip), flip)
    return {"Tmat": Tmat, "zplane": zplane,
            "center2d": torch.stack([cx2, cy2], 1), "depths": z,
            "radii": radii, "normal_cam": n_cam * flip}
