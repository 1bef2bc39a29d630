"""EWA projection of 3D Gaussians to screen space (counterpart of
``divshot_tpu/raster/project.py:38-163``).

Perspective Jacobian with the view-space clamp to 1.3 tan(fov), the +eps2d
low-pass dilation of the 2D covariance, the optional Mip-Splatting opacity
compensation ``comp``, and, given opacities, the opacity-aware tight extents
(``radii``, ``radii_xy``, ``rad2``). The arithmetic follows the JAX function
term by term so the two agree to float32 rounding. The camera's pose and
intrinsics enter as Python floats: a frame makes no host-to-device copy
and never waits on the card.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from divshot_tpu_torch.splat.camera import Camera
from divshot_tpu_torch.splat.math import cov3d_flat, matvec3


class Projection(NamedTuple):
    means2d: torch.Tensor   # (N, 2) pixel centres
    conics: torch.Tensor    # (N, 3) inverse cov2d (a, b, c)
    depths: torch.Tensor    # (N,) view-space z
    radii: torch.Tensor     # (N,) conservative pixel radius (0 = culled)
    comp: torch.Tensor      # (N,) AA opacity compensation (1 if off)
    cov2d: torch.Tensor     # (N, 3) dilated 2D covariance (xx, xy, yy)
    radii_xy: torch.Tensor | None = None  # (N, 2) ellipse AABB half-extents
    rad2: torch.Tensor | None = None      # (N,) squared circum-radius


def project_gaussians(
    means: torch.Tensor,       # (N, 3)
    log_scales: torch.Tensor,  # (N, 3)
    quats: torch.Tensor,       # (N, 4)
    camera: Camera,
    *,
    eps2d: float = 0.3,
    antialiased: bool = False,
    near: float = 0.01,
    far: float = 1e10,
    fov_clamp: tuple | None = None,
    opacities: torch.Tensor | None = None,
) -> Projection:
    R = camera.rotation
    t = camera.translation
    p_view = matvec3(R, means, t)
    z = p_view[..., 2]

    tan_fovx, tan_fovy = camera.tan_fovx, camera.tan_fovy
    zc = torch.clamp_min(z, near)
    if fov_clamp is not None:
        tan_fovx, tan_fovy = fov_clamp
    # float32 products, as JAX forms 1.3 * tan_fov
    limx = float(np.float32(1.3) * np.float32(tan_fovx))
    limy = float(np.float32(1.3) * np.float32(tan_fovy))
    tx = torch.clamp(p_view[..., 0] / zc, -limx, limx) * zc
    ty = torch.clamp(p_view[..., 1] / zc, -limy, limy) * zc

    fx, fy = camera.fx, camera.fy
    rz = 1.0 / zc
    rz2 = rz * rz
    c00, c01, c02, c11, c12, c22 = cov3d_flat(log_scales, quats)
    cm = ((c00, c01, c02), (c01, c11, c12), (c02, c12, c22))
    # T = R_view @ C, then V = T @ R_view^T (symmetric, six components)
    t_rows = [[sum(R[i][k] * cm[k][j] for k in range(3)) for j in range(3)]
              for i in range(3)]

    def v_entry(i, l):
        return sum(t_rows[i][j] * R[l][j] for j in range(3))

    v00, v01, v02 = v_entry(0, 0), v_entry(0, 1), v_entry(0, 2)
    v11, v12, v22 = v_entry(1, 1), v_entry(1, 2), v_entry(2, 2)

    j00 = fx * rz
    j02 = -fx * tx * rz2
    j11 = fy * rz
    j12 = -fy * ty * rz2
    cxx = j00 * j00 * v00 + 2 * j00 * j02 * v02 + j02 * j02 * v22
    cxy = j00 * j11 * v01 + j00 * j12 * v02 + j02 * j11 * v12 + j02 * j12 * v22
    cyy = j11 * j11 * v11 + 2 * j11 * j12 * v12 + j12 * j12 * v22

    det_raw = cxx * cyy - cxy * cxy
    cxx_d = cxx + eps2d
    cyy_d = cyy + eps2d
    det = cxx_d * cyy_d - cxy * cxy
    det_safe = torch.clamp_min(det, 1e-12)

    comp = (torch.sqrt(torch.clamp_min(det_raw, 0.0) / det_safe)
            if antialiased else torch.ones_like(det))

    inv_det = 1.0 / det_safe
    conic_a = cyy_d * inv_det
    conic_b = -cxy * inv_det
    conic_c = cxx_d * inv_det

    # radius: 3 sigma of the major eigenvalue, or with opacities the
    # alpha >= 1/255 level set capped at 3 sigma
    mid = 0.5 * (cxx_d + cyy_d)
    disc = torch.sqrt(torch.clamp_min(mid * mid - det_safe, 0.1))
    lambda1 = mid + disc
    if opacities is not None:
        op_eff = opacities * comp
        L = torch.log(torch.clamp_min(op_eff, 1e-12) * 255.0)
        coeff = torch.clamp_max(torch.sqrt(2.0 * torch.clamp_min(L, 0.0)),
                                3.0)
        op_ok = L > 0.0
    else:
        coeff = 3.0
        op_ok = torch.ones_like(z, dtype=torch.bool)
    rad2 = coeff * coeff * torch.clamp_min(lambda1, 0.0)
    radius = torch.ceil(torch.sqrt(rad2))
    rx = torch.ceil(coeff * torch.sqrt(torch.clamp_min(cxx_d, 0.0)))
    ry = torch.ceil(coeff * torch.sqrt(torch.clamp_min(cyy_d, 0.0)))

    u = fx * p_view[..., 0] * rz + camera.cx
    v = fy * p_view[..., 1] * rz + camera.cy

    W, H = camera.width, camera.height
    valid = (z > near) & (z < far) & (det > 0) & op_ok
    inside = (u + rx > 0) & (u - rx < W) & (v + ry > 0) & (v - ry < H)
    keep = valid & inside
    zero = torch.zeros((), device=means.device)
    radii = torch.where(keep, radius, zero)

    return Projection(
        means2d=torch.stack([u, v], -1),
        conics=torch.stack([conic_a, conic_b, conic_c], -1),
        depths=z,
        radii=radii,
        comp=comp,
        cov2d=torch.stack([cxx_d, cxy, cyy_d], -1),
        radii_xy=torch.where(keep[:, None], torch.stack([rx, ry], -1), zero),
        rad2=rad2,
    )
