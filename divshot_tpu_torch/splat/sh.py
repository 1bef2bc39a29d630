"""Real spherical-harmonics colour, degrees 0..3, and SH rotation
(counterpart of ``divshot_tpu/splat/sh.py``).

Constants and basis order are the JAX package's (graphdeco convention):
colour = 0.5 + SH_C0 * sh0 + sum_k basis[k] * shN[k], clamped at 0. The
rotation of the rest coefficients is solved per band in float64 numpy on
the host from fixed sample directions, as in JAX, and applied to ``shN``
on its device.
"""

from __future__ import annotations

import numpy as np
import torch

SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
         -1.0925484305920792, 0.5462742152960396)
SH_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
         0.3731763325901154, -0.4570457994644658, 1.445305721320277,
         -0.5900435899266435)

NUM_SH_REST = {0: 0, 1: 3, 2: 8, 3: 15}


def eval_sh_basis(dirs: torch.Tensor, degree: int) -> torch.Tensor:
    """SH basis without the DC term at unit directions (..., 3) ->
    (..., NUM_SH_REST[degree])."""
    if degree == 0:
        return dirs.new_zeros((*dirs.shape[:-1], 0))
    x, y, z = dirs.unbind(-1)
    out = [-SH_C1 * y, SH_C1 * z, -SH_C1 * x]
    if degree >= 2:
        xx, yy, zz = x * x, y * y, z * z
        xy, yz, xz = x * y, y * z, x * z
        out += [
            SH_C2[0] * xy,
            SH_C2[1] * yz,
            SH_C2[2] * (2.0 * zz - xx - yy),
            SH_C2[3] * xz,
            SH_C2[4] * (xx - yy),
        ]
    if degree >= 3:
        out += [
            SH_C3[0] * y * (3.0 * xx - yy),
            SH_C3[1] * xy * z,
            SH_C3[2] * y * (4.0 * zz - xx - yy),
            SH_C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy),
            SH_C3[4] * x * (4.0 * zz - xx - yy),
            SH_C3[5] * z * (xx - yy),
            SH_C3[6] * x * (xx - 3.0 * yy),
        ]
    return torch.stack(out, -1)


def eval_sh_color(sh0: torch.Tensor, shN: torch.Tensor, dirs: torch.Tensor,
                  degree: int | None = None) -> torch.Tensor:
    """(N, 3) DC + (N, K, 3) rest + (N, 3) unit dirs -> (N, 3) colour."""
    if degree is None:
        degree = {0: 0, 3: 1, 8: 2, 15: 3}[shN.shape[-2]]
    color = 0.5 + SH_C0 * sh0
    if degree > 0:
        basis = eval_sh_basis(dirs, degree)
        n = NUM_SH_REST[degree]
        color = color + (basis[..., None] * shN[..., :n, :]).sum(-2)
    return torch.clamp_min(color, 0.0)


# ---------------------------------------------------------------------------
# SH rotation


def _sh_basis_np(dirs: np.ndarray, degree: int) -> np.ndarray:
    """float64 numpy twin of ``eval_sh_basis`` (for exact rotation
    solves)."""
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    out = [-SH_C1 * y, SH_C1 * z, -SH_C1 * x]
    if degree >= 2:
        xx, yy, zz = x * x, y * y, z * z
        out += [
            SH_C2[0] * x * y, SH_C2[1] * y * z,
            SH_C2[2] * (2.0 * zz - xx - yy),
            SH_C2[3] * x * z, SH_C2[4] * (xx - yy),
        ]
    if degree >= 3:
        out += [
            SH_C3[0] * y * (3.0 * xx - yy),
            SH_C3[1] * x * y * z,
            SH_C3[2] * y * (4.0 * zz - xx - yy),
            SH_C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy),
            SH_C3[4] * x * (4.0 * zz - xx - yy),
            SH_C3[5] * z * (xx - yy),
            SH_C3[6] * x * (xx - 3.0 * yy),
        ]
    return np.stack(out, -1)


_BAND_SLICE = {1: slice(0, 3), 2: slice(3, 8), 3: slice(8, 15)}

# fixed sample directions per band, generic enough that each band's basis
# matrix is invertible
_SAMPLES = {
    1: np.array([[1, 0, 0], [0, 1, 0], [0, 0, 1]], np.float64),
    2: np.array([[1, 2, 3], [-2, 1, 2], [3, -1, 2], [1, 1, -1], [2, -3, 1]],
                np.float64),
    3: np.array([[1, 2, 3], [-2, 1, 2], [3, -1, 2], [1, 1, -1], [2, -3, 1],
                 [-1, -2, 2], [3, 2, -1]], np.float64),
}
_SAMPLES = {k: v / np.linalg.norm(v, axis=1, keepdims=True)
            for k, v in _SAMPLES.items()}


def sh_rotation_matrix(R: np.ndarray, degree: int = 3) -> np.ndarray:
    """Block-diagonal (K, K) float64 matrix M over the rest coefficients
    with sh_new = M @ sh_rest rotating the radiance field by the world
    rotation R: per band, M_l = b(samples)^-1 @ b(samples @ R)."""
    R = np.asarray(R, np.float64)
    K = NUM_SH_REST[degree]
    M = np.zeros((K, K))
    for band in range(1, degree + 1):
        s = _SAMPLES[band]
        A = _sh_basis_np(s, band)[:, _BAND_SLICE[band]]
        B = _sh_basis_np(s @ R, band)[:, _BAND_SLICE[band]]
        M[_BAND_SLICE[band], _BAND_SLICE[band]] = np.linalg.solve(A, B)
    return M


def rotate_sh(shN: torch.Tensor, R: np.ndarray,
              degree: int | None = None) -> torch.Tensor:
    """Rotate rest SH coefficients (N, K, 3) by the world rotation R
    (3, 3), on ``shN``'s device and in its dtype."""
    if degree is None:
        degree = {0: 0, 3: 1, 8: 2, 15: 3}[shN.shape[-2]]
    if degree == 0:
        return shN
    K = NUM_SH_REST[degree]
    M = torch.as_tensor(sh_rotation_matrix(np.asarray(R), degree),
                        dtype=shN.dtype, device=shN.device)
    out = torch.einsum("jk,nkc->njc", M, shN[..., :K, :])
    if shN.shape[-2] > K:
        out = torch.cat([out, shN[..., K:, :]], dim=-2)
    return out
