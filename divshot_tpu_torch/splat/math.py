"""Core splat geometry math: quaternions, 3D covariances.

Counterpart of ``divshot_tpu/splat/math.py``. Only what the projection uses
is ported: the scalar-component rotation, the flat symmetric covariance,
the elementwise 3-vector rotation and the NaN-free normalisation. The
formulas and their evaluation order are kept, so the two packages agree to
the last bits on the same float32 inputs.
"""

from __future__ import annotations

import torch


def quat_rotmat_components(quats: torch.Tensor, normalize: bool = True):
    """(..., 4) wxyz -> the 9 rotation-matrix entries as (...,) tensors,
    row-major."""
    if normalize:
        quats = normalize_quats(quats)
    w, x, y, z = quats.unbind(-1)
    return (1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
            2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
            2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y))


def cov3d_flat(log_scales: torch.Tensor, quats: torch.Tensor):
    """cov3D = R S S^T R^T as its 6 symmetric components
    (xx, xy, xz, yy, yz, zz), each (...,)."""
    r = quat_rotmat_components(quats)
    s2 = torch.exp(2.0 * log_scales)
    s0, s1, s2_ = s2.unbind(-1)

    def dot_rows(a, b):
        return (r[3 * a] * r[3 * b] * s0 + r[3 * a + 1] * r[3 * b + 1] * s1
                + r[3 * a + 2] * r[3 * b + 2] * s2_)

    return (dot_rows(0, 0), dot_rows(0, 1), dot_rows(0, 2),
            dot_rows(1, 1), dot_rows(1, 2), dot_rows(2, 2))


def safe_normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Unit-normalize along the last axis; finite at x == 0."""
    s = torch.sum(x * x, dim=-1, keepdim=True)
    return x / torch.sqrt(torch.clamp_min(s, eps))


def normalize_quats(quats: torch.Tensor) -> torch.Tensor:
    s = torch.sum(quats * quats, dim=-1, keepdim=True)
    return quats / torch.sqrt(torch.clamp_min(s, 1e-12))


def matvec3(R, x: torch.Tensor, t) -> torch.Tensor:
    """out[..., i] = sum_j R[i][j] * x[..., j] + t[i], elementwise. ``R`` is
    a 3x3 nested sequence and ``t`` a 3-sequence of Python floats (a
    camera's rotation and translation)."""
    x0, x1, x2 = x.unbind(-1)
    return torch.stack(
        [R[i][0] * x0 + R[i][1] * x1 + R[i][2] * x2 + t[i] for i in range(3)],
        -1)
