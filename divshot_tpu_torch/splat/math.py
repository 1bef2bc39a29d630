"""Core splat geometry math: quaternions, 3D covariances.

Counterpart of ``divshot_tpu/splat/math.py``: the rotation matrix and its
scalar components, the flat symmetric covariance, the elementwise 3-vector
rotation and dot, the NaN-free normalisation, and the editor's rotation
matrix to quaternion and Hamilton product. The formulas and their
evaluation order are kept, so the two packages agree to the last bits on
the same float32 inputs.
"""

from __future__ import annotations

import numpy as np
import torch


def quat_to_rotmat(quats: torch.Tensor, normalize: bool = True
                   ) -> torch.Tensor:
    """(..., 4) wxyz quaternions -> (..., 3, 3) rotation matrices."""
    r = quat_rotmat_components(quats, normalize)
    return torch.stack([torch.stack(r[3 * i:3 * i + 3], -1)
                        for i in range(3)], -2)


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


def dot3(r, x: torch.Tensor) -> torch.Tensor:
    """out[...] = sum_j r[j] * x[..., j], elementwise; ``r`` is a
    3-sequence of Python floats (a camera's rotation row)."""
    return r[0] * x[..., 0] + r[1] * x[..., 1] + r[2] * x[..., 2]


def rotmat_to_quat(R: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) -> (..., 4) wxyz, Shepperd's four cases computed for
    every row and picked by ``torch.where`` as JAX's ``jnp.where`` picks
    them."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    def root(v):
        return torch.sqrt(torch.clamp_min(v, 1e-12)) * 2

    s = root(tr + 1.0)
    q0 = torch.stack([0.25 * s, (m21 - m12) / s, (m02 - m20) / s,
                      (m10 - m01) / s], -1)
    s = root(1.0 + m00 - m11 - m22)
    q1 = torch.stack([(m21 - m12) / s, 0.25 * s, (m01 + m10) / s,
                      (m02 + m20) / s], -1)
    s = root(1.0 + m11 - m00 - m22)
    q2 = torch.stack([(m02 - m20) / s, (m01 + m10) / s, 0.25 * s,
                      (m12 + m21) / s], -1)
    s = root(1.0 + m22 - m00 - m11)
    q3 = torch.stack([(m10 - m01) / s, (m02 + m20) / s, (m12 + m21) / s,
                      0.25 * s], -1)
    c1 = (m00 > m11) & (m00 > m22)
    c2 = m11 > m22
    q_neg = torch.where(c1[..., None], q1, torch.where(c2[..., None], q2, q3))
    q = torch.where((tr > 0)[..., None], q0, q_neg)
    norm = torch.sqrt(torch.sum(q * q, dim=-1, keepdim=True))
    return q / torch.clamp_min(norm, 1e-12)


def rotmat_to_quat_np(R) -> np.ndarray:
    """A host rotation matrix's quaternion, computed in float32 on the CPU
    as JAX's ``edit.ops._rotmat_to_quat_np`` computes it."""
    return rotmat_to_quat(torch.as_tensor(np.asarray(R, np.float32))).numpy()


def quat_multiply(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product of wxyz quaternions (broadcasting)."""
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ], -1)
