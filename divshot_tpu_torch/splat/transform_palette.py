"""Deferred, 16-bit-indexed per-splat transforms (counterpart of
``divshot_tpu/splat/transform_palette.py``): the editor keeps a palette
of affine transforms and a per-splat index; splats render through their
entry without the model being rewritten until a bake.

The matrices live on the host, the indices on the device. ``apply`` is
one masked pass per non-identity entry. Entry 0 is the identity; the
palette holds at most 65536 entries (u16 indices, stored as int32).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from divshot_tpu_torch.splat.gaussians import GaussianParams
from divshot_tpu_torch.splat.math import (matvec3, quat_multiply,
                                          rotmat_to_quat_np)
from divshot_tpu_torch.splat.sh import rotate_sh

MAX_ENTRIES = 65536


def polar_rotation(A: np.ndarray) -> np.ndarray:
    """The rotation of a 3x3 matrix's polar decomposition (float64)."""
    u, _s, vt = np.linalg.svd(A)
    R = u @ vt
    if np.linalg.det(R) < 0:
        u[:, -1] *= -1
        R = u @ vt
    return R


def _polar_decompose(m: np.ndarray):
    """4x4 affine -> (R (3, 3), uniform log-scale, t (3,)), in float64,
    returned as float32."""
    A = np.asarray(m, np.float64)[:3, :3]
    t = np.asarray(m, np.float64)[:3, 3]
    R = polar_rotation(A)
    log_s = np.log(max(np.cbrt(max(np.linalg.det(A), 1e-12)), 1e-12))
    return R.astype(np.float32), np.float32(log_s), t.astype(np.float32)


def affine_means(m: np.ndarray, means: torch.Tensor) -> torch.Tensor:
    """``m[:3, :3] @ x + m[:3, 3]`` for every row, with the matrix's
    float32 entries, in JAX's order (``matvec3(A, x) + t``)."""
    m32 = np.asarray(m, np.float32)
    return matvec3(m32[:3, :3].tolist(), means, m32[:3, 3].tolist())


class SplatTransformPalette:
    """Host matrices + per-splat palette indices on ``device``."""

    def __init__(self, capacity: int, device="cuda"):
        self.capacity = capacity
        self.matrices: list[np.ndarray] = [np.eye(4, dtype=np.float32)]
        self.indices = torch.zeros((capacity,), dtype=torch.int32,
                                   device=device)

    @property
    def num_entries(self) -> int:
        return len(self.matrices)

    def add(self, matrix: np.ndarray) -> int:
        """-> the palette slot of ``matrix`` (new, or an identical one)."""
        m = np.asarray(matrix, np.float32).reshape(4, 4)
        for i, e in enumerate(self.matrices):
            if np.array_equal(e, m):
                return i
        if len(self.matrices) >= MAX_ENTRIES:
            raise ValueError("transform palette full (65536 entries)")
        self.matrices.append(m)
        return len(self.matrices) - 1

    def assign(self, mask: torch.Tensor, slot: int) -> None:
        """Point the splats under ``mask`` at palette entry ``slot``."""
        if not 0 <= slot < len(self.matrices):
            raise IndexError(slot)
        self.indices = torch.where(mask, slot, self.indices).to(torch.int32)

    def clear(self) -> None:
        self.matrices = [np.eye(4, dtype=np.float32)]
        self.indices = torch.zeros((self.capacity,), dtype=torch.int32,
                                   device=self.indices.device)

    def apply(self, params: GaussianParams) -> GaussianParams:
        """The deferred transforms applied (render-time view; the params
        stay untouched until a bake)."""
        means, quats, scales, shN = (params.means, params.quats,
                                     params.scales, params.shN)
        degree = {0: 0, 3: 1, 8: 2, 15: 3}[shN.shape[1]]
        for slot in range(1, len(self.matrices)):
            m = self.matrices[slot]
            R, log_s, _t = _polar_decompose(m)
            sel = self.indices == slot
            rq = torch.as_tensor(rotmat_to_quat_np(R), device=quats.device)
            means = torch.where(sel[:, None], affine_means(m, means), means)
            quats = torch.where(sel[:, None], quat_multiply(rq[None], quats),
                                quats)
            scales = torch.where(sel[:, None], scales + float(log_s), scales)
            if degree > 0:
                shN = torch.where(sel[:, None, None],
                                  rotate_sh(shN, R, degree), shN)
        return dataclasses.replace(params, means=means, quats=quats,
                                   scales=scales, shN=shN)

    def bake(self, params: GaussianParams) -> GaussianParams:
        """Materialise every entry into the params and reset the palette."""
        out = self.apply(params)
        self.clear()
        return out
