"""Synthetic scenes and orbit cameras (counterpart of
``divshot_tpu/gsio/synthetic.py:20-60``). The numpy draws are the JAX
package's, in the same order, so one seed gives the same scene in both.
"""

from __future__ import annotations

import numpy as np

from divshot_tpu_torch.splat.camera import Camera
from divshot_tpu_torch.splat.gaussians import GaussianParams


def random_scene(rng: np.random.Generator, n: int, *, sh_degree: int = 0,
                 radius: float = 1.2, capacity: int | None = None,
                 scale_range: tuple[float, float] = (0.02, 0.09),
                 device="cuda") -> GaussianParams:
    """Blob-cluster scene: gaussians clumped around 12 centres."""
    k = 12
    centers = rng.uniform(-radius, radius, (k, 3))
    which = rng.integers(0, k, n)
    means = centers[which] + 0.25 * rng.standard_normal((n, 3))
    scales = rng.uniform(np.log(scale_range[0]), np.log(scale_range[1]),
                         (n, 3))
    quats = rng.standard_normal((n, 4))
    opacity = rng.uniform(0.5, 3.0, (n,))
    base = rng.uniform(0, 1, (k, 3))
    sh0 = (base[which] + 0.15 * rng.standard_normal((n, 3)) - 0.5) / 0.2821
    n_sh = {0: 0, 1: 3, 2: 8, 3: 15}[sh_degree]
    shN = 0.08 * rng.standard_normal((n, n_sh, 3)) if n_sh else None
    return GaussianParams.create(
        means.astype(np.float32), scales=scales.astype(np.float32),
        quats=quats.astype(np.float32), opacity=opacity.astype(np.float32),
        sh0=sh0.astype(np.float32),
        shN=None if shN is None else shN.astype(np.float32),
        sh_degree=sh_degree, capacity=capacity, device=device)


def orbit_cameras(num: int, *, radius: float = 4.0, height: float = 1.0,
                  width: int = 128, fov_y_deg: float = 50.0,
                  height_px: int | None = None,
                  device="cuda") -> list[Camera]:
    h = height_px if height_px is not None else width
    cams = []
    for i in range(num):
        a = 2 * np.pi * i / num
        eye = [radius * np.cos(a), height * np.sin(2 * a), radius * np.sin(a)]
        cams.append(Camera.look_at(eye, [0, 0, 0], [0, -1, 0], fov_y_deg,
                                   width, h, device=device))
    return cams
