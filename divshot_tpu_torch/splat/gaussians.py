"""Capacity-padded Gaussian splat parameters (counterpart of
``divshot_tpu/splat/gaussians.py:37-181``).

Storage conventions are the JAX package's and standard 3DGS's: ``scales``
holds log-scales, ``opacity`` logits, ``quats`` unnormalised (w, x, y, z),
``sh0`` the DC term and ``shN`` the higher coefficients, coefficient-major
(C, K, 3). Every tensor has the capacity as its leading dimension; ``alive``
marks the real splats, and the padded tail is dead and numerically benign.
"""

from __future__ import annotations

from dataclasses import dataclass, fields

import numpy as np
import torch

from divshot_tpu_torch.splat.sh import SH_C0

_FIELDS = ("means", "scales", "quats", "opacity", "sh0", "shN")


@dataclass(frozen=True)
class GaussianParams:
    means: torch.Tensor    # (C, 3) f32 world positions
    scales: torch.Tensor   # (C, 3) f32 log-scales
    quats: torch.Tensor    # (C, 4) f32 (w, x, y, z), unnormalised
    opacity: torch.Tensor  # (C,)   f32 logits
    sh0: torch.Tensor      # (C, 3) f32 DC SH coefficient
    shN: torch.Tensor      # (C, K, 3) f32 higher SH coefficients
    alive: torch.Tensor    # (C,)   bool

    @property
    def capacity(self) -> int:
        return self.means.shape[0]

    @property
    def device(self) -> torch.device:
        return self.means.device

    @property
    def num_alive(self) -> int:
        return int(self.alive.sum())

    @property
    def sh_degree(self) -> int:
        return {0: 0, 3: 1, 8: 2, 15: 3}[self.shN.shape[1]]

    def effective_opacity(self) -> torch.Tensor:
        """Sigmoid opacity with dead splats zeroed."""
        return torch.where(self.alive, torch.sigmoid(self.opacity),
                           torch.zeros((), device=self.device))

    @classmethod
    def create(cls, means, *, scales=None, quats=None, opacity=None,
               sh0=None, shN=None, sh_degree: int = 3,
               capacity: int | None = None,
               device="cuda") -> "GaussianParams":
        """Build params from (possibly partial) numpy arrays, padding to
        ``capacity`` with dead splats."""
        means = np.asarray(means, np.float32)
        n = means.shape[0]
        cap = n if capacity is None else capacity
        if cap < n:
            raise ValueError(f"capacity {cap} < num splats {n}")
        n_sh = {0: 0, 1: 3, 2: 8, 3: 15}[sh_degree]

        def mk(x, shape, fill=0.0):
            if x is None:
                return np.full((n, *shape), fill, np.float32)
            return np.asarray(x, np.float32).reshape((n, *shape))

        def pad(x, fill=0.0):
            out = np.full((cap, *x.shape[1:]), fill, x.dtype)
            out[:n] = x
            return out

        quats_ = mk(quats, (4,))
        if quats is None:
            quats_[:, 0] = 1.0
        quats_ = pad(quats_)
        quats_[n:, 0] = 1.0        # identity quaternions in the dead tail
        shN_ = mk(shN, (n_sh, 3)) if n_sh else np.zeros((n, 0, 3), np.float32)
        arrays = dict(
            means=pad(means),
            scales=pad(mk(scales, (3,), np.log(0.01)),
                       float(np.float32(np.log(0.01)))),
            quats=quats_,
            opacity=pad(mk(opacity, ()).reshape(n), -15.0),
            sh0=pad(mk(sh0, (3,))),
            shN=pad(shN_),
            alive=pad(np.ones((n,), bool), False),
        )
        return cls(**{k: torch.as_tensor(v, device=device)
                      for k, v in arrays.items()})

    @classmethod
    def from_numpy(cls, d: dict, *, device="cuda") -> "GaussianParams":
        """Carry JAX params across: ``d`` maps each field name (``means``,
        ``scales``, ``quats``, ``opacity``, ``sh0``, ``shN``, ``alive``) to
        that field as a numpy array, capacity padding included. A bf16
        field (``pack_level``'s ``shN``) stays bf16."""
        out = {}
        for f in fields(cls):
            if f.name == "alive":
                out[f.name] = torch.as_tensor(np.array(d[f.name], np.bool_),
                                              device=device)
            else:
                out[f.name] = to_tensor(d[f.name], device)
        return cls(**out)

    def compact_numpy(self) -> dict[str, np.ndarray]:
        """Host-side float32 arrays with dead and padded splats removed,
        whatever dtype the training buffers are stored in."""
        alive = self.alive.cpu().numpy()
        return {k: getattr(self, k).detach().float().cpu().numpy()[alive]
                for k in _FIELDS}


def to_tensor(x, device) -> torch.Tensor:
    """A float numpy array as a float32 tensor on ``device``; a bf16 one
    (numpy's ``bfloat16`` extension dtype, as JAX hands it over) as a bf16
    tensor of the same values."""
    x = np.asarray(x)
    t = torch.as_tensor(np.array(x, np.float32), device=device)
    return t.to(torch.bfloat16) if x.dtype.name == "bfloat16" else t


def init_from_points(points: np.ndarray, colors: np.ndarray, *,
                     sh_degree: int = 3, capacity: int | None = None,
                     init_opacity: float = 0.1,
                     device="cuda") -> GaussianParams:
    """Splats from a sparse point cloud, 3DGS-paper style: isotropic
    log-scale of the mean distance to the 3 nearest neighbours, identity
    rotation, opacity logit of ``init_opacity``, DC SH from RGB."""
    points = np.asarray(points, np.float32)
    colors = np.asarray(colors, np.float32)
    n = points.shape[0]
    try:
        from scipy.spatial import cKDTree
        knn_d, _ = cKDTree(points).query(points, k=4, workers=-1)
        d2_mean = (knn_d[:, 1:4].astype(np.float32) ** 2).mean(axis=1)
    except ImportError:  # chunked O(n^2) search
        d2_mean = np.empty((n,), np.float32)
        chunk = 4096
        for s in range(0, n, chunk):
            e = min(s + chunk, n)
            d2 = (np.sum(points[s:e, None, :] ** 2, -1).astype(np.float32)
                  + np.sum(points[None, :, :] ** 2, -1)
                  - 2.0 * points[s:e] @ points.T)
            np.maximum(d2, 1e-10, out=d2)
            idx = np.argpartition(d2, 3, axis=1)[:, :4]
            vals = np.take_along_axis(d2, idx, axis=1)
            vals.sort(axis=1)
            d2_mean[s:e] = vals[:, 1:4].mean(axis=1)  # skip self (dist 0)
    dist = np.sqrt(np.maximum(d2_mean, 1e-7))
    log_scales = np.repeat(np.log(dist)[:, None], 3, axis=1)
    sh0 = (colors - 0.5) / SH_C0
    opacity = np.full((n,), float(np.log(init_opacity / (1 - init_opacity))),
                      np.float32)
    return GaussianParams.create(points, scales=log_scales, opacity=opacity,
                                 sh0=sh0, sh_degree=sh_degree,
                                 capacity=capacity, device=device)
