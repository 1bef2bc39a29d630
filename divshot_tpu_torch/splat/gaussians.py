"""Capacity-padded Gaussian splat parameters (counterpart of
``divshot_tpu/splat/gaussians.py:37-135``).

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
        that field as a numpy array, capacity padding included."""
        out = {}
        for f in fields(cls):
            dtype = np.bool_ if f.name == "alive" else np.float32
            out[f.name] = torch.as_tensor(
                np.array(d[f.name], dtype=dtype), device=device)
        return cls(**out)

    def compact_numpy(self) -> dict[str, np.ndarray]:
        """Host-side float32 arrays with dead and padded splats removed."""
        alive = self.alive.cpu().numpy()
        return {k: getattr(self, k).detach().cpu().numpy()[alive]
                for k in _FIELDS}
