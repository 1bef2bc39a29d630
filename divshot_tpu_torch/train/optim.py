"""Per-group Adam for splat parameters (counterpart of
``divshot_tpu/train/optim.py``).

Independent Adam moments per parameter group, exponential position-lr
decay scaled by the scene extent, shN at feature_lr / 20, and the optional
visible-only update (``visible_adam``). Written as functions on tensors, as
in the JAX package, so the densification strategies edit moment buffers
with the same index operations they apply to the parameters. The step
count is a host integer: the schedule never reads the card. A group stored
in bf16 (``pack_level``: ``shN`` and its moments) is updated in float32
and rounded back to the dtype each buffer is stored in.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from divshot_tpu_torch.core.config import OptimConfig
from divshot_tpu_torch.splat.gaussians import GaussianParams

PARAM_FIELDS = ("means", "scales", "quats", "opacity", "sh0", "shN")


@dataclass
class AdamState:
    mu: dict[str, torch.Tensor]
    nu: dict[str, torch.Tensor]
    step: int = 0

    @classmethod
    def init(cls, params: GaussianParams) -> "AdamState":
        return cls(mu={f: torch.zeros_like(getattr(params, f))
                       for f in PARAM_FIELDS},
                   nu={f: torch.zeros_like(getattr(params, f))
                       for f in PARAM_FIELDS}, step=0)


def _f32(x) -> float:
    return float(np.float32(x))


def pos_lr_schedule(cfg: OptimConfig, step: int, scene_extent: float,
                    init: float | None = None,
                    final: float | None = None) -> float:
    """graphdeco get_expon_lr_func: log-lerp init -> final over max_steps,
    times the scene extent, in float32 as the JAX function computes it."""
    f = np.float32
    init = cfg.pos_lr_init if init is None else init
    final = cfg.pos_lr_final if final is None else final
    t = np.clip(f(step) / f(cfg.pos_lr_max_steps), f(0), f(1))
    log_lerp = np.exp(np.log(f(init)) * (f(1) - t) + np.log(f(final)) * t)
    return _f32(log_lerp * f(scene_extent))


def group_lrs(cfg: OptimConfig, step: int, scene_extent: float,
              hypers: dict | None = None) -> dict[str, float]:
    """Per-group learning rates; ``hypers`` (``trainer.hypers_from_config``)
    override the config's values."""
    h = hypers or {}
    feat = _f32(h.get("feature_lr", cfg.feature_lr))
    return {
        "means": pos_lr_schedule(cfg, step, scene_extent,
                                 init=h.get("pos_lr_init"),
                                 final=h.get("pos_lr_final")),
        "scales": _f32(h.get("scaling_lr", cfg.scaling_lr)),
        "quats": _f32(h.get("rotation_lr", cfg.rotation_lr)),
        "opacity": _f32(h.get("opacity_lr", cfg.opacity_lr)),
        "sh0": feat,
        "shN": _f32(np.float32(feat) / np.float32(20.0)),
    }


def adam_update(cfg: OptimConfig, params: GaussianParams,
                grads: dict[str, torch.Tensor], state: AdamState,
                scene_extent: float, visible: torch.Tensor | None = None,
                hypers: dict | None = None
                ) -> tuple[GaussianParams, AdamState]:
    """One Adam step of every group -> (params, state). ``visible`` (C,)
    bool restricts the update and the moments to visible splats when
    ``cfg.visible_adam``."""
    step = state.step + 1
    lrs = group_lrs(cfg, step, scene_extent, hypers)
    b1, b2, eps = _f32(cfg.b1), _f32(cfg.b2), _f32(cfg.eps)
    f = np.float32
    bc1 = _f32(f(1) - f(b1) ** f(step))
    bc2 = _f32(f(1) - f(b2) ** f(step))
    new_p, new_mu, new_nu = {}, {}, {}
    with torch.no_grad():
        for name in PARAM_FIELDS:
            g = grads[name].float()
            p = getattr(params, name)
            mu0, nu0 = state.mu[name].float(), state.nu[name].float()
            mu = mu0 * b1 + _f32(1 - cfg.b1) * g
            nu = nu0 * b2 + _f32(1 - cfg.b2) * g * g
            upd = lrs[name] * (mu / bc1) / (torch.sqrt(nu / bc2) + eps)
            if visible is not None and cfg.visible_adam:
                mask = visible.reshape((-1,) + (1,) * (p.dim() - 1))
                mu = torch.where(mask, mu, mu0)
                nu = torch.where(mask, nu, nu0)
                upd = torch.where(mask, upd, torch.zeros((), device=p.device))
            new_p[name] = (p.float() - upd).to(p.dtype)
            new_mu[name] = mu.to(state.mu[name].dtype)
            new_nu[name] = nu.to(state.nu[name].dtype)
    return (dataclasses.replace(params, **new_p),
            AdamState(mu=new_mu, nu=new_nu, step=step))
