"""Learnable environment background (counterpart of
``divshot_tpu/models/background.py``): an equirectangular radiance grid
sampled by each pixel's ray direction and composited behind the splats
with the residual transmittance, img = splat_rgb + T env(dir). The trainer
updates it with an Adam of its own (``train/trainer.py``).

Plain tensor functions on the device of their inputs, float32 in JAX's
order of operations. The four-corner gather's backward is a scatter-add:
on a card its atomic adds land in an order that varies from run to run.
"""

from __future__ import annotations

import math

import torch

from divshot_tpu_torch.splat.camera import Camera
from divshot_tpu_torch.splat.math import matvec3


def init_envmap(height: int = 64, width: int = 128,
                init_color=(0.5, 0.5, 0.5), *, device="cuda"
                ) -> torch.Tensor:
    """(H, W, 3) logit-space radiance grid of one colour."""
    c = torch.clamp(torch.tensor(init_color, dtype=torch.float32,
                                 device=device), 1e-3, 1 - 1e-3)
    logit = torch.log(c) - torch.log1p(-c)
    return logit.expand(height, width, 3).clone()


def pixel_ray_dirs(camera: Camera) -> torch.Tensor:
    """(H, W, 3) world-space unit ray directions."""
    dev = camera.device
    xs = (torch.arange(camera.width, dtype=torch.float32, device=dev) + 0.5
          - camera.cx) / camera.fx
    ys = (torch.arange(camera.height, dtype=torch.float32, device=dev)
          + 0.5 - camera.cy) / camera.fy
    gx, gy = torch.meshgrid(xs, ys, indexing="xy")
    d_cam = torch.stack([gx, gy, torch.ones_like(gx)], -1)
    d_world = matvec3(camera.viewmat[:3, :3].T.tolist(), d_cam,
                      (0.0, 0.0, 0.0))
    norm = torch.sqrt((d_world * d_world).sum(-1, keepdim=True))
    return d_world / torch.clamp_min(norm, 1e-8)


def sample_envmap(envmap: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """Bilinear equirect sample -> (..., 3) rgb in [0, 1]. ``u`` wraps
    around the grid's width; ``v`` is clipped to its rows."""
    He, We = envmap.shape[:2]
    theta = torch.arccos(torch.clamp(dirs[..., 1], -1, 1))     # [0, pi]
    phi = torch.atan2(dirs[..., 2], dirs[..., 0])               # [-pi, pi]
    u = (phi / (2 * math.pi) + 0.5) * We - 0.5
    v = theta / math.pi * (He - 1)
    u0 = torch.floor(u).to(torch.int32)
    v0 = torch.clamp(torch.floor(v).to(torch.int32), 0, He - 2)
    au = (u - u0)[..., None]
    av = (v - v0)[..., None]
    u0m = torch.remainder(u0, We).long()
    u1m = torch.remainder(u0 + 1, We).long()
    v0 = v0.long()
    p00 = envmap[v0, u0m]
    p01 = envmap[v0, u1m]
    p10 = envmap[v0 + 1, u0m]
    p11 = envmap[v0 + 1, u1m]
    logit = ((1 - au) * (1 - av) * p00 + (1 - au) * av * p01
             + au * (1 - av) * p10 + au * av * p11)
    return torch.sigmoid(logit)


def render_background(envmap: torch.Tensor, camera: Camera) -> torch.Tensor:
    """(H, W, 3) background image for a camera."""
    return sample_envmap(envmap, pixel_ray_dirs(camera))
