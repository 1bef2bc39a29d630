"""Geometry losses of 2DGS training (counterpart of
``divshot_tpu/train/geometry.py``): the flattened-surfel approximation,
splat normals, normals from a depth map and the normal-consistency loss
(2DGS eq. 13: 1 - n_render . n_depth over confident pixels).
"""

from __future__ import annotations

import dataclasses

import torch

from divshot_tpu_torch.splat.camera import Camera
from divshot_tpu_torch.splat.gaussians import GaussianParams
from divshot_tpu_torch.splat.math import quat_to_rotmat, safe_normalize

FLAT_LOG_SCALE = -9.0   # exp(-9) ~ 1e-4: the surfel's thickness


def _toward_camera(n: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """``n`` flipped so that ``n . d <= 0`` (zero dot: kept)."""
    flip = torch.sign(-d)
    return n * torch.where(flip == 0, torch.ones_like(flip), flip)


def flatten_to_surfels(params: GaussianParams) -> GaussianParams:
    """2DGS by flattened 3D gaussians: the third scale axis clamped to
    (near) zero thickness."""
    s = params.scales
    flat = torch.cat([s[:, :2], torch.full_like(s[:, 2:3], FLAT_LOG_SCALE)],
                     1)
    return dataclasses.replace(params, scales=flat)


def splat_normals(params: GaussianParams, camera: Camera) -> torch.Tensor:
    """(C, 3) world-space unit normals (the rotated z axis), flipped toward
    the camera."""
    n = quat_to_rotmat(params.quats)[..., :, 2]
    view_dir = params.means - camera.campos[None, :]
    return _toward_camera(n, (n * view_dir).sum(-1, keepdim=True))


def normals_from_depth(depth: torch.Tensor, camera: Camera,
                       alpha: torch.Tensor) -> torch.Tensor:
    """(H, W, 3) camera-space normals of the expected-depth map by
    unprojected finite differences, zero where ``alpha <= 0.5``."""
    H, W = depth.shape
    dev = depth.device
    xs = (torch.arange(W, dtype=torch.float32, device=dev) + 0.5
          - camera.cx) / camera.fx
    ys = (torch.arange(H, dtype=torch.float32, device=dev) + 0.5
          - camera.cy) / camera.fy
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    pts = torch.stack([gx * depth, gy * depth, depth], -1)      # (H, W, 3)
    ddx = torch.diff(pts, dim=1, append=pts[:, -1:])
    ddy = torch.diff(pts, dim=0, append=pts[-1:])
    n = safe_normalize(torch.linalg.cross(ddx, ddy, dim=-1))
    # oriented toward the camera (-z in camera space: +z looks forward)
    return _toward_camera(n, n[..., 2:3]) * (alpha[..., None] > 0.5)


def normal_consistency_loss(rendered_normal_cam: torch.Tensor,
                            depth: torch.Tensor, alpha: torch.Tensor,
                            camera: Camera) -> torch.Tensor:
    """1 - n_render . n_depth, averaged over the pixels with alpha > 0.5;
    ``rendered_normal_cam`` (H, W, 3) camera-space, ``depth`` and
    ``alpha`` (H, W)."""
    n_r = safe_normalize(rendered_normal_cam, eps=1e-12)
    n_d = normals_from_depth(depth, camera, alpha)
    w = (alpha > 0.5).float()
    dots = (n_r * n_d).sum(-1)
    return (w * (1.0 - dots)).sum() / torch.clamp_min(w.sum(), 1.0)
