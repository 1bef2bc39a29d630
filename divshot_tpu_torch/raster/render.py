"""The inference-only viewer path (counterpart of
``divshot_tpu/raster/render.py:239-340``).

``render_fast`` runs projection, SH colour, the expand kernel, a sort, the
feature gather and the forward compositing kernel. The returned
``FastBins`` (table and tile ranges) can be passed back while the scene and
camera are static, so a repeat frame runs only the compositing kernel.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from divshot_tpu_torch.raster import raster as _raster
from divshot_tpu_torch.raster.bin import expand_sorted
from divshot_tpu_torch.raster.project import Projection, project_gaussians
from divshot_tpu_torch.splat.camera import Camera
from divshot_tpu_torch.splat.gaussians import GaussianParams
from divshot_tpu_torch.splat.math import safe_normalize
from divshot_tpu_torch.splat.sh import eval_sh_color


class FastBins(NamedTuple):
    """Per-frame state ``render_fast`` can reuse while the camera and splats
    are static. ``token`` is the caller's generation stamp: reusing bins
    under another ``params_token`` raises instead of rendering stale
    geometry."""
    table: torch.Tensor
    tile_start: torch.Tensor
    num_instances: torch.Tensor
    token: int | None = None


def frame_inputs(params: GaussianParams, camera: Camera, *,
                 sh_degree: int | None = None, eps2d: float = 0.3,
                 antialiased: bool = False
                 ) -> tuple[Projection, torch.Tensor, torch.Tensor]:
    """-> (projection, colours (N, 3), compensated opacities (N,)): what
    the binning and compositing of one frame consume."""
    if sh_degree is None:
        sh_degree = params.sh_degree
    opac_raw = params.effective_opacity()
    proj = project_gaussians(params.means, params.scales, params.quats,
                             camera, eps2d=eps2d, antialiased=antialiased,
                             opacities=opac_raw)
    dirs = safe_normalize(params.means - camera.campos[None, :])
    colors = eval_sh_color(params.sh0, params.shN, dirs, sh_degree)
    return proj, colors, opac_raw * proj.comp


def render_fast(
    params: GaussianParams,
    camera: Camera,
    *,
    sh_degree: int | None = None,
    background: torch.Tensor | None = None,
    tile_size: int = 16,
    instance_capacity: int = 1 << 23,
    max_tiles_per_gaussian: int = 64,
    eps2d: float = 0.3,
    antialiased: bool = False,
    bins: FastBins | None = None,
    t_eps: float = 1e-4,
    params_token: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor, FastBins]:
    """-> (image (H, W, 3), alpha (H, W), FastBins), on the params' device.
    ``instance_capacity`` bounds the per-tile instances; the demand before
    the cap is ``FastBins.num_instances``."""
    if bins is not None and bins.token != params_token:
        raise ValueError(
            f"stale FastBins: bins were built under params_token="
            f"{bins.token!r} but the caller now passes {params_token!r}; "
            f"re-bin after updating splat params (pass bins=None)")
    dev = params.device
    if background is None:
        background = torch.zeros((3,), device=dev)

    if bins is None:
        proj, colors, opac = frame_inputs(
            params, camera, sh_degree=sh_degree, eps2d=eps2d,
            antialiased=antialiased)
        sb = expand_sorted(
            proj.means2d, proj.conics, proj.depths, proj.radii,
            proj.radii_xy, proj.rad2, colors, opac, width=camera.width,
            height=camera.height, tile_size=tile_size,
            instance_capacity=instance_capacity,
            mt=min(max_tiles_per_gaussian, 256))
        bins = FastBins(table=sb.table, tile_start=sb.tile_start,
                        num_instances=sb.num_instances, token=params_token)

    out = _raster.rasterize_forward(
        bins.table, bins.tile_start, width=camera.width,
        height=camera.height, tile_size=tile_size, nch=3, t_eps=t_eps)
    tiles_x = -(-camera.width // tile_size)
    tiles_y = -(-camera.height // tile_size)
    img = _raster._tiles_to_image(out[:, 0:3], tiles_x, tiles_y, tile_size,
                                  camera.width, camera.height)
    t_px = _raster._tiles_to_image(out[:, 7:8], tiles_x, tiles_y, tile_size,
                                   camera.width, camera.height)[..., 0]
    img = img + t_px[..., None] * background[None, None, :]
    return img, 1.0 - t_px, bins
