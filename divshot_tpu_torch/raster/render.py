"""Top-level render: params + camera -> image (counterpart of
``divshot_tpu/raster/render.py``).

``render`` is the differentiable render, projection and SH colour in
PyTorch autograd, then one of JAX's routes, by ``backend`` and
``binning``:

- ``"pallas"`` / ``"pallas"``, the training path and the port's default
  (JAX's is ``"tiles"``): one ``torch.autograd.Function``
  (``RasterBinned``, the counterpart of
  ``pallas_raster._make_raster_binned``) whose forward runs the expand
  kernel, the sort, the feature gather and the forward kernel, and whose
  backward runs the backward kernel and the per-gaussian reduce;
- ``"pallas"`` / ``"xla"``: ``tiles.bin_gaussians`` (torch ops), then
  the forward and backward kernels over its bins
  (``raster.rasterize_pallas``);
- ``"tiles"`` (and any other name, as in JAX): ``tiles.bin_gaussians``
  with its id matrix, then ``tiles.composite_tiles``, torch ops with the
  hand-written backward;
- ``"dense"``: ``dense.composite_dense``, O(N * pixels), under autograd;
- ``"surfel_pallas"``: exact-2DGS surfels through the surfel kernels
  (``surfel_raster.render_surfels``); ``"surfel"``: through the XLA
  compositor's counterpart (``surfel.render_surfels``).

On a card the kernel routes launch their kernels; the other routes are
PyTorch ops on the card, as they are XLA code in JAX.

``render_fast`` is the inference-only viewer path: the forward kernel
with no autograd, after the expand kernel's binning (``binning="pallas"``)
or ``tiles.bin_gaussians`` (``"xla"``). The returned ``FastBins`` (table
and tile ranges) can be passed back while the scene and camera are
static, so a repeat frame runs only the compositing kernel.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from divshot_tpu_torch.raster import raster as _raster
from divshot_tpu_torch.raster import tiles as _tiles
from divshot_tpu_torch.raster.bin import expand_sorted, reduce_grads_sorted
from divshot_tpu_torch.raster.dense import composite_dense
from divshot_tpu_torch.raster.project import Projection, project_gaussians
from divshot_tpu_torch.raster.raster import (rasterize_pallas, split_tiles,
                                             tile_cotangent)
from divshot_tpu_torch.raster.surfel import \
    render_surfels as render_surfels_xla
from divshot_tpu_torch.raster.surfel_raster import render_surfels
from divshot_tpu_torch.splat.camera import Camera
from divshot_tpu_torch.splat.gaussians import GaussianParams
from divshot_tpu_torch.splat.math import safe_normalize
from divshot_tpu_torch.splat.sh import eval_sh_color


class RenderOutput(NamedTuple):
    image: torch.Tensor          # (H, W, 3)
    alpha: torch.Tensor          # (H, W)
    proj: Projection
    means2d: torch.Tensor        # the projected means the compositor read
    absgrad_sink: torch.Tensor   # (N, 2); its gradient is the AbsGS sum
    extra: torch.Tensor | None = None          # (H, W, E) extra planes
    num_instances: torch.Tensor | None = None  # () int32 demand before cap
    max_tile_count: torch.Tensor | None = None  # () int32


class RasterArgs(NamedTuple):
    """The static arguments of ``RasterBinned``."""
    width: int
    height: int
    tile_size: int
    instance_capacity: int
    mt: int
    t_eps: float
    with_absgrad: bool


class RasterBinned(torch.autograd.Function):
    """Binning + compositing with the analytic VJP. Inputs ``means2d (N,
    2)``, ``conics (N, 3)``, ``colors (N, nch)`` (nch <= 7, rgb first),
    ``opacities (N,)``, ``background (3,)`` and the zero sinks
    ``absgrad_sink (N, 2)`` / ``npix_sink (N,)``, whose gradients are the
    AbsGS sums and the per-splat pixel counts; ``depths``, ``radii``,
    ``radii_xy`` and ``rad2`` fix the binning and get no gradient.
    -> (image (H, W, nch), alpha (H, W), num_instances, max_tile_count)."""

    @staticmethod
    def forward(ctx, means2d, conics, colors, opacities, background,
                absgrad_sink, npix_sink, depths, radii, radii_xy, rad2,
                cfg: RasterArgs):
        del absgrad_sink, npix_sink
        nch = colors.shape[1]
        bins = expand_sorted(
            means2d, conics, depths, radii, radii_xy, rad2, colors,
            opacities, width=cfg.width, height=cfg.height,
            tile_size=cfg.tile_size,
            instance_capacity=cfg.instance_capacity, mt=cfg.mt)
        out = _raster.rasterize_forward(
            bins.table, bins.tile_start, width=cfg.width, height=cfg.height,
            tile_size=cfg.tile_size, nch=nch, t_eps=cfg.t_eps)
        img, t_px = split_tiles(out, background, cfg.width, cfg.height,
                                cfg.tile_size, nch)
        ctx.cfg, ctx.bins, ctx.nch = cfg, bins, nch
        ctx.save_for_backward(out, background, t_px)
        n_inst = bins.num_instances
        max_tc = bins.tile_counts.max()
        ctx.mark_non_differentiable(n_inst, max_tc)
        return img, 1.0 - t_px, n_inst, max_tc

    @staticmethod
    def backward(ctx, g_img, g_alpha, _g_ni, _g_mtc):
        out, background, t_px = ctx.saved_tensors
        cfg, bins, nch = ctx.cfg, ctx.bins, ctx.nch
        if g_img is None:
            g_img = out.new_zeros((cfg.height, cfg.width, nch))
        cot = tile_cotangent(g_img, g_alpha, background, cfg.width,
                             cfg.height, cfg.tile_size, nch)
        grads = _raster.rasterize_backward(
            bins.table, bins.tile_start, cot, out, width=cfg.width,
            height=cfg.height, tile_size=cfg.tile_size, nch=nch,
            t_eps=cfg.t_eps, with_absgrad=cfg.with_absgrad)
        g = reduce_grads_sorted(grads, bins, nch=nch)
        d_bg = torch.einsum("hwc,hw->c", g_img[..., :3], t_px)
        return (g["means2d"], g["conics"], g["colors"], g["opacity"], d_bg,
                g["absgrad"], g["npix"], None, None, None, None, None)


def rasterize_binned(means2d, conics, colors, opacities, proj: Projection,
                     *, width: int, height: int, tile_size: int = 16,
                     instance_capacity: int = 1 << 20,
                     max_tiles_per_gaussian: int = 64, background=None,
                     absgrad_sink=None, npix_sink=None, t_eps: float = 1e-4,
                     with_absgrad: bool = True):
    """Differentiable raster with its binning (counterpart of
    ``pallas_raster.rasterize_pallas_binned``) -> (image (H, W, nch), alpha
    (H, W), num_instances, max_tile_count). ``proj`` supplies the binning
    geometry (depths, radii, and optionally radii_xy and rad2, without
    which the tile rectangles are squares of the radius and the corner
    cull is off), which gets no gradient."""
    dev = means2d.device
    n = means2d.shape[0]
    if background is None:
        background = torch.zeros((3,), device=dev)
    if absgrad_sink is None:
        absgrad_sink = torch.zeros((n, 2), device=dev)
    if npix_sink is None:
        npix_sink = torch.zeros((n,), device=dev)
    cfg = RasterArgs(width, height, tile_size, instance_capacity,
                       min(max_tiles_per_gaussian, 256), t_eps,
                       bool(with_absgrad))
    geom = [None if x is None else x.detach() for x in (
        proj.depths, proj.radii, proj.radii_xy, proj.rad2)]
    return RasterBinned.apply(
        means2d, conics, colors, opacities, background, absgrad_sink,
        npix_sink, *geom, cfg)


def render(
    params: GaussianParams,
    camera: Camera,
    *,
    sh_degree: int | None = None,
    background: torch.Tensor | None = None,
    backend: str = "pallas",
    binning: str = "pallas",
    tile_size: int = 16,
    tile_capacity: int = 1024,
    instance_capacity: int | None = None,
    instance_capacity_mult: float = 8.0,
    max_tiles_per_gaussian: int = 64,
    chunk: int = 32,
    eps2d: float = 0.3,
    antialiased: bool = False,
    radius_clip: float = 0.0,
    t_eps: float = 1e-4,
    absgrad_sink: torch.Tensor | None = None,
    means2d_sink: torch.Tensor | None = None,
    npix_sink: torch.Tensor | None = None,
    override_colors: torch.Tensor | None = None,
    extra_colors: torch.Tensor | None = None,
    cull_sh_radius: float = 0.0,
    with_absgrad: bool = True,
) -> RenderOutput:
    """Differentiable render on the route ``backend`` / ``binning`` names
    (the module docstring lists them). ``tile_capacity`` (the id
    matrix's columns: the instances past it in a tile are dropped, as in
    JAX) and ``chunk`` belong to the ``"tiles"`` and ``"surfel"`` routes;
    the kernel routes ignore them, as JAX's Pallas routes do.

    ``absgrad_sink`` / ``means2d_sink`` are zero (N, 2) inputs whose
    gradients harvest the AbsGS absolute and the signed screen-space
    gradients per gaussian, ``npix_sink`` (N,) the pixels each splat was
    applied to (the kernel routes). ``override_colors`` (N, 3) replaces
    the SH colour, so that any per-splat quantity (a depth, a normal) is
    composited with the same weights; its gradient flows back to it as to
    the SH colour. ``extra_colors`` (N, E <= 4) adds planes composited in
    the same pass, returned as ``extra`` (the ``"pallas"`` backend
    only)."""
    if backend == "surfel":
        out, _npix = render_surfels_xla(
            params, camera, sh_degree=sh_degree, background=background,
            tile_size=tile_size, tile_capacity=tile_capacity,
            instance_capacity=instance_capacity,
            instance_capacity_mult=instance_capacity_mult,
            max_tiles_per_gaussian=max_tiles_per_gaussian, chunk=chunk,
            t_eps=t_eps, absgrad_sink=absgrad_sink,
            means2d_sink=means2d_sink, npix_sink=npix_sink,
            override_colors=override_colors, with_geometry=False)
        return out
    if backend == "surfel_pallas":
        return render_surfels(
            params, camera, sh_degree=sh_degree, background=background,
            tile_size=tile_size, instance_capacity=instance_capacity,
            instance_capacity_mult=instance_capacity_mult,
            max_tiles_per_gaussian=max_tiles_per_gaussian, t_eps=t_eps,
            absgrad_sink=absgrad_sink, means2d_sink=means2d_sink,
            npix_sink=npix_sink, override_colors=override_colors,
            with_geometry=False)
    if sh_degree is None:
        sh_degree = params.sh_degree
    dev = params.device
    opac_raw = params.effective_opacity()
    proj = project_gaussians(params.means, params.scales, params.quats,
                             camera, eps2d=eps2d, antialiased=antialiased,
                             opacities=opac_raw.detach())
    if radius_clip > 0.0:
        proj = proj._replace(radii=torch.where(
            proj.radii > radius_clip, proj.radii,
            torch.zeros((), device=dev)))
    if override_colors is not None:
        colors = override_colors
    else:
        dirs = safe_normalize(params.means - camera.campos[None, :])
        shN = params.shN
        if cull_sh_radius > 0.0:
            shN = shN * (proj.radii > cull_sh_radius)[:, None, None]
        colors = eval_sh_color(params.sh0, shN, dirs, sh_degree)
    opac = opac_raw * proj.comp
    if background is None:
        background = torch.zeros((3,), device=dev)
    if extra_colors is not None and backend != "pallas":
        raise ValueError("extra_colors requires the pallas backend")

    if backend == "dense":
        # the opacities carry the compensation already
        img, alpha = composite_dense(
            proj._replace(comp=torch.ones_like(proj.comp)), colors, opac,
            camera.width, camera.height, background=background)
        sink = torch.zeros((params.capacity, 2), device=dev) \
            if absgrad_sink is None else absgrad_sink
        return RenderOutput(img, alpha, proj, proj.means2d, sink)

    if instance_capacity is None:
        instance_capacity = max(1 << 16,
                                int(instance_capacity_mult * params.capacity))
    if absgrad_sink is None:
        absgrad_sink = torch.zeros((params.capacity, 2), device=dev)
    means2d = proj.means2d if means2d_sink is None \
        else proj.means2d + means2d_sink
    cols = colors if extra_colors is None \
        else torch.cat([colors, extra_colors], 1)

    if backend == "pallas" and binning == "pallas":
        img, alpha, n_inst, max_tc = rasterize_binned(
            means2d, proj.conics, cols, opac, proj, width=camera.width,
            height=camera.height, tile_size=tile_size,
            instance_capacity=instance_capacity,
            max_tiles_per_gaussian=max_tiles_per_gaussian,
            background=background, absgrad_sink=absgrad_sink,
            npix_sink=npix_sink, t_eps=t_eps, with_absgrad=with_absgrad)
        extra = None
        if extra_colors is not None:
            img, extra = img[..., :3], img[..., 3:]
        return RenderOutput(img, alpha, proj, proj.means2d, absgrad_sink,
                            extra, n_inst, max_tc)

    bins = _tiles.bin_gaussians(
        proj.means2d, proj.depths, proj.radii, camera.width, camera.height,
        tile_size=tile_size, tile_capacity=tile_capacity,
        instance_capacity=instance_capacity,
        max_tiles_per_gaussian=max_tiles_per_gaussian,
        build_ids_mat=backend != "pallas", radii_xy=proj.radii_xy,
        rad2=proj.rad2)
    max_tc = bins.tile_counts.max()
    if backend == "pallas":
        img, alpha = rasterize_pallas(
            means2d, proj.conics, cols, opac, bins, width=camera.width,
            height=camera.height, tile_size=tile_size, background=background,
            absgrad_sink=absgrad_sink, npix_sink=npix_sink, t_eps=t_eps,
            with_absgrad=with_absgrad)
        extra = None
        if extra_colors is not None:
            img, extra = img[..., :3], img[..., 3:]
        return RenderOutput(img, alpha, proj, proj.means2d, absgrad_sink,
                            extra, bins.num_instances, max_tc)
    img, alpha = _tiles.composite_tiles(
        means2d, proj.conics, colors, opac, bins.ids_mat, camera.width,
        camera.height, tile_size=tile_size, chunk=chunk,
        background=background, absgrad_sink=absgrad_sink, t_eps=t_eps)
    return RenderOutput(img, alpha, proj, proj.means2d, absgrad_sink, None,
                        bins.num_instances, max_tc)


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
    binning: str = "pallas",
    params_token: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor, FastBins]:
    """-> (image (H, W, 3), alpha (H, W), FastBins), on the params' device.
    ``instance_capacity`` bounds the per-tile instances; the demand before
    the cap is ``FastBins.num_instances``. ``binning``: ``"pallas"``, the
    expand kernel and its sort, or ``"xla"``, ``tiles.bin_gaussians``
    without the id matrix and the feature gather."""
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
        if binning == "pallas":
            sb = expand_sorted(
                proj.means2d, proj.conics, proj.depths, proj.radii,
                proj.radii_xy, proj.rad2, colors, opac, width=camera.width,
                height=camera.height, tile_size=tile_size,
                instance_capacity=instance_capacity,
                mt=min(max_tiles_per_gaussian, 256))
            table = sb.table
        else:
            sb = _tiles.bin_gaussians(
                proj.means2d, proj.depths, proj.radii, camera.width,
                camera.height, tile_size=tile_size,
                instance_capacity=instance_capacity,
                max_tiles_per_gaussian=max_tiles_per_gaussian,
                build_ids_mat=False, radii_xy=proj.radii_xy, rad2=proj.rad2)
            table = _raster.build_feature_table(
                proj.means2d, proj.conics, colors, opac, sb.inst_gauss)
        bins = FastBins(table=table, tile_start=sb.tile_start,
                        num_instances=sb.num_instances, token=params_token)

    out = _raster.rasterize_forward(
        bins.table, bins.tile_start, width=camera.width,
        height=camera.height, tile_size=tile_size, nch=3, t_eps=t_eps)
    img, t_px = split_tiles(out, background, camera.width, camera.height,
                            tile_size, 3)
    return img, 1.0 - t_px, bins
