"""Exact-2DGS (surfel) projection (counterpart of
``divshot_tpu/raster/surfel.py:52-132``).

Per splat the (u, v, 1) -> pixel-homogeneous map is the 3x3 matrix

    T = K' . [s_u R r1 | s_v R r2 | R mu + t],  K' = [[fx,0,cx],[0,fy,cy],[0,0,1]]

A pixel (x, y) meets the splat's plane at (u, v) = (p_x, p_y) / p_z with
``p = (x T_row3 - T_row1) x (y T_row3 - T_row2)`` (2DGS paper, eq. 9-10);
the compositing kernels (``raster/surfel_raster.py``) evaluate that per
pixel. ``project_surfels`` gives them their per-splat inputs: ``Tmat``,
the view-depth plane ``zplane`` (z = zplane . (u, v, 1)), the centre, the
dual-conic AABB radius and the camera-facing normal. Plain autograd
tensors, with the JAX function's float32 operations in its order.

``render_surfels`` is the JAX package's XLA route for exact 2DGS
(``render(backend="surfel")``, the JAX trainer's 2DGS route off the TPU):
``tiles.bin_gaussians`` with its id matrix, then the chunked compositor
of ``_make_surfel_compositor`` in PyTorch ops, differentiated by autograd
through ``torch.utils.checkpoint`` a chunk at a time, as JAX
differentiates through ``jax.checkpoint(step)``. The per-pixel
intersection depth is composited as z and z^2 with the weights detached
(``DETACH_DEPTH_W``: the distortion's gradient flows into z, not into the
weights); the per-splat applied-pixel counts are returned without a
gradient. The kernel route keeps its own name,
``surfel_raster.render_surfels``.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from divshot_tpu_torch.splat.camera import Camera
from divshot_tpu_torch.splat.math import (matvec3, quat_rotmat_components,
                                          safe_normalize)
from divshot_tpu_torch.splat.sh import eval_sh_color

ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.999
T_EPS = 1e-4
FILTER_INV_SQ = 2.0        # 2DGS low-pass: rho2d = 2 |d|^2
Z_MIN = 0.01               # per-pixel intersection depth cull
DETACH_DEPTH_W = True      # distortion gradients flow to z, not to weights

_ZERO3 = (0.0, 0.0, 0.0)


def _sum3(a, b, c):
    return (a + b) + c


def project_surfels(means: torch.Tensor, log_scales: torch.Tensor,
                    quats: torch.Tensor, camera: Camera, *,
                    near: float = 0.01, far: float = 1e10
                    ) -> dict[str, torch.Tensor]:
    """-> dict of per-splat ``Tmat`` (N, 3, 3), ``zplane`` (N, 3),
    ``center2d`` (N, 2), ``depths`` (N,) centre view z, ``radii`` (N,)
    (0 = culled) and ``normal_cam`` (N, 3), the unit normal in camera space
    flipped toward the camera. Only the first two scale axes are used."""
    R = camera.rotation
    r = quat_rotmat_components(quats)          # row-major rotation entries
    su = torch.exp(log_scales[:, 0])
    sv = torch.exp(log_scales[:, 1])
    # view-space tangent frame and centre
    tu = matvec3(R, torch.stack([r[0], r[3], r[6]], -1), _ZERO3) \
        * su[:, None]
    tv = matvec3(R, torch.stack([r[1], r[4], r[7]], -1), _ZERO3) \
        * sv[:, None]
    cv = matvec3(R, means, camera.translation)

    fx, fy, cx, cy = camera.fx, camera.fy, camera.cx, camera.cy

    def kp(p):  # K' . p for view-space p: (N, 3) -> (N, 3)
        return torch.stack([fx * p[:, 0] + cx * p[:, 2],
                            fy * p[:, 1] + cy * p[:, 2], p[:, 2]], 1)

    Tmat = torch.stack([kp(tu), kp(tv), kp(cv)], 2)       # columns u, v, 1
    zplane = torch.stack([tu[:, 2], tv[:, 2], cv[:, 2]], 1)

    # dual-conic AABB (2DGS computeAABB): M* = T diag(1, 1, -1) T^T
    T0, T1, T2 = Tmat[:, 0, :], Tmat[:, 1, :], Tmat[:, 2, :]
    w = (1.0, 1.0, -1.0)

    def wsum(a, b, f=w):
        return _sum3(*(a[:, k] * b[:, k] * f[k] for k in range(3)))

    dist = wsum(T2, T2)
    dist_ok = torch.abs(dist) > 1e-7
    dist_safe = torch.where(dist_ok, dist, torch.ones_like(dist))
    f = [wk / dist_safe for wk in w]
    cx2 = _sum3(*(f[k] * T0[:, k] * T2[:, k] for k in range(3)))
    cy2 = _sum3(*(f[k] * T1[:, k] * T2[:, k] for k in range(3)))
    ex = cx2 * cx2 - _sum3(*(f[k] * T0[:, k] * T0[:, k] for k in range(3)))
    ey = cy2 * cy2 - _sum3(*(f[k] * T1[:, k] * T1[:, k] for k in range(3)))
    ext = torch.clamp_min(torch.maximum(ex, ey), 0.0)
    # the low-pass disc reaches ~2.4 px (alpha cutoff at rho2d = 11)
    radius = torch.ceil(torch.clamp_min(3.0 * torch.sqrt(ext), 2.5))

    z = cv[:, 2]
    W, H = camera.width, camera.height
    inside = ((cx2 + radius > 0) & (cx2 - radius < W)
              & (cy2 + radius > 0) & (cy2 - radius < H))
    valid = (z > near) & (z < far) & dist_ok & (ext > 0) & inside
    radii = torch.where(valid, radius, torch.zeros((), device=z.device))

    # camera-facing normal (third rotation column), camera space
    n_cam = matvec3(R, torch.stack([r[2], r[5], r[8]], -1), _ZERO3)
    flip = torch.sign(-(n_cam * cv).sum(1, keepdim=True))
    flip = torch.where(flip == 0, torch.ones_like(flip), flip)
    return {"Tmat": Tmat, "zplane": zplane,
            "center2d": torch.stack([cx2, cy2], 1), "depths": z,
            "radii": radii, "normal_cam": n_cam * flip}


def _surfel_alpha(Trows, zpl, c2d, shift, op, ids, pix):
    """alpha and the intersection depth z of each (tile, slot, pixel):
    ``Trows`` (T, CH, 9), ``zpl`` (T, CH, 3), ``c2d`` and ``shift`` (T, CH,
    2), ``op`` and ``ids`` (T, CH), ``pix`` (T, px, 2) -> (T, CH, px)
    each, 0 where the pair is invalid."""
    x = pix[:, None, :, 0] - shift[:, :, None, 0]            # (T, CH, px)
    y = pix[:, None, :, 1] - shift[:, :, None, 1]
    T0, T1, T2 = (Trows[:, :, None, k:k + 3] for k in (0, 3, 6))
    # h_u = x T2 - T0, h_v = y T2 - T1, p = h_u x h_v (per pixel)
    hu = x[..., None] * T2 - T0
    hv = y[..., None] * T2 - T1
    p0 = hu[..., 1] * hv[..., 2] - hu[..., 2] * hv[..., 1]
    p1 = hu[..., 2] * hv[..., 0] - hu[..., 0] * hv[..., 2]
    pz = hu[..., 0] * hv[..., 1] - hu[..., 1] * hv[..., 0]
    pz_ok = torch.abs(pz) > 1e-9
    pz_safe = torch.where(pz_ok, pz, 1.0)
    u = p0 / pz_safe
    v = p1 / pz_safe
    rho3d = u * u + v * v
    dx = x - c2d[:, :, None, 0]
    dy = y - c2d[:, :, None, 1]
    rho = torch.minimum(rho3d, FILTER_INV_SQ * (dx * dx + dy * dy))
    z_px = (zpl[:, :, None, 0] * u + zpl[:, :, None, 1] * v
            + zpl[:, :, None, 2])
    alpha = op[..., None] * torch.exp(-0.5 * rho)
    valid = (ids[..., None] >= 0) & pz_ok & (alpha >= ALPHA_MIN) \
        & (z_px > Z_MIN)
    return (torch.where(valid, torch.clamp_max(alpha, ALPHA_MAX), 0.0),
            torch.where(valid, z_px, 0.0))


def _composite_step(carry, ids, Tflat, zplane, center2d, shift, colors,
                    opacities, pix, t_eps: float):
    """One chunk of the surfel compositor: the carry (accum (T, px, C),
    zacc (T, px, 2), T (T, px), done (T, px) bool) -> the next one, and the
    chunk's per-slot applied-pixel counts (T, CH)."""
    accum, zacc, trans, done = carry
    safe = torch.clamp_min(ids, 0).long()
    alpha, z_px = _surfel_alpha(Tflat[safe], zplane[safe], center2d[safe],
                                shift[safe], opacities[safe], ids, pix)
    q = trans[:, None, :] * torch.cumprod(1.0 - alpha, 1)
    applied = (q >= t_eps) & ~done[:, None, :]
    a_eff = torch.where(applied, alpha, 0.0)
    om_eff = 1.0 - a_eff
    t_excl = trans[:, None, :] * torch.cat(
        [torch.ones_like(om_eff[:, :1]), torch.cumprod(om_eff, 1)[:, :-1]], 1)
    w = a_eff * t_excl                                       # (T, CH, px)
    accum = accum + torch.einsum("tcp,tcd->tpd", w, colors[safe])
    wz = w.detach() if DETACH_DEPTH_W else w
    zacc = zacc + torch.stack([(wz * z_px).sum(1),
                               (wz * z_px * z_px).sum(1)], -1)
    trans = trans * torch.prod(om_eff, 1)
    done = done | (q < t_eps).any(1)
    cnt = (applied & (alpha > 0)).sum(2, dtype=torch.float32).detach()
    return accum, zacc, trans, done, cnt


def _surfel_composite(Tmat, zplane, center2d, shift, colors, opacities,
                      background, ids_mat, width: int, height: int,
                      tile_size: int, chunk: int, t_eps: float):
    """The XLA surfel compositor's forward (``_make_surfel_compositor``):
    -> (image (H, W, 3 + C - 3 + 2) ``[rgb, const.., z, z^2]``, alpha (H,
    W), per-splat applied-pixel counts (N,), no gradient). The columns past
    the densest tile's count hold no instance and are not walked
    (``tiles.walked_chunks``)."""
    from divshot_tpu_torch.raster.tiles import (_pixel_coords,
                                                tiles_to_image,
                                                walked_chunks)
    dev = Tmat.device
    n = Tmat.shape[0]
    pix = torch.as_tensor(_pixel_coords(width, height, tile_size),
                          device=dev)
    nt, px = pix.shape[0], pix.shape[1]
    Tflat = Tmat.reshape(-1, 9)
    carry = (torch.zeros((nt, px, colors.shape[1]), device=dev),
             torch.zeros((nt, px, 2), device=dev),
             torch.ones((nt, px), device=dev),
             torch.zeros((nt, px), dtype=torch.bool, device=dev))
    npix = torch.zeros((n + 1,), device=dev)
    recording = torch.is_grad_enabled() and any(
        x.requires_grad for x in (Tmat, zplane, center2d, shift, colors,
                                  opacities))
    for lo, hi in walked_chunks(ids_mat, chunk):
        ids = ids_mat[:, lo:hi]
        args = (ids, Tflat, zplane, center2d, shift, colors, opacities, pix,
                t_eps)
        if recording:
            *carry, cnt = checkpoint(_composite_step, carry, *args,
                                     use_reentrant=False)
        else:
            *carry, cnt = _composite_step(carry, *args)
        npix.index_add_(0, torch.where(ids >= 0, ids, n).reshape(-1).long(),
                        cnt.reshape(-1))
    accum, zacc, trans, _ = carry
    rgb = accum[..., :3] + trans[..., None] * background[None, None, :]
    tile_img = torch.cat([rgb, accum[..., 3:], zacc], -1)
    img = tiles_to_image(tile_img, width, height, tile_size)
    alpha = tiles_to_image(1.0 - trans[..., None], width, height,
                           tile_size)[..., 0]
    return img, alpha, npix[:-1]


def render_surfels(params, camera: Camera, *, sh_degree: int | None = None,
                   background: torch.Tensor | None = None,
                   tile_size: int = 16, tile_capacity: int = 1024,
                   instance_capacity: int | None = None,
                   instance_capacity_mult: float = 8.0,
                   max_tiles_per_gaussian: int = 64, chunk: int = 32,
                   t_eps: float = T_EPS,
                   absgrad_sink: torch.Tensor | None = None,
                   means2d_sink: torch.Tensor | None = None,
                   npix_sink: torch.Tensor | None = None,
                   override_colors: torch.Tensor | None = None,
                   with_geometry: bool = True, **_ignored):
    """Exact-2DGS differentiable render on the XLA route -> (``RenderOutput``
    whose ``extra`` is (H, W, 4) ``[z, z^2, nx, ny]`` with
    ``with_geometry`` (premultiplied by the compositing weights;
    camera-space normals), per-splat applied-pixel counts (N,) plus
    ``npix_sink``, without gradient). The two sinks ride one virtual
    screen shift of each splat, so both get the signed dL/dshift (JAX's
    AbsGS for surfels is that signed sum's magnitude, documented weaker);
    a caller that wants ``npix_sink``'s gradient to be the counts adds
    ``sum(npix_sink * counts)`` to its loss, as JAX's trainer does."""
    from divshot_tpu_torch.raster import tiles as _tiles
    from divshot_tpu_torch.raster.project import Projection
    from divshot_tpu_torch.raster.render import RenderOutput

    dev = params.device
    cap = params.capacity
    if sh_degree is None:
        sh_degree = params.sh_degree
    if background is None:
        background = torch.zeros((3,), device=dev)
    proj = project_surfels(params.means, params.scales, params.quats,
                           camera)
    if override_colors is not None:
        colors = override_colors
    else:
        dirs = safe_normalize(params.means - camera.campos[None, :])
        colors = eval_sh_color(params.sh0, params.shN, dirs, sh_degree)
    if with_geometry:
        colors = torch.cat([colors, proj["normal_cam"][:, :2]], 1)
    opac = params.effective_opacity()
    if instance_capacity is None:
        instance_capacity = max(1 << 16, int(instance_capacity_mult * cap))
    bins = _tiles.bin_gaussians(
        proj["center2d"], proj["depths"], proj["radii"], camera.width,
        camera.height, tile_size=tile_size, tile_capacity=tile_capacity,
        instance_capacity=instance_capacity,
        max_tiles_per_gaussian=max_tiles_per_gaussian, build_ids_mat=True)
    zeros2 = torch.zeros((cap, 2), device=dev)
    absgrad_sink = zeros2 if absgrad_sink is None else absgrad_sink
    means2d_sink = zeros2 if means2d_sink is None else means2d_sink
    npix_sink = torch.zeros((cap,), device=dev) if npix_sink is None \
        else npix_sink
    shift = means2d_sink + absgrad_sink
    img, alpha, npix = _surfel_composite(
        proj["Tmat"], proj["zplane"], proj["center2d"], shift, colors, opac,
        background, bins.ids_mat, camera.width, camera.height, tile_size,
        chunk, float(t_eps))
    nco = colors.shape[1]
    extra = None
    if with_geometry:
        # [z, z^2] come last; reorder to [z, z^2, nx, ny]
        extra = torch.cat([img[..., nco:], img[..., 3:nco]], -1)
    zeros3 = torch.zeros((cap, 3), device=dev)
    proj_out = Projection(
        means2d=proj["center2d"], conics=zeros3, depths=proj["depths"],
        radii=proj["radii"], comp=torch.ones((cap,), device=dev),
        cov2d=zeros3)
    out = RenderOutput(img[..., :3], alpha, proj_out, proj["center2d"],
                       absgrad_sink, extra, bins.num_instances,
                       bins.tile_counts.max())
    return out, (npix + npix_sink).detach()
