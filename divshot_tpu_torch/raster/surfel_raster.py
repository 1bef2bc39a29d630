"""Exact-2DGS (surfel) compositing (counterpart of
``divshot_tpu/raster/pallas_surfel.py``).

The instance table is feature-major, ``(roundup8(15 + nch), I)``, rows
``[T(9) zplane(3) center2d(2) opacity ch0..ch{nch-1} 0-pad]`` in
depth-sorted order, with the linear opacity (not its log, unlike the 3DGS
table); ``tile_start (T+1,)`` gives each tile's instance range. Per
(pixel (x, y), instance):

    hu = x T[6:9] - T[0:3],  hv = y T[6:9] - T[3:6],  p = hu x hv,
    (u, v) = (p0, p1) / p2,  rho = min(u^2 + v^2, 2 |pix - center2d|^2),
    z = zplane . (u, v, 1),  alpha = min(op exp(-rho / 2), 0.999),

valid iff ``|p2| > 1e-9``, ``op exp(-rho/2) >= 1/255`` and ``z > 0.01``;
a pixel stops at the first instance with ``T (1 - alpha) < t_eps``, which
is not applied (the 3DGS rule).

``surfel_forward`` is the wrapper of the CUDA kernel ``csrc/
surfel_forward.cu`` -> ``(T, 8, px)``: the channels in rows 0..nch-1, the
composited intersection depth z in row 5 and z^2 in row 6 (weights
detached: the distortion loss's gradient flows into z, not into the
weights), the final transmittance in row 7. ``surfel_backward`` wraps
``csrc/surfel_backward.cu``, its VJP -> ``(20 + nch, I)`` rows
``dT(9) dzp(3) dc2d(2) dop dch.. ds_x ds_y |ds_x| |ds_y| npix``, where
``ds`` is the gradient of a virtual screen shift of the splat (the 2DGS
counterpart of the 3DGS means2d gradient), summed signed and, per pixel,
as magnitudes (AbsGS). On a CPU tensor each wrapper runs its plain
PyTorch version (``surfel_forward_plain``, ``surfel_backward_plain``); on
a CUDA tensor it launches the kernel or raises. The forward kernel culls
long tiles in a pass of its own and walks only their surviving pairs, as
the 3DGS forward does (``raster/raster.py``, ``raster/units.py``):
``raster.kernel_mask`` gives that pass's survivor mask on the card.

``RasterSurfel`` is the autograd Function around binning, the table and
the two kernels; ``render_surfels`` the exact-2DGS render.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from divshot_tpu_torch import _build
from divshot_tpu_torch.raster import units
from divshot_tpu_torch.raster.bin import expand_sorted, segment_rows_sorted
from divshot_tpu_torch.raster.project import Projection
from divshot_tpu_torch.raster.raster import (_grid, _image_to_tiles,
                                             _pack_live, _survived,
                                             _tiles_to_image,
                                             forward_workspace)
from divshot_tpu_torch.raster.surfel import (ALPHA_MAX, ALPHA_MIN,
                                             FILTER_INV_SQ, T_EPS, Z_MIN,
                                             project_surfels)
from divshot_tpu_torch.splat.math import safe_normalize
from divshot_tpu_torch.splat.sh import eval_sh_color

MAX_CH = 5                # rgb + camera-space (nx, ny)
ROW_ZP = 9                # table rows: T(9) zplane(3) center2d(2) op ch..
ROW_C2D = 12
ROW_OP = 14
ROW_CH = 15
ROW_Z = 5                 # (T, 8, px) rows: ch0..4 z z2 T
ROW_Z2 = 6
ROW_T = 7

# elements per (tile, pixel, instance) array of one plain-version chunk
_CHUNK_ELEMS = 1 << 22

# the float32 values the kernels compare against
_F32 = {k: float(np.float32(v)) for k, v in (
    ("alpha_min", ALPHA_MIN), ("alpha_max", ALPHA_MAX), ("z_min", Z_MIN),
    ("pz_min", 1e-9))}


class SurfelPairCounts(NamedTuple):
    """(pixel, instance) pairs of a surfel forward pass, by how far each
    gets."""
    evaluated: int   # each pixel's instances up to its stop
    shaded: int      # past the p2 and alpha culls: its depth z computed
    passed: int      # past the z cull too (the applied ones and the stop)
    applied: int     # composited: weight, channels, z and z^2 accumulated
    live: int        # applied with alpha not clamped


def feat_rows(nch: int) -> int:
    """Rows of the instance table: 15 + nch, padded to a multiple of 8."""
    return (15 + nch + 7) // 8 * 8


def ngrad_rows(nch: int) -> int:
    """Rows of the backward's output: dT dzp dc2d dop dch.. ds |ds| npix."""
    return 20 + nch


def build_surfel_table(Tmat, zplane, center2d, opacities, colors,
                       inst_gauss) -> torch.Tensor:
    """(feat_rows(nch), I) f32 table in sorted instance order;
    ``inst_gauss`` is the owner per instance. An instance without an owner
    (negative, or the expansion's out-of-range marker) gets opacity 0."""
    n = opacities.shape[0]
    nch = colors.shape[1]
    if not 1 <= nch <= MAX_CH:
        raise ValueError(f"nch must be in 1..{MAX_CH}")
    featT = torch.cat([Tmat.reshape(n, 9).T, zplane.T, center2d.T,
                       opacities[None, :], colors.T,
                       colors.new_zeros((feat_rows(nch) - 15 - nch, n))], 0)
    dead = (inst_gauss < 0) | (inst_gauss >= n)
    tab = featT[:, torch.clamp(inst_gauss, 0, max(n - 1, 0)).long()]
    tab[ROW_OP] = torch.where(dead, torch.zeros((), device=tab.device),
                              tab[ROW_OP])
    return tab


def _check_inputs(table, tile_start, width, height, tile_size, nch):
    """Shared input checks of the two wrappers -> (tiles_x, num_tiles,
    px)."""
    tiles_x, tiles_y = _grid(width, height, tile_size)
    num_tiles = tiles_x * tiles_y
    px = tile_size * tile_size
    if not 1 <= nch <= MAX_CH:
        raise ValueError(f"nch must be in 1..{MAX_CH}")
    if px > 1024 or px % 32:
        raise ValueError("tile_size**2 must be a multiple of 32 and at "
                         "most 1024 (threads per block)")
    _build.require(table, "table", torch.float32)
    if table.dim() != 2 or table.shape[0] < ROW_CH + nch:
        raise ValueError(f"table: shape {tuple(table.shape)}, expected "
                         f"({ROW_CH + nch}+, I)")
    _build.require(tile_start, "tile_start", torch.int32, (num_tiles + 1,),
                   table.device)
    return tiles_x, num_tiles, px


def surfel_forward(table: torch.Tensor, tile_start: torch.Tensor, *,
                   width: int, height: int, tile_size: int = 16,
                   nch: int = 5, t_eps: float = T_EPS) -> torch.Tensor:
    """-> (T, 8, tile_size**2) per-tile rows (module docstring).
    ``tile_start`` must hold non-decreasing offsets within [0, I]. The
    kernel's workspace (``raster.forward_workspace``) holds under half the
    table's bytes."""
    if table.device.type == "cpu":
        return surfel_forward_plain(table, tile_start, width=width,
                                    height=height, tile_size=tile_size,
                                    nch=nch, t_eps=t_eps)
    tiles_x, num_tiles, px = _check_inputs(table, tile_start, width, height,
                                           tile_size, nch)
    out = torch.empty((num_tiles, 8, px), dtype=torch.float32,
                      device=table.device)
    work = forward_workspace(table, px)
    err = _build.library().divshot_surfel_forward(
        table.data_ptr(), table.shape[1], tile_start.data_ptr(), num_tiles,
        tiles_x, tile_size, nch, float(np.float32(t_eps)), out.data_ptr(),
        None if work is None else work.data_ptr(),
        _build.stream_ptr(table.device))
    _build.check_launch("surfel_forward", err)
    return out


def cull_passes(table: torch.Tensor, tiles_x: int, tile_size: int):
    """The plain culls of one tile's pairs, for
    ``units.forward_cull_plain``: ``(tile, start, end) -> (px, end -
    start)`` bool, the pairs that pass all three."""
    def passes(t: int, start: int, end: int) -> torch.Tensor:
        dev = table.device
        terms = _chunk_terms(table, torch.tensor([t], device=dev),
                             torch.tensor([start], device=dev),
                             torch.tensor([end - start], device=dev), 0,
                             end - start, 1, tiles_x, tile_size)
        return terms["ok"][0]
    return passes


def surfel_forward_two_pass_plain(table: torch.Tensor,
                                  tile_start: torch.Tensor, *, width: int,
                                  height: int, tile_size: int = 16,
                                  nch: int = 5, t_eps: float = T_EPS,
                                  unit: int = units.FWD_UNIT):
    """The kernel's two passes in plain PyTorch: the cull pass at ``unit``,
    then the walk from its mask."""
    tiles_x, _ = _grid(width, height, tile_size)
    cull = units.forward_cull_plain(
        tile_start, table.shape[1], cull_passes(table, tiles_x, tile_size),
        tile_size * tile_size, unit)
    return surfel_forward_plain(table, tile_start, width=width,
                                height=height, tile_size=tile_size, nch=nch,
                                t_eps=t_eps, survivors=cull, unit=unit)


def surfel_backward(table: torch.Tensor, tile_start: torch.Tensor,
                    cot: torch.Tensor, fwd: torch.Tensor, *, width: int,
                    height: int, tile_size: int = 16, nch: int = 5,
                    t_eps: float = T_EPS) -> torch.Tensor:
    """VJP of ``surfel_forward`` -> (20 + nch, I) per-instance rows.
    ``cot`` (T, 8, px) holds the channel cotangents in rows 0..nch-1, those
    of z and z^2 in rows 5 and 6 and ``g_T = g_alpha - g_rgb . bg`` in row
    7; ``fwd`` is the forward's output on the same table. ``npix`` counts
    the pixels whose alpha gradient an instance received. The kernel
    walks each tile in units of at most ``units.UNIT`` instances, one
    block each (``raster/units.py``). It leaves the columns at or past
    ``tile_start[-1]`` unwritten (the plain version zeroes them)."""
    if table.device.type == "cpu":
        return surfel_backward_plain(table, tile_start, cot, fwd,
                                     width=width, height=height,
                                     tile_size=tile_size, nch=nch,
                                     t_eps=t_eps)
    tiles_x, num_tiles, px = _check_inputs(table, tile_start, width, height,
                                           tile_size, nch)
    for name, t in (("cot", cot), ("fwd", fwd)):
        _build.require(t, name, torch.float32, (num_tiles, 8, px),
                       table.device)
    grads = torch.empty((ngrad_rows(nch), table.shape[1]),
                        dtype=torch.float32, device=table.device)
    err = _build.library().divshot_surfel_backward(
        table.data_ptr(), table.shape[1], tile_start.data_ptr(), num_tiles,
        tiles_x, tile_size, nch, float(np.float32(t_eps)), cot.data_ptr(),
        fwd.data_ptr(), grads.data_ptr(), _build.stream_ptr(table.device))
    _build.check_launch("surfel_backward", err)
    return grads


# --------------------------------------------------------------------------
# plain versions


def _chunk_terms(table, tile, s0, n_t, k0: int, chunk: int, nch: int,
                 tiles_x: int, tile_size: int) -> dict:
    """The kernels' per-(pixel, instance) terms for instance positions
    k0..k0+chunk of each active tile, in the kernels' float32 order ->
    dict of ``kk`` (C,), ``valid`` (A, C), table rows ``f`` (15+nch, A, C),
    and (A, px, C) arrays: x, y, hu and hv (3 each), p2, u, v, dx, dy,
    sel (the 3-D branch of rho), z, G, a = op G, ok (the pair passes the
    culls) and alpha."""
    dev = table.device
    px = tile_size * tile_size
    last = max(table.shape[1] - 1, 0)
    pix = torch.arange(px, device=dev)
    kk = k0 + torch.arange(chunk, device=dev)
    valid = kk < n_t[:, None]
    f = table[:ROW_CH + nch, torch.clamp_max(s0[:, None] + kk, last)]
    fp = f[:, :, None, :]                                       # (R, A, 1, C)
    x = ((tile % tiles_x)[:, None] * tile_size
         + pix % tile_size).float()[:, :, None] + 0.5           # (A, px, 1)
    y = ((tile // tiles_x)[:, None] * tile_size
         + pix // tile_size).float()[:, :, None] + 0.5
    hu = [x * fp[6 + i] - fp[i] for i in range(3)]
    hv = [y * fp[6 + i] - fp[3 + i] for i in range(3)]
    p0 = hu[1] * hv[2] - hu[2] * hv[1]
    p1 = hu[2] * hv[0] - hu[0] * hv[2]
    p2 = hu[0] * hv[1] - hu[1] * hv[0]
    u = p0 / p2
    v = p1 / p2
    rho3d = u * u + v * v
    dx = x - fp[ROW_C2D]
    dy = y - fp[ROW_C2D + 1]
    rho2d = FILTER_INV_SQ * (dx * dx + dy * dy)
    sel = rho3d <= rho2d
    rho = torch.where(sel, rho3d, rho2d)
    z = (fp[ROW_ZP] * u + fp[ROW_ZP + 1] * v) + fp[ROW_ZP + 2]
    G = torch.exp(-0.5 * rho)
    a = fp[ROW_OP] * G
    # written so that a NaN fails every compare, as in the kernels
    ok = ((torch.abs(p2) > _F32["pz_min"]) & (a >= _F32["alpha_min"])
          & (z > _F32["z_min"]))
    alpha = torch.clamp_max(a, _F32["alpha_max"])
    return dict(kk=kk, valid=valid, f=f, x=x, y=y, hu=hu, hv=hv, p2=p2,
                u=u, v=v, dx=dx, dy=dy, sel=sel, z=z, G=G, a=a, ok=ok,
                alpha=alpha)


def _chunk_size(n_act: int, px: int, n_t, k0: int, budget: int) -> int:
    return max(1, min(256, budget // (n_act * px), int((n_t - k0).max())))


def surfel_forward_plain(table: torch.Tensor, tile_start: torch.Tensor, *,
                         width: int, height: int, tile_size: int = 16,
                         nch: int = 5, t_eps: float = T_EPS,
                         count_pairs: bool = False,
                         survivors: units.FwdCull | None = None,
                         unit: int = units.FWD_UNIT):
    """Plain PyTorch version of the surfel forward kernel, with the
    kernel's float32 operations in the kernel's order, so both take the
    same cull and stop decisions. The tiles still compositing advance
    together one chunk of instance positions at a time: the culls run on
    the whole chunk at once, then each pixel walks only its valid
    instances in order. With ``survivors`` (a cull pass's result at
    ``unit``, ``units.forward_cull_plain``) each tile it culled takes its
    culls from the mask, as the kernel's second pass does. With
    ``count_pairs`` it returns ``(out, SurfelPairCounts, reach)``: the (pixel, instance) pairs of each class
    and per tile the number of its instances that must be read."""
    dev = table.device
    tiles_x, tiles_y = _grid(width, height, tile_size)
    num_tiles = tiles_x * tiles_y
    px = tile_size * tile_size
    t_eps = float(np.float32(t_eps))
    out = torch.zeros((num_tiles, 8, px), device=dev)
    out[:, ROW_T] = 1.0

    tile = torch.arange(num_tiles, device=dev)
    s0 = tile_start[:-1].long()
    n_t = tile_start[1:].long() - s0
    trans = torch.ones((num_tiles, px), device=dev)
    acc = torch.zeros((nch + 2, num_tiles, px), device=dev)   # ch.. z z2
    done = torch.zeros((num_tiles, px), dtype=torch.bool, device=dev)
    counts = torch.zeros((5,), dtype=torch.int64, device=dev)
    reach = torch.zeros((num_tiles,), dtype=torch.int64, device=dev)
    rows = list(range(nch)) + [ROW_Z, ROW_Z2]

    def flush(sel):
        for i, r in enumerate(rows):
            out[tile[sel], r] = acc[i, sel]
        out[tile[sel], ROW_T] = trans[sel]

    k0 = 0
    while True:
        keep = (n_t > k0) & ~done.all(1)
        if not bool(keep.all()):
            flush(~keep)
            tile, s0, n_t = tile[keep], s0[keep], n_t[keep]
            trans, acc, done = trans[keep], acc[:, keep], done[keep]
        n_act = tile.numel()
        if not n_act:
            break
        chunk = _chunk_size(n_act, px, n_t, k0, _CHUNK_ELEMS)
        t = _chunk_terms(table, tile, s0, n_t, k0, chunk, nch, tiles_x,
                         tile_size)
        was_done = done
        ok = _survived(t["ok"], survivors, tile, s0, n_t, t["kk"], unit)
        live = t["valid"][:, None, :] & ok & ~done[:, :, None]
        n_live, n_pack, p_alpha, p_pos = _pack_live(live, t["alpha"])
        stop_pos = torch.full((n_act, px), -1, dtype=torch.long, device=dev)
        chans = t["f"][ROW_CH:ROW_CH + nch]                     # (nch, A, C)
        unclamped = t["a"] < _F32["alpha_max"]
        for j in range(n_pack):
            a = p_alpha[..., j]
            q = trans * (1.0 - a)
            on = (n_live > j) & ~done
            stop = on & (q < t_eps)
            apply = on & ~stop
            w = a * trans
            pos = p_pos[..., j:j + 1]
            ch = torch.gather(chans, 2, pos[..., 0].expand(nch, -1, -1))
            zj = torch.gather(t["z"], 2, pos)[..., 0]
            wz = w * zj
            new = torch.cat([acc[:nch] + w * ch, (acc[nch] + wz)[None],
                             (acc[nch + 1] + wz * zj)[None]], 0)
            acc = torch.where(apply, new, acc)
            trans = torch.where(apply, q, trans)
            stop_pos = torch.where(stop, p_pos[..., j], stop_pos)
            if count_pairs:
                live_j = apply & torch.gather(unclamped, 2, pos)[..., 0]
                counts[2:] += torch.stack([on.sum(), apply.sum(),
                                           live_j.sum()])
            done = done | stop
        if count_pairs:
            n_valid = t["valid"].sum(1)[:, None]
            evaluated = torch.where(stop_pos >= 0, stop_pos + 1, n_valid)
            evaluated = torch.where(was_done, 0, evaluated)
            counts[0] += evaluated.sum()
            shaded = ((torch.abs(t["p2"]) > _F32["pz_min"])
                      & (t["a"] >= _F32["alpha_min"])
                      & (torch.arange(chunk, device=dev)
                         < evaluated[:, :, None]))
            counts[1] += shaded.sum()
            reach[tile] = k0 + evaluated.max(1).values
        k0 += chunk
    if count_pairs:
        return out, SurfelPairCounts(*(int(c) for c in counts)), reach
    return out


def surfel_backward_plain(table: torch.Tensor, tile_start: torch.Tensor,
                          cot: torch.Tensor, fwd: torch.Tensor, *,
                          width: int, height: int, tile_size: int = 16,
                          nch: int = 5, t_eps: float = T_EPS,
                          abs_sums: bool = False):
    """Plain PyTorch version of the surfel backward kernel. The forward is
    recomputed as ``surfel_forward_plain`` does it (the same float32
    operations, so the same cull, clamp and stop decisions); each pixel's
    walk records, per applied instance, its transmittance before it and
    the running sum of ``w cdot``; the gradient terms of the whole chunk
    are then evaluated at once and summed over the pixels. With
    ``abs_sums`` it returns ``(grads, sums)``: ``sums`` holds, per row and
    column, the sum of the magnitudes of the per-pixel terms, the scale of
    the rounding error of that entry's sum."""
    dev = table.device
    tiles_x, tiles_y = _grid(width, height, tile_size)
    num_tiles = tiles_x * tiles_y
    px = tile_size * tile_size
    t_eps = float(np.float32(t_eps))
    grads = torch.zeros((ngrad_rows(nch), table.shape[1]), device=dev)
    sums = torch.zeros_like(grads) if abs_sums else None

    tile = torch.arange(num_tiles, device=dev)
    s0 = tile_start[:-1].long()
    n_t = tile_start[1:].long() - s0
    g = cot[:, :nch].permute(1, 0, 2)                          # (nch, T, px)
    gz = cot[:, ROW_Z:ROW_Z2 + 1].permute(1, 0, 2)             # (2, T, px)
    # the rear sum runs over the weight-coupled channels only (z detached)
    cf = (g * fwd[:, :nch].permute(1, 0, 2)).sum(0)            # (T, px)
    gt_tfin = cot[:, ROW_T] * fwd[:, ROW_T]
    trans = torch.ones((num_tiles, px), device=dev)
    c_dot = torch.zeros((num_tiles, px), device=dev)
    done = torch.zeros((num_tiles, px), dtype=torch.bool, device=dev)
    k0 = 0
    while True:
        keep = (n_t > k0) & ~done.all(1)
        if not bool(keep.all()):
            tile, s0, n_t = tile[keep], s0[keep], n_t[keep]
            g, gz, cf, gt_tfin = g[:, keep], gz[:, keep], cf[keep], \
                gt_tfin[keep]
            trans, c_dot, done = trans[keep], c_dot[keep], done[keep]
        n_act = tile.numel()
        if not n_act:
            break
        chunk = _chunk_size(n_act, px, n_t, k0, _CHUNK_ELEMS // 8)
        t = _chunk_terms(table, tile, s0, n_t, k0, chunk, nch, tiles_x,
                         tile_size)
        live = t["valid"][:, None, :] & t["ok"] & ~done[:, :, None]
        n_live, n_pack, p_alpha, p_pos = _pack_live(live, t["alpha"])
        chans = t["f"][ROW_CH:ROW_CH + nch]
        cdot = torch.einsum("cap,cak->apk", g, chans)           # (A, px, C)
        rec_t, rec_cd, rec_pos = [], [], []
        for j in range(n_pack):
            a = p_alpha[..., j]
            q = trans * (1.0 - a)
            on = (n_live > j) & ~done
            stop = on & (q < t_eps)
            apply = on & ~stop
            w = a * trans
            cd = torch.gather(cdot, 2, p_pos[..., j:j + 1])[..., 0]
            c_dot = torch.where(apply, c_dot + w * cd, c_dot)
            rec_t.append(trans)
            rec_cd.append(c_dot)
            rec_pos.append(torch.where(apply, p_pos[..., j], chunk))
            trans = torch.where(apply, q, trans)
            done = done | stop
        if n_pack:
            pos = torch.stack(rec_pos, -1)

            def scatter(vals, fill):
                return fill.new_zeros((n_act, px, chunk + 1)).scatter_(
                    -1, pos, vals)[..., :chunk]

            t_ex = scatter(torch.stack(rec_t, -1), trans)
            cd_in = scatter(torch.stack(rec_cd, -1), trans)
            app = scatter(torch.ones_like(pos, dtype=torch.bool),
                          live)
            ok = t["valid"]
            cols = (s0[:, None] + t["kk"])[ok]
            terms = _backward_terms(t, g, gz, cf, gt_tfin, cdot, t_ex,
                                    cd_in, app, nch)
            grads[:, cols] = torch.stack([x.sum(1) for x in terms])[:, ok]
            if abs_sums:
                sums[:, cols] = torch.stack(
                    [x.abs().sum(1) for x in terms])[:, ok]
        k0 += chunk
    return (grads, sums) if abs_sums else grads


def _backward_terms(t: dict, g, gz, cf, gt_tfin, cdot, t_ex, cd_in, app,
                    nch: int) -> list[torch.Tensor]:
    """The 20 + nch per-pixel terms (A, px, C) of one chunk, which the
    gradient rows sum over the pixels. Every term is computed for the whole
    chunk and then selected with ``where`` on the applied pairs, so a NaN
    or an infinity in a pair that was not applied adds an exact zero."""
    zero = torch.zeros((), device=t_ex.device)
    alpha, u, v, p2 = t["alpha"], t["u"], t["v"], t["p2"]
    hu, hv, f, sel = t["hu"], t["hv"], t["f"], t["sel"]
    live = app & (t["a"] < _F32["alpha_max"])
    w = alpha * t_ex
    rear = cf[:, :, None] - cd_in
    d_alpha = torch.where(
        live, cdot * t_ex + (gt_tfin[:, :, None] - rear) / (1.0 - alpha),
        zero)
    g_rho = -0.5 * d_alpha * alpha
    d_z = w * (gz[0][:, :, None] + 2.0 * t["z"] * gz[1][:, :, None])
    zp = [f[ROW_ZP + i][:, None, :] for i in range(3)]
    d_u = torch.where(sel, 2.0 * u * g_rho, zero) + zp[0] * d_z
    d_v = torch.where(sel, 2.0 * v * g_rho, zero) + zp[1] * d_z
    g2d = torch.where(sel, zero, g_rho)
    d_dx = 2.0 * FILTER_INV_SQ * t["dx"] * g2d
    d_dy = 2.0 * FILTER_INV_SQ * t["dy"] * g2d
    g_p0 = d_u / p2
    g_p1 = d_v / p2
    g_p2 = -(u * d_u + v * d_v) / p2
    d_hu = [hv[1] * g_p2 - hv[2] * g_p1, hv[2] * g_p0 - hv[0] * g_p2,
            hv[0] * g_p1 - hv[1] * g_p0]
    d_hv = [g_p1 * hu[2] - g_p2 * hu[1], g_p2 * hu[0] - g_p0 * hu[2],
            g_p0 * hu[1] - g_p1 * hu[0]]
    T2 = [f[6 + i][:, None, :] for i in range(3)]
    ds_x = -((T2[0] * d_hu[0] + T2[1] * d_hu[1] + T2[2] * d_hu[2]) + d_dx)
    ds_y = -((T2[0] * d_hv[0] + T2[1] * d_hv[1] + T2[2] * d_hv[2]) + d_dy)
    x, y = t["x"], t["y"]
    terms = ([-d for d in d_hu] + [-d for d in d_hv]
             + [x * d_hu[i] + y * d_hv[i] for i in range(3)]
             + [u * d_z, v * d_z, d_z, -d_dx, -d_dy, d_alpha * t["G"]]
             + [w * g[k][:, :, None] for k in range(nch)]
             + [ds_x, ds_y, ds_x.abs(), ds_y.abs(), live.float()])
    return [torch.where(app, term, zero) for term in terms]


# --------------------------------------------------------------------------
# the differentiable render


def split_surfel_tiles(out: torch.Tensor, background: torch.Tensor,
                       width: int, height: int, tile_size: int, nch: int):
    """(T, 8, px) forward rows -> (rgb (H, W, 3) over ``background``,
    transmittance (H, W), extra (H, W, nch - 1) ``[z, z2, ch3..]``)."""
    tiles_x, tiles_y = _grid(width, height, tile_size)

    def image(r0, r1):
        return _tiles_to_image(out[:, r0:r1], tiles_x, tiles_y, tile_size,
                               width, height)

    t_px = image(ROW_T, ROW_T + 1)[..., 0]
    rgb = image(0, 3) + t_px[..., None] * background[None, None, :]
    return rgb, t_px, torch.cat([image(ROW_Z, ROW_Z2 + 1), image(3, nch)],
                                -1)


def surfel_cotangent(g_rgb, g_alpha, g_extra, background, nch: int,
                     tile_size: int = 16) -> torch.Tensor:
    """The cotangent tiles (T, 8, px) the backward kernel takes, from the
    gradients of ``RasterSurfel``'s outputs: rgb (H, W, 3), alpha (H, W)
    and extra (H, W, nch - 1) ``[z, z2, ch3..]``."""
    h, w = g_alpha.shape
    # dL/dT enters through the background composite (+g_rgb . bg) and
    # alpha = 1 - T (-g_alpha); the kernel takes the folded sign
    g_t = g_alpha - torch.einsum("hwc,c->hw", g_rgb, background)
    cot_img = torch.cat([g_rgb, g_extra[..., 2:], g_rgb.new_zeros(
        (h, w, MAX_CH - nch)), g_extra[..., 0:2], g_t[..., None]], -1)
    tiles_x, tiles_y = _grid(w, h, tile_size)
    return _image_to_tiles(cot_img, tiles_x, tiles_y, tile_size).contiguous()


class SurfelArgs(NamedTuple):
    """The static arguments of ``RasterSurfel``."""
    width: int
    height: int
    tile_size: int
    instance_capacity: int
    mt: int
    t_eps: float


class RasterSurfel(torch.autograd.Function):
    """Binning + surfel compositing with the analytic VJP (counterpart of
    ``pallas_surfel._make_surfel_raster``). Inputs ``Tmat (N, 3, 3)``,
    ``zplane (N, 3)``, ``center2d (N, 2)``, ``opacities (N,)``, ``colors
    (N, nch)`` (nch <= 5, rgb first), ``background (3,)`` and the zero
    sinks ``absgrad_sink (N, 2)``, ``means2d_sink (N, 2)`` and ``npix_sink
    (N,)``, whose gradients are the per-pixel |ds| sums (AbsGS), the signed
    screen-shift gradients and the per-splat pixel counts; ``depths`` and
    ``radii`` fix the binning and get no gradient.
    -> (rgb (H, W, 3), alpha (H, W), extra (H, W, 2 + nch - 3)
    ``[z, z2, ch3..]``, num_instances, max_tile_count)."""

    @staticmethod
    def forward(ctx, Tmat, zplane, center2d, opacities, colors, background,
                absgrad_sink, means2d_sink, npix_sink, depths, radii,
                cfg: SurfelArgs):
        del absgrad_sink, means2d_sink, npix_sink
        nch = colors.shape[1]
        bins = expand_sorted(
            center2d, None, depths, radii, None, None, None, None,
            width=cfg.width, height=cfg.height, tile_size=cfg.tile_size,
            instance_capacity=cfg.instance_capacity, mt=cfg.mt,
            build_table=False)
        table = build_surfel_table(Tmat, zplane, center2d, opacities,
                                   colors, bins.s_owner)
        out = surfel_forward(table, bins.tile_start, width=cfg.width,
                             height=cfg.height, tile_size=cfg.tile_size,
                             nch=nch, t_eps=cfg.t_eps)
        rgb, t_px, extra = split_surfel_tiles(out, background, cfg.width,
                                              cfg.height, cfg.tile_size, nch)
        ctx.cfg, ctx.bins, ctx.nch, ctx.n = cfg, bins, nch, Tmat.shape[0]
        ctx.save_for_backward(table, out, background, t_px)
        n_inst = bins.num_instances
        max_tc = bins.tile_counts.max()
        ctx.mark_non_differentiable(n_inst, max_tc)
        return rgb, 1.0 - t_px, extra, n_inst, max_tc

    @staticmethod
    def backward(ctx, g_rgb, g_alpha, g_extra, _g_ni, _g_mtc):
        table, out, background, t_px = ctx.saved_tensors
        cfg, bins, nch, n = ctx.cfg, ctx.bins, ctx.nch, ctx.n
        h, w = cfg.height, cfg.width
        if g_rgb is None:
            g_rgb = out.new_zeros((h, w, 3))
        if g_alpha is None:
            g_alpha = out.new_zeros((h, w))
        if g_extra is None:
            g_extra = out.new_zeros((h, w, nch - 1))
        cot = surfel_cotangent(g_rgb, g_alpha, g_extra, background, nch,
                               cfg.tile_size)
        grads = surfel_backward(table, bins.tile_start, cot, out, width=w,
                                height=h, tile_size=cfg.tile_size, nch=nch,
                                t_eps=cfg.t_eps)
        seg = segment_rows_sorted(grads, bins, range(ngrad_rows(nch)))
        rds = ROW_CH + nch
        d_bg = torch.einsum("hwc,hw->c", g_rgb, t_px)
        return (seg[0:9].T.reshape(n, 3, 3), seg[ROW_ZP:ROW_ZP + 3].T,
                seg[ROW_C2D:ROW_C2D + 2].T, seg[ROW_OP],
                seg[ROW_CH:ROW_CH + nch].T, d_bg,
                seg[rds + 2:rds + 4].T,          # absgrad_sink <- |ds|
                seg[rds:rds + 2].T,              # means2d_sink <- signed ds
                seg[rds + 4],                    # npix_sink <- pixel count
                None, None, None)


def bin_radii(radii: torch.Tensor, opacities: torch.Tensor) -> torch.Tensor:
    """The radii the binning takes: 0 for a splat whose opacity is below
    1/255 (a dead one's is 0), since the alpha cull rejects each of its
    pairs (a = op G <= op), so it needs no instance. JAX's surfel binning
    expands such splats and culls their pairs in the kernel; the dead
    capacity padding, all at the origin, would fill a few tiles that every
    pixel walks. The projection keeps its radii: visibility and the
    densification statistics read them, as in JAX."""
    return torch.where(opacities >= _F32["alpha_min"], radii,
                       torch.zeros((), device=radii.device))


def surfel_inputs(params, camera, *, sh_degree: int | None = None,
                  override_colors: torch.Tensor | None = None,
                  with_geometry: bool = True):
    """-> (``project_surfels``' dict, colours (N, 3), or (N, 5) with the
    camera-space normal's (nx, ny) when ``with_geometry``, opacities (N,)):
    what the binning and compositing of one frame consume."""
    if sh_degree is None:
        sh_degree = params.sh_degree
    proj = project_surfels(params.means, params.scales, params.quats,
                           camera)
    if override_colors is not None:
        colors = override_colors
    else:
        dirs = safe_normalize(params.means - camera.campos[None, :])
        colors = eval_sh_color(params.sh0, params.shN, dirs, sh_degree)
    if with_geometry:
        colors = torch.cat([colors, proj["normal_cam"][:, :2]], 1)
    return proj, colors, params.effective_opacity()


def render_surfels(params, camera, *, sh_degree: int | None = None,
                   background: torch.Tensor | None = None,
                   tile_size: int = 16,
                   instance_capacity: int | None = None,
                   instance_capacity_mult: float = 8.0,
                   max_tiles_per_gaussian: int = 64, t_eps: float = T_EPS,
                   absgrad_sink: torch.Tensor | None = None,
                   means2d_sink: torch.Tensor | None = None,
                   npix_sink: torch.Tensor | None = None,
                   override_colors: torch.Tensor | None = None,
                   with_geometry: bool = True):
    """Exact-2DGS differentiable render through the surfel kernels
    (counterpart of ``pallas_surfel.render_surfels_pallas``) ->
    ``RenderOutput`` whose ``extra`` is (H, W, 4) ``[z, z^2, nx, ny]``
    with ``with_geometry`` (composited, premultiplied by the weights;
    camera-space normals), else None. The sinks' gradients (see
    ``RasterSurfel``) come straight from the backward kernel's rows, so
    the JAX twin's second return value, the forward pixel counts, has no
    counterpart: ``npix_sink``'s gradient is that count."""
    from divshot_tpu_torch.raster.render import RenderOutput

    dev = params.device
    cap = params.capacity
    if background is None:
        background = torch.zeros((3,), device=dev)
    proj, colors, opac = surfel_inputs(
        params, camera, sh_degree=sh_degree, override_colors=override_colors,
        with_geometry=with_geometry)
    if instance_capacity is None:
        instance_capacity = max(1 << 16, int(instance_capacity_mult * cap))
    sinks = [torch.zeros(s, device=dev) if x is None else x for x, s in (
        (absgrad_sink, (cap, 2)), (means2d_sink, (cap, 2)),
        (npix_sink, (cap,)))]
    cfg = SurfelArgs(camera.width, camera.height, tile_size,
                     instance_capacity, min(max_tiles_per_gaussian, 256),
                     t_eps)
    rgb, alpha, extra, n_inst, max_tc = RasterSurfel.apply(
        proj["Tmat"], proj["zplane"], proj["center2d"], opac, colors,
        background, *sinks,
        proj["depths"].detach(), bin_radii(proj["radii"], opac).detach(),
        cfg)
    zeros = torch.zeros((cap, 3), device=dev)
    proj_out = Projection(
        means2d=proj["center2d"], conics=zeros, depths=proj["depths"],
        radii=proj["radii"], comp=torch.ones((cap,), device=dev),
        cov2d=zeros)
    return RenderOutput(rgb, alpha, proj_out, proj["center2d"], sinks[0],
                        extra if with_geometry else None, n_inst, max_tc)
