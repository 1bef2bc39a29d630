"""Tile binning and the tiles compositor (counterpart of
``divshot_tpu/raster/tiles.py``).

``bin_gaussians`` expands every projected gaussian into one instance per
covered 16x16 tile, as JAX's does, field for field: a scatter-free
expansion (one boundary scatter of the gaussians' packed fields, a
running maximum of the segment starts and a hold-last gather), the corner
cull, and one sort of the packed (tile | depth) key. The key is JAX's
(``tile_bits``, ``depth_bits``, ``lo_bits`` as there), not the kernel
route's (``raster/bin.py``), so near depth ties order as in JAX's
``"tiles"``. Its unsigned 32-bit word is sorted as int32 with the top bit
flipped, stably, as ``bin.sort_instances`` sorts. With ``build_ids_mat``
the sorted instances fill a dense ``(num_tiles, tile_capacity)`` id
matrix, front to back (the ``"tiles"`` and XLA surfel routes); without
it the tile ranges are clamped short of the capacity by the guard lanes,
as JAX clamps them for its Pallas kernels (``binning="xla"``).

``composite_tiles`` composites the id matrix chunk by chunk with the
early stop of the CUDA reference (stop before the instance that would
take the transmittance below ``t_eps``); its ``torch.autograd.Function``
backward is JAX's hand-written VJP: the chunks walked back to front,
each one's transmittance rebuilt by division, the per-slot gradients
summed to the gaussians with ``index_add_``. ``_use_autodiff`` runs the
same forward under plain autograd (the tests' oracle, as in JAX). Both
are plain PyTorch on the tensors' device: this route has no kernel in
either package. The columns past the densest tile's count hold no
instance, so neither pass walks them (``walked_chunks``: the last chunk
is cut there).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from divshot_tpu_torch.raster.raster import _image_to_tiles, _tiles_to_image

ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.999
T_EPS = 1e-4
_U32 = 0xFFFFFFFF
_KEY_BIAS = 1 << 31


class TileBins(NamedTuple):
    ids_mat: torch.Tensor | None  # (num_tiles, K) int32 ids, -1 = empty,
    #                               front to back within each row
    num_instances: torch.Tensor   # () int32 demand before the cap
    tile_counts: torch.Tensor     # (num_tiles,) int32 instances per tile
    inst_gauss: torch.Tensor      # (I,) int32 sorted owners (-1 culled)
    tile_start: torch.Tensor      # (num_tiles+1,) int32 ranges per tile
    inst_tile: torch.Tensor       # (I,) int32 sorted tile per instance
    exp2sorted: torch.Tensor      # (I,) int32 expansion slot -> sorted
    g_offsets: torch.Tensor       # (N,) int32 exclusive offsets
    g_counts: torch.Tensor        # (N,) int32 instances per gaussian
    perm: torch.Tensor            # (I,) int64 sorted -> expansion slot (the
    #                               port's: its reduce's input)


def _tile_grid(width: int, height: int, tile_size: int) -> tuple[int, int]:
    return -(-width // tile_size), -(-height // tile_size)


def _tile_coord(x: torch.Tensor, hi: int, fn) -> torch.Tensor:
    """``clip(fn(x), 0, hi)`` cast to int32; NaN -> 0 first, as XLA casts
    it (the CPU's cast of NaN gives INT_MIN)."""
    return torch.clamp(torch.nan_to_num(fn(x), nan=0.0), 0, hi).to(
        torch.int32)


def bin_gaussians(means2d: torch.Tensor, depths: torch.Tensor,
                  radii: torch.Tensor, width: int, height: int, *,
                  tile_size: int = 16, tile_capacity: int = 1024,
                  instance_capacity: int = 1 << 20,
                  max_tiles_per_gaussian: int = 64,
                  build_ids_mat: bool = True, guard_lanes: int = 2048,
                  radii_xy: torch.Tensor | None = None,
                  rad2: torch.Tensor | None = None) -> TileBins:
    """Expand gaussians into depth-sorted per-tile instance lists. The
    inputs get no gradient. ``radii_xy`` (N, 2) gives per-axis rectangle
    half-extents (else squares of ``radii``); ``rad2`` (N,) the squared
    radius of the alpha >= 1/255 ellipse, which turns on the corner cull
    of (instance, tile) pairs."""
    with torch.no_grad():
        return _bin(means2d, depths, radii, width, height, tile_size,
                    tile_capacity, instance_capacity,
                    max_tiles_per_gaussian, build_ids_mat, guard_lanes,
                    radii_xy, rad2)


def _bin(means2d, depths, radii, width, height, tile_size, tile_capacity,
         cap, mt, build_ids_mat, guard_lanes, radii_xy, rad2) -> TileBins:
    dev = means2d.device
    n = means2d.shape[0]
    tw, th = _tile_grid(width, height, tile_size)
    num_tiles = tw * th
    if num_tiles >= 1 << 19:
        raise ValueError("tile grid too large for packed keys")
    i32 = torch.int32

    u, v = means2d[:, 0], means2d[:, 1]
    rx = radii_xy[:, 0] if radii_xy is not None else radii
    ry = radii_xy[:, 1] if radii_xy is not None else radii
    tmin_x = _tile_coord((u - rx) / tile_size, tw, torch.floor)
    tmax_x = _tile_coord((u + rx) / tile_size, tw, torch.ceil)
    tmin_y = _tile_coord((v - ry) / tile_size, th, torch.floor)
    tmax_y = _tile_coord((v + ry) / tile_size, th, torch.ceil)
    nx = tmax_x - tmin_x
    counts = torch.clamp_max(torch.where(radii > 0, nx * (tmax_y - tmin_y),
                                         0), mt).to(i32)
    offsets = torch.cumsum(counts, 0, dtype=i32) - counts
    total = (offsets[-1] + counts[-1] if n
             else torch.zeros((), dtype=i32, device=dev))

    tile_bits = max(1, (num_tiles + 1).bit_length())
    depth_bits = 32 - tile_bits
    lo_bits = max(tile_bits, mt.bit_length())

    # scatter-free expansion: one boundary scatter marks each gaussian's
    # first slot (chA is never 0, so it is the flag), a running maximum
    # gives each slot's segment start, and a gather there holds its fields
    iota = torch.arange(cap, device=dev)
    inf = torch.full((), float("inf"), device=dev)
    dbits = torch.where(depths > 0, depths, inf).contiguous().view(
        i32).long() & _U32
    tmin_lin = (tmin_y * tw + tmin_x).long()
    ch_a = (tmin_lin << 13) | torch.clamp_min(nx, 1).long()
    ch_b = ((dbits >> lo_bits) << lo_bits) | counts.long()
    rows = torch.stack([ch_a, ch_b, torch.arange(1, n + 1, device=dev)], 1)
    keep = (counts > 0) & (offsets < cap)
    M = torch.zeros((cap, 3), dtype=torch.int64, device=dev)
    M[offsets[keep].long()] = rows[keep]
    start = torch.cummax(torch.where(M[:, 0] != 0, iota, 0), 0).values
    j = iota - start                                   # rank in its gaussian
    held = M[start]
    ch_a, ch_b = held[:, 0], held[:, 1]
    owner = held[:, 2] - 1                             # 0 sentinel -> -1
    nx_i = ch_a & 0x1FFF
    cnt_i = ch_b & ((1 << lo_bits) - 1)
    # j < mt <= 256 wherever it matters (real), so integer division is
    # JAX's exact float32 division there
    jy = torch.div(j, torch.clamp_min(nx_i, 1), rounding_mode="floor")
    tile = (ch_a >> 13) + jy * tw + (j - jy * nx_i)
    real = (owner >= 0) & (j < cnt_i)
    if rad2 is not None:
        # corner cull: drop the pairs whose nearest rect point lies outside
        # the alpha >= 1/255 circum-radius (no such pair can reach 1/255)
        gi = torch.stack([u, v, rad2], 1)[torch.clamp(owner, 0,
                                                      max(n - 1, 0))]
        ttx = (tile % tw).float() * tile_size
        tty = (tile // tw).float() * tile_size
        zero = torch.zeros((), device=dev)
        dx = torch.maximum(torch.maximum(ttx - gi[:, 0],
                                         gi[:, 0] - (ttx + tile_size)), zero)
        dy = torch.maximum(torch.maximum(tty - gi[:, 1],
                                         gi[:, 1] - (tty + tile_size)), zero)
        real = real & (dx * dx + dy * dy <= gi[:, 2])
    key = torch.where(real, (tile << depth_bits)
                      | ((ch_b >> lo_bits) << (lo_bits - tile_bits)), _U32)

    # one stable int32 sort of the key word with its top bit flipped
    s_key, perm = torch.sort((key - _KEY_BIAS).to(i32), stable=True)
    s_key = s_key.long() + _KEY_BIAS
    s_gauss = torch.where(real, owner, -1)[perm].to(i32)
    s_tile = torch.clamp_max(s_key >> depth_bits, num_tiles).to(i32)
    exp2sorted = torch.empty_like(perm)
    exp2sorted[perm] = iota
    tile_bounds = torch.searchsorted(
        s_tile, torch.arange(num_tiles + 1, dtype=i32, device=dev)).to(i32)
    if not build_ids_mat:
        # the guard band of JAX's Pallas kernels, kept for the same ranges
        tile_bounds = torch.clamp_max(tile_bounds,
                                      max(cap - guard_lanes, cap // 2))
    tile_start = tile_bounds[:num_tiles]
    tile_counts = tile_bounds[1:] - tile_start

    ids_mat = None
    if build_ids_mat:
        k = tile_capacity
        rank = iota - tile_start[torch.clamp_max(s_tile, num_tiles - 1)
                                 .long()]
        ok = (s_tile < num_tiles) & (rank < k)
        flat = torch.where(ok, s_tile.long() * k + rank, num_tiles * k)
        ids_mat = torch.full((num_tiles * k + 1,), -1, dtype=i32,
                             device=dev)
        ids_mat[flat[ok]] = s_gauss[ok]
        ids_mat = ids_mat[:-1].reshape(num_tiles, k)

    return TileBins(ids_mat=ids_mat, num_instances=total,
                    tile_counts=tile_counts, inst_gauss=s_gauss,
                    tile_start=tile_bounds, inst_tile=s_tile,
                    exp2sorted=exp2sorted.to(i32), g_offsets=offsets,
                    g_counts=counts, perm=perm)


# ---------------------------------------------------------------------------
# compositor with the analytic VJP


def _pixel_coords(width: int, height: int, tile_size: int) -> np.ndarray:
    """(num_tiles, tile_size^2, 2) pixel-centre coordinates per tile."""
    tw, th = _tile_grid(width, height, tile_size)
    ty, tx = np.meshgrid(np.arange(th), np.arange(tw), indexing="ij")
    iy, ix = np.meshgrid(np.arange(tile_size), np.arange(tile_size),
                         indexing="ij")
    x = (tx.reshape(-1, 1) * tile_size + ix.reshape(1, -1)) + 0.5
    y = (ty.reshape(-1, 1) * tile_size + iy.reshape(1, -1)) + 0.5
    return np.stack([x, y], -1).astype(np.float32)


def tiles_to_image(tile_img: torch.Tensor, width: int, height: int,
                   tile_size: int) -> torch.Tensor:
    """(T, px, C) -> (H, W, C)."""
    tw, th = _tile_grid(width, height, tile_size)
    return _tiles_to_image(tile_img.transpose(1, 2), tw, th, tile_size,
                           width, height)


def image_to_tiles(img: torch.Tensor, tile_size: int) -> torch.Tensor:
    """(H, W, C) -> (T, px, C), zero-padded to the tile grid."""
    tw, th = _tile_grid(img.shape[1], img.shape[0], tile_size)
    return _image_to_tiles(img, tw, th, tile_size).transpose(1, 2)


def _chunk_alpha(m2d, con, op, ids, pix):
    """alpha (T, CH, px) of one chunk, 0 where invalid, and dx, dy,
    power."""
    dx = pix[:, None, :, 0] - m2d[:, :, None, 0]          # (T, CH, px)
    dy = pix[:, None, :, 1] - m2d[:, :, None, 1]
    power = (-0.5 * (con[..., 0, None] * dx * dx
                     + con[..., 2, None] * dy * dy)
             - con[..., 1, None] * dx * dy)
    alpha = op[..., None] * torch.exp(power)
    valid = (ids[..., None] >= 0) & (power <= 0) & (alpha >= ALPHA_MIN)
    alpha = torch.where(valid, torch.clamp_max(alpha, ALPHA_MAX), 0.0)
    return alpha, dx, dy, power


def _excl_cumprod(om: torch.Tensor) -> torch.Tensor:
    """Exclusive product down axis 1 of (T, CH, px)."""
    return torch.cat([torch.ones_like(om[:, :1]),
                      torch.cumprod(om, 1)[:, :-1]], 1)


def walked_chunks(ids_mat: torch.Tensor, chunk: int
                  ) -> list[tuple[int, int]]:
    """The (start, end) column ranges of the chunks that hold an instance:
    up to the densest row's count (rows fill from the front), the last
    chunk cut there; the columns past it are empty in every row and
    composite nothing. One read of the device."""
    filled = int((ids_mat >= 0).sum(1).max()) if ids_mat.numel() else 0
    return [(lo, min(lo + chunk, filled)) for lo in range(0, filled, chunk)]


def _forward(means2d, conics, colors, opacities, ids_mat, pix, chunks,
             t_eps):
    """JAX's ``_forward`` over the column ranges ``chunks`` -> (accum (T,
    px, 3), T (T, px), n_contrib)."""
    nt, px = pix.shape[0], pix.shape[1]
    dev = means2d.device
    accum = torch.zeros((nt, px, colors.shape[1]), device=dev)
    trans = torch.ones((nt, px), device=dev)
    done = torch.zeros((nt, px), dtype=torch.bool, device=dev)
    n_contrib = torch.zeros((nt, px), dtype=torch.int32, device=dev)
    for lo, hi in chunks:
        ids = ids_mat[:, lo:hi]
        safe = torch.clamp_min(ids, 0).long()
        alpha, _, _, _ = _chunk_alpha(means2d[safe], conics[safe],
                                      opacities[safe], ids, pix)
        q = trans[:, None, :] * torch.cumprod(1.0 - alpha, 1)
        applied = (q >= t_eps) & ~done[:, None, :]
        a_eff = torch.where(applied, alpha, 0.0)
        om_eff = 1.0 - a_eff
        w = a_eff * (trans[:, None, :] * _excl_cumprod(om_eff))
        accum = accum + torch.einsum("tcp,tcd->tpd", w, colors[safe])
        trans = trans * torch.prod(om_eff, 1)
        done = done | (q < t_eps).any(1)
        n_contrib = n_contrib + applied.sum(1, dtype=torch.int32)
    return accum, trans, n_contrib


class TilesArgs(NamedTuple):
    width: int
    height: int
    tile_size: int
    chunk: int
    t_eps: float


def _split(accum, trans, background, cfg: TilesArgs):
    tile_img = accum + trans[..., None] * background[None, None, :]
    img = tiles_to_image(tile_img, cfg.width, cfg.height, cfg.tile_size)
    alpha = tiles_to_image(1.0 - trans[..., None], cfg.width, cfg.height,
                           cfg.tile_size)[..., 0]
    return img, alpha


class CompositeTiles(torch.autograd.Function):
    """The tiles compositor with JAX's hand-written VJP. Inputs
    ``means2d (N, 2)``, ``conics (N, 3)``, ``colors (N, 3)``,
    ``opacities (N,)``, ``background (3,)``, the zero ``absgrad_sink (N,
    2)`` (its gradient is the AbsGS sum of |d mean2d| per pixel) and
    ``ids_mat`` -> (image (H, W, 3), alpha (H, W))."""

    @staticmethod
    def forward(ctx, means2d, conics, colors, opacities, background,
                absgrad_sink, ids_mat, cfg: TilesArgs):
        del absgrad_sink
        pix = torch.as_tensor(_pixel_coords(cfg.width, cfg.height,
                                            cfg.tile_size),
                              device=means2d.device)
        chunks = walked_chunks(ids_mat, cfg.chunk)
        accum, trans, n_contrib = _forward(
            means2d, conics, colors, opacities, ids_mat, pix, chunks,
            cfg.t_eps)
        ctx.cfg, ctx.chunks = cfg, chunks
        ctx.save_for_backward(means2d, conics, colors, opacities,
                              background, ids_mat, trans, n_contrib, pix)
        return _split(accum, trans, background, cfg)

    @staticmethod
    def backward(ctx, g_img, g_alpha):
        (means2d, conics, colors, opacities, background, ids_mat, t_final,
         n_contrib, pix) = ctx.saved_tensors
        cfg = ctx.cfg
        n = means2d.shape[0]
        dev = means2d.device
        if g_img is None:
            g_img = means2d.new_zeros((cfg.height, cfg.width, 3))
        if g_alpha is None:
            g_alpha = means2d.new_zeros((cfg.height, cfg.width))
        g_img_t = image_to_tiles(g_img, cfg.tile_size)            # (T, px, 3)
        g_alpha_t = image_to_tiles(g_alpha[..., None], cfg.tile_size)[..., 0]
        # dL/dT_final = g_img . bg - g_alpha; dT_final/dalpha_i =
        # -T_final / (1 - a_i)
        g_t = g_alpha_t - torch.einsum("tpd,d->tp", g_img_t, background)
        nt, px = t_final.shape
        # one row past the gaussians takes the empty slots' sums
        d_m = torch.zeros((n + 1, 2), device=dev)
        d_con = torch.zeros((n + 1, 3), device=dev)
        d_col = torch.zeros((n + 1, 3), device=dev)
        d_op = torch.zeros((n + 1,), device=dev)
        d_abs = torch.zeros((n + 1, 2), device=dev)
        t_end = t_final
        rear = torch.zeros((nt, px, 3), device=dev)
        for lo, hi in reversed(ctx.chunks):
            ids = ids_mat[:, lo:hi]
            safe = torch.clamp_min(ids, 0).long()
            con, col = conics[safe], colors[safe]
            alpha, dx, dy, power = _chunk_alpha(means2d[safe], con,
                                                opacities[safe], ids, pix)
            slot = torch.arange(lo, hi, dtype=torch.int32, device=dev)
            applied = slot[None, :, None] < n_contrib[:, None, :]
            a_eff = torch.where(applied, alpha, 0.0)
            om_eff = 1.0 - a_eff
            t_start = torch.clamp_max(
                t_end / torch.clamp_min(torch.prod(om_eff, 1), 1e-12), 1.0)
            t_excl = t_start[:, None, :] * _excl_cumprod(om_eff)
            w = a_eff * t_excl                                   # (T, CH, px)
            wc = w[..., None] * col[:, :, None, :]               # (T, CH, px, 3)
            # rear_i = rear_end + sum_{j > i} w_j c_j
            rear_i = rear[:, None] + (torch.flip(torch.cumsum(
                torch.flip(wc, [1]), 1), [1]) - wc)
            rear = rear + wc.sum(1)
            del wc
            om_c = torch.clamp_min(om_eff, 1e-3)
            inner = col[:, :, None, :] * t_excl[..., None] \
                - rear_i / om_c[..., None]
            del rear_i
            d_alpha = ((g_img_t[:, None] * inner).sum(-1)
                       + g_t[:, None, :] * t_final[:, None, :] / om_c)
            del inner
            live = applied & (alpha > 0) & (alpha < ALPHA_MAX)
            d_alpha = torch.where(live, d_alpha, 0.0)
            d_power = d_alpha * alpha                          # alpha = op G
            d_u = (con[..., 0, None] * dx + con[..., 1, None] * dy) * d_power
            d_v = (con[..., 2, None] * dy + con[..., 1, None] * dx) * d_power
            sids = torch.where(ids >= 0, ids, n).reshape(-1).long()
            d_m.index_add_(0, sids, torch.stack(
                [d_u.sum(-1), d_v.sum(-1)], -1).reshape(-1, 2))
            d_abs.index_add_(0, sids, torch.stack(
                [d_u.abs().sum(-1), d_v.abs().sum(-1)], -1).reshape(-1, 2))
            d_con.index_add_(0, sids, torch.stack(
                [(-0.5 * dx * dx * d_power).sum(-1),
                 (-dx * dy * d_power).sum(-1),
                 (-0.5 * dy * dy * d_power).sum(-1)], -1).reshape(-1, 3))
            d_col.index_add_(0, sids, torch.einsum(
                "tcp,tpd->tcd", w, g_img_t).reshape(-1, 3))
            d_op.index_add_(0, sids,
                            (d_alpha * torch.exp(power)).sum(-1).reshape(-1))
            t_end = t_start
        d_bg = torch.einsum("tpd,tp->d", g_img_t, t_final)
        return (d_m[:n], d_con[:n], d_col[:n], d_op[:n], d_bg, d_abs[:n],
                None, None)


def composite_tiles(means2d: torch.Tensor, conics: torch.Tensor,
                    colors: torch.Tensor, opacities: torch.Tensor,
                    ids_mat: torch.Tensor, width: int, height: int, *,
                    tile_size: int = 16, chunk: int = 32,
                    background: torch.Tensor | None = None,
                    absgrad_sink: torch.Tensor | None = None,
                    t_eps: float = T_EPS, _use_autodiff: bool = False
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Composite binned gaussians -> (image (H, W, 3), alpha (H, W)) on
    the inputs' device. Differentiate with respect to ``absgrad_sink``
    (zeros (N, 2)) to harvest the AbsGS accumulator."""
    dev = means2d.device
    if background is None:
        background = torch.zeros((3,), device=dev)
    if absgrad_sink is None:
        absgrad_sink = torch.zeros((means2d.shape[0], 2), device=dev)
    if ids_mat.shape[1] % chunk:
        raise ValueError("tile_capacity must be divisible by chunk")
    cfg = TilesArgs(width, height, tile_size, chunk, float(t_eps))
    if not _use_autodiff:
        return CompositeTiles.apply(means2d, conics, colors, opacities,
                                    background, absgrad_sink, ids_mat, cfg)
    pix = torch.as_tensor(_pixel_coords(width, height, tile_size),
                          device=dev)
    k = ids_mat.shape[1]
    accum, trans, _ = _forward(means2d, conics, colors, opacities, ids_mat,
                               pix, [(lo, lo + chunk)
                                     for lo in range(0, k, chunk)],
                               cfg.t_eps)
    return _split(accum, trans, background, cfg)
