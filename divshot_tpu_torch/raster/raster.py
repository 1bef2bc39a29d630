"""Forward tile compositing (counterpart of
``divshot_tpu/raster/pallas_raster.py``).

The instance table is feature-major, ``(6 + nch, I)``, rows
``[u v a b c log_op ch0..]`` in depth-sorted order; ``tile_start (T+1,)``
gives each tile's instance range. ``rasterize_forward`` is the wrapper of
the CUDA forward kernel (``csrc/forward.cu``) and returns ``(T, 8, px)``:
the channels in rows 0..nch-1 and the final transmittance in row 7, all
before the background. ``rasterize_backward`` is the wrapper of the CUDA
backward kernel (``csrc/backward.cu``), the forward's VJP: it returns the
per-instance gradient rows ``(9 + nch, I)``
``[du dv da db dc dop dch.. |du| |dv| npix]``. On a CPU tensor each
wrapper runs its plain PyTorch version (``rasterize_forward_plain``,
``rasterize_backward_plain``); on a CUDA tensor it launches the kernel or
raises. The forward kernel culls the long tiles (``units.is_long``) in a
pass of its own, spread over the card, and then walks only their
surviving pairs (``raster/units.py``); ``kernel_mask`` gives that pass's
survivor mask on the card, ``rasterize_forward_plain(survivors=...)`` the
walk from its plain version.

``segment_rows`` is the wrapper of the CUDA segment reduce
(``csrc/segment.cu``), which every backward route runs after its backward
kernel: it sums a backward's per-instance rows back to per-gaussian sums,
each gaussian's terms in an order the kernel fixes (no float atomics, no
cumsum), so that a training step gives the same bits on every run. It is
two launches: ``segment_stage`` writes the rows instance-major in
expansion order through the sort's permutation, ``segment_reduce`` sums
each gaussian's contiguous run of records; their plain versions are
``segment_stage_plain`` and ``segment_reduce_plain``, and
``segment_rows_plain`` states the same function through the inverse
permutation.

``rasterize_pallas`` is the differentiable raster over bins made by
``tiles.bin_gaussians`` (JAX's ``binning="xla"``; ``RasterPallas``, the
counterpart of ``pallas_raster._make_raster``): its forward gathers the
table and runs the forward kernel, its backward runs the backward kernel
and ``reduce_instance_grads``, the per-gaussian segment sums over the
binning's ``perm``, ``g_offsets`` and ``g_counts``.
"""

from __future__ import annotations

import math
import re
from typing import NamedTuple

import numpy as np
import torch

from divshot_tpu_torch import _build
from divshot_tpu_torch.raster import units

ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.999
T_EPS = 1e-4
LOG_AMIN = math.log(ALPHA_MIN)
LOG_AMAX = math.log(ALPHA_MAX)
LOGOP_FLOOR = -80.0

MAX_CH = 7
ROW_LOGOP = 5
ROW_CH = 6           # first channel row of the table
ROW_T = 7            # transmittance row of the (T, 8, px) output

# elements per (tile, pixel, instance) array of one plain-version chunk
_CHUNK_ELEMS = 1 << 24

# the float32 values the kernel compares against
_LOG_AMIN_F32 = float(np.float32(LOG_AMIN))
_LOG_AMAX_F32 = float(np.float32(LOG_AMAX))


def build_feature_table(means2d, conics, colors, opacities,
                        inst_gauss) -> torch.Tensor:
    """(6 + nch, I) f32 table in sorted instance order; ``inst_gauss`` is
    the owner per instance, -1 for a dead one (which gets LOGOP_FLOOR)."""
    n = means2d.shape[0]
    nch = colors.shape[1]
    if nch > MAX_CH:
        raise ValueError(f"at most {MAX_CH} channels")
    logop = torch.clamp_min(torch.log(torch.clamp_min(opacities, 1e-35)),
                            LOGOP_FLOOR)
    featT = torch.cat([means2d.T, conics.T, logop[None, :], colors.T], 0)
    tab = featT[:, torch.clamp(inst_gauss, 0, max(n - 1, 0)).long()]
    tab[ROW_LOGOP] = torch.where(inst_gauss >= 0, tab[ROW_LOGOP],
                                 torch.full((), LOGOP_FLOOR,
                                            device=tab.device))
    return tab


def _tiles_to_image(rows: torch.Tensor, tiles_x: int, tiles_y: int,
                    tile_size: int, width: int, height: int) -> torch.Tensor:
    """(T, C, px) -> (H, W, C)."""
    c = rows.shape[1]
    img = rows.reshape(tiles_y, tiles_x, c, tile_size, tile_size)
    img = img.permute(0, 3, 1, 4, 2).reshape(
        tiles_y * tile_size, tiles_x * tile_size, c)
    return img[:height, :width]


def _image_to_tiles(img: torch.Tensor, tiles_x: int, tiles_y: int,
                    tile_size: int) -> torch.Tensor:
    """(H, W, C) -> (T, C, px), zero-padding to the tile grid."""
    h, w, c = img.shape
    img = torch.nn.functional.pad(
        img, (0, 0, 0, tiles_x * tile_size - w, 0, tiles_y * tile_size - h))
    img = img.reshape(tiles_y, tile_size, tiles_x, tile_size, c)
    return img.permute(0, 2, 4, 1, 3).reshape(
        tiles_y * tiles_x, c, tile_size * tile_size)


def _grid(width: int, height: int, tile_size: int) -> tuple[int, int]:
    return -(-width // tile_size), -(-height // tile_size)


def _check_kernel_inputs(table, tile_start, width, height, tile_size, nch):
    """Shared input checks of the forward and backward wrappers ->
    (tiles_x, num_tiles, px)."""
    tiles_x, tiles_y = _grid(width, height, tile_size)
    num_tiles = tiles_x * tiles_y
    px = tile_size * tile_size
    if not 1 <= nch <= MAX_CH:
        raise ValueError(f"nch must be in 1..{MAX_CH}")
    if px > 1024:
        raise ValueError("tile_size**2 must be <= 1024 (threads per block)")
    _build.require(table, "table", torch.float32)
    if table.dim() != 2 or table.shape[0] < ROW_CH + nch:
        raise ValueError(f"table: shape {tuple(table.shape)}, expected "
                         f"({ROW_CH + nch}, I)")
    _build.require(tile_start, "tile_start", torch.int32, (num_tiles + 1,),
                   table.device)
    return tiles_x, num_tiles, px


def rasterize_forward(table: torch.Tensor, tile_start: torch.Tensor, *,
                      width: int, height: int, tile_size: int = 16,
                      nch: int = 3, t_eps: float = T_EPS) -> torch.Tensor:
    """-> (T, 8, tile_size**2) per-tile rows. ``tile_start`` must hold
    non-decreasing offsets within [0, I], as ``expand_sorted`` makes them.
    The kernel's workspace (``forward_workspace``) holds at most 34.1
    bytes a column at 16x16 tiles, the table 4 (6 + nch); nothing is read
    back on the host."""
    if table.device.type == "cpu":
        return rasterize_forward_plain(table, tile_start, width=width,
                                       height=height, tile_size=tile_size,
                                       nch=nch, t_eps=t_eps)
    tiles_x, num_tiles, px = _check_kernel_inputs(
        table, tile_start, width, height, tile_size, nch)
    if px % 32:
        raise ValueError("tile_size**2 must be a multiple of 32 (warps)")
    out = torch.empty((num_tiles, 8, px), dtype=torch.float32,
                      device=table.device)
    work = forward_workspace(table, px)
    err = _build.library().divshot_forward(
        table.data_ptr(), table.shape[1], tile_start.data_ptr(), num_tiles,
        tiles_x, tile_size, nch, float(np.float32(t_eps)), out.data_ptr(),
        None if work is None else work.data_ptr(),
        _build.stream_ptr(table.device))
    _build.check_launch("forward", err)
    return out


def forward_workspace(table: torch.Tensor, px: int) -> torch.Tensor | None:
    """A forward kernel's workspace: ``units.work_words`` int32,
    uninitialised, on the table's device and current stream; None when no
    tile can be culled (``units.work_words`` 0). Freed when the call's
    caller drops it, so nothing of it outlives the forward."""
    nwork = units.work_words(table.shape[1], px)
    return (torch.empty((nwork,), dtype=torch.int32, device=table.device)
            if nwork else None)


def kernel_mask(entry: str, table: torch.Tensor, tile_start: torch.Tensor,
                *, width: int, height: int, tile_size: int = 16
                ) -> torch.Tensor:
    """Run the forward kernel ``entry`` (``divshot_forward`` or
    ``divshot_surfel_forward``) at nch 1, not counted as a path launch ->
    the survivor mask its cull pass leaves in the workspace, (words, px)
    int64 word values; only the words of the culled long tiles' segments
    are defined (``units.forward_cull_plain`` is its plain version)."""
    _build.require(table, "table", torch.float32)
    tiles_x, tiles_y = _grid(width, height, tile_size)
    num_tiles, px = tiles_x * tiles_y, tile_size * tile_size
    _build.require(tile_start, "tile_start", torch.int32, (num_tiles + 1,),
                   table.device)
    out = torch.empty((num_tiles, 8, px), dtype=torch.float32,
                      device=table.device)
    work = forward_workspace(table, px)
    err = getattr(_build.library(), entry)(
        table.data_ptr(), table.shape[1], tile_start.data_ptr(), num_tiles,
        tiles_x, tile_size, 1, float(np.float32(T_EPS)), out.data_ptr(),
        None if work is None else work.data_ptr(),
        _build.stream_ptr(table.device))
    if err != 0:
        raise RuntimeError(f"CUDA kernel {entry} failed to launch: "
                           f"cudaError_t {err}")
    if work is None:
        return torch.zeros((0, px), dtype=torch.int64, device=table.device)
    nwords = units.cull_words(table.shape[1])
    return work[:nwords * px].view(nwords, px).long() & 0xFFFFFFFF


def cull_passes(table: torch.Tensor, tiles_x: int, tile_size: int):
    """The plain cull of one tile's pairs, for ``units.forward_cull_plain``:
    ``(tile, start, end) -> (px, end - start)`` bool, s >= log(1/255)."""
    def passes(t: int, start: int, end: int) -> torch.Tensor:
        dev = table.device
        _, _, _, _, _, s, _ = _chunk_terms(
            table, torch.tensor([t], device=dev),
            torch.tensor([start], device=dev),
            torch.tensor([end - start], device=dev), 0, end - start, 1,
            tiles_x, tile_size)
        return s[0] >= _LOG_AMIN_F32
    return passes


def _chunk_terms(table, tile, s0, n_t, k0: int, chunk: int, nch: int,
                 tiles_x: int, tile_size: int):
    """The kernels' per-(pixel, instance) terms for instance positions
    k0..k0+chunk of each active tile, in the kernels' float32 order ->
    (kk (C,), valid (A, C), rows f (6+nch, A, C), dx, dy, s, alpha, each
    (A, px, C))."""
    dev = table.device
    px = tile_size * tile_size
    last = max(table.shape[1] - 1, 0)
    pix = torch.arange(px, device=dev)
    kk = k0 + torch.arange(chunk, device=dev)
    valid = kk < n_t[:, None]                                   # (A, C)
    f = table[:ROW_CH + nch, torch.clamp_max(s0[:, None] + kk, last)]
    fp = f[:, :, None, :]                                       # (R, A, 1, C)
    pxx = ((tile % tiles_x)[:, None] * tile_size
           + pix % tile_size).float()[:, :, None] + 0.5         # (A, px, 1)
    pyy = ((tile // tiles_x)[:, None] * tile_size
           + pix // tile_size).float()[:, :, None] + 0.5
    dx = pxx - fp[0]
    dy = pyy - fp[1]
    quad = (fp[2] * dx * dx + 2.0 * fp[3] * dx * dy) + fp[4] * dy * dy
    s = fp[ROW_LOGOP] - 0.5 * quad                              # (A, px, C)
    alpha = torch.exp(torch.clamp_max(s, _LOG_AMAX_F32))
    return kk, valid, f, dx, dy, s, alpha


def _survived(passed: torch.Tensor, survivors: units.FwdCull | None, tile,
              s0, n_t, kk, unit: int) -> torch.Tensor:
    """The cull of a chunk (A, px, C) of tiles ``tile``: ``passed`` as
    evaluated, or for the tiles the cull pass culled the mask's bits."""
    if survivors is None:
        return passed
    culled = survivors.culled[tile]
    if not bool(culled.any()):
        return passed
    bits = units.survivor_bits(survivors.mask, s0, n_t, s0[:, None] + kk,
                               unit)
    return torch.where(culled[:, None, None], bits, passed)


def _pack_live(live: torch.Tensor, alpha: torch.Tensor):
    """Pack each pixel's live instances to the front, in order ->
    (n_live (A, px), n_pack, alphas and chunk positions (A, px, n_pack+1))."""
    n_act, px, chunk = live.shape
    n_live = live.sum(-1)
    n_pack = int(n_live.max())
    slot = torch.where(live, torch.cumsum(live, -1) - 1, n_pack)
    p_alpha = alpha.new_zeros((n_act, px, n_pack + 1)).scatter_(
        -1, slot, alpha)
    p_pos = slot.new_zeros((n_act, px, n_pack + 1)).scatter_(
        -1, slot, torch.arange(chunk, device=live.device).expand_as(slot))
    return n_live, n_pack, p_alpha, p_pos


class PairCounts(NamedTuple):
    """(pixel, instance) pairs of a forward pass, by how far each gets."""
    evaluated: int   # s computed: each pixel's instances up to its stop
    passed: int      # passed the alpha cull (the applied ones and the stop)
    applied: int     # composited: weight and colour accumulated
    live: int        # applied with s below LOG_AMAX (alpha not clamped)


def rasterize_forward_plain(table: torch.Tensor, tile_start: torch.Tensor, *,
                            width: int, height: int, tile_size: int = 16,
                            nch: int = 3, t_eps: float = T_EPS,
                            count_pairs: bool = False,
                            survivors: units.FwdCull | None = None,
                            unit: int = units.FWD_UNIT):
    """Plain PyTorch version of the forward kernel, with the kernel's
    float32 operations in the kernel's order, so both take the same cull
    and stop decisions. The tiles still compositing advance together one
    chunk of instance positions at a time: the cull runs on the whole chunk
    at once, then each pixel walks only its live instances in order.
    With ``survivors``, a cull pass's result at ``unit``
    (``units.forward_cull_plain``), each tile it culled takes its cull from
    the mask instead, as the kernel's second pass does.
    With ``count_pairs`` it returns ``(out, PairCounts, reach)``: the
    (pixel, instance) pairs of each class this data holds, and per tile
    the number of its instances that must be read (up to the furthest any
    of its pixels gets)."""
    dev = table.device
    tiles_x, tiles_y = _grid(width, height, tile_size)
    num_tiles = tiles_x * tiles_y
    px = tile_size * tile_size
    t_eps = float(np.float32(t_eps))
    out = torch.zeros((num_tiles, 8, px), device=dev)
    out[:, ROW_T] = 1.0

    # state of the tiles still compositing, compacted after every chunk
    tile = torch.arange(num_tiles, device=dev)
    s0 = tile_start[:-1].long()
    n_t = tile_start[1:].long() - s0
    trans = torch.ones((num_tiles, px), device=dev)
    acc = torch.zeros((nch, num_tiles, px), device=dev)
    done = torch.zeros((num_tiles, px), dtype=torch.bool, device=dev)
    counts = torch.zeros((4,), dtype=torch.int64, device=dev)
    reach = torch.zeros((num_tiles,), dtype=torch.int64, device=dev)
    k0 = 0
    while True:
        keep = (n_t > k0) & ~done.all(1)
        if not bool(keep.all()):
            out[tile[~keep], :nch] = acc[:, ~keep].permute(1, 0, 2)
            out[tile[~keep], ROW_T] = trans[~keep]
            tile, s0, n_t = tile[keep], s0[keep], n_t[keep]
            trans, acc, done = trans[keep], acc[:, keep], done[keep]
        n_act = tile.numel()
        if not n_act:
            break
        chunk = max(1, min(256, _CHUNK_ELEMS // (n_act * px),
                           int((n_t - k0).max())))
        kk, valid, f, _, _, s, alpha = _chunk_terms(
            table, tile, s0, n_t, k0, chunk, nch, tiles_x, tile_size)
        was_done = done
        passed = _survived(s >= _LOG_AMIN_F32, survivors, tile, s0, n_t, kk,
                           unit)
        live = valid[:, None, :] & passed & ~done[:, :, None]
        n_live, n_pack, p_alpha, p_pos = _pack_live(live, alpha)
        stop_pos = torch.full((n_act, px), -1, dtype=torch.long, device=dev)
        chans = f[ROW_CH:ROW_CH + nch]                          # (nch, A, C)
        if count_pairs:
            unclamped = s < _LOG_AMAX_F32
        for j in range(n_pack):
            a = p_alpha[..., j]
            q = trans * (1.0 - a)
            on = (n_live > j) & ~done
            stop = on & (q < t_eps)
            apply = on & ~stop
            w = a * trans
            ch = torch.gather(chans, 2, p_pos[..., j].expand(nch, -1, -1))
            acc = torch.where(apply, acc + w * ch, acc)
            trans = torch.where(apply, q, trans)
            stop_pos = torch.where(stop, p_pos[..., j], stop_pos)
            if count_pairs:
                live_j = apply & torch.gather(
                    unclamped, 2, p_pos[..., j:j + 1])[..., 0]
                counts[1:] += torch.stack([on.sum(), apply.sum(),
                                           live_j.sum()])
            done = done | stop
        if count_pairs:
            n_valid = valid.sum(1)[:, None]
            evaluated = torch.where(stop_pos >= 0, stop_pos + 1, n_valid)
            evaluated = torch.where(was_done, 0, evaluated)
            counts[0] += evaluated.sum()
            reach[tile] = k0 + evaluated.max(1).values
        k0 += chunk
    if count_pairs:
        return out, PairCounts(*(int(c) for c in counts)), reach
    return out


def rasterize_forward_two_pass_plain(table: torch.Tensor,
                                    tile_start: torch.Tensor, *, width: int,
                                    height: int, tile_size: int = 16,
                                    nch: int = 3, t_eps: float = T_EPS,
                                    unit: int = units.FWD_UNIT):
    """The kernel's two passes in plain PyTorch: the cull pass at ``unit``
    (``units.forward_cull_plain``), then the walk from its mask."""
    tiles_x, _ = _grid(width, height, tile_size)
    cull = units.forward_cull_plain(
        tile_start, table.shape[1], cull_passes(table, tiles_x, tile_size),
        tile_size * tile_size, unit)
    return rasterize_forward_plain(table, tile_start, width=width,
                                   height=height, tile_size=tile_size,
                                   nch=nch, t_eps=t_eps, survivors=cull,
                                   unit=unit)


def rasterize_backward(table: torch.Tensor, tile_start: torch.Tensor,
                       cot: torch.Tensor, fwd: torch.Tensor, *, width: int,
                       height: int, tile_size: int = 16, nch: int = 3,
                       t_eps: float = T_EPS,
                       with_absgrad: bool = True) -> torch.Tensor:
    """VJP of ``rasterize_forward`` -> (9 + nch, I) per-instance gradient
    rows ``[du dv da db dc dop dch.. |du| |dv| npix]``. ``cot`` (T, 8, px)
    holds the channel cotangents in rows 0..nch-1 and
    ``g_T = g_alpha - g_img . bg`` in row 7; ``fwd`` is the forward's
    output on the same table. The ``|du|``/``|dv|`` rows are zero unless
    ``with_absgrad``; ``npix`` counts the pixels whose alpha gradient an
    instance received. The kernel walks each tile in units of at most
    ``units.UNIT`` instances, one block each (``raster/units.py``). It
    leaves the columns at or past ``tile_start[-1]`` unwritten (the plain
    version zeroes them)."""
    if table.device.type == "cpu":
        return rasterize_backward_plain(
            table, tile_start, cot, fwd, width=width, height=height,
            tile_size=tile_size, nch=nch, t_eps=t_eps,
            with_absgrad=with_absgrad)
    if tile_size * tile_size % 32:
        raise ValueError("tile_size**2 must be a multiple of 32 (warps)")
    tiles_x, num_tiles, px = _check_kernel_inputs(
        table, tile_start, width, height, tile_size, nch)
    for name, t in (("cot", cot), ("fwd", fwd)):
        _build.require(t, name, torch.float32, (num_tiles, 8, px),
                       table.device)
    grads = torch.empty((9 + nch, table.shape[1]), dtype=torch.float32,
                        device=table.device)
    err = _build.library().divshot_backward(
        table.data_ptr(), table.shape[1], tile_start.data_ptr(), num_tiles,
        tiles_x, tile_size, nch, float(np.float32(t_eps)),
        int(bool(with_absgrad)), cot.data_ptr(), fwd.data_ptr(),
        grads.data_ptr(), _build.stream_ptr(table.device))
    _build.check_launch("backward", err)
    return grads


def rasterize_backward_plain(table: torch.Tensor, tile_start: torch.Tensor,
                             cot: torch.Tensor, fwd: torch.Tensor, *,
                             width: int, height: int, tile_size: int = 16,
                             nch: int = 3, t_eps: float = T_EPS,
                             with_absgrad: bool = True,
                             abs_sums: bool = False):
    """Plain PyTorch version of the backward kernel. The forward is
    recomputed as ``rasterize_forward_plain`` does it (the same float32
    operations, so the same cull, clamp and stop decisions); each pixel's
    sequential walk records, per applied instance, its transmittance before
    it and the running sum of ``w cdot``; the gradient terms are then
    evaluated for the whole chunk at once and summed over the pixels. With
    ``abs_sums`` it returns ``(grads, sums)``: ``sums`` holds, per row and
    column, the sum of the magnitudes of the per-pixel terms, the scale of
    the rounding error of that entry's sum."""
    dev = table.device
    tiles_x, tiles_y = _grid(width, height, tile_size)
    num_tiles = tiles_x * tiles_y
    px = tile_size * tile_size
    t_eps = float(np.float32(t_eps))
    grads = torch.zeros((9 + nch, table.shape[1]), device=dev)
    sums = torch.zeros_like(grads) if abs_sums else None

    tile = torch.arange(num_tiles, device=dev)
    s0 = tile_start[:-1].long()
    n_t = tile_start[1:].long() - s0
    g = cot[:, :nch].permute(1, 0, 2)                          # (nch, T, px)
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
            g, cf, gt_tfin = g[:, keep], cf[keep], gt_tfin[keep]
            trans, c_dot, done = trans[keep], c_dot[keep], done[keep]
        n_act = tile.numel()
        if not n_act:
            break
        chunk = max(1, min(256, _CHUNK_ELEMS // 4 // (n_act * px),
                           int((n_t - k0).max())))
        kk, valid, f, dx, dy, s, alpha = _chunk_terms(
            table, tile, s0, n_t, k0, chunk, nch, tiles_x, tile_size)
        live = valid[:, None, :] & (s >= _LOG_AMIN_F32) & ~done[:, :, None]
        n_live, n_pack, p_alpha, p_pos = _pack_live(live, alpha)
        chans = f[ROW_CH:ROW_CH + nch]                          # (nch, A, C)
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
            # per chunk position: T before the instance, the running w cdot
            # including it, and whether it was applied
            pos = torch.stack(rec_pos, -1)
            t_ex = trans.new_zeros((n_act, px, chunk + 1)).scatter_(
                -1, pos, torch.stack(rec_t, -1))[..., :chunk]
            cd_in = trans.new_zeros((n_act, px, chunk + 1)).scatter_(
                -1, pos, torch.stack(rec_cd, -1))[..., :chunk]
            app = torch.zeros((n_act, px, chunk + 1), dtype=torch.bool,
                              device=dev).scatter_(
                -1, pos, True)[..., :chunk]
            _backward_chunk_rows(grads, s0[:, None] + kk, valid, f, dx, dy,
                                 s, alpha, g, cf, gt_tfin, cdot, t_ex,
                                 cd_in, app, nch, with_absgrad, sums)
        k0 += chunk
    return (grads, sums) if abs_sums else grads


def _backward_chunk_rows(grads, cols, valid, f, dx, dy, s, alpha, g, cf,
                         gt_tfin, cdot, t_ex, cd_in, app, nch, with_absgrad,
                         sums=None):
    """Gradient rows of one chunk of instance positions, written into
    ``grads[:, cols]`` where ``valid``, and the sums of their terms'
    magnitudes into ``sums`` when given. Terms of instances that were not
    applied are exact zeros (``where``, so a NaN instance adds no NaN)."""
    zero = torch.zeros((), device=grads.device)
    live = app & (s < _LOG_AMAX_F32)
    rear = cf[:, :, None] - cd_in
    dalpha = cdot * t_ex + (gt_tfin[:, :, None] - rear) / (1.0 - alpha)
    ds = torch.where(live, dalpha * alpha, zero)
    a, b, c = (f[r][:, None, :] for r in (2, 3, 4))
    du = torch.where(live, ds * (a * dx + b * dy), zero)
    dv = torch.where(live, ds * (b * dx + c * dy), zero)
    w = torch.where(app, alpha * t_ex, zero)
    conic = [torch.where(live, -0.5 * ds * dx * dx, zero),
             torch.where(live, -ds * dx * dy, zero),
             torch.where(live, -0.5 * ds * dy * dy, zero)]
    inv_op = torch.exp(-torch.fmax(f[ROW_LOGOP], f.new_tensor(LOGOP_FLOOR)))
    if with_absgrad:
        absgrad = [du.abs().sum(1), dv.abs().sum(1)]
    else:
        absgrad = [zero.expand_as(du[:, 0]), zero.expand_as(du[:, 0])]
    npix = [live.sum(1).float()]
    rows = ([du.sum(1), dv.sum(1)] + [x.sum(1) for x in conic]
            + [ds.sum(1) * inv_op]
            + list(torch.einsum("cap,apk->cak", g, w)) + absgrad + npix)
    grads[:, cols[valid]] = torch.stack(rows, 0)[:, valid]   # (9+nch, A, C)
    if sums is not None:
        rows = ([du.abs().sum(1), dv.abs().sum(1)]
                + [x.abs().sum(1) for x in conic] + [ds.abs().sum(1) * inv_op]
                + list(torch.einsum("cap,apk->cak", g.abs(), w)) + absgrad
                + npix)
        sums[:, cols[valid]] = torch.stack(rows, 0)[:, valid]


# ---------------------------------------------------------------------------
# the differentiable raster over XLA-binned instances


# the widest record the segment stage writes (floats): ``kMaxStride`` in
# csrc/segment.cu
SEGMENT_MAX_ROWS = int(re.search(r"constexpr int kMaxStride = (\d+);",
                                 (_build.CSRC / "segment.cu").read_text())
                       .group(1))


def segment_stride(nrows: int) -> int:
    """The floats of a staged record of ``nrows`` rows: rounded up to 8
    (whole 32-byte sectors)."""
    return -(-nrows // 8) * 8


def segment_stage(grads: torch.Tensor, tile_start: torch.Tensor,
                  perm: torch.Tensor, g_offsets: torch.Tensor,
                  g_counts: torch.Tensor, rows) -> torch.Tensor:
    """The segment reduce's first launch: per-instance rows in sorted order
    -> records (icap, ``segment_stride(len(rows))``) in expansion order.
    The record of slot ``perm[j]`` holds ``grads[rows, j]`` when ``j <
    tile_start[-1]`` and zeros for a culled position, then zeros to the
    stride; only the slots inside a segment (``[0, demand)`` cut at icap)
    get one. On a CPU tensor it runs ``segment_stage_plain``; on a CUDA
    tensor it launches ``stage_kernel`` (``csrc/segment.cu``) or raises."""
    if grads.device.type == "cpu":
        return segment_stage_plain(grads, tile_start, perm, g_offsets,
                                   g_counts, rows)
    dev = grads.device
    if not isinstance(rows, range):
        # a list of rows: gathered into rows 0.. first
        grads, rows = grads[list(rows)].contiguous(), range(len(rows))
    row0, step, nrows = rows.start, rows.step, len(rows)
    if not 0 < nrows <= SEGMENT_MAX_ROWS:
        raise ValueError(f"segment_rows sums 1 to {SEGMENT_MAX_ROWS} rows, "
                         f"got {nrows}")
    if not (0 <= row0 < grads.shape[0] and 0 <= rows[-1] < grads.shape[0]):
        raise ValueError(f"rows {list(rows)} out of the {grads.shape[0]} "
                         f"rows")
    _build.require(grads, "grads", torch.float32)
    icap, n = grads.shape[1], g_counts.shape[0]
    _build.require(tile_start, "tile_start", torch.int32, device=dev)
    _build.require(perm, "perm", torch.int64, (icap,), dev)
    _build.require(g_offsets, "g_offsets", torch.int32, (n,), dev)
    _build.require(g_counts, "g_counts", torch.int32, (n,), dev)
    stride = segment_stride(nrows)
    records = torch.empty((icap, stride), dtype=torch.float32, device=dev)
    err = _build.library().divshot_segment_stage(
        grads.data_ptr(), icap, row0, step, nrows, tile_start.data_ptr(),
        tile_start.shape[0] - 1, perm.data_ptr(), g_offsets.data_ptr(),
        g_counts.data_ptr(), n, records.data_ptr(), stride,
        _build.stream_ptr(dev))
    _build.check_launch("segment_rows", err, count=False)
    return records


def segment_reduce(records: torch.Tensor, g_offsets: torch.Tensor,
                   g_counts: torch.Tensor, nrows: int) -> torch.Tensor:
    """The segment reduce's second launch: records in expansion order ->
    (nrows, N), row r of gaussian g the sum of row r of the records of its
    slots ``[g_offsets[g], g_offsets[g] + g_counts[g])`` (cut at the
    capacity), in an order the kernel fixes. On a CPU tensor it runs
    ``segment_reduce_plain``; on a CUDA tensor it launches
    ``reduce_kernel`` (``csrc/segment.cu``) or raises."""
    if records.device.type == "cpu":
        return segment_reduce_plain(records, g_offsets, g_counts, nrows)
    dev = records.device
    _build.require(records, "records", torch.float32, device=dev)
    icap, stride = records.shape
    n = g_counts.shape[0]
    _build.require(g_offsets, "g_offsets", torch.int32, (n,), dev)
    _build.require(g_counts, "g_counts", torch.int32, (n,), dev)
    out = torch.empty((nrows, n), dtype=torch.float32, device=dev)
    err = _build.library().divshot_segment_reduce(
        records.data_ptr(), stride, nrows, g_offsets.data_ptr(),
        g_counts.data_ptr(), n, icap, out.data_ptr(), _build.stream_ptr(dev))
    _build.check_launch("segment_rows", err, count=False)
    return out


def segment_rows(grads: torch.Tensor, tile_start: torch.Tensor,
                 perm: torch.Tensor, g_offsets: torch.Tensor,
                 g_counts: torch.Tensor, rows) -> torch.Tensor:
    """Per-instance rows in sorted order -> (len(rows), N) per-gaussian
    sums of ``grads[rows]`` (at most ``SEGMENT_MAX_ROWS`` rows), the
    wrapper of the CUDA segment reduce (``csrc/segment.cu``): no float
    atomics, no cumsum, each gaussian's terms added in an order the kernel
    fixes, so that every launch gives the same bits.

    Gaussian g's instances are the expansion slots ``[g_offsets[g],
    g_offsets[g] + g_counts[g])`` (cut at the capacity; ``g_offsets`` the
    exclusive prefix sum of ``g_counts``); ``perm`` (int64) is the sort's
    permutation, each sorted position's slot, and keeps the slots past the
    demand past that position (a stable sort that puts the empty slots'
    key last, as both binnings' does). Positions at or past
    ``tile_start[-1]`` (culled instances and the capacity tail, never
    written by a backward kernel) count as 0, and ``tile_start[-1]`` is
    read on the card. A gaussian without instances gets 0. Two launches,
    counted once: ``segment_stage`` writes the rows instance-major in
    expansion order, ``segment_reduce`` sums each gaussian's contiguous
    run. On a CPU tensor it runs their plain versions."""
    records = segment_stage(grads, tile_start, perm, g_offsets, g_counts,
                            rows)
    out = segment_reduce(records, g_offsets, g_counts, len(rows))
    if grads.device.type == "cuda":
        _build.LAUNCHES["segment_rows"] += 1
    return out


def segment_owners(g_offsets: torch.Tensor, g_counts: torch.Tensor,
                   icap: int) -> tuple[torch.Tensor, torch.Tensor]:
    """-> (each instance's expansion slot, its gaussian), the slots of each
    gaussian in order, cut at the capacity ``icap``."""
    n = g_counts.shape[0]
    dev = g_counts.device
    lo = g_offsets.long()
    lens = torch.clamp(torch.clamp_max(lo + g_counts.long().clamp_min(0),
                                       icap) - lo, min=0)
    owner = torch.repeat_interleave(torch.arange(n, device=dev), lens)
    first = torch.cumsum(lens, 0) - lens
    k = torch.arange(owner.numel(), device=dev) - first[owner]
    return lo[owner] + k, owner


def _selected(grads: torch.Tensor, rows) -> torch.Tensor:
    """``grads[rows]`` for a ``range`` (a view when its step is positive)
    or a list of rows."""
    return (grads[rows.start:rows.stop:rows.step]
            if isinstance(rows, range) and rows.step > 0
            else grads[list(rows)])


def segment_stage_plain(grads: torch.Tensor, tile_start: torch.Tensor,
                        perm: torch.Tensor, g_offsets: torch.Tensor,
                        g_counts: torch.Tensor, rows) -> torch.Tensor:
    """Plain PyTorch version of ``segment_stage``, in the dtype of
    ``grads``, for ``perm`` a permutation of the slots: every position's
    rows scattered to its slot, then the culled positions' records zeroed.
    A slot outside every segment, which the kernel leaves unwritten and no
    reduce reads, holds its position's record here."""
    del g_offsets, g_counts
    sel = _selected(grads, rows)
    perm = perm.long()
    records = sel.new_zeros((grads.shape[1], segment_stride(sel.shape[0])))
    records[perm, :sel.shape[0]] = sel.T
    records[perm[int(tile_start[-1]):]] = 0.0
    return records


def segment_reduce_plain(records: torch.Tensor, g_offsets: torch.Tensor,
                         g_counts: torch.Tensor, nrows: int) -> torch.Tensor:
    """Plain PyTorch version of ``segment_reduce``, in the dtype of
    ``records``: each gaussian's records added by ``index_add_`` (on the
    CPU one add after another, in slot order)."""
    slot, owner = segment_owners(g_offsets, g_counts, records.shape[0])
    return records.new_zeros((nrows, g_counts.shape[0])).index_add_(
        1, owner, records[slot, :nrows].T)


def segment_rows_plain(grads: torch.Tensor, tile_start: torch.Tensor,
                       exp2sorted: torch.Tensor, g_offsets: torch.Tensor,
                       g_counts: torch.Tensor, rows) -> torch.Tensor:
    """The function ``segment_rows`` computes, written from the other side
    of the sort, in the dtype of ``grads``: ``exp2sorted`` (each expansion
    slot's sorted position, the inverse of ``perm``) gathers each
    gaussian's live terms to expansion order, and ``index_add_`` adds them
    per gaussian (on the CPU one add after another, in slot order, so it
    gives the bits of ``segment_stage_plain`` then
    ``segment_reduce_plain``). The tests hold the port against it."""
    sel = _selected(grads, rows)
    slot, owner = segment_owners(g_offsets, g_counts, grads.shape[1])
    pos = exp2sorted.long()[slot]
    live = pos < tile_start[-1].long()
    vals = torch.where(live[None, :], sel[:, pos], sel.new_zeros(()))
    return sel.new_zeros((sel.shape[0], g_counts.shape[0])).index_add_(
        1, owner, vals)


def grad_fields(seg: torch.Tensor, nch: int) -> dict[str, torch.Tensor]:
    """The 3DGS backward's (9 + nch) summed rows by name."""
    return {
        "means2d": seg[0:2].T,
        "conics": seg[2:5].T,
        "opacity": seg[5],
        "colors": seg[ROW_CH:ROW_CH + nch].T,
        "absgrad": seg[6 + nch:8 + nch].T,
        "npix": seg[8 + nch],
    }


def reduce_instance_grads(grads: torch.Tensor, tile_start: torch.Tensor,
                          perm: torch.Tensor, g_offsets: torch.Tensor,
                          g_counts: torch.Tensor, nch: int = 3
                          ) -> dict[str, torch.Tensor]:
    """The backward kernel's rows (9 + nch, I), in the sorted order of
    ``tiles.bin_gaussians`` (whose sort's permutation is ``perm``), ->
    per-gaussian sums (counterpart of
    ``pallas_raster.reduce_instance_grads``, which takes the inverse,
    ``exp2sorted``; the port's kernel writes no boundary blocks, so there
    are none to add): dict(means2d (N, 2), conics (N, 3), colors (N, nch),
    opacity (N,), absgrad (N, 2), npix (N,))."""
    return grad_fields(segment_rows(grads, tile_start, perm, g_offsets,
                                    g_counts, range(9 + nch)), nch)


def split_tiles(out: torch.Tensor, background: torch.Tensor, width: int,
                height: int, tile_size: int, nch: int):
    """(T, 8, px) forward rows -> (image (H, W, nch) with the background on
    its first three channels, transmittance (H, W))."""
    tiles_x, tiles_y = _grid(width, height, tile_size)
    img = _tiles_to_image(out[:, 0:nch], tiles_x, tiles_y, tile_size,
                          width, height)
    t_px = _tiles_to_image(out[:, ROW_T:ROW_T + 1], tiles_x, tiles_y,
                           tile_size, width, height)[..., 0]
    bg = background if nch == 3 else torch.cat(
        [background, background.new_zeros((nch - 3,))])
    return img + t_px[..., None] * bg[None, None, :], t_px


def tile_cotangent(g_img, g_alpha, background: torch.Tensor, width: int,
                   height: int, tile_size: int, nch: int) -> torch.Tensor:
    """The image's and alpha's cotangents (None: zero) -> the backward
    kernel's (T, 8, px) cotangent rows: the channels', and in row 7 dL/dT,
    which enters through the background composite (+g_rgb . bg) and alpha
    = 1 - T (-g_alpha), with the sign the kernel folds in."""
    if g_img is None:
        g_img = background.new_zeros((height, width, nch))
    if g_alpha is None:
        g_alpha = background.new_zeros((height, width))
    g_t = g_alpha - torch.einsum("hwc,c->hw", g_img[..., :3], background)
    cot_img = torch.cat([g_img, g_img.new_zeros((*g_img.shape[:2],
                                                 MAX_CH - nch)),
                         g_t[..., None]], -1)
    tiles_x, tiles_y = _grid(width, height, tile_size)
    return _image_to_tiles(cot_img, tiles_x, tiles_y, tile_size).contiguous()


class RasterArgs(NamedTuple):
    """The static arguments of ``RasterPallas``."""
    width: int
    height: int
    tile_size: int
    t_eps: float
    with_absgrad: bool


class RasterPallas(torch.autograd.Function):
    """Compositing of binned instances with the analytic VJP. Inputs
    ``means2d (N, 2)``, ``conics (N, 3)``, ``colors (N, nch)`` (nch <= 7,
    rgb first), ``opacities (N,)``, ``background (3,)``, the zero sinks
    ``absgrad_sink (N, 2)`` / ``npix_sink (N,)`` (their gradients are the
    AbsGS sums and the pixel counts), and the binning's ``inst_gauss``,
    ``tile_start``, ``perm``, ``g_offsets`` and ``g_counts``, which
    get no gradient -> (image (H, W, nch), alpha (H, W))."""

    @staticmethod
    def forward(ctx, means2d, conics, colors, opacities, background,
                absgrad_sink, npix_sink, inst_gauss, tile_start, perm,
                g_offsets, g_counts, cfg: RasterArgs):
        del absgrad_sink, npix_sink
        nch = colors.shape[1]
        table = build_feature_table(means2d, conics, colors, opacities,
                                    inst_gauss)
        out = rasterize_forward(table, tile_start, width=cfg.width,
                                height=cfg.height, tile_size=cfg.tile_size,
                                nch=nch, t_eps=cfg.t_eps)
        img, t_px = split_tiles(out, background, cfg.width, cfg.height,
                                cfg.tile_size, nch)
        ctx.cfg, ctx.nch = cfg, nch
        ctx.save_for_backward(table, out, background, t_px, tile_start,
                              perm, g_offsets, g_counts)
        return img, 1.0 - t_px

    @staticmethod
    def backward(ctx, g_img, g_alpha):
        (table, out, background, t_px, tile_start, perm, g_offsets,
         g_counts) = ctx.saved_tensors
        cfg, nch = ctx.cfg, ctx.nch
        cot = tile_cotangent(g_img, g_alpha, background, cfg.width,
                             cfg.height, cfg.tile_size, nch)
        grads = rasterize_backward(
            table, tile_start, cot, out, width=cfg.width, height=cfg.height,
            tile_size=cfg.tile_size, nch=nch, t_eps=cfg.t_eps,
            with_absgrad=cfg.with_absgrad)
        g = reduce_instance_grads(grads, tile_start, perm, g_offsets,
                                  g_counts, nch=nch)
        d_bg = (None if g_img is None
                else torch.einsum("hwc,hw->c", g_img[..., :3], t_px))
        return (g["means2d"], g["conics"], g["colors"], g["opacity"], d_bg,
                g["absgrad"], g["npix"], None, None, None, None, None, None)


def rasterize_pallas(means2d, conics, colors, opacities, bins, *,
                     width: int, height: int, tile_size: int = 16,
                     background=None, absgrad_sink=None, npix_sink=None,
                     t_eps: float = T_EPS, with_absgrad: bool = True):
    """Differentiable raster through the forward and backward kernels over
    ``bins``, a ``tiles.TileBins`` made without the id matrix ->
    (image (H, W, nch), alpha (H, W)). ``colors`` may carry up to 7
    channels (rgb first); ``with_absgrad=False`` leaves the AbsGS rows of
    the backward at zero."""
    dev = means2d.device
    n = means2d.shape[0]
    if background is None:
        background = torch.zeros((3,), device=dev)
    if absgrad_sink is None:
        absgrad_sink = torch.zeros((n, 2), device=dev)
    if npix_sink is None:
        npix_sink = torch.zeros((n,), device=dev)
    cfg = RasterArgs(width, height, tile_size, t_eps, bool(with_absgrad))
    return RasterPallas.apply(
        means2d, conics, colors, opacities, background, absgrad_sink,
        npix_sink, bins.inst_gauss, bins.tile_start, bins.perm,
        bins.g_offsets, bins.g_counts, cfg)
