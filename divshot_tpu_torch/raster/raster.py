"""Forward tile compositing (counterpart of
``divshot_tpu/raster/pallas_raster.py``).

The instance table is feature-major, ``(6 + nch, I)``, rows
``[u v a b c log_op ch0..]`` in depth-sorted order; ``tile_start (T+1,)``
gives each tile's instance range. ``rasterize_forward`` is the wrapper of
the CUDA forward kernel (``csrc/forward.cu``) and returns ``(T, 8, px)``:
the channels in rows 0..nch-1 and the final transmittance in row 7, all
before the background. On a CPU tensor it runs
``rasterize_forward_plain``, the plain PyTorch version of the same
function; on a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from divshot_tpu_torch import _build

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


def _grid(width: int, height: int, tile_size: int) -> tuple[int, int]:
    return -(-width // tile_size), -(-height // tile_size)


def rasterize_forward(table: torch.Tensor, tile_start: torch.Tensor, *,
                      width: int, height: int, tile_size: int = 16,
                      nch: int = 3, t_eps: float = T_EPS) -> torch.Tensor:
    """-> (T, 8, tile_size**2) per-tile rows. ``tile_start`` must hold
    non-decreasing offsets within [0, I], as ``expand_sorted`` makes them."""
    if table.device.type == "cpu":
        return rasterize_forward_plain(table, tile_start, width=width,
                                       height=height, tile_size=tile_size,
                                       nch=nch, t_eps=t_eps)
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
    out = torch.empty((num_tiles, 8, px), dtype=torch.float32,
                      device=table.device)
    err = _build.library().divshot_forward(
        table.data_ptr(), table.shape[1], tile_start.data_ptr(), num_tiles,
        tiles_x, tile_size, nch, float(np.float32(t_eps)), out.data_ptr(),
        _build.stream_ptr(table.device))
    _build.check_launch("forward", err)
    return out


def rasterize_forward_plain(table: torch.Tensor, tile_start: torch.Tensor, *,
                            width: int, height: int, tile_size: int = 16,
                            nch: int = 3, t_eps: float = T_EPS,
                            count_pairs: bool = False):
    """Plain PyTorch version of the forward kernel, with the kernel's
    float32 operations in the kernel's order, so both take the same cull
    and stop decisions. The tiles still compositing advance together one
    chunk of instance positions at a time: the cull runs on the whole chunk
    at once, then each pixel walks only its live instances in order.
    With ``count_pairs`` it also returns the work this data needs: the
    number of (pixel, instance) pairs evaluated (each pixel's instances up
    to and including the one where it stops), and per tile the number of
    its instances that must be read (up to the furthest any of its pixels
    gets)."""
    dev = table.device
    tiles_x, tiles_y = _grid(width, height, tile_size)
    num_tiles = tiles_x * tiles_y
    px = tile_size * tile_size
    t_eps = float(np.float32(t_eps))
    last = max(table.shape[1] - 1, 0)
    out = torch.zeros((num_tiles, 8, px), device=dev)
    out[:, ROW_T] = 1.0

    # state of the tiles still compositing, compacted after every chunk
    tile = torch.arange(num_tiles, device=dev)
    s0 = tile_start[:-1].long()
    n_t = tile_start[1:].long() - s0
    pix = torch.arange(px, device=dev)
    trans = torch.ones((num_tiles, px), device=dev)
    acc = torch.zeros((nch, num_tiles, px), device=dev)
    done = torch.zeros((num_tiles, px), dtype=torch.bool, device=dev)
    pairs = torch.zeros((), dtype=torch.int64, device=dev)
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
        chunk = max(1, min(256, _CHUNK_ELEMS // (n_act * px)))
        kk = k0 + torch.arange(chunk, device=dev)
        valid = kk < n_t[:, None]                               # (A, C)
        f = table[:ROW_CH + nch, torch.clamp_max(s0[:, None] + kk, last)]
        fp = f[:, :, None, :]                                   # (R, A, 1, C)
        pxx = ((tile % tiles_x)[:, None] * tile_size
               + pix % tile_size).float()[:, :, None] + 0.5     # (A, px, 1)
        pyy = ((tile // tiles_x)[:, None] * tile_size
               + pix // tile_size).float()[:, :, None] + 0.5
        dx = pxx - fp[0]
        dy = pyy - fp[1]
        quad = (fp[2] * dx * dx + 2.0 * fp[3] * dx * dy) + fp[4] * dy * dy
        s = fp[ROW_LOGOP] - 0.5 * quad                          # (A, px, C)
        was_done = done
        live = valid[:, None, :] & (s >= _LOG_AMIN_F32) & ~done[:, :, None]
        alpha = torch.exp(torch.clamp_max(s, _LOG_AMAX_F32))

        # pack each pixel's live instances to the front, in order
        n_live = live.sum(-1)
        n_pack = int(n_live.max())
        slot = torch.where(live, torch.cumsum(live, -1) - 1, n_pack)
        p_alpha = alpha.new_zeros((n_act, px, n_pack + 1)).scatter_(
            -1, slot, alpha)
        p_pos = slot.new_zeros((n_act, px, n_pack + 1)).scatter_(
            -1, slot, torch.arange(chunk, device=dev).expand_as(slot))
        stop_pos = torch.full((n_act, px), -1, dtype=torch.long, device=dev)
        chans = f[ROW_CH:ROW_CH + nch]                          # (nch, A, C)
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
            done = done | stop
        if count_pairs:
            n_valid = valid.sum(1)[:, None]
            evaluated = torch.where(stop_pos >= 0, stop_pos + 1, n_valid)
            evaluated = torch.where(was_done, 0, evaluated)
            pairs += evaluated.sum()
            reach[tile] = k0 + evaluated.max(1).values
        k0 += chunk
    return (out, pairs, reach) if count_pairs else out
