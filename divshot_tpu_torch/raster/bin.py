"""Instance binning for the tile rasterizer (counterpart of
``divshot_tpu/raster/pallas_bin.py``).

``prep`` computes each visible gaussian's tile rectangle, its instance count
(capped at ``mt``) and exclusive offset, and its depth-key bits.
``expand_instances`` is the wrapper of the CUDA expand kernel
(``csrc/expand.cu``): it writes one sort key and one owner per instance
slot. The key is the 32-bit (tile | depth) word with its top bit flipped,
stored as int32, so that a signed sort orders it as the unsigned word;
a culled slot holds ``CULLED_KEY``, which sorts last. ``sort_instances``
sorts the keys and finds the per-tile ranges; ``expand_sorted`` runs the
three and, unless ``build_table=False`` (the surfel path builds its own),
builds the feature table, as the JAX function does after its Pallas call.
``segment_rows_sorted`` sums any per-instance rows of a backward kernel
back to per-gaussian sums through the segment kernel (``raster.segment_rows``,
``csrc/segment.cu``: no float atomics, the same bits on every launch);
``reduce_grads_sorted`` names the 3DGS backward's rows.

The kernel merges the gaussians with the slots into one sequence and gives
each block ``PIECE`` items of it (a piece); ``expand_partition`` writes out
where each piece starts, as the kernel's blocks find it on the card, and
``expand_partition_plain`` is its plain version.

On a CPU tensor ``expand_instances`` runs ``expand_instances_plain``, the
plain PyTorch version of the same function; on a CUDA tensor it launches
the kernel or raises.
"""

from __future__ import annotations

import re
from typing import NamedTuple

import torch

from divshot_tpu_torch import _build
from divshot_tpu_torch.raster.raster import (build_feature_table,
                                             grad_fields, segment_rows)

# the unsigned key word w is stored as w - 2^31 (its top bit flipped)
KEY_BIAS = 1 << 31
CULLED_KEY = 0xFFFFFFFF - KEY_BIAS
NO_OWNER = 0x7FFFFFFF
# merged items (gaussians and slots) a block of the expand kernel takes:
# ``kPiece`` in csrc/expand.cu
PIECE = int(re.search(r"constexpr int32_t kPiece = (\d+);",
                      (_build.CSRC / "expand.cu").read_text()).group(1))


class Prep(NamedTuple):
    """Per-gaussian expansion inputs; all (N,) tensors."""
    offsets: torch.Tensor     # int32 exclusive instance offsets
    counts: torch.Tensor      # int32 instances per gaussian
    tmin_x: torch.Tensor      # int32 first tile column
    tmin_y: torch.Tensor      # int32 first tile row
    nx: torch.Tensor          # int32 tile columns of the rectangle
    depth_key: torch.Tensor   # int32 depth field of the sort key
    u: torch.Tensor           # f32 pixel centre
    v: torch.Tensor
    rad2: torch.Tensor        # f32 squared cull radius
    total: torch.Tensor       # () int32 instance demand (before the cap)


_PREP_DTYPES = (torch.int32,) * 6 + (torch.float32,) * 3


class SortedBins(NamedTuple):
    """Depth-sorted per-tile instances (the JAX ``SortedBins``)."""
    table: torch.Tensor | None   # (6 + nch, I) f32 [u v a b c logop ch...]
    tile_start: torch.Tensor     # (T+1,) int32
    s_owner: torch.Tensor        # (I,) int32 owner per sorted instance
    perm: torch.Tensor           # (I,) int64 expansion slot per sorted one
    g_offsets: torch.Tensor      # (N,) int32
    g_counts: torch.Tensor       # (N,) int32
    num_instances: torch.Tensor  # () int32 demand before the cap
    tile_counts: torch.Tensor    # (T,) int32


def key_bits(width: int, height: int, tile_size: int) -> tuple[int, int]:
    """-> (number of tiles, depth bits of the 32-bit sort key)."""
    num_tiles = -(-width // tile_size) * -(-height // tile_size)
    if num_tiles >= 1 << 19:
        raise ValueError("tile grid too large for packed keys")
    return num_tiles, 32 - max(1, (num_tiles + 1).bit_length())


def prep(means2d, depths, radii, radii_xy, rad2, width: int, height: int,
         tile_size: int, mt: int) -> Prep:
    """Counterpart of ``pallas_bin.prep_gdata`` without the TPU packing."""
    n = means2d.shape[0]
    tw = -(-width // tile_size)
    th = -(-height // tile_size)
    u = means2d[:, 0].contiguous()
    v = means2d[:, 1].contiguous()
    rx = radii_xy[:, 0] if radii_xy is not None else radii
    ry = radii_xy[:, 1] if radii_xy is not None else radii

    def tile_coord(x, hi, fn):
        # NaN -> 0 before the cast, as XLA converts it (the CPU's cast of
        # NaN to int32 gives INT_MIN)
        return torch.clamp(torch.nan_to_num(fn(x / tile_size), nan=0.0), 0,
                           hi).to(torch.int32)

    tmin_x = tile_coord(u - rx, tw, torch.floor)
    tmax_x = tile_coord(u + rx, tw, torch.ceil)
    tmin_y = tile_coord(v - ry, th, torch.floor)
    tmax_y = tile_coord(v + ry, th, torch.ceil)
    nx = tmax_x - tmin_x
    counts = torch.clamp_max(
        torch.where(radii > 0, nx * (tmax_y - tmin_y), 0), mt).to(torch.int32)
    offsets = (torch.cumsum(counts, 0, dtype=torch.int32) - counts)
    total = (offsets[-1] + counts[-1] if n
             else torch.zeros((), dtype=torch.int32, device=u.device))

    # the key's depth field: the top bits of the depth's float pattern
    _, depth_bits = key_bits(width, height, tile_size)
    db = min(depth_bits, 24)
    inf = torch.full((), float("inf"), device=u.device)
    dbits = torch.where(depths > 0, depths, inf).contiguous().view(torch.int32)
    depth_key = ((dbits >> 8) >> (24 - db)) << (depth_bits - db)
    r2 = rad2 if rad2 is not None else torch.full_like(u, 1e30)
    return Prep(offsets=offsets, counts=counts, tmin_x=tmin_x.contiguous(),
                tmin_y=tmin_y.contiguous(), nx=nx.contiguous(),
                depth_key=depth_key.contiguous(), u=u, v=v,
                rad2=r2.contiguous(), total=total)


def expand_instances(p: Prep, cap: int, *, width: int, height: int,
                     tile_size: int = 16) -> tuple[torch.Tensor, torch.Tensor]:
    """-> (keys (cap,) int32, owners (cap,) int32). CPU tensors take the
    plain version; CUDA tensors the kernel."""
    if p.u.device.type == "cpu":
        return expand_instances_plain(p, cap, width=width, height=height,
                                      tile_size=tile_size)
    n = p.u.shape[0]
    dev = p.u.device
    _build.require(p.u, "u", torch.float32, (n,))
    for name, t, dtype in zip(Prep._fields, p, _PREP_DTYPES):
        # the checks of _build.require, which raises with the reason
        if (t.dtype != dtype or t.device != dev or t.shape != (n,)
                or not t.is_contiguous()):
            _build.require(t, name, dtype, (n,), dev)
    if not 0 < cap < 2 ** 31 - PIECE - n:
        raise ValueError(f"instance capacity {cap} out of range")
    _, depth_bits = key_bits(width, height, tile_size)
    keys, owners = torch.empty((2, cap), dtype=torch.int32,
                               device=dev).unbind(0)
    err = _build.library().divshot_expand(
        p.offsets.data_ptr(), p.counts.data_ptr(), p.tmin_x.data_ptr(),
        p.tmin_y.data_ptr(), p.nx.data_ptr(), p.depth_key.data_ptr(),
        p.u.data_ptr(), p.v.data_ptr(), p.rad2.data_ptr(), n, cap,
        -(-width // tile_size), tile_size, depth_bits, keys.data_ptr(),
        owners.data_ptr(), _build.stream_ptr(dev))
    _build.check_launch("expand", err)
    return keys, owners


def expand_instances_plain(p: Prep, cap: int, *, width: int, height: int,
                           tile_size: int = 16
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the expand kernel, same outputs."""
    n = p.u.shape[0]
    dev = p.u.device
    tw = -(-width // tile_size)
    _, depth_bits = key_bits(width, height, tile_size)
    i = torch.arange(cap, dtype=torch.int32, device=dev)
    in_range = i < p.total
    if n == 0:
        return (torch.full((cap,), CULLED_KEY, dtype=torch.int32, device=dev),
                torch.full((cap,), NO_OWNER, dtype=torch.int32, device=dev))
    g = torch.clamp(torch.searchsorted(p.offsets, i, right=True) - 1, 0, n - 1)
    j = i - p.offsets[g]
    w = torch.clamp_min(p.nx[g], 1)
    jy = torch.div(j, w, rounding_mode="floor")
    tx = p.tmin_x[g] + (j - jy * w)
    ty = p.tmin_y[g] + jy
    ts = float(tile_size)
    ttx = tx.to(torch.float32) * ts
    tty = ty.to(torch.float32) * ts
    ug, vg = p.u[g], p.v[g]
    zero = torch.zeros((), device=dev)
    dx = torch.maximum(torch.maximum(ttx - ug, ug - (ttx + ts)), zero)
    dy = torch.maximum(torch.maximum(tty - vg, vg - (tty + ts)), zero)
    keep = dx * dx + dy * dy <= p.rad2[g]
    tile = (ty * tw + tx).to(torch.int64)
    key = torch.where(in_range & keep,
                      ((tile << depth_bits) | p.depth_key[g].to(torch.int64))
                      - KEY_BIAS, CULLED_KEY)
    owner = torch.where(in_range, g.to(torch.int32), NO_OWNER)
    return key.to(torch.int32), owner.to(torch.int32)


def expand_partition(offsets: torch.Tensor, counts: torch.Tensor,
                     cap: int) -> torch.Tensor:
    """The split of ``expand_partition_plain`` as the expand kernel's blocks
    find it on the card (``divshot_expand_partition``); the plain version
    for a CPU tensor. No host synchronisation; not counted as a path
    launch."""
    if offsets.device.type == "cpu":
        return expand_partition_plain(offsets, cap)
    n = offsets.shape[0]
    _build.require(offsets, "offsets", torch.int32, (n,))
    _build.require(counts, "counts", torch.int32, (n,), offsets.device)
    pieces = -(-(n + cap) // PIECE)
    out = torch.empty((pieces + 1,), dtype=torch.int32,
                      device=offsets.device)
    err = _build.library().divshot_expand_partition(
        offsets.data_ptr(), counts.data_ptr(), n, cap, pieces,
        out.data_ptr(), _build.stream_ptr(offsets.device))
    if err != 0:
        raise RuntimeError(f"CUDA kernel expand_partition failed to launch: "
                           f"cudaError_t {err}")
    return out


def expand_partition_plain(offsets: torch.Tensor, cap: int) -> torch.Tensor:
    """-> (pieces + 1,) int32: the first gaussian of each piece of the
    expand kernel's work, then ``n``. The kernel merges the gaussians'
    places ``g + min(offsets[g], cap)`` with the ``cap`` slots, a gaussian
    before its slots and the slots past the demand after every gaussian
    (``offsets[g]`` never exceeds the demand, so the clamp at ``cap`` is
    the clamp at ``min(demand, cap)``); piece ``c`` is the items ``[c PIECE,
    (c+1) PIECE)``, so its gaussians are those whose place lies there and
    its slots ``[c PIECE - g_c, (c+1) PIECE - g_(c+1))``."""
    n = offsets.shape[0]
    pieces = -(-(n + cap) // PIECE)
    places = (torch.arange(n, dtype=torch.int64, device=offsets.device)
              + torch.clamp_max(offsets.long(), cap))
    d = torch.clamp_max(torch.arange(pieces + 1, dtype=torch.int64,
                                     device=offsets.device) * PIECE, n + cap)
    return torch.searchsorted(places, d).to(torch.int32)


def sort_instances(keys, owners, *, num_tiles: int, depth_bits: int,
                   guard_lanes: int = 2048):
    """(tile | depth) sort of the expanded instances -> (sorted keys, owners
    in that order, tile_start (T+1,) int32, the sort's permutation: the
    expansion slot of each sorted instance). One stable sort of the int32
    keys, then one search of the ``T+1`` tile starts' keys: tile ``t``
    starts at the first key ``>= t << depth_bits`` (biased); for ``t = T``
    that is the first culled slot, whose key's tile field (all ones) lies
    above ``T`` (``key_bits`` leaves room for ``T + 1``). ``tile_start``
    is clamped ``guard_lanes`` short of the capacity, as in JAX."""
    cap = keys.shape[0]
    s_key, perm = torch.sort(keys, stable=True)
    firsts = (torch.arange(num_tiles + 1, dtype=torch.int64,
                           device=keys.device) << depth_bits) - KEY_BIAS
    bounds = torch.searchsorted(s_key, firsts.to(torch.int32))
    tile_start = torch.clamp_max(
        bounds, max(cap - guard_lanes, cap // 2)).to(torch.int32)
    return s_key, owners[perm], tile_start, perm


def sort_instances_int64(keys, owners, *, num_tiles: int, depth_bits: int,
                         guard_lanes: int = 2048):
    """The int64 form of ``sort_instances``, the reference that the checks
    hold it against: the unsigned key words widened to int64 and sorted,
    the tile field shifted out and clamped, and one search of the tile
    numbers. Same outputs, the keys as int64 words. No path calls it."""
    cap = keys.shape[0]
    s_key, perm = torch.sort(keys.to(torch.int64) + KEY_BIAS, stable=True)
    s_tile = torch.clamp_max(s_key >> depth_bits, num_tiles)
    bounds = torch.searchsorted(
        s_tile, torch.arange(num_tiles + 1, device=s_tile.device))
    tile_start = torch.clamp_max(
        bounds, max(cap - guard_lanes, cap // 2)).to(torch.int32)
    return s_key, owners[perm], tile_start, perm


def expand_sorted(means2d, conics, depths, radii, radii_xy, rad2, colors,
                  opacities, *, width: int, height: int, tile_size: int = 16,
                  instance_capacity: int = 1 << 20, mt: int = 64,
                  guard_lanes: int = 2048,
                  build_table: bool = True) -> SortedBins:
    """Expand -> (tile | depth) sort -> per-tile ranges and, with
    ``build_table``, the feature table (else ``table`` is None and
    ``conics``, ``colors`` and ``opacities`` are not read)."""
    if mt > 256:
        raise ValueError("mt must be <= 256")
    cap = instance_capacity
    num_tiles, depth_bits = key_bits(width, height, tile_size)
    p = prep(means2d, depths, radii, radii_xy, rad2, width, height,
             tile_size, mt)
    keys, owners = expand_instances(p, cap, width=width, height=height,
                                    tile_size=tile_size)
    s_key, s_owner, tile_start, perm = sort_instances(
        keys, owners, num_tiles=num_tiles, depth_bits=depth_bits,
        guard_lanes=guard_lanes)
    table = None
    if build_table:
        inst = torch.where(s_key == CULLED_KEY, -1, s_owner)
        table = build_feature_table(means2d, conics, colors, opacities, inst)
    return SortedBins(
        table=table, tile_start=tile_start, s_owner=s_owner, perm=perm,
        g_offsets=p.offsets, g_counts=p.counts, num_instances=p.total,
        tile_counts=tile_start[1:] - tile_start[:-1])


def segment_rows_sorted(grads: torch.Tensor, bins: SortedBins,
                        rows) -> torch.Tensor:
    """Per-instance rows in sorted order -> (len(rows), N) per-gaussian
    sums of ``grads[rows]`` (counterpart of
    ``pallas_bin.segment_rows_sorted``), by ``raster.segment_rows`` (the
    segment reduce on the card) through the sort's permutation."""
    return segment_rows(grads, bins.tile_start, bins.perm, bins.g_offsets,
                        bins.g_counts, rows)


def reduce_grads_sorted(grads: torch.Tensor, bins: SortedBins, *,
                        nch: int = 3) -> dict[str, torch.Tensor]:
    """The 3DGS backward's rows (9 + nch, I) in sorted order -> per-
    gaussian sums (counterpart of ``pallas_bin.reduce_grads_sorted``), by
    ``segment_rows_sorted``.

    -> dict(means2d (N, 2), conics (N, 3), colors (N, nch), opacity (N,),
    absgrad (N, 2), npix (N,))."""
    return grad_fields(segment_rows_sorted(grads, bins, range(9 + nch)),
                       nch)
