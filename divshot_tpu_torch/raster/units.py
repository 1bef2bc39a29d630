"""The work split of the two backward kernels and the survivor mask of
the two forwards (``csrc/units.cuh``).

A tile's depth-sorted instance range ``[tile_start[t], tile_start[t+1])``
is cut at every multiple of ``UNIT`` strictly inside it when the tile holds
more than ``UNIT`` instances; a shorter tile is one unit. Each unit runs in
its own block, which re-walks the tile's prefix before it with the
forward's operations alone, so a long tile no longer runs serially on one
SM. The grid is sized from what the host knows, ``num_tiles + ceil(I /
UNIT)`` blocks for ``I`` table columns: blocks ``[0, M)``, ``M = ceil(I /
UNIT)``, take the unit that starts at column ``(M - 1 - b) * UNIT`` if one
does (the deepest first), blocks ``[M, M + num_tiles)`` each tile's first
unit; the others leave at once. The kernels find their unit on the card
(``units::find``); ``backward_schedule`` writes out what ``units::find``
gives every block, and ``backward_schedule_plain`` is its plain version.

The forwards cull a tile of more than ``LONG_REGIONS`` regions' columns
("long") in a pass of their own, spread over the card: the table's columns
fall into regions of ``FWD_UNIT``, a long tile is cut at the region bounds
into segments, and one bit per (pixel, column) of each segment, set where
the pair passes the cull, goes to a survivor mask of ``cull_words(I)``
words per pixel (``segment`` gives each segment's place); the chain then
walks only the survivors. A shorter tile is walked in one pass, and so is
a long tile that a probe of its first columns finds dense (``probe``),
whose pixels are likely to stop early. ``forward_cull_plain`` is the plain
version of that pass, ``survivor_bits`` reads the mask back, and the plain
forwards take the mask (``survivors``) to walk a long tile from it, as the
kernels do.
"""

from __future__ import annotations

import re
from typing import NamedTuple

import numpy as np
import torch

from divshot_tpu_torch import _build


def _header_unit(name: str = "kUnit") -> int:
    text = (_build.CSRC / "units.cuh").read_text()
    return int(re.search(rf"constexpr int(?:32_t)? {name} = (\d+);",
                         text).group(1))


# instances per unit at most: ``units::kUnit``, read from its header
UNIT = _header_unit()
# columns of a forward cull region: ``units::kFwdUnit``; a tile of more
# than ``LONG_REGIONS`` regions' columns is culled apart
FWD_UNIT = _header_unit("kFwdUnit")
LONG_REGIONS = _header_unit("kFwdLongRegions")
# pixels a tile holds at most for the cull: larger tiles are all walked in
# one pass, and the workspace is empty
CULL_MAX_PX = _header_unit("kCullMaxPx")
# the probe of a long tile (``units::dense_tile``): of 32 sample pixels, at
# least PROBE_DENSE pass the cull on at least PROBE_BUSY of its first
# PROBE_COLS columns -> dense
PROBE_COLS = _header_unit("kProbeCols")
PROBE_BUSY = _header_unit("kProbeBusy")
PROBE_DENSE = _header_unit("kProbeDense")


def backward_schedule_plain(tile_start: torch.Tensor,
                            num_instances: int) -> torch.Tensor:
    """-> (num_tiles + ceil(num_instances / UNIT), 4) int64 rows ``(tile,
    s0, start, end)``: the unit ``[start, end)`` that each block of a
    backward grid walks, in tile ``tile`` whose range starts at ``s0``;
    ``(-1, 0, 0, 0)`` for a block without one. A loop over the tiles:
    each tile's first unit goes to block ``M + t``, the one that starts at
    column ``c`` to block ``M - 1 - c // UNIT``. ``tile_start`` holds
    non-decreasing offsets within ``[0, num_instances]``."""
    ts = [int(x) for x in tile_start.cpu()]
    m = -(-num_instances // UNIT)
    rows = np.zeros((m + len(ts) - 1, 4), np.int64)
    rows[:, 0] = -1
    for t in range(len(ts) - 1):
        s, e = ts[t], ts[t + 1]
        if e <= s:
            continue
        cuts = [s]
        if e - s > UNIT:
            cuts += list(range((s // UNIT + 1) * UNIT, e, UNIT))
        for i, c in enumerate(cuts):
            end = cuts[i + 1] if i + 1 < len(cuts) else e
            rows[m + t if i == 0 else m - 1 - c // UNIT] = (t, s, c, end)
    return torch.from_numpy(rows)


def backward_schedule(tile_start: torch.Tensor,
                      num_instances: int) -> torch.Tensor:
    """The schedule of ``backward_schedule_plain`` as the backward kernels
    find it on the card (``csrc/units.cu``); the plain version for a CPU
    tensor. No host synchronisation; not counted as a path launch."""
    if tile_start.device.type == "cpu":
        return backward_schedule_plain(tile_start, num_instances)
    num_tiles = tile_start.shape[0] - 1
    _build.require(tile_start, "tile_start", torch.int32, (num_tiles + 1,))
    blocks = num_tiles + -(-num_instances // UNIT)
    out = torch.empty((blocks, 4), dtype=torch.int64,
                      device=tile_start.device)
    err = _build.library().divshot_backward_schedule(
        tile_start.data_ptr(), num_tiles, num_instances, blocks,
        out.data_ptr(), _build.stream_ptr(tile_start.device))
    if err != 0:
        raise RuntimeError(f"CUDA kernel backward_schedule failed to "
                           f"launch: cudaError_t {err}")
    return out


# --------------------------------------------------------------------------
# the forwards' survivor mask


def cull_regions(num_instances: int, unit: int = FWD_UNIT) -> int:
    """Regions over ``num_instances`` columns (``units::cull_regions``): 0
    when no tile can be long."""
    if unit % 32 or unit <= 0:
        raise ValueError("the unit must be a positive multiple of 32")
    return (-(-num_instances // unit)
            if num_instances > LONG_REGIONS * unit else 0)


def cull_words(num_instances: int, unit: int = FWD_UNIT) -> int:
    """Words per pixel of the survivor mask over ``num_instances`` columns
    (``units::cull_words``): ``unit // 32 + 1`` a region, the last region
    only those its columns need; 0 when no tile can be long."""
    m = cull_regions(num_instances, unit)
    if not m:
        return 0
    return (m - 1) * (unit // 32 + 1) + -(-(num_instances - (m - 1) * unit)
                                          // 32)


def work_words(num_instances: int, npx: int) -> int:
    """int32 words of the forward kernels' workspace (``units::work_words``):
    the survivor mask, then three words a region (the long tiles' marks and
    the culled tiles' counters); none for tiles of more than
    ``CULL_MAX_PX`` pixels."""
    if npx > CULL_MAX_PX:
        return 0
    return cull_words(num_instances) * npx + 3 * cull_regions(num_instances)


def segment(s: int, e: int, c: int, unit: int = FWD_UNIT):
    """-> (start, end, word): the segment of the long tile ``[s, e)`` that
    starts at column ``c`` (``s`` or a region's first column inside it) and
    the mask word of its first 32 columns (``units::segment``)."""
    j = c // unit
    end = min(e, (j + 1) * unit)
    nw = -(-(end - c) // 32)
    return c, end, j * (unit // 32 + 1) + (0 if c == j * unit
                                           else unit // 32 + 1 - nw)


def is_long(n_t, unit: int = FWD_UNIT):
    """Whether a tile of ``n_t`` instances is culled apart."""
    return n_t > LONG_REGIONS * unit


def probe(passes, t: int, s: int, npx: int) -> bool:
    """Whether the long tile t from column s is dense: ``passes(t, start,
    end)`` gives the (npx, end - start) pairs that pass the cull."""
    ok = passes(t, s, s + PROBE_COLS)[::npx // 32]        # 32 sample pixels
    return int((ok.sum(1) >= PROBE_BUSY).sum()) >= PROBE_DENSE


def long_segments(tile_start: torch.Tensor, unit: int = FWD_UNIT,
                  culled=None):
    """-> [(tile, start, end, word)]: every segment of every long tile (of
    those in ``culled`` when given), in column order."""
    ts = [int(x) for x in tile_start.cpu()]
    out = []
    for t in range(len(ts) - 1):
        s, e = ts[t], ts[t + 1]
        if not is_long(e - s, unit) or (culled is not None
                                        and not bool(culled[t])):
            continue
        c = s
        while c < e:
            start, end, word = segment(s, e, c, unit)
            out.append((t, start, end, word))
            c = end
    return out


class FwdCull(NamedTuple):
    """A cull pass's result: ``mask`` (words, npx) int64 holding each 32-bit
    word's value; ``written`` (words,) bool, the words of a segment (the
    only ones the kernels write); ``culled`` (T,) bool, the long tiles
    that the probe found sparse, which the chain walks from the mask."""
    mask: torch.Tensor
    written: torch.Tensor
    culled: torch.Tensor


def forward_cull_plain(tile_start: torch.Tensor, num_instances: int,
                       passes, npx: int, unit: int = FWD_UNIT) -> FwdCull:
    """Plain version of the forwards' cull pass, probe included.
    ``passes(tile, start, end)`` gives the (npx, end - start) pairs of
    pixels and columns ``[start, end)`` of ``tile`` that pass the cull."""
    dev = tile_start.device
    nwords = cull_words(num_instances, unit)
    mask = torch.zeros((nwords, npx), dtype=torch.int64, device=dev)
    written = torch.zeros((nwords,), dtype=torch.bool, device=dev)
    ts = [int(x) for x in tile_start.cpu()]
    culled = torch.tensor([is_long(e - s, unit) and not probe(passes, t, s,
                                                              npx)
                           for t, (s, e) in enumerate(zip(ts, ts[1:]))],
                          dtype=torch.bool, device=dev)
    weights = torch.arange(32, device=dev)
    for t, start, end, word in long_segments(tile_start, unit, culled):
        ok = passes(t, start, end).long()
        nw = -(-(end - start) // 32)
        ok = torch.nn.functional.pad(ok, (0, 32 * nw - (end - start)))
        mask[word:word + nw] = (ok.reshape(npx, nw, 32) << weights).sum(-1).T
        written[word:word + nw] = True
    return FwdCull(mask, written, culled)


def survivor_bits(mask: torch.Tensor, s0: torch.Tensor, n_t: torch.Tensor,
                  cols: torch.Tensor, unit: int = FWD_UNIT) -> torch.Tensor:
    """The mask's bits of columns ``cols`` (A, C) of long tiles ``[s0, s0 +
    n_t)`` (A,), which each column must lie in -> (A, npx, C) bool: where
    the kernels' walk finds a survivor."""
    kw = unit // 32 + 1
    s0, e0 = s0[:, None], (s0 + n_t)[:, None]
    j = torch.div(cols, unit, rounding_mode="floor")
    c_seg = torch.maximum(s0, j * unit)
    end = torch.minimum(e0, (j + 1) * unit)
    first = torch.where(c_seg == j * unit, 0,
                        kw - torch.div(end - c_seg + 31, 32,
                                       rounding_mode="floor"))
    off = cols - c_seg
    word = j * kw + first + torch.div(off, 32, rounding_mode="floor")
    bits = mask[word.clamp(0, mask.shape[0] - 1)] >> (off % 32)[..., None]
    return (bits & 1).bool().permute(0, 2, 1)
