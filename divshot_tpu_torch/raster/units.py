"""The work split of the two backward kernels (``csrc/units.cuh``).

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
"""

from __future__ import annotations

import re

import numpy as np
import torch

from divshot_tpu_torch import _build


def _header_unit() -> int:
    text = (_build.CSRC / "units.cuh").read_text()
    return int(re.search(r"constexpr int32_t kUnit = (\d+);", text).group(1))


# instances per unit at most: ``units::kUnit``, read from its header
UNIT = _header_unit()


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
