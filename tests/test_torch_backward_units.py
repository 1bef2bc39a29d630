"""The backward kernels' unit split (``divshot_tpu_torch/raster/units.py``,
``csrc/units.cuh``): the plain version of the schedule cuts every tile into
the units the kernels' header describes, within the grid bound, and the
wrappers' checks raise for what the kernels do not take. On the card,
``chip_smoke.py`` holds the schedule the kernels find
(``backward_schedule``) against this plain version."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from divshot_tpu_torch.raster import raster as R
from divshot_tpu_torch.raster import surfel_raster as SR
from divshot_tpu_torch.raster.units import (UNIT, backward_schedule,
                                            backward_schedule_plain)

U = UNIT


def _starts(counts) -> torch.Tensor:
    return torch.tensor(np.concatenate([[0], np.cumsum(counts)]),
                        dtype=torch.int32)


def check_partition(rows: np.ndarray, ts: np.ndarray, n: int) -> None:
    """``rows`` is a schedule of the tiles ``ts`` over ``n`` columns: one
    row per block of the grid bound; each tile's units cut its range into
    consecutive pieces of 1..U columns at multiples of U, a tile of at most
    U columns is one unit, an empty tile has none; each tile's first unit
    sits in block M + t, the unit starting at column c in block
    M - 1 - c // U."""
    num_tiles, m = len(ts) - 1, -(-n // U)
    assert rows.shape == (num_tiles + m, 4)
    live = rows[rows[:, 0] >= 0]
    assert (rows[rows[:, 0] < 0, 1:] == 0).all()
    assert (live[:, 3] <= ts[-1]).all()
    for t in range(num_tiles):
        s, e = int(ts[t]), int(ts[t + 1])
        mine = live[live[:, 0] == t]
        mine = mine[np.argsort(mine[:, 2])]
        if e <= s:
            assert len(mine) == 0 and rows[m + t, 0] == -1
            continue
        assert (mine[:, 1] == s).all()
        assert mine[0, 2] == s and mine[-1, 3] == e
        np.testing.assert_array_equal(mine[1:, 2], mine[:-1, 3])
        lengths = mine[:, 3] - mine[:, 2]
        assert ((lengths >= 1) & (lengths <= U)).all()
        assert (mine[1:, 2] % U == 0).all()
        assert len(mine) == 1 + (e - s > U) * ((e - 1) // U - s // U)
        np.testing.assert_array_equal(rows[m + t], mine[0])
        for r in mine[1:]:
            np.testing.assert_array_equal(rows[m - 1 - r[2] // U], r)


CASES = {
    # (tile instance counts, extra table columns past tile_start[-1])
    "empty tiles": ([0, 5, 0, 0, 7, 0], 0),
    "all empty": ([0, 0, 0], 3),
    "tiles of exactly U": ([U, U, U], 0),
    "exact multiples of U, aligned": ([2 * U, 3 * U], 0),
    "U + 1 across a multiple of U": ([U - 1, U + 1, 2], 0),
    "long, unaligned": ([3, 4 * U + 17, 1, 2 * U + 1], 0),
    "overflow past tile_start[-1]": ([3, 4 * U + 17, 1, 2 * U + 1],
                                     7 * U + 29),
    "one tile, one column": ([1], 0),
    "no columns": ([0], 0),
}


@pytest.mark.parametrize("case", list(CASES))
def test_schedule_cuts_every_tile_into_units(case):
    counts, extra = CASES[case]
    ts = _starts(counts)
    n = int(ts[-1]) + extra
    check_partition(backward_schedule_plain(ts, n).numpy(), ts.numpy(), n)


@pytest.mark.parametrize("seed", range(6))
def test_schedule_random_tiles(seed):
    """Random tile lengths, many empty, some several units long."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, 6 * U, 40) * (rng.random(40) < 0.6)
    ts = _starts(counts)
    n = int(ts[-1]) + int(rng.integers(0, 3 * U))
    check_partition(backward_schedule_plain(ts, n).numpy(), ts.numpy(), n)


def test_deepest_units_come_first():
    """Blocks [0, M) hold the units that start deeper in the table first;
    each tile's first unit follows them."""
    ts = _starts([5, 10 * U, 0, 6 * U + 3])
    n = int(ts[-1])
    got = backward_schedule_plain(ts, n)
    m = -(-n // U)
    cont = got[:m][got[:m, 0] >= 0]
    assert len(cont) == 10 + 6
    assert (cont[:, 2] > cont[:, 1]).all()            # not a tile's first
    assert (torch.diff(cont[:, 2]) < 0).all()          # deepest first
    first = got[m:]
    assert (first[first[:, 0] >= 0][:, 2] == ts[:-1].long()[[0, 1, 3]]).all()


def test_grid_bound():
    """One block per tile and one per U columns of the table, however many
    of the columns the tiles hold."""
    ts = _starts([3, 0, 2])
    for n, blocks in ((5, 4), (U, 4), (U + 1, 5), (3 * U, 6)):
        assert backward_schedule_plain(ts, n).shape == (blocks, 4)


def test_schedule_off_the_cpu_needs_a_cuda_tensor():
    ts = torch.zeros(5, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        backward_schedule(ts, 10)


def _meta_inputs(rows: int):
    return (torch.zeros((rows, 4), device="meta"),
            torch.zeros(21, dtype=torch.int32, device="meta"),
            torch.zeros((20, 8, 256), device="meta"),
            torch.zeros((20, 8, 256), device="meta"))


@pytest.mark.parametrize("wrapper,rows", [(R.rasterize_backward, 9),
                                          (SR.surfel_backward, 24)])
def test_backward_wrappers_reject_what_the_kernels_do_not_take(wrapper,
                                                               rows):
    """Tensors off the CPU go to the kernel path, whose checks raise for a
    tensor that is not on a CUDA device and for a tile size whose square is
    not a whole number of warps."""
    kw = dict(width=80, height=64)
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        wrapper(*_meta_inputs(rows), **kw)
    with pytest.raises(ValueError, match="multiple of 32"):
        wrapper(*_meta_inputs(rows), tile_size=12, **kw)
