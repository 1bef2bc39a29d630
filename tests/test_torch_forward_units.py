"""The forwards' cull pass and their walk over its survivors
(``divshot_tpu_torch/raster/units.py``, ``csrc/units.cuh``): the survivor
mask's layout gives every segment of a long tile words of its own within
the workspace, and the plain two-pass walk (the plain cull pass, then the
chain from its mask) equals the plain forwards bitwise, and the JAX
forwards at the parity tests' tolerances. A small unit (``U``) exercises
the split at test size. On the card, ``chip_smoke.py`` holds the kernels
against the plain forwards and the mask they write against
``forward_cull_plain``."""

from __future__ import annotations

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from divshot_tpu.raster import pallas_raster as jax_raster
from divshot_tpu.raster.surfel import _make_surfel_compositor

from divshot_tpu_torch.raster import raster as R
from divshot_tpu_torch.raster import surfel_raster as SR
from divshot_tpu_torch.raster import units

U = 64
L = units.LONG_REGIONS * U   # a longer tile is culled apart at U
W = H = 32                   # 2 x 2 tiles of 16 px


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _starts(counts) -> torch.Tensor:
    return torch.tensor(np.concatenate([[0], np.cumsum(counts)]),
                        dtype=torch.int32)


# --------------------------------------------------------------------------
# the mask's layout


TILINGS = {
    # tile instance counts
    "empty and short tiles": [0, 5, 0, L, 7, 0],
    "one long tile from column 0": [L + 5],
    "long tiles back to back": [L + 1, 2 * L + 3, L + 1, 4 * L],
    "long tiles between short ones": [3, L + 1, 2 * U - 1, 1, L + 40, 0,
                                      3 * L + 31],
    "aligned long tiles": [2 * L, 3 * L, L],
}


def check_layout(ts: torch.Tensor, n: int, unit: int) -> None:
    """Every long tile is cut at the region bounds into consecutive
    segments that cover it; no two segments share a word; every word lies
    in the workspace."""
    segs = units.long_segments(ts, unit)
    nwords = units.cull_words(n, unit)
    owner = np.full(nwords, -1)
    starts = ts.tolist()
    for t in range(len(starts) - 1):
        s, e = starts[t], starts[t + 1]
        mine = [g for g in segs if g[0] == t]
        if e - s <= units.LONG_REGIONS * unit:
            assert not mine
            continue
        assert mine[0][1] == s and mine[-1][2] == e
        for (_, a, b, _), (_, c, _, _) in zip(mine, mine[1:]):
            assert b == c and c % unit == 0
        for i, (_, a, b, word) in enumerate(mine):
            assert 1 <= b - a <= unit and a // unit == (b - 1) // unit
            nw = -(-(b - a) // 32)
            assert 0 <= word and word + nw <= nwords
            assert (owner[word:word + nw] == -1).all()
            owner[word:word + nw] = 1000 * t + i


@pytest.mark.parametrize("case", list(TILINGS))
@pytest.mark.parametrize("unit", [32, U, 1024])
def test_segments_get_words_of_their_own(case, unit):
    ts = _starts([c * unit // U for c in TILINGS[case]])
    check_layout(ts, int(ts[-1]) + 3, unit)


@pytest.mark.parametrize("seed", range(4))
def test_segments_random_tilings(seed):
    """Random tile lengths, many empty, some several units long, with
    columns past the last tile."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, 6 * U, 30) * (rng.random(30) < 0.6)
    ts = _starts(counts)
    check_layout(ts, int(ts[-1]) + int(rng.integers(0, 3 * U)), U)


def test_workspace_holds_no_more_than_the_table():
    """The forward kernels' workspace at 256 pixels holds at most the bytes
    of the 3DGS table at nch 3 (36 bytes a column) once a tile can be
    long, and nothing before; at 32x32 tiles, which are never culled,
    nothing."""
    long = units.LONG_REGIONS * units.FWD_UNIT
    assert units.work_words(long, 256) == units.cull_words(L, U) == 0
    for n in list(range(long + 1, 3 * long, 97)) + [10 ** 6, 1 << 24]:
        assert 0 < units.work_words(n, 256) * 4 <= 36 * n
        assert units.work_words(n, 1024) == 0
    assert units.FWD_UNIT % 32 == 0 and units.UNIT % units.FWD_UNIT == 0


def _pattern(t, start, end, npx=256):
    """A sparse cull pattern of (pixel, column) pairs: about one pair in
    eleven passes."""
    p = torch.arange(npx)[:, None]
    c = torch.arange(start, end)[None]
    return (7 * p + 13 * c + t) % 11 == 0


def test_mask_bits_read_back_where_they_were_set():
    """``survivor_bits`` reads each culled tile's bits back as the cull
    set them."""
    ts = _starts([5, L + 7, 0, L + 1])
    cull = units.forward_cull_plain(ts, int(ts[-1]), _pattern, 256, U)
    assert cull.culled.tolist() == [False, True, False, True]
    for t in (1, 3):
        s, e = int(ts[t]), int(ts[t + 1])
        got = units.survivor_bits(cull.mask, ts[t:t + 1].long(),
                                  (ts[t + 1:t + 2] - ts[t:t + 1]).long(),
                                  torch.arange(s, e)[None], U)[0]
        assert torch.equal(got, _pattern(t, s, e))


def test_probe_takes_dense_tiles_out_of_the_cull():
    """A long tile whose sample pixels pass often on its first columns is
    walked in one pass: no segment, no mask word."""
    ts = _starts([L + 7, L + 9])

    def passes(t, start, end):
        return (_pattern(t, start, end) if t == 1
                else torch.ones((256, end - start), dtype=torch.bool))

    cull = units.forward_cull_plain(ts, int(ts[-1]), passes, 256, U)
    assert cull.culled.tolist() == [False, True]
    segs = units.long_segments(ts, U, cull.culled)
    assert {g[0] for g in segs} == {1}
    assert int(cull.written.sum()) == sum(-(-(e - s) // 32)
                                          for _, s, e, _ in segs)


# --------------------------------------------------------------------------
# the plain two-pass walk against the plain forwards


def _splat_cols(surfel: bool, x0, y0, sigma, op, chans) -> np.ndarray:
    """Table columns of isotropic splats centred at (x0, y0) with a
    standard deviation of ``sigma`` px and opacity ``op``: a 3DGS conic
    with its log-opacity, or a fronto-parallel surfel at depth 2."""
    n = chans.shape[1]
    if surfel:
        rows = [sigma, 0.0, x0, 0.0, sigma, y0, 0.0, 0.0, 1.0, 0.0, 0.0,
                2.0, x0, y0, op]
    else:
        inv = 1.0 / np.asarray(sigma) ** 2
        rows = [x0, y0, inv, 0.0, inv, np.log(op)]
    return np.concatenate([np.stack([np.broadcast_to(
        np.asarray(r, np.float64), (n,)) for r in rows]), chans])


# a pixel of tile 1 that two clamping splats stop in its first region, and
# tile 1's centre, where the broad splats stop the pixels first
CLAMPED = (19, 5)
CENTRE = (24.0, 8.0)


def stop_frame(surfel: bool, nch: int, seed: int = 0, planted: bool = True):
    """A 32x32 frame for the split at ``U`` (long tiles: more than ``L``
    columns) -> (table, tile_start): tile 0 holds 5U + 7 random splats (a
    long tile the probe finds dense); tile 1 holds 7U + 21 columns from
    column 5U + 7 on, fillers far away that every pixel culls but for two
    opacity-1 splats on one pixel centre in its first region (that pixel
    stops there) and, from its second region on, every third column a
    broad splat (sigma 6 px) at its centre, so that its pixels stop in
    different middle regions and its corners never (the probe finds it
    sparse: it is culled); a whole-NaN column, a NaN u, a NaN opacity, a
    clamping splat and (surfels) edge-on columns on region bounds; tile 2
    is empty; tile 3 holds exactly L random splats (walked in one
    pass). Without ``planted``, no NaN, clamping or edge-on column."""
    rng = np.random.default_rng(seed)
    n0, n1, n3 = 5 * U + 7, 7 * U + 21, L

    def random_cols(n, cx, cy):
        return _splat_cols(surfel, cx + rng.uniform(0, 16, n),
                           cy + rng.uniform(0, 16, n),
                           rng.uniform(0.4, 4.0, n), rng.uniform(0.05, 0.6, n),
                           rng.uniform(0, 1, (nch, n)))

    col = n0 + np.arange(n1)
    hit = (col >= 6 * U) & ((col - 6 * U) % 3 == 0)
    tile1 = _splat_cols(surfel, np.where(hit, CENTRE[0], 1e4),
                        np.where(hit, CENTRE[1], 1e4), 6.0,
                        rng.uniform(0.15, 0.25, n1),
                        rng.uniform(0, 1, (nch, n1)))
    t = np.concatenate([random_cols(n0, 0, 0), tile1,
                        random_cols(n3, 16, 16)], 1)

    def clamp(c, x, y):        # opacity 1 on the pixel centre (x, y)
        t[:, c] = _splat_cols(surfel, x + 0.5, y + 0.5, 0.25, 1.0,
                              t[-nch:, c:c + 1])[:, 0]

    clamp(n0 + 2, *CLAMPED)
    clamp(n0 + 5, *CLAMPED)
    rows = (SR.feat_rows(nch) if surfel else R.ROW_CH + nch)
    if not planted:
        table = np.zeros((rows, t.shape[1]), np.float32)
        table[:t.shape[0]] = t
        return torch.from_numpy(table), _starts([n0, n1, 0, n3])
    op_row = SR.ROW_OP if surfel else R.ROW_LOGOP
    t[:, 6 * U] = np.nan
    t[0, 7 * U - 1] = np.nan
    t[op_row, 8 * U] = np.nan
    clamp(7 * U, 24, 8)
    if surfel:
        for c, eps in ((6 * U + 1, 0.0), (8 * U - 1, 1e-3), (9 * U, 1e-6)):
            t[:SR.ROW_CH, c] = [12.0, 1.0, 24.0, 24.0, 2.0 + 2.0 * eps, 48.0,
                                0.0, 0.0, 1.0, 0.0, 0.0, 2.0, 24.0, 8.0, 0.9]
    table = np.zeros((rows, t.shape[1]), np.float32)
    table[:t.shape[0]] = t
    ts = torch.tensor([0, n0, n0 + n1, n0 + n1, n0 + n1 + n3],
                      dtype=torch.int32)
    return torch.from_numpy(table), ts


def _passes(surfel: bool):
    return SR.cull_passes if surfel else R.cull_passes


def _forwards(surfel: bool):
    if surfel:
        return SR.surfel_forward_plain, SR.surfel_forward_two_pass_plain
    return R.rasterize_forward_plain, R.rasterize_forward_two_pass_plain


@pytest.mark.parametrize("surfel,nch", [(False, 3), (False, 7), (True, 5),
                                        (True, 3)])
@pytest.mark.parametrize("seed", [0, 1])
def test_two_pass_walk_equals_the_plain_forward(surfel, nch, seed):
    """The plain cull pass at U and the walk over its survivors equal the
    plain forward bitwise on the stop frame: pixels that stop in the first
    region, in middle regions and never, NaN, clamping and edge-on columns
    on region bounds, an empty tile and one of exactly the long
    threshold."""
    table, ts = stop_frame(surfel, nch, seed)
    plain, two_pass = _forwards(surfel)
    kw = dict(width=W, height=H, nch=nch)
    want = plain(table, ts, **kw)
    got = two_pass(table, ts, unit=U, **kw)
    assert torch.equal(got, want)
    assert bool(torch.isfinite(got).all())

    # the frame holds what it promises: tile 0 dense, tile 1 culled; the
    # clamped pixel stops in tile 1's first region; its other pixels are
    # still walking when the region cuts fall, until they stop in
    # different regions or never
    cull = units.forward_cull_plain(
        ts, table.shape[1], _passes(surfel)(table, 2, 16), 256, U)
    assert cull.culled.tolist() == [False, True, False, False]
    assert float(want[1, 7, CLAMPED[1] * 16 + CLAMPED[0] - 16]) <= 1e-3
    alive = []
    for c in list(range(6 * U, 12 * U, U)) + [int(ts[2]) - 3]:
        cut = ts.clone()
        cut[2:4] = c
        part = plain(table, cut, **kw)
        alive.append(int((part[1] != want[1]).any(0).sum()))
    assert alive[0] == 255 and alive[-1] > 0, alive
    assert len(set(alive)) >= 4 and alive == sorted(alive, reverse=True)


@pytest.mark.parametrize("surfel", [False, True])
def test_walk_reads_the_mask(surfel):
    """With every survivor bit cleared, the walk composites nothing in the
    culled tile and leaves the others as the plain forward has them."""
    nch = 5 if surfel else 3
    table, ts = stop_frame(surfel, nch)
    plain, _ = _forwards(surfel)
    kw = dict(width=W, height=H, nch=nch)
    cull = units.forward_cull_plain(
        ts, table.shape[1], _passes(surfel)(table, 2, 16), 256, U)
    got = plain(table, ts, survivors=cull._replace(
        mask=torch.zeros_like(cull.mask)), unit=U, **kw)
    want = plain(table, ts, **kw)
    assert (got[1, 7] == 1.0).all() and not got[1, :7].any()
    assert torch.equal(got[[0, 2, 3]], want[[0, 2, 3]])


# --------------------------------------------------------------------------
# against JAX


def test_two_pass_walk_matches_jax_forward():
    """The stop frame (its culled long tile included) through the plain
    two-pass walk at U and through the Pallas forward (interpret mode), at
    the bar of tests/test_torch_parity.py (atol 3e-5). The Pallas kernel
    reads table rows in multiples of 8 and a guard band of 1024 columns
    past the last tile: the table is padded with zeros."""
    table, ts = stop_frame(False, 3, planted=False)
    padded = np.zeros((16, 9 * 256), np.float32)
    padded[:table.shape[0], :table.shape[1]] = table.numpy()
    want = np.asarray(jax_raster.rasterize_forward(
        padded, ts.numpy(), width=W, height=H, nch=3, interpret=True))
    table = torch.from_numpy(padded)
    assert bool(units.forward_cull_plain(
        ts, table.shape[1], R.cull_passes(table, 2, 16), 256,
        U).culled.any())
    got = R.rasterize_forward_two_pass_plain(table, ts, width=W, height=H,
                                             nch=3, unit=U).numpy()
    np.testing.assert_allclose(got, want, atol=3e-5)


def test_two_pass_surfel_walk_matches_jax_compositor():
    """The surfel stop frame (its culled long tile included) through the
    plain two-pass walk at U and through JAX's float32 XLA surfel
    compositor (each column a splat, each tile's columns its ids), at the
    bars of tests/test_torch_surfel_parity.py (image and alpha atol 5e-5,
    z and z^2 2e-4). The Pallas surfel kernel is no oracle here: its bf16
    split prefix products over the frame's ~140 layers differ from the
    plain single-pass forward by up to 9e-4."""
    nch = 5
    table, ts = stop_frame(True, nch, planted=False)
    tab = table.numpy()
    n = tab.shape[1]
    starts = ts.tolist()
    k = -(-max(b - a for a, b in zip(starts, starts[1:])) // 64) * 64
    ids = np.full((len(starts) - 1, k), -1, np.int32)
    for t, (a, b) in enumerate(zip(starts, starts[1:])):
        ids[t, :b - a] = np.arange(a, b)
    forward = _make_surfel_compositor(W, H, 16, 64, nch - 3)
    img, alpha, _ = forward(*(jnp.asarray(x) for x in (
        tab[0:9].T.reshape(n, 3, 3), tab[SR.ROW_ZP:SR.ROW_ZP + 3].T,
        tab[SR.ROW_C2D:SR.ROW_C2D + 2].T, np.zeros((n, 2), np.float32),
        tab[SR.ROW_CH:SR.ROW_CH + nch].T, tab[SR.ROW_OP],
        np.zeros((n,), np.float32), np.zeros((3,), np.float32), ids)))
    assert bool(units.forward_cull_plain(
        ts, n, SR.cull_passes(table, 2, 16), 256, U).culled.any())
    got = SR.surfel_forward_two_pass_plain(table, ts, width=W, height=H,
                                           nch=nch, unit=U)
    rows = SR._tiles_to_image(got, 2, 2, 16, W, H).numpy()
    img = np.asarray(img)
    np.testing.assert_allclose(rows[..., :nch], img[..., :nch], atol=5e-5)
    np.testing.assert_allclose(1.0 - rows[..., SR.ROW_T], np.asarray(alpha),
                               atol=5e-5)
    np.testing.assert_allclose(rows[..., SR.ROW_Z:SR.ROW_Z2 + 1],
                               img[..., nch:], atol=2e-4)


# --------------------------------------------------------------------------
# the wrappers


@pytest.mark.parametrize("cull,rows", [
    (functools.partial(R.kernel_mask, "divshot_forward"), 9),
    (functools.partial(R.kernel_mask, "divshot_surfel_forward"), 24)])
def test_cull_wrappers_reject_what_the_kernels_do_not_take(cull, rows):
    """The mask is read from the kernel alone: a table or tile_start not on
    a CUDA device raises before anything is launched."""
    table = torch.zeros((rows, 4 * units.FWD_UNIT), device="meta")
    ts = torch.zeros(5, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="table: expected a CUDA tensor"):
        cull(table, ts, width=32, height=32)
    with pytest.raises(ValueError, match="table: expected a CUDA tensor"):
        cull(torch.zeros(table.shape), torch.zeros(5, dtype=torch.int32),
             width=32, height=32)
