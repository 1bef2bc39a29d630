"""The expand kernel's split and keys on the CPU (``raster/bin.py``,
``csrc/expand.cu``).

The kernel gives each block ``PIECE`` items (a piece) of the merged
sequence of gaussians and slots (``expand_partition_plain`` is where each
piece starts); ``_block_walk`` replays the kernel's blocks in numpy from
that split, and both it and the plain version are held slot for slot
against the loop reference of ``test_torch_kernels_plain`` on adversarial
counts. The int32 keys (the unsigned word with its top bit flipped) and
``sort_instances`` are held against the unsigned order and the int64 sort
they replace, at 1920x1080 where half the tiles have the word's top bit
set. The kernel itself runs only on a card (``chip_smoke.py``)."""

import bisect
import re

import numpy as np
import pytest
import torch

from divshot_tpu_torch import _build
from divshot_tpu_torch.raster import bin as B
from tests.test_torch_kernels_plain import _expand_loop, _prep

f32 = np.float32
# items a thread of the kernel walks (``kItems`` in csrc/expand.cu)
ITEMS = int(re.search(r"constexpr int kItems = (\d+);",
                      (_build.CSRC / "expand.cu").read_text()).group(1))


def _synthetic_prep(rng, counts, width=1920, height=1080, nan=()):
    """A ``Prep`` with the given instance counts, each gaussian's rectangle
    large enough to hold them inside the tile grid, centres near it (some
    tiles culled), and NaN in the named fields of a few gaussians that own
    instances."""
    tw, th = -(-width // 16), -(-height // 16)
    counts = np.asarray(counts, np.int32)
    n = counts.size
    nx = np.maximum(rng.integers(1, 33, n), -(-counts // th)).astype(np.int32)
    ny = np.maximum(-(-counts // nx), 1)
    tmin_x = rng.integers(0, tw - nx + 1).astype(np.int32)
    tmin_y = rng.integers(0, th - ny + 1).astype(np.int32)
    u = ((tmin_x + nx * rng.random(n)) * 16).astype(f32)
    v = ((tmin_y + ny * rng.random(n)) * 16).astype(f32)
    rad2 = (rng.random(n) * 64 * (nx + ny)) ** 2
    _, depth_bits = B.key_bits(width, height, 16)
    depth_key = rng.integers(0, 1 << depth_bits, n).astype(np.int32)
    offsets = (np.cumsum(counts) - counts).astype(np.int32)
    fields = {"u": u, "v": v, "rad2": rad2.astype(f32)}
    owning = np.flatnonzero(counts > 0)
    for k, name in enumerate(nan):
        fields[name][owning[k * len(owning) // 3]] = np.nan
    t = {k: torch.from_numpy(np.ascontiguousarray(a)) for k, a in dict(
        offsets=offsets, counts=counts, tmin_x=tmin_x, tmin_y=tmin_y,
        nx=nx, depth_key=depth_key, **fields).items()}
    total = int(counts.sum())
    return B.Prep(**t, total=torch.tensor(total, dtype=torch.int32))


def _block_walk(p: B.Prep, cap, width=1920, height=1080, ts=16):
    """The expand kernel's blocks replayed in numpy: each piece starts where
    ``expand_partition_plain`` says and stages its gaussians' places; each
    of its threads finds how many come before its ``ITEMS`` items and walks
    them in order, a slot taking the last gaussian passed as its owner; a
    slot's index in its owner's rectangle comes from the owner's first
    slot -> (keys int32, owners int32, times each slot was written)."""
    a = {k: v.numpy().astype(np.int64) for k, v in p._asdict().items()
         if k not in ("u", "v", "rad2")}
    uf, vf, r2 = p.u.numpy(), p.v.numpy(), p.rad2.numpy()
    n = uf.size
    tw = -(-width // ts)
    _, depth_bits = B.key_bits(width, height, ts)
    total = int(a["offsets"][-1] + a["counts"][-1]) if n else 0
    slots = min(total, cap)
    starts = B.expand_partition_plain(p.offsets, cap).numpy()
    keys = np.full(cap, -1, np.int64)
    owners = np.full(cap, -1, np.int64)
    written = np.zeros(cap, np.int64)
    for c in range(starts.size - 1):
        d0, d1 = c * B.PIECE, min((c + 1) * B.PIECE, n + cap)
        if d0 >= n + slots:
            keys[d0 - n:d1 - n] = B.CULLED_KEY
            owners[d0 - n:d1 - n] = B.NO_OWNER
            written[d0 - n:d1 - n] += 1
            continue
        g0, ng = int(starts[c]), int(starts[c + 1] - starts[c])
        i0, ns = d0 - g0, d1 - d0 - ng
        place = [k + min(int(a["offsets"][g0 + k]), cap) - i0
                 for k in range(ng)]
        own = np.full(ns, -1, np.int64)
        for it in range(0, B.PIECE, ITEMS):
            k = bisect.bisect_left(place, it)
            s = it - k
            for pos in range(it, min(it + ITEMS, d1 - d0)):
                if k < ng and place[k] == pos:
                    k += 1
                else:
                    own[s] = k
                    s += 1
        assert (own >= 0).all()
        s = np.arange(ns)
        live = s < slots - i0
        first = np.array([int(a["offsets"][g0 - 1]) - i0 if g0 else 0]
                         + [x - k for k, x in enumerate(place)], np.int64)
        g = np.maximum(g0 - 1 + own, 0)
        j = s - first[own]
        w = np.maximum(a["nx"][g], 1)
        tx = a["tmin_x"][g] + j % w
        ty = a["tmin_y"][g] + j // w
        ttx = tx.astype(f32) * f32(ts)
        tty = ty.astype(f32) * f32(ts)
        ug, vg = uf[g], vf[g]
        with np.errstate(invalid="ignore"):
            dx = np.maximum(np.maximum(ttx - ug, ug - (ttx + f32(ts))), f32(0))
            dy = np.maximum(np.maximum(tty - vg, vg - (tty + f32(ts))), f32(0))
            keep = (~np.isnan(ug) & ~np.isnan(vg)
                    & (dx * dx + dy * dy <= r2[g]))
        word = ((ty * tw + tx) << depth_bits) | a["depth_key"][g]
        keys[i0:i0 + ns] = np.where(live & keep, word - B.KEY_BIAS,
                                    B.CULLED_KEY)
        owners[i0:i0 + ns] = np.where(live, g, B.NO_OWNER)
        written[i0:i0 + ns] += 1
    return keys.astype(np.int32), owners.astype(np.int32), written


def _loop_keys(p, cap, width=1920, height=1080):
    """``_expand_loop`` with its unsigned words as the int32 keys."""
    k, o = _expand_loop(p, cap, width, height)
    return (k.astype(np.uint32).astype(np.int64)
            - B.KEY_BIAS).astype(np.int32), o


P = B.PIECE
CASES = {
    # all but the last gaussian without instances: a zero-count run longer
    # than three blocks' pieces
    "zero_run": (lambda r: [0] * (3 * P) + [5], 1000),
    "zero_run_middle": (lambda r: list(r.integers(1, 9, 300)) + [0] * (
        2 * P + 77) + list(r.integers(0, 9, 300)), 3 * P + 5),
    "all_mt64": (lambda r: [64] * 101, 7001),
    "all_mt256": (lambda r: [256] * 41, 11003),
    "n0": (lambda r: [], 100),
    "n1": (lambda r: [37], 50),
    "total0": (lambda r: [0] * 500, 3000),
    "overflow": (lambda r: list(r.integers(0, 65, 200)), 3001),
    "cap_piece_multiple": (lambda r: list(r.integers(0, 40, 150)), 2 * P),
    "exact_fit": (lambda r: [7] * 300, 2100),
}
NAN = ("u", "v", "rad2")


@pytest.mark.parametrize("case", sorted(CASES))
def test_partition_covers_every_slot_and_gaussian_once(case):
    counts_fn, cap = CASES[case]
    p = _synthetic_prep(np.random.default_rng(1), counts_fn(
        np.random.default_rng(0)))
    n = p.u.shape[0]
    starts = B.expand_partition_plain(p.offsets, cap).long()
    blocks = -(-(n + cap) // P)
    assert starts.shape == (blocks + 1,)
    assert int(starts[0]) == 0 and int(starts[-1]) == n
    d = torch.clamp_max(torch.arange(blocks + 1) * P, n + cap)
    first_slot = d - starts
    assert int(first_slot[0]) == 0 and int(first_slot[-1]) == cap
    # each block: gaussians [g_b, g_b+1), slots [d_b - g_b, d_b+1 - g_b+1),
    # both ranges non-decreasing, so every one is in exactly one block
    assert bool((starts[1:] >= starts[:-1]).all())
    assert bool((first_slot[1:] >= first_slot[:-1]).all())
    assert bool(((starts[1:] - starts[:-1])
                 + (first_slot[1:] - first_slot[:-1]) == d[1:] - d[:-1]).all())
    # a block's instances belong to its gaussians or the one before them
    _, owners = B.expand_instances_plain(p, cap, width=1920, height=1080)
    slot_block = torch.searchsorted(first_slot, torch.arange(cap),
                                    right=True) - 1
    live = owners != B.NO_OWNER
    ob = owners[live].long()
    sb = slot_block[live]
    assert bool((ob >= starts[sb] - 1).all() and (ob < starts[sb + 1]).all())


# NaN u, v and rad2 where at least three gaussians own instances
WALK_CASES = [(c, ()) for c in sorted(CASES)] + [
    (c, NAN) for c in sorted(CASES)
    if sum(k > 0 for k in CASES[c][0](np.random.default_rng(0))) >= 3]


@pytest.mark.parametrize("case,nan", WALK_CASES)
def test_block_walk_and_plain_match_loop(case, nan):
    """The kernel's walk (replayed) and the plain version equal the loop
    reference slot for slot, and the walk writes every slot once."""
    counts_fn, cap = CASES[case]
    counts = counts_fn(np.random.default_rng(0))
    p = _synthetic_prep(np.random.default_rng(1), counts, nan=nan)
    want_k, want_o = _loop_keys(p, cap)
    keys, owners = B.expand_instances_plain(p, cap, width=1920, height=1080)
    np.testing.assert_array_equal(keys.numpy(), want_k)
    np.testing.assert_array_equal(owners.numpy(), want_o)
    wk, wo, written = _block_walk(p, cap)
    np.testing.assert_array_equal(written, np.ones(cap, np.int64))
    np.testing.assert_array_equal(wk, want_k)
    np.testing.assert_array_equal(wo, want_o)
    if nan:
        for name in nan:
            g = int(torch.nonzero(torch.isnan(getattr(p, name)))[0, 0])
            assert bool((keys[owners == g] == B.CULLED_KEY).all())


@pytest.mark.parametrize("seed,mt,cap", [(0, 64, 1 << 13), (2, 64, 400)])
def test_block_walk_matches_plain_on_a_frame(seed, mt, cap):
    p, _, cam = _prep(seed, mt=mt)
    keys, owners = B.expand_instances_plain(p, cap, width=cam.width,
                                            height=cam.height)
    wk, wo, _ = _block_walk(p, cap, cam.width, cam.height)
    np.testing.assert_array_equal(wk, keys.numpy())
    np.testing.assert_array_equal(wo, owners.numpy())


def test_biased_keys_sort_in_unsigned_order():
    rng = np.random.default_rng(3)
    words = np.concatenate([rng.integers(0, 1 << 32, 5000, np.uint64),
                            [0, 1, (1 << 31) - 1, 1 << 31, (1 << 32) - 2,
                             (1 << 32) - 1]]).astype(np.uint64)
    keys = torch.from_numpy((words.astype(np.int64)
                             - B.KEY_BIAS).astype(np.int32))
    order = torch.sort(keys, stable=True).indices.numpy()
    np.testing.assert_array_equal(order, np.argsort(words, kind="stable"))
    assert B.CULLED_KEY == torch.iinfo(torch.int32).max
    assert int(keys[-1]) == B.CULLED_KEY


def _tile_keys(rng, width, height, per_tile=3):
    """Keys of every tile of the frame (``per_tile`` each, random depths,
    shuffled) and some culled ones -> (int32 keys, each key's tile, T)."""
    num_tiles, depth_bits = B.key_bits(width, height, 16)
    tiles = np.repeat(np.arange(num_tiles), per_tile)
    words = (tiles.astype(np.int64) << depth_bits) | rng.integers(
        0, 1 << depth_bits, tiles.size)
    words = np.concatenate([words, np.full(500, 0xFFFFFFFF, np.int64)])
    tiles = np.concatenate([tiles, np.full(500, num_tiles)])
    perm = rng.permutation(words.size)
    return (torch.from_numpy((words[perm] - B.KEY_BIAS).astype(np.int32)),
            tiles[perm], num_tiles, depth_bits)


def test_tile_start_at_1080p():
    """At 1920x1080 (8,160 tiles, 19 depth bits) the key words of tiles
    4,096-8,159 have the top bit set: the biased keys give every tile its
    range, as the int64 sort does, where a signed sort of the unbiased
    words puts exactly those tiles first."""
    rng = np.random.default_rng(4)
    keys, tiles, num_tiles, depth_bits = _tile_keys(rng, 1920, 1080)
    assert (num_tiles, depth_bits) == (8160, 19)
    owners = torch.arange(keys.numel(), dtype=torch.int32)
    s_key, s_owner, start, perm = B.sort_instances(
        keys, owners, num_tiles=num_tiles, depth_bits=depth_bits,
        guard_lanes=0)
    want = np.searchsorted(np.sort(tiles), np.arange(num_tiles + 1))
    np.testing.assert_array_equal(start.numpy(), want)
    np.testing.assert_array_equal(tiles[perm.numpy()], np.sort(tiles))
    assert torch.equal(s_owner, owners[perm])
    ref = B.sort_instances_int64(keys, owners, num_tiles=num_tiles,
                                 depth_bits=depth_bits, guard_lanes=0)
    assert torch.equal(start, ref[2]) and torch.equal(s_owner, ref[1])
    assert torch.equal(perm, ref[3])
    assert torch.equal(s_key.long() + B.KEY_BIAS, ref[0])
    # without the bias: the top-bit tiles sort first
    raw = keys.long() + B.KEY_BIAS
    signed = torch.where(raw >= B.KEY_BIAS, raw - (1 << 32), raw)
    naive = tiles[torch.sort(signed.to(torch.int32), stable=True)
                  .indices.numpy()]
    high = int(((tiles >= 4096) & (tiles < num_tiles)).sum()) + 500
    assert set(naive[:high]) == set(range(4096, num_tiles + 1))
    np.testing.assert_array_equal(naive[high:], np.sort(tiles)[:-high])


@pytest.mark.parametrize("seed,cap,guard", [(0, 1 << 13, 2048),
                                            (2, 400, 0), (5, 4096, 1024)])
def test_sort_matches_int64_path_on_a_frame(seed, cap, guard):
    """On a frame's expansion (overflowing at cap 400) the int32 sort gives
    the int64 path's ranges, owners and permutation, guard clamp
    included."""
    p, _, cam = _prep(seed)
    num_tiles, depth_bits = B.key_bits(cam.width, cam.height, 16)
    keys, owners = B.expand_instances_plain(p, cap, width=cam.width,
                                            height=cam.height)
    kw = dict(num_tiles=num_tiles, depth_bits=depth_bits, guard_lanes=guard)
    got = B.sort_instances(keys, owners, **kw)
    ref = B.sort_instances_int64(keys, owners, **kw)
    for a, b in zip(got[1:], ref[1:]):
        assert torch.equal(a, b)
    assert torch.equal(got[0].long() + B.KEY_BIAS, ref[0])
