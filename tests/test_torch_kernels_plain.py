"""The port's kernel modules on the CPU: each kernel's plain PyTorch version
against an independent reference (a numpy loop, or float64 autograd for the
backward), NaN instances in each, the per-gaussian reduce, the wrappers'
CPU dispatch and input checks, the kernel build's failure paths, and the
render app's PNG path.

The CUDA kernels themselves run only on a card; ``python3 chip_smoke.py``
holds them against these plain versions there."""

import dataclasses
import math
import os
import stat
import struct
import zlib

import numpy as np
import pytest
import torch

from divshot_tpu_torch import _build
from divshot_tpu_torch.apps import render as app
from divshot_tpu_torch.gsio.io import load_model
from divshot_tpu_torch.gsio.synthetic import orbit_cameras, random_scene
from divshot_tpu_torch.raster import bin as B
from divshot_tpu_torch.raster import raster as R
from divshot_tpu_torch.raster.render import frame_inputs

CPU = "cpu"
f32 = np.float32


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _prep(seed=0, n=300, w=80, h=64, mt=64):
    params = random_scene(np.random.default_rng(seed), n, sh_degree=1,
                          capacity=n + 8, device=CPU)
    cam = orbit_cameras(1, width=w, height_px=h, device=CPU)[0]
    proj, colors, opac = frame_inputs(params, cam)
    p = B.prep(proj.means2d, proj.depths, proj.radii, proj.radii_xy,
               proj.rad2, w, h, 16, mt)
    return p, (proj, colors, opac), cam


def _expand_loop(p: B.Prep, cap, width, height, ts=16):
    """Slot-by-slot numpy reference of the expand kernel."""
    _, depth_bits = B.key_bits(width, height, ts)
    tw = -(-width // ts)
    keys = np.full(cap, 0xFFFFFFFF, np.uint64)
    owners = np.full(cap, B.NO_OWNER, np.int64)
    a = {k: v.numpy() for k, v in p._asdict().items()}
    for g in range(len(a["u"])):
        for j in range(a["counts"][g]):
            i = a["offsets"][g] + j
            if i >= cap:
                break
            w = max(a["nx"][g], 1)
            tx, ty = a["tmin_x"][g] + j % w, a["tmin_y"][g] + j // w
            ttx, tty = f32(tx) * f32(ts), f32(ty) * f32(ts)
            u, v = a["u"][g], a["v"][g]
            dx = max(max(ttx - u, u - (ttx + f32(ts))), f32(0))
            dy = max(max(tty - v, v - (tty + f32(ts))), f32(0))
            owners[i] = g
            if f32(dx * dx) + f32(dy * dy) <= a["rad2"][g]:
                keys[i] = ((ty * tw + tx) << depth_bits) | a["depth_key"][g]
    return keys, owners


@pytest.mark.parametrize("seed,mt,cap", [(0, 64, 1 << 13), (1, 4, 1 << 12),
                                         (2, 64, 400)])
def test_expand_plain_matches_loop(seed, mt, cap):
    p, _, cam = _prep(seed, mt=mt)
    keys, owners = B.expand_instances_plain(p, cap, width=cam.width,
                                            height=cam.height)
    want_k, want_o = _expand_loop(p, cap, cam.width, cam.height)
    np.testing.assert_array_equal(
        keys.numpy().astype(np.int64) + B.KEY_BIAS,
        want_k.astype(np.uint32).astype(np.int64))
    np.testing.assert_array_equal(owners.numpy(), want_o)
    assert int(p.total) == int(p.counts.sum())
    assert (int(p.total) > cap) == (cap == 400)


def _forward_loop(table, tile_start, width, height, nch, ts=16):
    """Pixel-by-pixel numpy reference of the forward kernel -> (out, pairs
    evaluated, passed, applied and live, instances read per tile)."""
    tx_n = -(-width // ts)
    num_tiles = tx_n * -(-height // ts)
    out = np.zeros((num_tiles, 8, ts * ts), np.float32)
    pairs, reach = np.zeros(4, np.int64), np.zeros(num_tiles, np.int64)
    amin, amax = f32(R.LOG_AMIN), f32(R.LOG_AMAX)
    for t in range(num_tiles):
        for p in range(ts * ts):
            x = f32((t % tx_n) * ts + p % ts) + f32(0.5)
            y = f32((t // tx_n) * ts + p // ts) + f32(0.5)
            T = f32(1)
            acc = np.zeros(nch, np.float32)
            seen = tile_start[t + 1] - tile_start[t]
            for k in range(tile_start[t], tile_start[t + 1]):
                u, v, a, b, c, lo = table[:6, k]
                dx, dy = x - u, y - v
                s = lo - f32(0.5) * ((a * dx * dx + f32(2) * b * dx * dy)
                                     + c * dy * dy)
                if s < amin:
                    continue
                pairs[1] += 1
                alpha = np.exp(min(s, amax))
                q = T * (f32(1) - alpha)
                if q < f32(R.T_EPS):
                    seen = k - tile_start[t] + 1
                    break
                pairs[2] += 1
                pairs[3] += int(s < amax)
                acc += (alpha * T) * table[6:6 + nch, k]
                T = q
            out[t, :nch, p] = acc
            out[t, 7, p] = T
            pairs[0] += seen
            reach[t] = max(reach[t], seen)
    return out, pairs, reach


@pytest.mark.parametrize("nch", [3, 1])
def test_forward_plain_matches_loop(nch):
    _, (proj, colors, opac), _ = _prep(3, n=120, w=40, h=24)
    w, h = 40, 24
    sb = B.expand_sorted(proj.means2d, proj.conics, proj.depths, proj.radii,
                         proj.radii_xy, proj.rad2, colors[:, :nch], opac,
                         width=w, height=h, instance_capacity=1 << 12)
    got, counts, reach = R.rasterize_forward_plain(
        sb.table, sb.tile_start, width=w, height=h, nch=nch,
        count_pairs=True)
    want, want_pairs, want_reach = _forward_loop(
        sb.table.numpy(), sb.tile_start.numpy(), w, h, nch)
    assert int(sb.tile_start[-1]) > 0
    np.testing.assert_allclose(got.numpy(), want, atol=3e-5)
    assert list(counts) == want_pairs.tolist()
    assert counts.evaluated >= counts.passed >= counts.applied >= counts.live
    assert counts.live > 0
    np.testing.assert_array_equal(reach.numpy(), want_reach)


def test_forward_plain_counts_pairs_and_stops():
    """Three opaque splats over the whole tile: the first is applied (its
    alpha clamped at 0.999, so no pair is live), the second takes T below
    t_eps, so every pixel stops there without it, and the third is never
    read."""
    ts = 16
    table = torch.zeros((9, 3))
    table[:, 0] = torch.tensor([8.0, 8.0, 1e-6, 0, 1e-6, 0.0, 1, 0, 0])
    table[:, 1] = torch.tensor([8.0, 8.0, 1e-6, 0, 1e-6, 0.0, 0, 1, 0])
    table[:, 2] = torch.tensor([8.0, 8.0, 1e-6, 0, 1e-6, 0.0, 0, 0, 1])
    start = torch.tensor([0, 3], dtype=torch.int32)
    out, counts, reach = R.rasterize_forward_plain(
        table, start, width=ts, height=ts, count_pairs=True)
    a = float(np.exp(f32(R.LOG_AMAX)))
    np.testing.assert_allclose(out[0, 0].numpy(), a, rtol=1e-6)
    np.testing.assert_allclose(out[0, 7].numpy(), 1 - a, rtol=1e-4)
    assert float(out[0, 1:3].abs().max()) == 0.0
    assert counts == R.PairCounts(evaluated=256 * 2, passed=256 * 2,
                                  applied=256, live=0)
    assert reach.tolist() == [2]


def _random_table(rng, per_tile, w, h, nch, ts=16):
    """A depth-ordered instance table over every tile of a w x h grid:
    per_tile splats around each tile, positive-definite conics, opacities
    in [0.2, 0.99]."""
    tx, ty = -(-w // ts), -(-h // ts)
    cols, starts = [], [0]
    for t in range(tx * ty):
        x0, y0 = (t % tx) * ts, (t // tx) * ts
        n = per_tile
        u = rng.uniform(x0 - 4, x0 + ts + 4, n)
        v = rng.uniform(y0 - 4, y0 + ts + 4, n)
        sx, sy = rng.uniform(1.0, 6.0, n), rng.uniform(1.0, 6.0, n)
        rho = rng.uniform(-0.7, 0.7, n)
        cxx, cyy, cxy = sx * sx, sy * sy, rho * sx * sy
        det = cxx * cyy - cxy * cxy
        lo = np.log(rng.uniform(0.2, 0.99, n))
        cols.append(np.concatenate([np.stack(
            [u, v, cyy / det, -cxy / det, cxx / det, lo]),
            rng.uniform(0, 1, (nch, n))], 0))
        starts.append(starts[-1] + n)
    return (torch.from_numpy(np.concatenate(cols, 1).astype(np.float32)),
            torch.tensor(starts, dtype=torch.int32))


def _dense_vjp(table, tile_start, cot, w, h, nch, ts=16):
    """float64 autograd of L = sum_ch g_ch C_ch - g_T T_fin per tile (the
    function whose VJP the backward computes), with the float32 cull and
    stop decisions of the forward held fixed. Per-pixel copies of u and v
    give the AbsGS sums."""
    tx = -(-w // ts)
    out = torch.zeros((9 + nch, table.shape[1]), dtype=torch.float64)
    amin, amax = float(f32(R.LOG_AMIN)), float(f32(R.LOG_AMAX))
    pix = torch.arange(ts * ts)
    for t in range(tile_start.numel() - 1):
        s0, e0 = int(tile_start[t]), int(tile_start[t + 1])
        k = e0 - s0
        if not k:
            continue
        px = ((t % tx) * ts + pix % ts).float() + 0.5
        py = ((t // tx) * ts + pix // ts).float() + 0.5
        tab = table[:, s0:e0]
        dx, dy = px[:, None] - tab[0], py[:, None] - tab[1]
        s32 = tab[5] - 0.5 * ((tab[2] * dx * dx + 2.0 * tab[3] * dx * dy)
                              + tab[4] * dy * dy)
        a32 = torch.exp(torch.clamp_max(s32, amax))
        trans = torch.ones(ts * ts)
        done = torch.zeros(ts * ts, dtype=torch.bool)
        app = torch.zeros((ts * ts, k), dtype=torch.bool)
        for j in range(k):
            q = trans * (1.0 - a32[:, j])
            on = (s32[:, j] >= amin) & ~done
            app[:, j] = on & (q >= R.T_EPS)
            trans = torch.where(app[:, j], q, trans)
            done |= on & (q < R.T_EPS)
        t64 = tab.double()
        uu = t64[0].expand(ts * ts, k).clone().requires_grad_()
        vv = t64[1].expand(ts * ts, k).clone().requires_grad_()
        rest = t64[2:].clone().requires_grad_()
        a, b, c, lo = rest[0], rest[1], rest[2], rest[3]
        ddx, ddy = px.double()[:, None] - uu, py.double()[:, None] - vv
        s = lo - 0.5 * (a * ddx * ddx + 2 * b * ddx * ddy + c * ddy * ddy)
        alpha = torch.where(app, torch.exp(torch.clamp_max(
            s, math.log(0.999))), torch.zeros((), dtype=torch.float64))
        cp = torch.cumprod(1 - alpha, 1)
        t_ex = torch.cat([torch.ones((ts * ts, 1), dtype=torch.float64),
                          cp[:, :-1]], 1)
        color = (alpha * t_ex) @ rest[4:4 + nch].T
        loss = ((cot[t, :nch].double().T * color).sum()
                - (cot[t, 7].double() * cp[:, -1]).sum())
        loss.backward()
        out[0, s0:e0], out[1, s0:e0] = uu.grad.sum(0), vv.grad.sum(0)
        out[2:5, s0:e0] = rest.grad[0:3]
        out[5, s0:e0] = rest.grad[3] * torch.exp(-lo.detach())
        out[6:6 + nch, s0:e0] = rest.grad[4:4 + nch]
        out[6 + nch, s0:e0] = uu.grad.abs().sum(0)
        out[7 + nch, s0:e0] = vv.grad.abs().sum(0)
        out[8 + nch, s0:e0] = (app & (s32 < amax)).sum(0).double()
    return out


@pytest.mark.parametrize("nch,per_tile,with_absgrad", [
    (3, 25, True), (7, 25, True), (3, 25, False), (3, 90, True)])
def test_backward_plain_matches_float64_autograd(nch, per_tile,
                                                 with_absgrad):
    """Every gradient row within 2e-5 of its largest magnitude (float32
    sums against float64), npix exactly; 90 splats a tile make pixels stop
    early."""
    rng = np.random.default_rng(nch + per_tile)
    w, h = 32, 16
    table, start = _random_table(rng, per_tile, w, h, nch)
    cot = torch.from_numpy(rng.standard_normal(
        (start.numel() - 1, 8, 256)).astype(np.float32))
    cot[:, nch:7] = 0.0
    fwd = R.rasterize_forward_plain(table, start, width=w, height=h, nch=nch)
    if per_tile == 90:
        assert float(fwd[:, R.ROW_T].min()) < 1e-3     # pixels stopped
    got = R.rasterize_backward_plain(table, start, cot, fwd, width=w,
                                     height=h, nch=nch,
                                     with_absgrad=with_absgrad)
    want = _dense_vjp(table, start, cot, w, h, nch)
    if not with_absgrad:
        want[6 + nch:8 + nch] = 0.0
    assert got.shape == (9 + nch, table.shape[1])
    assert torch.equal(got[8 + nch], want[8 + nch].float())
    for r in range(9 + nch):
        scale = float(want[r].abs().max()) + 1e-12
        err = float((got[r].double() - want[r]).abs().max()) / scale
        assert err < 2e-5, (r, err)


@pytest.mark.parametrize("with_absgrad", [True, False])
def test_backward_plain_abs_sums(with_absgrad):
    """``abs_sums``: the same gradient rows, and per entry the sum of its
    per-pixel terms' magnitudes, which is at least the entry's magnitude,
    equals the |du| |dv| rows in the du dv rows, and equals the entry in
    the rows whose terms are magnitudes (|du| |dv|, npix)."""
    rng = np.random.default_rng(11)
    w, h, nch = 32, 16, 3
    table, start = _random_table(rng, 25, w, h, nch)
    cot = torch.from_numpy(rng.standard_normal(
        (start.numel() - 1, 8, 256)).astype(np.float32))
    cot[:, nch:7] = 0.0
    kw = dict(width=w, height=h, nch=nch, with_absgrad=with_absgrad)
    fwd = R.rasterize_forward_plain(table, start, width=w, height=h, nch=nch)
    grads = R.rasterize_backward_plain(table, start, cot, fwd, **kw)
    g2, sums = R.rasterize_backward_plain(table, start, cot, fwd,
                                          abs_sums=True, **kw)
    assert torch.equal(grads, g2)
    assert (grads.abs() <= sums * (1 + 1e-6)).all()
    assert torch.equal(sums[6 + nch:], grads[6 + nch:])
    if with_absgrad:
        assert torch.equal(sums[0:2], grads[6 + nch:8 + nch])
    assert float(sums[:5].min()) >= 0.0 and float(sums[:5].max()) > 0.0


def test_nan_instances_are_culled_in_every_plain_kernel():
    """A NaN centre, radius or log-opacity culls the instance, as a
    log-opacity at the floor does, and contributes no NaN anywhere."""
    p, _, cam = _prep(6)
    g = int(torch.nonzero(p.counts > 0)[0, 0])
    keys, owners = B.expand_instances_plain(p, 4096, width=cam.width,
                                            height=cam.height)
    for field in ("u", "v", "rad2"):
        vals = getattr(p, field).clone()
        vals[g] = float("nan")
        k2, o2 = B.expand_instances_plain(p._replace(**{field: vals}), 4096,
                                          width=cam.width, height=cam.height)
        mine = o2 == g
        assert bool(mine.any()) and bool((k2[mine] == B.CULLED_KEY).all()), \
            field
        assert torch.equal(k2[~mine], keys[~mine])
        assert torch.equal(o2, owners)

    rng = np.random.default_rng(7)
    w, h, nch = 32, 16, 3
    table, start = _random_table(rng, 30, w, h, nch)
    cot = torch.from_numpy(rng.standard_normal(
        (start.numel() - 1, 8, 256)).astype(np.float32))
    cot[:, nch:7] = 0.0
    culled = table.clone()
    culled[R.ROW_LOGOP, [3, 17, 40]] = R.LOGOP_FLOOR
    nan = table.clone()
    nan[:, 3] = float("nan")                 # a whole NaN row
    nan[0, 17] = float("nan")                # a NaN u
    nan[R.ROW_LOGOP, 40] = float("nan")      # a NaN log-opacity
    kw = dict(width=w, height=h, nch=nch)
    f_nan = R.rasterize_forward_plain(nan, start, **kw)
    f_cul = R.rasterize_forward_plain(culled, start, **kw)
    assert torch.equal(f_nan, f_cul)
    g_nan = R.rasterize_backward_plain(nan, start, cot, f_nan, **kw)
    g_cul = R.rasterize_backward_plain(culled, start, cot, f_cul, **kw)
    assert torch.equal(g_nan, g_cul)
    assert float(g_nan[:, [3, 17, 40]].abs().max()) == 0.0


def test_reduce_grads_sorted_sums_each_gaussians_rows():
    """The reduce against a direct per-owner sum over the kept instances
    in float64 (6e-7 of the largest sum: float32 rounding)."""
    p, (proj, colors, opac), cam = _prep(8)
    sb = B.expand_sorted(proj.means2d, proj.conics, proj.depths, proj.radii,
                         proj.radii_xy, proj.rad2, colors, opac,
                         width=cam.width, height=cam.height,
                         instance_capacity=4096, guard_lanes=1024)
    rows = torch.from_numpy(np.random.default_rng(9).standard_normal(
        (12, 4096)).astype(np.float32))
    got = B.reduce_grads_sorted(rows, sb, nch=3)
    kept = int(sb.tile_start[-1])
    want = torch.zeros((12, colors.shape[0]), dtype=torch.float64)
    want.index_add_(1, sb.s_owner[:kept].long(), rows[:, :kept].double())
    for k, sl in (("means2d", slice(0, 2)), ("conics", slice(2, 5)),
                  ("colors", slice(6, 9)), ("absgrad", slice(9, 11))):
        np.testing.assert_allclose(got[k].T.numpy(), want[sl].numpy(),
                                   atol=6e-7 * float(want.abs().max()))
    np.testing.assert_allclose(got["opacity"].numpy(), want[5].numpy(),
                               atol=6e-7 * float(want.abs().max()))
    _, owners = B.expand_instances_plain(p, 4096, width=cam.width,
                                         height=cam.height)
    assert torch.equal(sb.s_owner, owners[sb.perm])


def test_image_to_tiles_inverts_tiles_to_image():
    img = torch.rand((7, 10, 2))
    tiles = R._image_to_tiles(img, 3, 2, 4)
    assert tiles.shape == (6, 2, 16)
    assert torch.equal(R._tiles_to_image(tiles, 3, 2, 4, 10, 7), img)
    # padding: x = 11 of tile 2 (row 0), y = 7 of tile 5 (last row)
    assert float(tiles[2, :, 3].abs().max()) == 0.0
    assert float(tiles[5, :, 12:].abs().max()) == 0.0


def test_frame_inputs_read_nothing_back_from_the_device():
    """A frame's projection and colours run with the splats and the camera
    on the meta device, where reading any tensor's value raises: a frame
    never waits on the card for its camera pose or its data."""
    params = random_scene(np.random.default_rng(0), 50, sh_degree=3,
                          capacity=56, device=CPU)
    meta = type(params)(**{f.name: getattr(params, f.name).to("meta")
                           for f in dataclasses.fields(params)})
    cam = orbit_cameras(1, width=64, height_px=48, device="meta")[0]
    proj, colors, opac = frame_inputs(meta, cam)
    assert proj.means2d.device.type == "meta"
    assert colors.shape == (56, 3) and opac.shape == (56,)


def test_wrappers_take_the_plain_version_on_cpu():
    p, (proj, colors, opac), cam = _prep(4)
    _build.reset_launches()
    k1, o1 = B.expand_instances(p, 4096, width=cam.width, height=cam.height)
    k2, o2 = B.expand_instances_plain(p, 4096, width=cam.width,
                                      height=cam.height)
    assert torch.equal(k1, k2) and torch.equal(o1, o2)
    sb = B.expand_sorted(proj.means2d, proj.conics, proj.depths, proj.radii,
                         proj.radii_xy, proj.rad2, colors, opac,
                         width=cam.width, height=cam.height,
                         instance_capacity=4096)
    f1 = R.rasterize_forward(sb.table, sb.tile_start, width=cam.width,
                             height=cam.height)
    f2 = R.rasterize_forward_plain(sb.table, sb.tile_start, width=cam.width,
                                   height=cam.height)
    assert torch.equal(f1, f2)
    cot = torch.rand((f1.shape[0], 8, 256))
    b1 = R.rasterize_backward(sb.table, sb.tile_start, cot, f1,
                              width=cam.width, height=cam.height)
    b2 = R.rasterize_backward_plain(sb.table, sb.tile_start, cot, f1,
                                    width=cam.width, height=cam.height)
    assert torch.equal(b1, b2)
    inv = torch.empty_like(sb.perm)
    inv[sb.perm] = torch.arange(4096)
    seg = (sb.g_offsets, sb.g_counts, range(12))
    assert torch.equal(R.segment_rows(b1, sb.tile_start, sb.perm, *seg),
                       R.segment_rows_plain(b1, sb.tile_start, inv.int(),
                                            *seg))
    assert _build.LAUNCHES == {"expand": 0, "forward": 0, "backward": 0,
                               "surfel_forward": 0, "surfel_backward": 0,
                               "segment_rows": 0}


def test_non_cpu_tensors_never_reach_the_plain_version():
    """A tensor on any device but the CPU goes to the kernel path, whose
    input checks reject what is not a CUDA tensor."""
    p, _, cam = _prep(5)
    meta = B.Prep(*[t.to("meta") for t in p])
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        B.expand_instances(meta, 1024, width=cam.width, height=cam.height)
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        R.rasterize_forward(torch.zeros((9, 4), device="meta"),
                            torch.zeros(21, dtype=torch.int32,
                                        device="meta"),
                            width=cam.width, height=cam.height)
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        R.rasterize_backward(torch.zeros((9, 4), device="meta"),
                             torch.zeros(21, dtype=torch.int32,
                                         device="meta"),
                             torch.zeros((20, 8, 256), device="meta"),
                             torch.zeros((20, 8, 256), device="meta"),
                             width=cam.width, height=cam.height)
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        R.segment_rows(torch.zeros((12, 4), device="meta"),
                       torch.zeros(21, dtype=torch.int32, device="meta"),
                       torch.zeros(4, dtype=torch.int32, device="meta"),
                       torch.zeros(3, dtype=torch.int32, device="meta"),
                       torch.zeros(3, dtype=torch.int32, device="meta"),
                       range(12))


class _OnCard:
    """A CPU tensor that reports a CUDA device, to reach the checks that
    follow the device check in ``_build.require``."""
    device = torch.device("cuda", 0)

    def __init__(self, t):
        self.t = t
        self.dtype, self.shape = t.dtype, t.shape

    def is_contiguous(self):
        return self.t.is_contiguous()


@pytest.mark.parametrize("bad,match", [
    (lambda t: t.double(), "dtype"),
    (lambda t: t[:4], "shape"),
    (lambda t: torch.zeros(16)[::2], None),
])
def test_require_rejects_bad_inputs(bad, match):
    t = torch.zeros(8, dtype=torch.float32)
    _build.require(_OnCard(t), "x", torch.float32, (8,))
    with pytest.raises(ValueError, match=match or "contiguous"):
        _build.require(_OnCard(bad(t)), "x", torch.float32, (8,))


def test_sort_instances_ranges_and_guard():
    depth_bits = 20
    tiles = np.array([3, 0, 3, 1, 0, 3], np.int64)
    keys = torch.tensor((((tiles << depth_bits) | np.arange(6))
                         - B.KEY_BIAS).tolist() + [B.CULLED_KEY] * 2,
                        dtype=torch.int32)
    owners = torch.arange(8, dtype=torch.int32)
    s_key, s_owner, start, perm = B.sort_instances(
        keys, owners, num_tiles=4, depth_bits=depth_bits, guard_lanes=0)
    assert start.tolist() == [0, 2, 3, 3, 6]
    assert s_owner.tolist() == [1, 4, 3, 0, 2, 5, 6, 7]
    assert perm.tolist() == s_owner.tolist()
    assert s_key[-1] == B.CULLED_KEY
    _, _, clamped, _ = B.sort_instances(keys, owners, num_tiles=4,
                                        depth_bits=depth_bits, guard_lanes=3)
    assert clamped.tolist() == [0, 2, 3, 3, 5]


def test_key_bits():
    assert B.key_bits(1920, 1080, 16) == (8160, 19)
    assert B.key_bits(64, 48, 16) == (12, 28)
    with pytest.raises(ValueError):
        B.key_bits(1 << 14, 1 << 14, 16)


def test_feature_table_and_tile_image_layout():
    n = 5
    means2d = torch.arange(2 * n, dtype=torch.float32).reshape(n, 2)
    conics = torch.ones((n, 3))
    colors = torch.rand((n, 3))
    opac = torch.tensor([0.5, 1.0, 0.0, 0.25, 1e-40])
    inst = torch.tensor([4, -1, 0, 2, 3], dtype=torch.int32)
    tab = R.build_feature_table(means2d, conics, colors, opac, inst)
    assert tab.shape == (9, 5)
    assert tab[0].tolist() == [8.0, 0.0, 0.0, 4.0, 6.0]
    assert tab[R.ROW_LOGOP, 1] == R.LOGOP_FLOOR          # dead instance
    assert tab[R.ROW_LOGOP, 3] == R.LOGOP_FLOOR          # zero opacity
    assert torch.equal(tab[6:, 2], colors[0])

    rows = torch.arange(6 * 2 * 16, dtype=torch.float32).reshape(6, 2, 16)
    img = R._tiles_to_image(rows, 3, 2, 4, 10, 7)
    assert img.shape == (7, 10, 2)
    # pixel (y, x) lies in tile (y // 4) * 3 + x // 4 at (y % 4) * 4 + x % 4
    assert img[5, 9, 1] == rows[1 * 3 + 2, 1, 1 * 4 + 1]


def test_build_raises_without_nvcc(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("NVCC", str(tmp_path / "missing"))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()


def test_build_reports_nvcc_stderr(tmp_path, monkeypatch):
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'error: no sm_90a here' >&2\nexit 2\n")
    fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("NVCC", str(fake))
    with pytest.raises(RuntimeError, match="no sm_90a here"):
        _build.build()
    assert not list((tmp_path / "build").glob("*.so"))


def test_library_path_follows_the_sources(tmp_path, monkeypatch):
    src = tmp_path / "csrc"
    src.mkdir()
    for f in _build.CSRC.iterdir():
        (src / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(_build, "CSRC", src)
    before = _build.library_path()
    assert before == _build.library_path()
    (src / "forward.cu").write_text((src / "forward.cu").read_text() + "\n")
    assert _build.library_path() != before


def _read_png(path):
    data = open(path, "rb").read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, chunks = 8, {}
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        assert crc == zlib.crc32(tag + body) & 0xFFFFFFFF
        chunks[tag] = body
        pos += 12 + n
    w, h = struct.unpack(">II", chunks[b"IHDR"][:8])
    raw = np.frombuffer(zlib.decompress(chunks[b"IDAT"]), np.uint8)
    rows = raw.reshape(h, 1 + 3 * w)
    assert (rows[:, 0] == 0).all()
    return rows[:, 1:].reshape(h, w, 3)


def test_write_png_round_trip(tmp_path):
    img = np.random.default_rng(0).integers(0, 256, (7, 5, 3), np.uint8)
    app.write_png(str(tmp_path / "a.png"), img)
    np.testing.assert_array_equal(_read_png(str(tmp_path / "a.png")), img)


def _write_ply(path, n, rng):
    names = (["x", "y", "z", "f_dc_0", "f_dc_1", "f_dc_2"]
             + [f"f_rest_{i}" for i in range(45)]
             + ["opacity", "scale_0", "scale_1", "scale_2",
                "rot_0", "rot_1", "rot_2", "rot_3"])
    rec = rng.standard_normal((n, 59)).astype(np.float32)
    rec[:, 0:3] *= 0.5
    rec[:, 6:51] *= 0.05
    rec[:, 51] = 2.0
    rec[:, 52:55] = np.log(0.05)
    head = ("ply\nformat binary_little_endian 1.0\n"
            f"element vertex {n}\n"
            + "".join(f"property float {nm}\n" for nm in names)
            + "end_header\n")
    with open(path, "wb") as f:
        f.write(head.encode() + rec.tobytes())
    return rec


def test_render_app_fast_path(tmp_path):
    rec = _write_ply(tmp_path / "m.ply", 200, np.random.default_rng(1))
    params, meta = load_model(str(tmp_path / "m.ply"), device=CPU)
    assert meta == {"antialiased": False, "sh_degree": 3}
    np.testing.assert_array_equal(params.means.numpy(), rec[:, :3])
    np.testing.assert_array_equal(params.shN[:, :, 1].numpy(),
                                  rec[:, 21:36])
    out = tmp_path / "shots"
    assert app.main(["--model", str(tmp_path / "m.ply"), "--out", str(out),
                     "--orbit", "2", "--width", "40", "--height", "24",
                     "--fast", "--device", CPU]) == 0
    pngs = sorted(os.listdir(out))
    assert pngs == ["00000.png", "00001.png"]
    img = _read_png(str(out / pngs[0]))
    assert img.shape == (24, 40, 3) and img.max() > 0


def test_render_app_unported_options(tmp_path):
    _write_ply(tmp_path / "m.ply", 10, np.random.default_rng(2))
    # the non-fast path, --video and XLA's backends are ported: the
    # "tiles" and "dense" views match the kernel route's
    assert app.main(["--model", str(tmp_path / "m.ply"), "--orbit", "1",
                     "--width", "16", "--height", "16", "--out",
                     str(tmp_path / "shots"), "--video",
                     str(tmp_path / "x.avi"), "--device", CPU]) == 0
    assert (tmp_path / "x.avi").read_bytes()[:4] == b"RIFF"
    want = _read_png(str(tmp_path / "shots" / "00000.png")).astype(int)
    for backend in ("tiles", "dense"):
        out = tmp_path / backend
        assert app.main(["--model", str(tmp_path / "m.ply"), "--orbit", "1",
                         "--width", "16", "--height", "16", "--backend",
                         backend, "--out", str(out), "--device", CPU]) == 0
        got = _read_png(str(out / "00000.png")).astype(int)
        assert np.abs(got - want).max() <= 1, backend
    # the other formats are ported now: a four-byte file fails as each
    # format's reader fails on it (JAX's alike), or holds no splat
    import gzip
    (tmp_path / "m.splat").write_bytes(b"ply\n")
    assert load_model(str(tmp_path / "m.splat"), device=CPU)[0].capacity == 0
    (tmp_path / "m.compressed.ply").write_bytes(b"ply\n")
    with pytest.raises(ValueError, match="unexpected EOF in PLY header"):
        load_model(str(tmp_path / "m.compressed.ply"), device=CPU)
    (tmp_path / "m.spz").write_bytes(b"ply\n")
    with pytest.raises(gzip.BadGzipFile):
        load_model(str(tmp_path / "m.spz"), device=CPU)
