"""The plain versions of the surfel kernels on their own, on the CPU: the
backward against float64 autograd of a dense per-tile reference, NaN and
edge-on instances, the pair counts, and the wrappers' dispatch and input
checks. (Parity with the JAX package is in ``test_torch_surfel_parity``.)
"""

import numpy as np
import pytest
import torch

from divshot_tpu_torch import _build
from divshot_tpu_torch.gsio.synthetic import orbit_cameras, random_scene
from divshot_tpu_torch.raster import bin as B
from divshot_tpu_torch.raster import surfel_raster as SR
from divshot_tpu_torch.raster.surfel import T_EPS, project_surfels

CPU = "cpu"
W, H = 32, 16


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _table(n: int, nch: int, seed: int, opacity=(0.5, 3.0),
           scale_range=(0.02, 0.12)):
    """A surfel table and its tile ranges from a projected random scene of
    ``n`` splats at W x H, their opacity logits drawn from ``opacity``."""
    rng = np.random.default_rng(seed)
    params = random_scene(rng, n, scale_range=scale_range, device=CPU)
    cam = orbit_cameras(1, width=W, height_px=H, radius=3.0, device=CPU)[0]
    pr = project_surfels(params.means, params.scales, params.quats, cam)
    sb = B.expand_sorted(pr["center2d"], None, pr["depths"], pr["radii"],
                         None, None, None, None, width=W, height=H,
                         instance_capacity=1 << 13, build_table=False)
    op = torch.tensor(rng.uniform(*opacity, n).astype(np.float32))
    cols = torch.tensor(rng.uniform(-1, 1, (n, nch)).astype(np.float32))
    table = SR.build_surfel_table(pr["Tmat"], pr["zplane"], pr["center2d"],
                                  torch.sigmoid(op), cols, sb.s_owner)
    return table, sb.tile_start


def _with_clamps(table, start):
    """The table with the first instance of each non-empty tile replaced by
    a fronto-parallel surfel of opacity 1 centred on one of the tile's
    pixel centres, where its alpha clamps at 0.999."""
    t = table.clone()
    for k in range(start.numel() - 1):
        if start[k + 1] == start[k]:
            continue
        c = int(start[k])
        x0 = (k % (W // 16)) * 16 + 3.5
        y0 = (k // (W // 16)) * 16 + 5.5
        d, fs = 2.0, 4.0
        t[0:9, c] = torch.tensor([fs, 0.0, x0 * d, 0.0, fs, y0 * d,
                                  0.0, 0.0, d])
        t[SR.ROW_ZP:SR.ROW_C2D + 2, c] = torch.tensor([0.0, 0.0, d, x0, y0])
        t[SR.ROW_OP, c] = 1.0
    return t


def _cotangent(num_tiles: int, nch: int, seed: int) -> torch.Tensor:
    cot = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (num_tiles, 8, 256)).astype(np.float32))
    cot[:, nch:SR.ROW_Z] = 0.0
    cot[:, SR.ROW_Z:SR.ROW_Z2 + 1] *= 0.1
    return cot


def _decisions(table, s0: int, e0: int, t: int, nch: int):
    """The plain kernels' float32 terms of tile t and, per (pixel,
    instance), whether the instance was applied, by a sequential walk."""
    terms = SR._chunk_terms(table, torch.tensor([t]), torch.tensor([s0]),
                            torch.tensor([e0 - s0]), 0, e0 - s0, nch,
                            -(-W // 16), 16)
    ok, alpha = terms["ok"][0], terms["alpha"][0]
    trans = torch.ones(256)
    done = torch.zeros(256, dtype=torch.bool)
    app = torch.zeros_like(ok)
    for j in range(e0 - s0):
        q = trans * (1.0 - alpha[:, j])
        on = ok[:, j] & ~done
        app[:, j] = on & (q >= np.float32(T_EPS))
        trans = torch.where(app[:, j], q, trans)
        done |= on & (q < np.float32(T_EPS))
    return terms, app


def _dense_vjp(table, start, cot, nch):
    """float64 autograd, per tile, of the surfel compositing of the
    applied pairs (the float32 decisions fixed), with a per-(pixel,
    instance) screen shift whose gradient gives the ds and |ds| rows."""
    out = torch.zeros((SR.ngrad_rows(nch), table.shape[1]),
                      dtype=torch.float64)
    f64 = torch.float64
    for t in range(start.numel() - 1):
        s0, e0 = int(start[t]), int(start[t + 1])
        if e0 == s0:
            continue
        terms, app = _decisions(table, s0, e0, t, nch)
        k = e0 - s0
        rows = table[:SR.ROW_CH + nch, s0:e0].double().clone() \
            .requires_grad_()
        shift = torch.zeros((2, 256, k), dtype=f64, requires_grad=True)
        x = terms["x"][0].double() - shift[0]
        y = terms["y"][0].double() - shift[1]
        hu = [x * rows[6 + i] - rows[i] for i in range(3)]
        hv = [y * rows[6 + i] - rows[3 + i] for i in range(3)]
        p0 = hu[1] * hv[2] - hu[2] * hv[1]
        p1 = hu[2] * hv[0] - hu[0] * hv[2]
        p2 = hu[0] * hv[1] - hu[1] * hv[0]
        p2 = torch.where(app, p2, torch.ones((), dtype=f64))
        u, v = p0 / p2, p1 / p2
        dx, dy = x - rows[SR.ROW_C2D], y - rows[SR.ROW_C2D + 1]
        rho = torch.where(terms["sel"][0], u * u + v * v,
                          2.0 * (dx * dx + dy * dy))
        a = rows[SR.ROW_OP] * torch.exp(-0.5 * rho)
        clamped = terms["a"][0] >= np.float32(0.999)
        zero = torch.zeros((), dtype=f64)
        alpha = torch.where(app, torch.where(clamped, 0.999 + zero, a), zero)
        cp = torch.cumprod(1.0 - alpha, 1)
        t_ex = torch.cat([torch.ones((256, 1), dtype=f64), cp[:, :-1]], 1)
        w = alpha * t_ex
        z = torch.where(app, (rows[SR.ROW_ZP] * u + rows[SR.ROW_ZP + 1] * v)
                        + rows[SR.ROW_ZP + 2], zero)
        wd = w.detach()
        c = cot[t].double()
        color = w @ rows[SR.ROW_CH:SR.ROW_CH + nch].T           # (256, nch)
        loss = ((c[:nch].T * color).sum()
                + (c[SR.ROW_Z] * (wd * z).sum(1)).sum()
                + (c[SR.ROW_Z2] * (wd * z * z).sum(1)).sum()
                - (c[SR.ROW_T] * cp[:, -1]).sum())
        loss.backward()
        rds = SR.ROW_CH + nch
        out[:rds, s0:e0] = rows.grad
        out[rds:rds + 2, s0:e0] = shift.grad.sum(1)
        out[rds + 2:rds + 4, s0:e0] = shift.grad.abs().sum(1)
        out[rds + 4, s0:e0] = (app & ~clamped).sum(0).double()
    return out


# an opaque scene: large splats at opacity 1 stop pixels early, and clamp
# alpha where a pixel lies near a splat's centre
OPAQUE = dict(opacity=(20.0, 30.0), scale_range=(0.2, 0.8))


@pytest.mark.parametrize("nch,n,opaque", [
    (5, 40, False), (3, 40, False), (5, 120, True)])
def test_surfel_backward_plain_matches_float64_autograd(nch, n, opaque):
    """Every row within 1e-4 of its largest magnitude, npix exactly: the
    float32 per-pixel terms of the geometry chain (cross products, the
    division by p2) partly cancel in each instance's sum over the tile's
    pixels, so they come within ~2.5e-5 of float64, not the 3DGS rows'
    2e-5. The last case has opaque splats, so pixels stop early and alphas
    clamp."""
    table, start = _table(n, nch, seed=n + nch, **(OPAQUE if opaque else {}))
    if opaque:
        table = _with_clamps(table, start)
    cot = _cotangent(start.numel() - 1, nch, nch)
    kw = dict(width=W, height=H, nch=nch)
    fwd = SR.surfel_forward_plain(table, start, **kw)
    if opaque:
        assert float(fwd[:, SR.ROW_T].min()) < 1e-3     # pixels stopped
    got = SR.surfel_backward_plain(table, start, cot, fwd, **kw)
    want = _dense_vjp(table, start, cot, nch)
    assert got.shape == (SR.ngrad_rows(nch), table.shape[1])
    assert float(want[-1].sum()) > 100
    assert torch.equal(got[-1], want[-1].float())
    for r in range(SR.ngrad_rows(nch) - 1):
        scale = float(want[r].abs().max()) + 1e-12
        err = float((got[r].double() - want[r]).abs().max()) / scale
        assert err < 1e-4, (r, err)


def _degenerate(table, start):
    """The table with NaN columns (all rows; one T entry; one zplane entry;
    the opacity), one exactly edge-on surfel (p2 = 0) and two nearly
    edge-on ones with a constant depth plane, -> (table, the NaN columns,
    the edge-on columns)."""
    t = table.clone()
    n = int(start[-1])
    cols = torch.linspace(0, n - 1, 7).long().tolist()
    nan = cols[:4]
    t[:, nan[0]] = float("nan")
    t[4, nan[1]] = float("nan")
    t[SR.ROW_ZP + 2, nan[2]] = float("nan")
    t[SR.ROW_OP, nan[3]] = float("nan")
    edge = cols[4:]
    for c, eps in zip(edge, (0.0, 1e-3, 1e-6)):
        t[3:6, c] = 2.0 * t[0:3, c]
        t[4, c] = t[4, c] * (1.0 + eps)
        t[6:8, c] = 0.0
        t[SR.ROW_ZP:SR.ROW_ZP + 2, c] = 0.0
        t[SR.ROW_OP, c] = 0.9
    return t, nan, edge


@pytest.mark.parametrize("nch", [5, 3])
def test_nan_and_edge_on_instances_in_the_plain_kernels(nch):
    """A NaN in any row culls the instance as opacity 0 does, in both plain
    kernels, and adds exact zeros; edge-on surfels keep every output
    finite."""
    table, start = _table(60, nch, seed=3)
    cot = _cotangent(start.numel() - 1, nch, 9)
    kw = dict(width=W, height=H, nch=nch)
    bad, nan, edge = _degenerate(table, start)
    culled = bad.clone()
    culled[SR.ROW_OP, nan] = 0.0
    culled[:, nan[0]] = 0.0
    f_bad = SR.surfel_forward_plain(bad, start, **kw)
    f_cul = SR.surfel_forward_plain(culled, start, **kw)
    assert torch.isfinite(f_bad).all()
    assert torch.equal(f_bad, f_cul)
    g_bad = SR.surfel_backward_plain(bad, start, cot, f_bad, **kw)
    g_cul = SR.surfel_backward_plain(culled, start, cot, f_cul, **kw)
    assert torch.isfinite(g_bad).all()
    assert torch.equal(g_bad, g_cul)
    assert not g_bad[:, nan].any()
    assert not g_bad[:, edge[0]].any()          # p2 = 0: culled


def test_surfel_forward_plain_counts_pairs():
    """The pair classes against a sequential walk of each tile, and the
    per-tile reads up to the furthest stop."""
    nch = 3
    table, start = _table(120, nch, seed=5, **OPAQUE)
    table = _with_clamps(table, start)
    out, counts, reach = SR.surfel_forward_plain(
        table, start, width=W, height=H, nch=nch, count_pairs=True)
    want = np.zeros(5, np.int64)
    for t in range(start.numel() - 1):
        s0, e0 = int(start[t]), int(start[t + 1])
        terms, app = _decisions(table, s0, e0, t, nch)
        ok = terms["ok"][0]
        passed = torch.zeros_like(ok)
        stop = torch.full((256,), e0 - s0)
        trans = torch.ones(256)
        for j in range(e0 - s0):
            on = ok[:, j] & (stop == e0 - s0)
            q = trans * (1.0 - terms["alpha"][0][:, j])
            passed[:, j] = on
            stop = torch.where(on & (q < np.float32(T_EPS)), j, stop)
            trans = torch.where(app[:, j], q, trans)
        evaluated = torch.clamp_max(stop + 1, e0 - s0)
        shaded = ((terms["p2"][0].abs() > np.float32(1e-9))
                  & (terms["a"][0] >= np.float32(1 / 255))
                  & (torch.arange(e0 - s0) < evaluated[:, None]))
        live = app & (terms["a"][0] < np.float32(0.999))
        want += [int(evaluated.sum()), int(shaded.sum()), int(passed.sum()),
                 int(app.sum()), int(live.sum())]
        assert int(reach[t]) == int(evaluated.max())
    assert tuple(counts) == tuple(want)
    assert (counts.evaluated > counts.shaded >= counts.passed
            > counts.applied > counts.live)


@pytest.mark.parametrize("nch", [5, 3])
def test_surfel_backward_plain_abs_sums(nch):
    """``abs_sums``: the same gradient rows, and per entry the sum of its
    per-pixel terms' magnitudes, which is at least the entry's magnitude,
    equals it in the rows whose terms are magnitudes (|ds|, npix), equals
    the |ds| rows in the signed ds rows, and is 0 on NaN and edge-on
    columns."""
    table, start = _table(60, nch, seed=3)
    bad, nan, edge = _degenerate(table, start)
    cot = _cotangent(start.numel() - 1, nch, 9)
    kw = dict(width=W, height=H, nch=nch)
    fwd = SR.surfel_forward_plain(bad, start, **kw)
    grads = SR.surfel_backward_plain(bad, start, cot, fwd, **kw)
    g2, sums = SR.surfel_backward_plain(bad, start, cot, fwd, abs_sums=True,
                                        **kw)
    assert torch.equal(grads, g2)
    assert (grads.abs() <= sums * (1 + 1e-6)).all()
    assert torch.equal(sums[-5:-3], grads[-3:-1])
    assert torch.equal(sums[-3:], grads[-3:])
    assert (sums[:, 1:].sum(0) > 0).any()
    assert not sums[:, nan].any() and not sums[:, edge[0]].any()


def test_surfel_wrappers_take_the_plain_version_on_cpu():
    table, start = _table(40, 5, seed=1)
    kw = dict(width=W, height=H, nch=5)
    _build.reset_launches()
    out = SR.surfel_forward(table, start, **kw)
    assert torch.equal(out, SR.surfel_forward_plain(table, start, **kw))
    cot = _cotangent(start.numel() - 1, 5, 2)
    assert torch.equal(SR.surfel_backward(table, start, cot, out, **kw),
                       SR.surfel_backward_plain(table, start, cot, out, **kw))
    assert _build.LAUNCHES["surfel_forward"] == 0
    assert _build.LAUNCHES["surfel_backward"] == 0


def test_surfel_wrappers_never_run_plain_on_other_devices():
    """A tensor that is not on the CPU goes to the kernel's input checks
    (and raises there without a card), never to the plain version."""
    table = torch.zeros((24, 64), device="meta")
    start = torch.zeros((3,), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        SR.surfel_forward(table, start, width=W, height=H)
    with pytest.raises(ValueError, match="CUDA"):
        SR.surfel_backward(table, start, table, table, width=W, height=H)
    with pytest.raises(ValueError, match="nch"):
        SR.surfel_forward(table, start, width=W, height=H, nch=6)


def test_dead_and_transparent_splats_get_no_instances():
    """A splat whose opacity is below 1/255 (the dead capacity padding, or
    an alive one nearly transparent) is left out of the binning; the image,
    the planes and the gradients of the others are those of the scene
    without it, and the projection keeps its radius."""
    import dataclasses
    from divshot_tpu_torch.raster.surfel_raster import render_surfels
    params = random_scene(np.random.default_rng(8), 50, capacity=80,
                          scale_range=(0.05, 0.2), device=CPU)
    op = params.opacity.clone()
    op[3] = -7.0                              # sigmoid(-7) < 1/255
    params = dataclasses.replace(params, opacity=op)
    cam = orbit_cameras(1, width=W, height_px=H, radius=3.0, device=CPU)[0]
    keep = torch.ones(80, dtype=torch.bool)
    keep[3] = False
    keep[50:] = False
    small = dataclasses.replace(params, **{
        f: getattr(params, f)[keep] for f in ("means", "scales", "quats",
                                              "opacity", "sh0", "shN",
                                              "alive")})
    outs = []
    for p in (params, small):
        leaves = {f: getattr(p, f).clone().requires_grad_() for f in
                  ("means", "scales", "quats", "opacity", "sh0")}
        out = render_surfels(dataclasses.replace(p, **leaves), cam,
                             instance_capacity=1 << 13)
        (out.image.sum() + out.extra.sum()).backward()
        outs.append((out, leaves))
    (full, g_full), (ref, g_ref) = outs
    assert int(full.num_instances) == int(ref.num_instances) > 0
    assert bool((full.proj.radii[50:] > 0).all())     # still projected
    for a, b in ((full.image, ref.image), (full.alpha, ref.alpha),
                 (full.extra, ref.extra)):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)
    for f in g_full:
        torch.testing.assert_close(g_full[f].grad[keep], g_ref[f].grad,
                                   rtol=1e-5, atol=1e-6)
        assert not g_full[f].grad[~keep].any()


def test_surfel_table_layout():
    n, nch = 5, 3
    rng = np.random.default_rng(0)
    Tm = torch.tensor(rng.standard_normal((n, 3, 3)).astype(np.float32))
    zp, c2 = torch.randn(n, 3), torch.randn(n, 2)
    op, cols = torch.rand(n), torch.rand(n, nch)
    inst = torch.tensor([2, -1, 4, B.NO_OWNER, 0], dtype=torch.int32)
    tab = SR.build_surfel_table(Tm, zp, c2, op, cols, inst)
    assert tab.shape == (SR.feat_rows(nch), 5) == (24, 5)
    assert torch.equal(tab[0:9, 0], Tm[2].reshape(9))
    assert torch.equal(tab[SR.ROW_ZP:SR.ROW_ZP + 3, 2], zp[4])
    assert torch.equal(tab[SR.ROW_C2D:SR.ROW_C2D + 2, 4], c2[0])
    assert torch.equal(tab[SR.ROW_CH:SR.ROW_CH + nch, 0], cols[2])
    assert tab[SR.ROW_OP].tolist() == [float(op[2]), 0.0, float(op[4]), 0.0,
                                       float(op[0])]
    assert not tab[SR.ROW_CH + nch:].any()
    assert SR.ngrad_rows(5) == 25 and SR.feat_rows(5) == 24
