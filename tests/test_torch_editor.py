"""The editor's edit side in the port against the JAX package on the CPU:
``EditSession`` through one script of every op (state bits and selection
masks equal but at float ties, counted and bounded; params within atol
1e-5, SH after a rotation within 1e-5 of the largest coefficient; undo
and redo depths equal; an undo restoring the params and state bitwise),
the palettes compared by their tables and their ``apply`` / ``bake``,
``rotate_sh``, ``sh_rotation_matrix``, ``rotmat_to_quat``,
``quat_multiply``, ``composite_dense``'s three falloffs (atol 1e-5) and
``apps.edit`` (output bytes, ``--stats`` lines, ``--html`` bytes).

A float tie: a splat whose (projected) centre lies within 1e-4 (pixels
on the screen tools, world units on the box and sphere) of the tool's
boundary, where float32 rounding decides the side. Ties are not moved
away from; where one flips, the port's state takes JAX's bits so the
script goes on in step.
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from divshot_tpu.apps import edit as jax_edit_app
from divshot_tpu.edit import ops as JO
from divshot_tpu.gsio.io import save_model as jax_save_model
from divshot_tpu.gsio.synthetic import orbit_cameras as jax_orbit
from divshot_tpu.gsio.synthetic import random_scene as jax_random_scene
from divshot_tpu.raster import dense as JD
from divshot_tpu.raster.project import project_gaussians as jax_project
from divshot_tpu.splat import math as JM
from divshot_tpu.splat import sh as JSH
from divshot_tpu.splat.color_palette import SplatPaintColorPalette as JPaint
from divshot_tpu.splat.transform_palette import SplatTransformPalette as JPal

from divshot_tpu_torch.apps import edit as edit_app
from divshot_tpu_torch.edit import ops as TO
from divshot_tpu_torch.raster import dense as TD
from divshot_tpu_torch.raster.project import project_gaussians
from divshot_tpu_torch.splat import math as TM
from divshot_tpu_torch.splat import sh as TSH
from divshot_tpu_torch.splat.color_palette import SplatPaintColorPalette
from divshot_tpu_torch.splat.gaussians import GaussianParams
from divshot_tpu_torch.splat.transform_palette import SplatTransformPalette
from tests.test_torch_train_options import _camera

CPU = "cpu"
FIELDS = ("means", "scales", "quats", "opacity", "sh0", "shN", "alive")
TIE = 1e-4
MAX_TIES = 3


def _carry(jp) -> GaussianParams:
    return GaussianParams.from_numpy(
        {f: np.asarray(getattr(jp, f)) for f in FIELDS}, device=CPU)


def _scene(n=400, capacity=430, seed=0, sh_degree=3):
    jp = jax_random_scene(np.random.default_rng(seed), n,
                          sh_degree=sh_degree, capacity=capacity)
    return jp, _carry(jp)


def _rot(axis, deg):
    th = np.radians(deg)
    c, s = np.cos(th), np.sin(th)
    a, b = [(1, 2), (0, 2), (0, 1)][axis]
    r = np.eye(3)
    r[a, a], r[a, b], r[b, a], r[b, b] = c, -s, s, c
    return r


def _affine(R, t=(0, 0, 0), scale=1.0):
    m = np.eye(4)
    m[:3, :3] = R * scale
    m[:3, 3] = t
    return m


def _same_params(tp, jp, sh_scale_tol=True):
    for f in FIELDS:
        a, b = getattr(tp, f).numpy(), np.asarray(getattr(jp, f))
        if f == "alive":
            np.testing.assert_array_equal(a, b)
        elif f == "shN" and sh_scale_tol:
            # after a rotation: within 1e-5 of the largest coefficient
            np.testing.assert_allclose(
                a, b, rtol=0, atol=1e-5 * max(float(np.abs(b).max()), 1e-30))
        else:
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-5, err_msg=f)


# --------------------------------------------------------------------------
# math and SH rotation


def _rotations(rng, n):
    """Random rotations plus one near each of Shepperd's four cases."""
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    Rs = np.asarray(JM.quat_to_rotmat(jnp.asarray(q, jnp.float32)))
    special = np.stack([np.eye(3), _rot(0, 179), _rot(1, 179),
                        _rot(2, 179)]).astype(np.float32)
    return np.concatenate([Rs, special])


def test_rotmat_to_quat_and_quat_multiply_match_jax():
    rng = np.random.default_rng(0)
    Rs = _rotations(rng, 300)
    jq = np.asarray(JM.rotmat_to_quat(jnp.asarray(Rs)))
    tq = TM.rotmat_to_quat(torch.as_tensor(Rs)).numpy()
    # every case of the four is taken
    tr = Rs[:, 0, 0] + Rs[:, 1, 1] + Rs[:, 2, 2]
    assert (tr > 0).any() and (tr <= 0).sum() >= 3
    np.testing.assert_allclose(tq, jq, rtol=0, atol=1e-6)
    a = rng.normal(size=(64, 4)).astype(np.float32)
    b = rng.normal(size=(64, 4)).astype(np.float32)
    np.testing.assert_array_equal(
        TM.quat_multiply(torch.as_tensor(a), torch.as_tensor(b)).numpy(),
        np.asarray(JM.quat_multiply(jnp.asarray(a), jnp.asarray(b))))
    x = rng.normal(size=(50, 3)).astype(np.float32)
    r = [float(v) for v in rng.normal(size=3).astype(np.float32)]
    np.testing.assert_array_equal(
        TM.dot3(r, torch.as_tensor(x)).numpy(),
        np.asarray(JM.dot3(jnp.asarray(r, jnp.float32), jnp.asarray(x))))


@pytest.mark.parametrize("degree", [1, 2, 3])
def test_sh_rotation_matches_jax(degree):
    rng = np.random.default_rng(degree)
    R = _rot(0, 30) @ _rot(1, -70) @ _rot(2, 115)
    np.testing.assert_array_equal(TSH.sh_rotation_matrix(R, degree),
                                  JSH.sh_rotation_matrix(R, degree))
    np.testing.assert_array_equal(
        TSH._sh_basis_np(R, degree), JSH._sh_basis_np(R, degree))
    k = TSH.NUM_SH_REST[degree]
    shN = rng.normal(size=(200, k, 3)).astype(np.float32) * 0.1
    jr = np.asarray(JSH.rotate_sh(jnp.asarray(shN), R))
    tr = TSH.rotate_sh(torch.as_tensor(shN), R).numpy()
    np.testing.assert_allclose(tr, jr, rtol=0,
                               atol=1e-5 * float(np.abs(jr).max()))
    # the radiance field turns with the splats: rotated coefficients at
    # R d equal the old ones at d
    d = rng.normal(size=(200, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    sh0 = np.zeros((200, 3), np.float32)
    before = TSH.eval_sh_color(torch.as_tensor(sh0), torch.as_tensor(shN),
                               torch.as_tensor(d.astype(np.float32)))
    after = TSH.eval_sh_color(torch.as_tensor(sh0), torch.from_numpy(tr),
                              torch.as_tensor((d @ R.T).astype(np.float32)))
    torch.testing.assert_close(after, before, atol=1e-5, rtol=0)


# --------------------------------------------------------------------------
# palettes


def test_palettes_match_jax():
    jp, tp = _scene(n=120, capacity=128)
    rng = np.random.default_rng(3)
    masks = [rng.random(128) < 0.3 for _ in range(3)]
    jpal, tpal = JPal(128), SplatTransformPalette(128, device=CPU)
    jpaint, tpaint = JPaint(128), SplatPaintColorPalette(128, device=CPU)
    mats = [_affine(_rot(1, 40), (0.2, -0.1, 0.3), 1.3),
            _affine(_rot(2, -75) @ _rot(0, 20), (0, 0.5, 0)),
            _affine(np.eye(3), (1, 2, 3), 0.5)]
    colors = [(1.0, 0.0, 0.0), (0.2, 0.9, 0.4), (1.0, 0.0, 0.0)]
    for m, c, mask in zip(mats, colors, masks):
        assert tpal.add(m) == jpal.add(m)
        assert tpaint.add(c) == jpaint.add(c)
        tpal.assign(torch.as_tensor(mask), len(tpal.matrices) - 1)
        jpal.assign(jnp.asarray(mask), len(jpal.matrices) - 1)
        tpaint.assign(torch.as_tensor(mask), tpaint.add(c))
        jpaint.assign(jnp.asarray(mask), jpaint.add(c))
    with pytest.raises(IndexError):
        tpal.assign(torch.as_tensor(masks[0]), 9)
    for a, b in zip(tpal.matrices, jpal.matrices):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(tpaint.colors, jpaint.colors):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tpal.indices.numpy(),
                                  np.asarray(jpal.indices))
    np.testing.assert_array_equal(tpaint.indices.numpy(),
                                  np.asarray(jpaint.indices))
    _same_params(tpal.apply(tp), jpal.apply(jp))
    _same_params(tpaint.apply(tp), jpaint.apply(jp))
    _same_params(tpaint.bake(tpal.bake(tp)), jpaint.bake(jpal.bake(jp)))
    assert tpal.num_entries == jpal.num_entries == 1
    assert tpaint.num_entries == jpaint.num_entries == 1
    assert not tpal.indices.any() and not tpaint.indices.any()
    tpaint.assign(torch.as_tensor(masks[0]), tpaint.add((0.5, 0.5, 0.5)))
    tpaint.clear(torch.ones(128, dtype=torch.bool))
    assert not tpaint.indices.any()


# --------------------------------------------------------------------------
# the session


def _boundary_distance(kind, args, jp, jcam):
    """float64 distance of every splat's (projected) centre to the
    boundary of one tool."""
    means = np.asarray(jp.means, np.float64)
    if kind in ("rect", "brush", "polygon", "pick"):
        V = np.asarray(jcam.viewmat, np.float64)
        p = means @ V[:3, :3].T + V[:3, 3]
        z = np.maximum(p[:, 2], 1e-6)
        s = np.stack([float(jcam.fx) * p[:, 0] / z + float(jcam.cx),
                      float(jcam.fy) * p[:, 1] / z + float(jcam.cy)], -1)
    if kind == "sphere":
        center, r = args
        return np.abs(np.linalg.norm(means - center, axis=1) - r)
    if kind == "box":
        lo, hi, m = args
        if m is not None:
            inv = np.linalg.inv(m)
            means = means @ inv[:3, :3].T + inv[:3, 3]
        return np.minimum(np.abs(means - lo), np.abs(means - hi)).min(1)
    if kind == "rect":
        x0, y0, x1, y1 = args
        return np.minimum(np.abs(s[:, :1] - [x0, x1]).min(1),
                          np.abs(s[:, 1:] - [y0, y1]).min(1))
    if kind == "brush":
        pts, r = args
        d = np.linalg.norm(s[:, None] - np.asarray(pts)[None], axis=-1)
        return np.abs(d.min(1) - r)
    # polygon: distance to its edges
    poly = np.asarray(args, np.float64)
    a, b = poly, np.roll(poly, -1, 0)
    ab = b - a
    t = np.clip(((s[:, None] - a[None]) * ab[None]).sum(-1)
                / (ab * ab).sum(-1)[None], 0, 1)
    return np.linalg.norm(s[:, None] - (a[None] + t[..., None] * ab[None]),
                          axis=-1).min(1)


def _script(jcam, cam):
    """(description, jax call, port call, tool kind, tool args)."""
    stroke = np.stack([np.linspace(8, 56, 8), 24 + 8 * np.sin(
        np.linspace(0, 3, 8))], -1).astype(np.float32)
    poly = np.array([[5, 5], [60, 8], [50, 40], [20, 44], [8, 30]],
                    np.float32)
    m_box = _affine(_rot(2, 30), (0.1, 0.2, -0.1))
    m_rot = _affine(_rot(0, 35) @ _rot(1, 50), (0.3, -0.2, 0.1), 1.25)
    m_pal = _affine(_rot(2, 60), (0.0, 0.4, 0.0))
    box_lo, box_hi = np.array([-1, -1, -1.0]), np.array([1, 0.5, 1.0])
    s = []

    def op(desc, name, *args, kind=None, targs=None, tool_args=None,
           **kw):
        s.append((desc,
                  lambda js: getattr(js, name)(*(jcam if a is cam else a
                                                 for a in args), **kw),
                  lambda ts: getattr(ts, name)(*args, **kw),
                  kind, tool_args))

    op("sphere", "select_sphere", [0.1, 0.0, 0.2], 1.0, kind="sphere",
       tool_args=(np.array([0.1, 0.0, 0.2]), 1.0))
    op("box add", "select_box", box_lo, box_hi, JO.OP_ADD, kind="box",
       tool_args=(box_lo, box_hi, None))
    op("box remove, transformed", "select_box", [-0.5, -0.5, -0.5],
       [0.5, 0.5, 0.5], JO.OP_REMOVE, m_box, kind="box",
       tool_args=(np.full(3, -0.5), np.full(3, 0.5), m_box))
    op("rect add", "select_rect", cam, 10, 5, 40, 30, JO.OP_ADD,
       kind="rect", tool_args=(10, 5, 40, 30))
    op("brush remove", "select_brush", cam, stroke, 5.0, JO.OP_REMOVE,
       kind="brush", tool_args=(stroke.astype(np.float64), 5.0))
    op("polygon add", "select_polygon", cam, poly, JO.OP_ADD,
       kind="polygon", tool_args=poly)
    op("hide", "hide_selected")
    op("inverse", "select_inverse")
    op("paint", "paint_selected", [1.0, 0.2, 0.0])
    op("rect set", "select_rect", cam, 0, 0, 40, 48, kind="rect",
       tool_args=(0, 0, 40, 48))
    op("transform", "transform_selected", m_rot)
    s.append(("palette transform",
              lambda js: JO.palette_transform_selected(js, m_pal),
              lambda ts: TO.palette_transform_selected(ts, m_pal), None,
              None))
    s.append(("palette paint",
              lambda js: JO.palette_paint_selected(js, (0.1, 0.3, 0.9)),
              lambda ts: TO.palette_paint_selected(ts, (0.1, 0.3, 0.9)),
              None, None))
    op("crop", "apply_crop", [
        {"type": "box", "lo": [-2, -2, -2], "hi": [2, 2, 2]},
        {"type": "sphere", "center": [0.5, 0.5, 0.5], "radius": 0.3,
         "op": "remove"}])
    op("unhide", "unhide_all")
    op("select sphere", "select_sphere", [-0.3, 0.2, 0.0], 0.9,
       kind="sphere", tool_args=(np.array([-0.3, 0.2, 0.0]), 0.9))
    op("delete", "delete_selected")
    op("compact", "compact")
    s.append(("bake paint", JO.bake_paint_palette, TO.bake_paint_palette,
              None, None))
    s.append(("bake palette", JO.bake_palette, TO.bake_palette, None,
              None))
    op("select all", "select_all")
    op("select none", "select_none")
    op("reset", "reset_states")
    return s


def _compare(ts, js, desc, kind, tool_args, jcam, ties):
    jstate = np.asarray(js.state).astype(np.int64)
    tstate = ts.state.numpy().astype(np.int64) & 0xFFFFFFFF
    diff = np.nonzero(jstate != tstate)[0]
    if len(diff):
        assert kind is not None, f"{desc}: state differs at {diff}"
        dist = _boundary_distance(kind, tool_args, js.params, jcam)[diff]
        assert (dist <= TIE).all(), f"{desc}: {diff} at {dist}"
        ties.extend(diff.tolist())
        ts.state = torch.as_tensor(jstate.astype(np.int32))
    _same_params(ts.params, js.params)
    assert len(ts.history) == len(js.history), desc
    assert len(ts.redo_stack) == len(js.redo_stack), desc


def _snapshot(ts):
    return ({f: getattr(ts.params, f).clone() for f in FIELDS},
            ts.state.clone())


def _same_bits(ts, snap):
    fields, state = snap
    return (all(torch.equal(getattr(ts.params, f), v)
                for f, v in fields.items())
            and torch.equal(ts.state, state))


def test_edit_session_script_matches_jax():
    jp, tp = _scene()
    other_j, other_t = _scene(n=250, capacity=260, seed=5)
    jcam = jax_orbit(3, width=64, height_px=48)[1]
    cam = _camera(jcam)
    js, ts = JO.EditSession(jp), TO.EditSession(tp)
    assert ts.state.dtype == torch.int32
    ties: list[int] = []
    snaps = []
    for desc, jf, tf, kind, targs in _script(jcam, cam):
        snaps.append(_snapshot(ts))
        before = ts.selected.clone()
        jf(js)
        tf(ts)
        _compare(ts, js, desc, kind, targs, jcam, ties)
        if kind is not None:    # every tool changes the selection
            assert not torch.equal(ts.selected, before), desc
    # the selection tools selected something and the structure ops bit
    assert int(ts.params.alive.sum()) < 400
    # pick: the nearest projected centre, or -1
    for x, y in ((32.0, 24.0), (3.0, 3.0), (-500.0, 0.0)):
        assert ts.pick(cam, x, y) == js.pick(jcam, x, y)
    # merge grows the capacity past the free slots
    snaps.append(_snapshot(ts))
    js.merge(other_j)
    ts.merge(other_t)
    assert ts.params.capacity == js.params.capacity > 430
    _compare(ts, js, "merge", None, None, jcam, ties)
    # three undos, two redos, each restoring the port bitwise
    for i in range(3):
        assert ts.undo() and js.undo()
        assert _same_bits(ts, snaps[-1 - i]), f"undo {i}"
        _compare(ts, js, f"undo {i}", None, None, jcam, ties)
    for i in range(2):
        assert ts.redo() and js.redo()
        _compare(ts, js, f"redo {i}", None, None, jcam, ties)
        assert _same_bits(ts, snaps[-2 + i]), f"redo {i}"

    # a new op clears the redo stack in both
    ts.select_all()
    js.select_all()
    _compare(ts, js, "select all", None, None, jcam, ties)
    assert not ts.redo() and not js.redo()
    print(f"float ties: {len(ties)} (splats {ties})")
    assert len(ties) <= MAX_TIES


def test_session_palettes_undo_and_visible_params():
    jp, tp = _scene(n=100, capacity=100, seed=2)
    js, ts = JO.EditSession(jp), TO.EditSession(tp)
    for s in (js, ts):
        s.select_sphere([0, 0, 0], 1.2)
    m = _affine(_rot(1, 80), (0.5, 0, 0), 0.8)
    assert TO.palette_transform_selected(ts, m) == \
        JO.palette_transform_selected(js, m)
    assert TO.palette_paint_selected(ts, (1, 1, 0)) == \
        JO.palette_paint_selected(js, (1, 1, 0))
    _same_params(TO.effective_params(ts), JO.effective_params(js))
    before = _snapshot(ts)
    TO.bake_palette(ts)
    JO.bake_palette(js)
    TO.bake_paint_palette(ts)
    JO.bake_paint_palette(js)
    _same_params(ts.params, js.params)
    assert ts.palette.num_entries == 1 and ts.paint_palette.num_entries == 1
    assert ts.undo() and ts.undo() and js.undo() and js.undo()
    assert _same_bits(ts, before)
    assert ts.palette.num_entries == 2
    np.testing.assert_array_equal(ts.palette.indices.numpy(),
                                  np.asarray(js._palette.indices))
    np.testing.assert_array_equal(ts.paint_palette.indices.numpy(),
                                  np.asarray(js._paint_palette.indices))
    for s in (js, ts):
        s.hide_selected()
    np.testing.assert_array_equal(ts.visible_params().alive.numpy(),
                                  np.asarray(js.visible_params().alive))
    # an empty palette bakes to nothing and pushes no undo
    fresh = TO.EditSession(_carry(jp))
    TO.bake_palette(fresh)
    TO.bake_paint_palette(fresh)
    assert not fresh.history and fresh.palette is None


def test_history_is_bounded():
    _, tp = _scene(n=20, capacity=20)
    ts = TO.EditSession(tp, max_history=4)
    for _ in range(6):
        ts.select_all()
    assert len(ts.history) == 4
    while ts.undo():
        pass
    assert not ts.undo() and len(ts.redo_stack) == 4


# --------------------------------------------------------------------------
# the dense compositor


@pytest.mark.parametrize("falloff", ["gaussian", "ring", "solid"])
def test_composite_dense_matches_jax(falloff, monkeypatch):
    jp, tp = _scene(n=300, capacity=320, seed=4, sh_degree=0)
    jcam = jax_orbit(2, width=40, height_px=32)[0]
    cam = _camera(jcam)
    jproj = jax_project(jp.means, jp.scales, jp.quats, jcam)
    tproj = project_gaussians(tp.means, tp.scales, tp.quats, cam)
    cols = np.random.default_rng(1).uniform(0, 1, (320, 3)
                                            ).astype(np.float32)
    bg = np.array([0.1, 0.2, 0.3], np.float32)
    ji, ja = JD.composite_dense(jproj, jnp.asarray(cols),
                                jp.effective_opacity(), 40, 32,
                                falloff=falloff, chunk=64,
                                background=jnp.asarray(bg))
    # pixel blocks smaller than the frame: each pixel's arithmetic is the
    # same in every block
    monkeypatch.setattr(TD, "PIXEL_BLOCK", 500)
    ti, ta = TD.composite_dense(tproj, torch.as_tensor(cols),
                                tp.effective_opacity(), 40, 32,
                                falloff=falloff, chunk=64,
                                background=torch.as_tensor(bg))
    assert float(ta.max()) > 0.5
    np.testing.assert_allclose(ti.numpy(), np.asarray(ji), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), atol=1e-5,
                               rtol=0)


# --------------------------------------------------------------------------
# apps.edit


def _ply(tmp_path, name, n, seed, capacity=None):
    jp = jax_random_scene(np.random.default_rng(seed), n, sh_degree=3,
                          capacity=capacity)
    path = str(tmp_path / name)
    jax_save_model(path, jp)
    return path


EDIT_OPS = ["select_sphere:0,0,0,1.2", "select_inverse", "delete",
            "crop_box:-1.5,-1.5,-1.5,1.5,1.5,1.5", "transform_translate:0,1,0",
            "transform_scale:2", "select_box:-2,-2,-2,0,3,2",
            "paint:1,0,0", "hide", "undo", "unhide", "redo", "compact"]


@pytest.mark.parametrize("rotate", [False, True])
def test_edit_app_matches_jax(tmp_path, capsys, rotate):
    src = _ply(tmp_path, "in.ply", 300, 0)
    extra = _ply(tmp_path, "b.ply", 40, 1)
    ops = EDIT_OPS + (["transform_rotate_y:45"] if rotate else [])
    argv = ["--input", src, "--merge", extra]
    for o in ops:
        argv += ["--op", o]
    outs = {}
    for name, main, dev in (("jax", jax_edit_app.main, []),
                            ("port", edit_app.main, ["--device", CPU])):
        out = str(tmp_path / f"{name}.ply")
        html = str(tmp_path / f"{name}.html")
        assert main(argv + ["--output", out, "--html", html] + dev) == 0
        assert main(argv + ["--stats"] + dev) == 0
        outs[name] = (open(out, "rb").read(), open(html, "rb").read(),
                      capsys.readouterr().out)
    (jb, jh, jo), (tb, th, to) = outs["jax"], outs["port"]
    assert to.replace("port", "jax").splitlines() == jo.splitlines()
    assert "bounds:" in to
    if not rotate:
        assert tb == jb
        assert th == jh
    else:
        # the SH rotation's sums round differently: the values within the
        # tolerance, the header and count the same
        from divshot_tpu_torch.gsio.ply import read_ply_arrays
        with open(tmp_path / "a.ply", "wb") as f:
            f.write(jb)
        ja, _ = read_ply_arrays(str(tmp_path / "a.ply"))
        ta, _ = read_ply_arrays(str(tmp_path / "port.ply"))
        assert ja.keys() == ta.keys()
        for k in ja:
            np.testing.assert_allclose(ta[k], ja[k], rtol=0, atol=1e-5,
                                       err_msg=k)
        assert len(th) == len(jh)


def test_edit_app_unknown_op_exits(tmp_path):
    src = _ply(tmp_path, "in.ply", 20, 0)
    for op in ("frobnicate", "transform_shear:1"):
        with pytest.raises(SystemExit, match="unknown op"):
            edit_app.main(["--input", src, "--op", op, "--device", CPU])
    assert os.path.exists(src)
