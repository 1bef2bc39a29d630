"""Parity of the port's exact-2DGS (surfel) slice with the JAX package on
the CPU, on the JAX tests' own scenes (``tests/test_surfel.py``): the
projection, the surfel table, the plain forward against the Pallas kernel
in interpret mode, the render against the float32 XLA compositor, the
gradients and the sinks, the overflow case of ``tests/test_round4.py``,
the per-splat reduce, the geometry losses and ``render``'s dispatch.

Tolerances, each with its reason:
- projection: rtol 2e-6 and atol 1e-6 (one float32 ulp of ``exp`` and of
  three-term sums decides; the values reach ~1e3);
- table: equal, but the opacity row, which is ``sigmoid`` (rtol 2.5e-7);
- forward and render: image and alpha atol 5e-5, the z, z^2 and normal
  planes atol 2e-4 (``tests/test_pallas_surfel.py:19-30``);
- gradients and the signed sink: 3e-4 of the largest value (``:33-63``);
  npix within 2 pixels of the Pallas route (``:97``);
- reduce 2e-5 of the largest segment sum (float32 cumsums in another
  order); geometry atol 1e-6.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from divshot_tpu.raster import pallas_bin as jax_bin
from divshot_tpu.raster import pallas_surfel as jax_ps
from divshot_tpu.raster.surfel import project_surfels as jax_project
from divshot_tpu.raster.surfel import render_surfels as jax_render_surfels
from divshot_tpu.train import geometry as jax_geometry

from divshot_tpu_torch.gsio.synthetic import orbit_cameras
from divshot_tpu_torch.raster import bin as B
from divshot_tpu_torch.raster import surfel_raster as SR
from divshot_tpu_torch.raster.render import render
from divshot_tpu_torch.raster import surfel as SF
from divshot_tpu_torch.raster.surfel import project_surfels
from divshot_tpu_torch.splat.camera import Camera
from divshot_tpu_torch.splat.gaussians import GaussianParams
from divshot_tpu_torch.train import geometry as G
from tests.test_raster import make_scene
from tests.test_surfel import _clean_surfel_scene, make_surfel_scene

CPU = "cpu"
FIELDS = ("means", "scales", "quats", "opacity", "sh0", "shN", "alive")
GRAD_FIELDS = ("means", "scales", "quats", "opacity", "sh0")


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _np(x):
    return np.asarray(x)


def _params(jp) -> GaussianParams:
    return GaussianParams.from_numpy({f: _np(getattr(jp, f))
                                      for f in FIELDS}, device=CPU)


def _camera(jc) -> Camera:
    return Camera.from_numpy({k: _np(getattr(jc, k)) for k in (
        "viewmat", "fx", "fy", "cx", "cy", "width", "height")}, device=CPU)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / (np.abs(b).max() + 1e-12)


@pytest.mark.parametrize("seed", [0, 1])
def test_project_surfels_matches_jax(seed):
    jp, jc = make_surfel_scene(seed=seed, n=60, size=64)
    want = jax_project(jp.means, jp.scales, jp.quats, jc)
    tp = _params(jp)
    got = project_surfels(tp.means, tp.scales, tp.quats, _camera(jc))
    assert set(got) == set(want)
    assert int((got["radii"] > 0).sum()) > 30
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), _np(want[k]), rtol=2e-6,
                                   atol=1e-6, err_msg=k)


def _jax_bins(jp, jc, nch, cap=1 << 14):
    """JAX's binning and surfel table for ``jp`` seen from ``jc``, on the
    Pallas route's inputs (``pallas_surfel.py:612-652``)."""
    pr = jax_project(jp.means, jp.scales, jp.quats, jc)
    n = jp.capacity
    colors = jnp.asarray(np.random.default_rng(nch).uniform(
        0, 1, (n, nch)), jnp.float32)
    bins = jax_bin.expand_sorted(
        pr["center2d"], jnp.zeros((n, 3)), pr["depths"], pr["radii"], None,
        None, jnp.zeros((n, 0)), jnp.ones((n,)), width=jc.width,
        height=jc.height, instance_capacity=cap, mt=64, nch=0,
        build_table=False, interpret=True)
    opac = jp.effective_opacity()
    table = jax_ps.build_surfel_table(pr["Tmat"], pr["zplane"],
                                      pr["center2d"], opac, colors,
                                      bins.s_owner)
    return pr, colors, opac, bins, table


def test_surfel_table_matches_jax():
    jp, jc = make_surfel_scene(n=60, size=64)
    pr, colors, opac, bins, want = _jax_bins(jp, jc, 5)
    tp = _params(jp)
    got = SR.build_surfel_table(
        *(torch.tensor(_np(pr[k])) for k in ("Tmat", "zplane", "center2d")),
        tp.effective_opacity(), torch.tensor(_np(colors)),
        torch.tensor(_np(bins.s_owner)))
    n = int(bins.tile_start[-1])
    assert got.shape == want.shape == (SR.feat_rows(5), 1 << 14)
    rows = [r for r in range(want.shape[0]) if r != SR.ROW_OP]
    np.testing.assert_array_equal(got.numpy()[rows, :n],
                                  _np(want)[rows, :n])
    np.testing.assert_allclose(got.numpy()[SR.ROW_OP, :n],
                               _np(want)[SR.ROW_OP, :n], rtol=2.5e-7)


@pytest.mark.parametrize("nch", [5, 3])
def test_surfel_forward_plain_matches_pallas(nch):
    """The plain forward on JAX's own table and tile ranges against the
    Pallas kernel (interpret mode)."""
    jp, jc = make_surfel_scene(n=60, size=64)
    _, _, _, bins, table = _jax_bins(jp, jc, nch)
    want = _np(jax_ps.surfel_forward(table, bins.tile_start, width=64,
                                     height=64, nch=nch, interpret=True))
    got = SR.surfel_forward(torch.tensor(_np(table)),
                            torch.tensor(_np(bins.tile_start)), width=64,
                            height=64, nch=nch).numpy()
    assert got.shape == want.shape == (16, 8, 256)
    assert float(got[:, SR.ROW_T].min()) < 0.5           # opaque pixels
    image_rows = list(range(nch)) + [SR.ROW_T]
    np.testing.assert_allclose(got[:, image_rows], want[:, image_rows],
                               atol=5e-5)
    np.testing.assert_allclose(got[:, SR.ROW_Z:SR.ROW_Z2 + 1],
                               want[:, SR.ROW_Z:SR.ROW_Z2 + 1], atol=2e-4)
    assert not got[:, nch:SR.ROW_Z].any()


@pytest.mark.parametrize("with_geometry", [True, False])
def test_render_surfels_matches_xla(with_geometry):
    """tests/test_pallas_surfel.py:19-30 through the port."""
    jp, jc = make_surfel_scene(n=60, size=64)
    bg = np.asarray([0.15, 0.3, 0.45], np.float32)
    want, _ = jax_render_surfels(jp, jc, background=jnp.asarray(bg),
                                 with_geometry=with_geometry)
    got = SR.render_surfels(_params(jp), _camera(jc),
                            background=torch.tensor(bg),
                            with_geometry=with_geometry)
    np.testing.assert_allclose(got.image.numpy(), _np(want.image),
                               atol=5e-5)
    np.testing.assert_allclose(got.alpha.numpy(), _np(want.alpha),
                               atol=5e-5)
    if with_geometry:
        assert got.extra.shape == (64, 64, 4)
        np.testing.assert_allclose(got.extra.numpy(), _np(want.extra),
                                   atol=2e-4)
    else:
        assert got.extra is None and want.extra is None
    np.testing.assert_array_equal(got.proj.radii.numpy(),
                                  _np(want.proj.radii))
    assert int(got.num_instances) == int(want.num_instances)


def test_surfel_gradients_match_xla():
    """tests/test_pallas_surfel.py:33-63: the gradients of means, scales,
    quats, opacity and sh0 through the hand-written backward (plain
    version) against autodiff through the XLA compositor, on its
    threshold-clean scene."""
    jp, jc, _seed = _clean_surfel_scene(n=12, size=32)
    bg = np.asarray([0.1, 0.2, 0.3], np.float32)
    tgt = np.random.default_rng(5).uniform(0, 1, (32, 32, 3)).astype(
        np.float32)

    def jax_loss(means, scales, quats, opacity, sh0):
        p = jp.replace(means=means, scales=scales, quats=quats,
                       opacity=opacity, sh0=sh0)
        out, _ = jax_render_surfels(p, jc, background=jnp.asarray(bg),
                                    with_geometry=True)
        zl = jnp.sum(out.extra[..., 0]) + 0.3 * jnp.sum(
            out.extra[..., 1]) + 0.11 * jnp.sum(out.extra[..., 2:])
        return (jnp.sum((out.image - tgt) ** 2)
                + 0.23 * jnp.sum(out.alpha) + 1e-3 * zl)

    want = jax.grad(jax_loss, argnums=(0, 1, 2, 3, 4))(
        *(getattr(jp, f) for f in GRAD_FIELDS))
    tp = _params(jp)
    leaves = {f: getattr(tp, f).clone().requires_grad_() for f in
              GRAD_FIELDS}
    out = SR.render_surfels(dataclasses.replace(tp, **leaves), _camera(jc),
                            background=torch.tensor(bg))
    zl = (out.extra[..., 0].sum() + 0.3 * out.extra[..., 1].sum()
          + 0.11 * out.extra[..., 2:].sum())
    loss = (((out.image - torch.tensor(tgt)) ** 2).sum()
            + 0.23 * out.alpha.sum() + 1e-3 * zl)
    loss.backward()
    for f, w in zip(GRAD_FIELDS, want):
        assert _rel(leaves[f].grad.numpy(), w) < 3e-4, f


@pytest.mark.parametrize("moment", ["z2_alpha", "z_sq"])
def test_distortion_moment_gradients_match_xla(moment):
    """The two moments of the depth-distortion loss, sum(z2 alpha) and
    sum(z^2) over the planes (weights detached from the depth, as in JAX),
    differentiated through both routes: within 3e-4 of the largest
    gradient, on the 60-splat scene."""
    jp, jc = make_surfel_scene(n=60, size=64)
    fields = ("means", "scales", "quats", "opacity")

    def value(out, lib):
        if moment == "z2_alpha":
            return lib.sum(out.extra[..., 1] * out.alpha)
        return lib.sum(out.extra[..., 0] ** 2)

    def jax_loss(*vals):
        out, _ = jax_render_surfels(jp.replace(**dict(zip(fields, vals))), jc,
                                    with_geometry=True)
        return value(out, jnp)

    want = jax.grad(jax_loss, argnums=(0, 1, 2, 3))(
        *(getattr(jp, f) for f in fields))
    tp = _params(jp)
    leaves = {f: getattr(tp, f).clone().requires_grad_() for f in fields}
    out = SR.render_surfels(dataclasses.replace(tp, **leaves), _camera(jc))
    value(out, torch).backward()
    for f, w in zip(fields, want):
        err = np.abs(leaves[f].grad.numpy() - _np(w)).max()
        # the scales gradient of a depth moment is ~0 (the intersection
        # does not move when the splat is scaled in its plane): held
        # against the largest gradient of the means
        scale = np.abs(_np(want[0])).max() if f == "scales" \
            else np.abs(_np(w)).max()
        assert err <= 3e-4 * scale, f


def test_surfel_sink_gradients():
    """tests/test_pallas_surfel.py:66-97: the signed means2d sink against
    the XLA route's screen-shift gradient, AbsGS dominance, and the pixel
    counts against the Pallas route's (interpret mode)."""
    jp, jc, _seed = _clean_surfel_scene(n=12, size=32)
    cap = jp.capacity
    z2 = jnp.zeros((cap, 2), jnp.float32)
    z1 = jnp.zeros((cap,), jnp.float32)

    def loss_x(m2d):
        out, _ = jax_render_surfels(jp, jc, means2d_sink=m2d,
                                    with_geometry=False)
        return jnp.mean((out.image - 0.4) ** 2)

    def loss_p(sinks):
        ab, m2d, npx = sinks
        out, _ = jax_ps.render_surfels_pallas(
            jp, jc, absgrad_sink=ab, means2d_sink=m2d, npix_sink=npx,
            with_geometry=False, interpret=True)
        return jnp.mean((out.image - 0.4) ** 2)

    g_x = _np(jax.grad(loss_x)(z2))
    _, _, np_p = map(_np, jax.grad(loss_p)((z2, z2, z1)))

    sinks = [torch.zeros(s, requires_grad=True)
             for s in ((cap, 2), (cap, 2), (cap,))]
    out = SR.render_surfels(_params(jp), _camera(jc), absgrad_sink=sinks[0],
                            means2d_sink=sinks[1], npix_sink=sinks[2],
                            with_geometry=False)
    assert out.absgrad_sink is sinks[0]
    ((out.image - 0.4) ** 2).mean().backward()
    g_ab, g_m2d, g_np = (s.grad.numpy() for s in sinks)
    assert np.abs(g_m2d - g_x).max() / (np.abs(g_x).max() + 1e-8) < 3e-4
    assert (g_ab + 1e-6 >= np.abs(g_m2d)).all() and g_ab.max() > 0
    assert (g_np >= 0).all() and g_np.max() > 0
    assert np.abs(g_np - np_p).max() <= 2


@pytest.mark.parametrize("capacity", [1 << 12, 1 << 11])
def test_surfel_alpha_clamp_and_overflow(capacity):
    """tests/test_round4.py:302-326 through the port: saturated opacities
    at the alpha clamp keep the image and the opacity gradients finite, at
    that test's instance capacity and at one whose guard clamp drops the
    sorted tail (demand above ``tile_start[-1]``)."""
    jp, jc = make_scene(np.random.default_rng(0), n=300, sh_degree=0)
    jp = jp.replace(opacity=jnp.where(jp.alive, 9.0, jp.opacity))
    tp, cam = _params(jp), _camera(jc)
    op = tp.opacity.clone().requires_grad_()
    out = SR.render_surfels(dataclasses.replace(tp, opacity=op), cam,
                            sh_degree=0, instance_capacity=capacity)
    if capacity == 1 << 11:
        assert int(out.num_instances) > capacity // 2      # tail dropped
    img = out.image.detach().numpy()
    assert np.isfinite(img).all() and img.max() <= 1.01
    out.image.sum().backward()
    assert torch.isfinite(op.grad).all()


@pytest.mark.parametrize("nch", [5, 3])
def test_segment_rows_sorted_matches_jax(nch):
    """Every row of the surfel backward's width through the port's reduce
    and JAX's, on the same bins (capacity tail and the guard clamp
    present)."""
    jp, jc = make_surfel_scene(n=60, size=64)
    tp, cam = _params(jp), _camera(jc)
    pr = project_surfels(tp.means, tp.scales, tp.quats, cam)
    cap = 1 << 12
    sb = B.expand_sorted(pr["center2d"], None, pr["depths"], pr["radii"],
                         None, None, None, None, width=64, height=64,
                         instance_capacity=cap, guard_lanes=1024,
                         build_table=False)
    assert sb.table is None and 0 < int(sb.tile_start[-1]) < cap
    ngrad = SR.ngrad_rows(nch)
    rows = np.random.default_rng(nch).standard_normal(
        (ngrad, cap)).astype(np.float32)
    got = B.segment_rows_sorted(torch.tensor(rows), sb, range(ngrad))
    num_tiles = sb.tile_start.shape[0] - 1
    want = jax_bin.segment_rows_sorted(
        jnp.asarray(rows), jnp.zeros((num_tiles, ngrad, 256)),
        jnp.asarray(sb.tile_start.numpy()), jnp.asarray(sb.s_owner.numpy()),
        jnp.asarray(sb.g_offsets.numpy()), jnp.asarray(sb.g_counts.numpy()),
        rows=list(range(ngrad)))
    assert got.shape == (ngrad, jp.capacity)
    assert _rel(got.numpy(), want) < 2e-5
    picked = B.segment_rows_sorted(torch.tensor(rows), sb, [ngrad - 1, 2])
    np.testing.assert_array_equal(picked.numpy(), got.numpy()[[ngrad - 1, 2]])


def test_flatten_and_splat_normals_match_jax():
    jp, jc = make_surfel_scene(n=60, size=64)
    tp, cam = _params(jp), _camera(jc)
    np.testing.assert_array_equal(
        G.flatten_to_surfels(tp).scales.numpy(),
        _np(jax_geometry.flatten_to_surfels(jp).scales))
    np.testing.assert_allclose(G.splat_normals(tp, cam).numpy(),
                               _np(jax_geometry.splat_normals(jp, jc)),
                               atol=1e-6)


def _depth_scene():
    rng = np.random.default_rng(3)
    jc = orbit_cameras(1, width=40, height_px=32, device=CPU)[0]
    yy, xx = np.mgrid[0:32, 0:40].astype(np.float32)
    depth = (3.0 + 0.02 * xx - 0.03 * yy + 0.05 * rng.standard_normal(
        (32, 40))).astype(np.float32)
    alpha = rng.uniform(0.2, 1.0, (32, 40)).astype(np.float32)
    n = rng.standard_normal((32, 40, 3)).astype(np.float32)
    return jc, depth, alpha, n


def _jax_camera(cam: Camera):
    from divshot_tpu.splat.camera import Camera as JCamera
    return JCamera(viewmat=jnp.asarray(cam.viewmat), fx=cam.fx, fy=cam.fy,
                   cx=cam.cx, cy=cam.cy, width=cam.width, height=cam.height)


def test_normals_from_depth_matches_jax():
    cam, depth, alpha, _ = _depth_scene()
    want = jax_geometry.normals_from_depth(jnp.asarray(depth),
                                           _jax_camera(cam),
                                           jnp.asarray(alpha))
    got = G.normals_from_depth(torch.tensor(depth), cam, torch.tensor(alpha))
    assert float((got != 0).any(-1).float().mean()) > 0.3
    np.testing.assert_allclose(got.numpy(), _np(want), atol=1e-6)


def test_normal_consistency_loss_matches_jax():
    cam, depth, alpha, n = _depth_scene()
    want = jax_geometry.normal_consistency_loss(
        jnp.asarray(n), jnp.asarray(depth), jnp.asarray(alpha),
        _jax_camera(cam))
    got = G.normal_consistency_loss(torch.tensor(n), torch.tensor(depth),
                                    torch.tensor(alpha), cam)
    assert 0.0 < float(got) < 2.0
    np.testing.assert_allclose(float(got), float(want), atol=1e-6)


def test_render_dispatches_the_surfel_backend():
    """``render(backend="surfel_pallas")`` is ``render_surfels`` without
    the geometry planes, as in JAX; ``render(backend="surfel")`` the XLA
    compositor's counterpart (``surfel.render_surfels``) without them,
    within the forward bar of the kernel route and of JAX's XLA route."""
    jp, jc = make_surfel_scene(n=60, size=64)
    tp, cam = _params(jp), _camera(jc)
    out = render(tp, cam, backend="surfel_pallas")
    ref = SR.render_surfels(tp, cam, with_geometry=False)
    assert out.extra is None
    assert torch.equal(out.image, ref.image)
    assert torch.equal(out.alpha, ref.alpha)
    xla = render(tp, cam, backend="surfel")
    xla_ref, npix = SF.render_surfels(tp, cam, with_geometry=False)
    assert xla.extra is None and torch.equal(xla.image, xla_ref.image)
    want, want_npix = jax.jit(lambda p: jax_render_surfels(
        p, jc, with_geometry=False))(jp)
    for got in (xla, out):
        np.testing.assert_allclose(got.image.numpy(), _np(want.image),
                                   atol=5e-5)
        np.testing.assert_allclose(got.alpha.numpy(), _np(want.alpha),
                                   atol=5e-5)
    np.testing.assert_array_equal(npix.numpy(), _np(want_npix))
    assert int(xla.num_instances) == int(want.num_instances)
