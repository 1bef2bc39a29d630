"""Parity of the port's training slice with the JAX package on the CPU:
the differentiable render and its backward, the per-gaussian reduce, the
losses, Adam, every strategy function on JAX's own random draws, and one
whole train step from a carried-across state. (The loss bars of
``tests/test_train.py``, met by the port's trainer, are in
``tests/test_torch_trainer.py``, so that the two files run on separate
workers.)

Tolerances, each with its reason:
- render: image atol 3e-5 against the JAX kernel route (the forward bar
  of ``tests/test_pallas_raster.py``); gradients atol 3e-4 against the
  JAX float32 XLA route (the bar of ``tests/test_round5.py``) and 3e-3 of
  the largest value against the JAX kernel route, whose bf16 split
  prefix sums put 1.2e-3 on the means gradient at this scene (logged in
  ROADMAP.md, Queue C);
- backward against the XLA tiles oracle: 3e-3 of the largest value
  (``tests/test_pallas_raster.py:44-71``), 5e-3 for the multichannel
  gradients (``:115``);
- reduce: 2e-5 of the largest segment sum (float32 cumsums in another
  order);
- losses atol 1e-6; Adam and the strategies rtol 1e-5 (float32 libm
  differences), masks exactly;
- the train step: loss rtol 1e-5, gradients atol 3e-4.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from divshot_tpu.core.config import DensifyConfig as JDensifyConfig
from divshot_tpu.core.config import OptimConfig as JOptimConfig
from divshot_tpu.core.config import TrainConfig as JTrainConfig
from divshot_tpu.gsio.synthetic import orbit_cameras as jax_orbit
from divshot_tpu.gsio.synthetic import random_scene as jax_random_scene
from divshot_tpu.gsio.synthetic import render_gt_images as jax_render_gt
from divshot_tpu.raster import pallas_bin as jax_bin
from divshot_tpu.raster import pallas_raster as jax_raster
from divshot_tpu.raster import tiles as jax_tiles
from divshot_tpu.raster.project import project_gaussians as jax_project
from divshot_tpu.raster.render import render as jax_render
from divshot_tpu.splat.sh import eval_sh_color as jax_eval_sh_color
from divshot_tpu.train import losses as jax_losses
from divshot_tpu.train import optim as jax_optim
from divshot_tpu.train import strategy as jax_strategy
from divshot_tpu.train import trainer as jax_trainer

from divshot_tpu_torch.core.config import (DensifyConfig, DensifyStrategy,
                                           OptimConfig, TrainConfig)
from divshot_tpu_torch.gsio.synthetic import orbit_cameras, random_scene
from divshot_tpu_torch.raster import bin as B
from divshot_tpu_torch.raster.project import Projection
from divshot_tpu_torch.raster.render import rasterize_binned, render
from divshot_tpu_torch.splat.camera import Camera
from divshot_tpu_torch.splat.gaussians import GaussianParams
from divshot_tpu_torch.train import losses as L
from divshot_tpu_torch.train import optim as O
from divshot_tpu_torch.train import strategy as S
from divshot_tpu_torch.train.trainer import (Dataset, TrainState,
                                             make_train_step)
from tests.test_raster import make_scene

CPU = "cpu"
FIELDS = ("means", "scales", "quats", "opacity", "sh0", "shN", "alive")
PFIELDS = ("means", "scales", "quats", "opacity", "sh0", "shN")


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _np(x):
    return np.asarray(x)


def _t(x, grad=False):
    return torch.tensor(np.asarray(x)).requires_grad_(grad)


def _params(jp) -> GaussianParams:
    return GaussianParams.from_numpy({f: _np(getattr(jp, f))
                                      for f in FIELDS}, device=CPU)


def _camera(jc) -> Camera:
    return Camera.from_numpy({k: _np(getattr(jc, k)) for k in (
        "viewmat", "fx", "fy", "cx", "cy", "width", "height")}, device=CPU)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / (np.abs(b).max() + 1e-12)


# ---------------------------------------------------------------------------
# render and the backward


# the render options the trainer passes (radiusClip, cullSH, the mip
# filter), each a case of test_render_matches_jax
RENDER_OPTIONS = {
    "defaults": {},
    "radius_clip": dict(radius_clip=2.5),
    "cull_sh": dict(cull_sh_radius=3.0),
    "all_antialiased": dict(radius_clip=2.5, cull_sh_radius=3.0,
                            antialiased=True),
}


@pytest.mark.parametrize("case", list(RENDER_OPTIONS))
def test_render_matches_jax(case):
    """tests/test_round5.py:78-106's scene and loss through the port's
    render, on the kernel route and on the ``"tiles"`` route, against
    JAX's float32 XLA ``"tiles"`` route; with the defaults also against
    JAX's kernel route (interpret mode), once."""
    rng = np.random.default_rng(0)
    jp = jax_random_scene(rng, 120, sh_degree=2 if case != "defaults"
                          else 1)
    jc = jax_orbit(1, width=64, height_px=48)[0]
    fields = ("means", "scales", "quats", "sh0", "opacity") + (
        ("shN",) if case != "defaults" else ())
    opts = RENDER_OPTIONS[case]

    def jax_run(jit=False, **kw):
        def f(fl):
            out = jax_render(jp.replace(**fl), jc, instance_capacity=1 << 13,
                             **opts, **kw)
            return jnp.sum(out.image * out.image) + jnp.sum(out.alpha), \
                out.image
        vg = jax.value_and_grad(f, has_aux=True)
        (loss, img), g = (jax.jit(vg) if jit else vg)(
            {k: getattr(jp, k) for k in fields})
        return float(loss), _np(img), {k: _np(v) for k, v in g.items()}

    if case == "defaults":
        loss_p, img_p, g_p = jax_run(backend="pallas", binning="pallas")
    with jax.default_matmul_precision("highest"):
        loss_x, img_x, g_x = jax_run(jit=True, backend="tiles",
                                     tile_capacity=512)

    tp = _params(jp)
    for route in ({}, {"backend": "tiles", "tile_capacity": 512}):
        leaves = {k: getattr(tp, k).clone().requires_grad_() for k in fields}
        out = render(dataclasses.replace(tp, **leaves), _camera(jc),
                     instance_capacity=1 << 13, **opts, **route)
        loss = (out.image * out.image).sum() + out.alpha.sum()
        loss.backward()
        img = out.image.detach().numpy()
        assert out.image.shape == (48, 64, 3)
        assert int(out.num_instances) > 0 and int(out.max_tile_count) > 0
        np.testing.assert_allclose(img, img_x, atol=3e-5, err_msg=str(route))
        np.testing.assert_allclose(float(loss.detach()), loss_x, rtol=1e-5)
        for k in fields:
            got = leaves[k].grad.numpy()
            np.testing.assert_allclose(got, g_x[k], atol=3e-4,
                                       err_msg=f"{k} {route}")
            if case == "defaults" and not route:
                assert _rel(got, g_p[k]) < 3e-3, k
        if case == "defaults" and not route:
            np.testing.assert_allclose(img, img_p, atol=3e-5)
            np.testing.assert_allclose(float(loss.detach()), loss_p,
                                       rtol=1e-5)


def _oracle_setup(n, tight=False, res=128):
    """tests/test_pallas_raster.py:_setup (and test_round4's tight
    variant): projection, colours, opacities and the XLA bins."""
    params, cam = make_scene(np.random.default_rng(0), n=n, sh_degree=0)
    op = params.effective_opacity()
    proj = jax_project(params.means, params.scales, params.quats, cam,
                       opacities=op if tight else None)
    dirs = jnp.tile(jnp.asarray([[0.0, 0, 1]]), (params.capacity, 1))
    colors = jax_eval_sh_color(params.sh0, params.shN, dirs)
    bins = jax_tiles.bin_gaussians(
        proj.means2d, proj.depths, proj.radii, res, res, tile_capacity=2048,
        instance_capacity=1 << 15,
        radii_xy=proj.radii_xy if tight else None,
        rad2=proj.rad2 if tight else None)
    return proj, colors, op, bins, res


def _port_proj(proj) -> Projection:
    """The binning geometry of a JAX projection, as torch tensors."""
    none = lambda x: None if x is None else _t(x)  # noqa: E731
    return Projection(means2d=_t(proj.means2d), conics=_t(proj.conics),
                      depths=_t(proj.depths), radii=_t(proj.radii),
                      comp=_t(proj.comp), cov2d=_t(proj.cov2d),
                      radii_xy=none(proj.radii_xy), rad2=none(proj.rad2))


def _port_raster(proj, colors, op, res, *, background=None, absgrad=True,
                 capacity=1 << 15):
    """Leaves (means2d, conics, colors, opacity, absgrad sink) and the
    port's (image, alpha, num_instances) on them."""
    pp = _port_proj(proj)
    leaves = [_t(proj.means2d, True), _t(proj.conics, True),
              _t(colors, True), _t(op, True),
              torch.zeros((pp.means2d.shape[0], 2), requires_grad=True)]
    bg = None if background is None else _t(background)
    img, alpha, n_inst, _ = rasterize_binned(
        *leaves[:4], pp, width=res, height=res, instance_capacity=capacity,
        background=bg, absgrad_sink=leaves[4], with_absgrad=absgrad)
    return leaves, img, alpha, n_inst


def test_backward_matches_tiles_oracle():
    """tests/test_pallas_raster.py:44-71: gradients of an image + alpha
    loss through the port's binned raster against autodiff of the XLA
    tiles oracle, 3e-3 of the largest value."""
    proj, colors, op, bins, res = _oracle_setup(300)
    target = np.random.default_rng(1).uniform(0, 1, (res, res, 3)).astype(
        np.float32)
    bg = jnp.asarray([0.3, 0.1, 0.6])

    def loss_x(args):
        img, alpha = jax_tiles.composite_tiles(
            *args, bins.ids_mat, res, res, chunk=32, background=bg)
        return jnp.sum((img - target) ** 2) + 0.37 * jnp.sum(alpha)

    with jax.default_matmul_precision("highest"):
        g_x = jax.grad(loss_x)((proj.means2d, proj.conics, colors, op))
    leaves, img, alpha, _ = _port_raster(proj, colors, op, res,
                                         background=bg)
    loss = ((img - torch.tensor(target)) ** 2).sum() + 0.37 * alpha.sum()
    loss.backward()
    for name, leaf, want in zip(("means2d", "conics", "colors", "opacity"),
                                leaves, g_x):
        assert _rel(leaf.grad.numpy(), want) < 3e-3, name


def test_backward_absgrad_matches_tiles_oracle():
    """tests/test_pallas_raster.py:74: the AbsGS sink's gradient, here held
    against the oracle's own AbsGS sink, 3e-3 of the largest value."""
    proj, colors, op, bins, res = _oracle_setup(200)
    sink = jnp.zeros((proj.means2d.shape[0], 2))

    def loss_x(s):
        img, _ = jax_tiles.composite_tiles(
            proj.means2d, proj.conics, colors, op, bins.ids_mat, res, res,
            chunk=32, absgrad_sink=s)
        return jnp.sum(img ** 2)

    with jax.default_matmul_precision("highest"):
        want = _np(jax.grad(loss_x)(sink))
    leaves, img, _, _ = _port_raster(proj, colors, op, res)
    (img ** 2).sum().backward()
    got = leaves[4].grad.numpy()
    assert got.sum() > 0
    assert _rel(got, want) < 3e-3


def test_backward_multichannel_matches_tiles_oracle():
    """tests/test_pallas_raster.py:115: two aux channels composited in the
    same pass as rgb; gradients of colours and opacities against two
    separate oracle composites, 5e-3 of the largest value (the bar of that
    test)."""
    proj, colors, op, bins, res = _oracle_setup(150)
    n = colors.shape[0]

    def loss_x(args):
        col, o = args
        img, alpha = jax_tiles.composite_tiles(
            proj.means2d, proj.conics, col, o, bins.ids_mat, res, res,
            chunk=32)
        aux = jnp.stack([col[:, 0] * 2.0, col[:, 1] - col[:, 2],
                         jnp.zeros((n,))], axis=1)
        img2, _ = jax_tiles.composite_tiles(
            proj.means2d, proj.conics, aux, o, bins.ids_mat, res, res,
            chunk=32)
        return (jnp.sum(img ** 2) + jnp.sum(img2[..., :2] ** 2)
                + 0.1 * jnp.sum(alpha))

    with jax.default_matmul_precision("highest"):
        g_x = jax.grad(loss_x)((colors, op))
    col = _t(colors, True)
    o = _t(op, True)
    aux = torch.stack([col[:, 0] * 2.0, col[:, 1] - col[:, 2]], 1)
    img, alpha, _, _ = rasterize_binned(
        _t(proj.means2d), _t(proj.conics), torch.cat([col, aux], 1), o,
        _port_proj(proj), width=res, height=res, instance_capacity=1 << 15)
    assert img.shape == (res, res, 5)
    ((img[..., :3] ** 2).sum() + (img[..., 3:] ** 2).sum()
     + 0.1 * alpha.sum()).backward()
    assert _rel(col.grad.numpy(), g_x[0]) < 5e-3
    assert _rel(o.grad.numpy(), g_x[1]) < 5e-3


def test_backward_with_absgrad_off():
    """tests/test_round4.py:88 on the tight binning: with_absgrad=False
    leaves every other gradient as it was (atol 1e-6) and the sink's
    gradient zero; both agree with the oracle (3e-3 of the largest)."""
    proj, colors, op, bins, res = _oracle_setup(200, tight=True)

    def loss_x(args):
        img, alpha = jax_tiles.composite_tiles(
            args[0], proj.conics, args[1], op, bins.ids_mat, res, res,
            chunk=32)
        return jnp.sum(img ** 2) + 0.2 * jnp.sum(alpha)

    with jax.default_matmul_precision("highest"):
        g_x = jax.grad(loss_x)((proj.means2d, colors))
    grads = {}
    for absgrad in (True, False):
        leaves, img, alpha, _ = _port_raster(proj, colors, op, res,
                                             absgrad=absgrad)
        ((img ** 2).sum() + 0.2 * alpha.sum()).backward()
        grads[absgrad] = [x.grad.numpy() for x in leaves]
    for i in range(4):
        np.testing.assert_allclose(grads[False][i], grads[True][i],
                                   atol=1e-6)
    assert np.abs(grads[False][4]).sum() == 0.0
    assert np.abs(grads[True][4]).sum() > 0.0
    assert _rel(grads[False][0], g_x[0]) < 3e-3
    assert _rel(grads[False][2], g_x[1]) < 3e-3


def test_instance_overflow_stays_finite():
    """tests/test_round4.py:271: demand above the instance capacity drops
    the excess instances, and the image and gradients stay finite."""
    params, cam = make_scene(np.random.default_rng(0), n=2000, sh_degree=0)
    res = 128
    op = params.effective_opacity()
    proj = jax_project(params.means, params.scales, params.quats, cam,
                       opacities=op)
    colors = np.full((params.capacity, 3), 0.5, np.float32)
    leaves, img, alpha, n_inst = _port_raster(proj, colors, op, res,
                                              capacity=1 << 12)
    assert int(n_inst) > 1 << 12
    arr = img.detach().numpy()
    assert np.isfinite(arr).all() and 0.0 <= arr.min() <= arr.max() <= 1.01
    a = alpha.detach().numpy()
    assert np.isfinite(a).all() and a.max() <= 1.0 + 1e-5
    img.sum().backward()
    for x in leaves[:4]:
        assert torch.isfinite(x.grad).all()


@pytest.mark.parametrize("nch,with_absgrad", [(3, True), (3, False),
                                               (5, True)])
def test_reduce_grads_sorted_matches_jax(nch, with_absgrad):
    """The port's reduce against JAX's on the same per-instance rows and
    the same bins (culled instances, capacity tail and the guard clamp all
    present): 2e-5 of the largest segment sum."""
    tp = random_scene(np.random.default_rng(4), 600, device=CPU)
    cam = orbit_cameras(1, width=96, height_px=80, device=CPU)[0]
    from divshot_tpu_torch.raster.render import frame_inputs
    proj, colors, opac = frame_inputs(tp, cam)
    cols = colors if nch == 3 else torch.cat([colors, colors[:, :2]], 1)
    cap = 1 << 12
    sb = B.expand_sorted(proj.means2d, proj.conics, proj.depths, proj.radii,
                         proj.radii_xy, proj.rad2, cols, opac, width=96,
                         height=80, instance_capacity=cap, guard_lanes=1024)
    assert int(sb.num_instances) > 0
    rows = np.random.default_rng(5).standard_normal(
        (9 + nch, cap)).astype(np.float32)
    got = B.reduce_grads_sorted(torch.tensor(rows), sb, nch=nch)
    ngrad = jax_raster._ngrad_rows(nch)
    padded = np.zeros((ngrad, cap), np.float32)
    padded[:9 + nch] = rows
    num_tiles = sb.tile_start.shape[0] - 1
    want = jax_bin.reduce_grads_sorted(
        jnp.asarray(padded), jnp.zeros((num_tiles, ngrad, 256)),
        jnp.asarray(sb.tile_start.numpy()), jnp.asarray(sb.s_owner.numpy()),
        jnp.asarray(sb.g_offsets.numpy()), jnp.asarray(sb.g_counts.numpy()),
        nch=nch, with_absgrad=with_absgrad)
    for k in ("means2d", "conics", "colors", "opacity", "npix"):
        assert _rel(got[k].numpy(), want[k]) < 2e-5, k
    if with_absgrad:
        assert _rel(got["absgrad"].numpy(), want["absgrad"]) < 2e-5


# ---------------------------------------------------------------------------
# losses, Adam, strategies


def test_losses_match_jax():
    rng = np.random.default_rng(6)
    a = rng.uniform(0, 1, (48, 64, 3)).astype(np.float32)
    b = np.clip(a + 0.1 * rng.standard_normal(a.shape), 0, 1).astype(
        np.float32)
    ta, tb = torch.tensor(a), torch.tensor(b)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    with jax.default_matmul_precision("highest"):
        pairs = [(L.ssim(ta, tb), jax_losses.ssim(ja, jb)),
                 (L.l1(ta, tb), jax_losses.l1(ja, jb)),
                 (L.photometric_loss(ta, tb, 0.2),
                  jax_losses.photometric_loss(ja, jb, 0.2)),
                 (L.photometric_loss(ta, tb, 0.0),
                  jax_losses.photometric_loss(ja, jb, 0.0))]
        psnr = float(jax_losses.psnr(ja, jb))
    for got, want in pairs:
        np.testing.assert_allclose(float(got), float(want), atol=1e-6)
    # PSNR is ~20 dB, where one float32 ulp is 2e-6: held relatively
    np.testing.assert_allclose(float(L.psnr(ta, tb)), psnr, rtol=1e-6)
    assert float(L.ssim(ta, ta)) > 0.999


def _rand_params(rng, n=96, cap=128, sh_degree=1):
    jp = jax_random_scene(rng, n, sh_degree=sh_degree, capacity=cap)
    return jp, _params(jp)


def _rand_opt(rng, jp, step):
    d = {"mu": {}, "nu": {}}
    for f in PFIELDS:
        shape = getattr(jp, f).shape
        d["mu"][f] = (1e-3 * rng.standard_normal(shape)).astype(np.float32)
        d["nu"][f] = (1e-6 * rng.uniform(0, 1, shape)).astype(np.float32)
    jopt = jax_optim.AdamState(
        mu={f: jnp.asarray(v) for f, v in d["mu"].items()},
        nu={f: jnp.asarray(v) for f, v in d["nu"].items()},
        step=jnp.int32(step))
    topt = O.AdamState(mu={f: torch.tensor(v) for f, v in d["mu"].items()},
                       nu={f: torch.tensor(v) for f, v in d["nu"].items()},
                       step=step)
    return jopt, topt


def _assert_params(tp, jp, rtol=1e-5, atol=1e-6):
    for f in FIELDS:
        got, want = getattr(tp, f).detach().numpy(), _np(getattr(jp, f))
        if f == "alive":
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=rtol, atol=atol,
                                       err_msg=f)


def _assert_opt(topt, jopt, rtol=1e-5, atol=1e-9):
    assert topt.step == int(jopt.step)
    for f in PFIELDS:
        np.testing.assert_allclose(topt.mu[f].numpy(), _np(jopt.mu[f]),
                                   rtol=rtol, atol=atol, err_msg=f)
        np.testing.assert_allclose(topt.nu[f].numpy(), _np(jopt.nu[f]),
                                   rtol=rtol, atol=atol, err_msg=f)


@pytest.mark.parametrize("visible_adam", [False, True])
def test_adam_update_matches_jax(visible_adam):
    rng = np.random.default_rng(7)
    jp, tp = _rand_params(rng)
    jopt, topt = _rand_opt(rng, jp, step=6)
    grads = {f: (1e-3 * rng.standard_normal(getattr(jp, f).shape)).astype(
        np.float32) for f in PFIELDS}
    visible = rng.uniform(0, 1, jp.capacity) < 0.7
    jc, tc = JOptimConfig(visible_adam=visible_adam), OptimConfig(
        visible_adam=visible_adam)
    jp2, jopt2 = jax_optim.adam_update(
        jc, jp, {f: jnp.asarray(g) for f, g in grads.items()}, jopt, 2.5,
        jnp.asarray(visible))
    tp2, topt2 = O.adam_update(tc, tp, {f: torch.tensor(g) for f, g in
                                        grads.items()}, topt, 2.5,
                               torch.tensor(visible))
    _assert_params(tp2, jp2)
    _assert_opt(topt2, jopt2)
    for step in (0, 1, 700, 40_000):
        np.testing.assert_allclose(
            O.pos_lr_schedule(tc, step, 2.5),
            float(jax_optim.pos_lr_schedule(jc, jnp.int32(step), 2.5)),
            rtol=1e-6)


def _dstate(rng, cap):
    d = {"grad_accum": rng.uniform(0, 4e-3, cap).astype(np.float32),
         "count": rng.integers(0, 4, cap).astype(np.float32),
         "max_radii": rng.uniform(0, 0.2, cap).astype(np.float32)}
    return (jax_strategy.DensifyState(**{k: jnp.asarray(v)
                                         for k, v in d.items()}),
            S.DensifyState(**{k: torch.tensor(v) for k, v in d.items()}))


def _assert_dstate(td, jd):
    for k in ("grad_accum", "count", "max_radii"):
        np.testing.assert_allclose(getattr(td, k).numpy(),
                                   _np(getattr(jd, k)), rtol=1e-5,
                                   atol=1e-9, err_msg=k)


@pytest.mark.parametrize("use_abs,pixel_scale", [(True, 0.0), (False, 0.3)])
def test_update_stats_matches_jax(use_abs, pixel_scale):
    rng = np.random.default_rng(8)
    cap = 128
    jd, td = _dstate(rng, cap)
    obs = {"grad2d": rng.uniform(0, 1e-3, cap), "absgrad2d":
           rng.uniform(0, 2e-3, cap), "radii": np.where(
               rng.uniform(0, 1, cap) < 0.6, rng.uniform(1, 30, cap), 0.0),
           "npix": rng.integers(0, 300, cap)}
    obs = {k: v.astype(np.float32) for k, v in obs.items()}
    jd2 = jax_strategy.update_stats(
        jd, jax_strategy.DensifyObs(**{k: jnp.asarray(v) for k, v in
                                       obs.items()}, width=64, height=48),
        use_abs, pixel_scale)
    td2 = S.update_stats(td, S.DensifyObs(**{k: torch.tensor(v) for k, v in
                                            obs.items()}, width=64,
                                          height=48), use_abs, pixel_scale)
    _assert_dstate(td2, jd2)


def _split_eps(key, shape):
    k1, k2 = jax.random.split(key)
    return (_np(jax.random.normal(k1, shape)),
            _np(jax.random.normal(k2, shape)))


@pytest.mark.parametrize("revised,step", [(True, 400), (False, 3500)])
def test_adc_refine_matches_jax(revised, step):
    """Clone, split and prune on JAX's split draws; ``step`` 3500 also
    runs the size prune (after the first alpha reset)."""
    rng = np.random.default_rng(9)
    jp, tp = _rand_params(rng, n=96, cap=160)
    jopt, topt = _rand_opt(rng, jp, step=step)
    jd, td = _dstate(rng, jp.capacity)
    kw = dict(grow_grad2d=1e-3, revised_opacity=revised,
              refine_scale2d_stop_iter=1000, densify_scale2d=0.1,
              prune_opacity=0.2)
    key = jax.random.PRNGKey(3)
    jp2, jopt2, jd2 = jax_strategy.adc_refine(
        JDensifyConfig(**kw), jp, jopt, jd, key, jnp.int32(step), 1.5)
    eps = tuple(torch.tensor(e) for e in _split_eps(key, jp.means.shape))
    tp2, topt2, td2 = S.adc_refine(DensifyConfig(**kw), tp, topt, td, step,
                                   1.5, eps=eps)
    assert int(tp2.alive.sum()) > int(tp.alive.sum()) - 20
    assert bool((tp2.alive & ~tp.alive).any())     # clones or splits landed
    _assert_params(tp2, jp2)
    _assert_opt(topt2, jopt2)
    _assert_dstate(td2, jd2)


def test_alpha_reset_matches_jax():
    rng = np.random.default_rng(10)
    jp, tp = _rand_params(rng)
    jopt, topt = _rand_opt(rng, jp, step=3)
    jp2, jopt2 = jax_strategy.alpha_reset(JDensifyConfig(), jp, jopt)
    tp2, topt2 = S.alpha_reset(DensifyConfig(), tp, topt)
    _assert_params(tp2, jp2)
    _assert_opt(topt2, jopt2)


def test_mcmc_refine_matches_jax():
    """Relocation and growth on JAX's relocation targets; the tabulated
    split denominator equals JAX's."""
    rng = np.random.default_rng(11)
    jp, tp = _rand_params(rng, n=96, cap=160)
    jp = jp.replace(opacity=jp.opacity.at[:12].set(-8.0))   # to relocate
    tp = dataclasses.replace(tp, opacity=torch.tensor(_np(jp.opacity)))
    jopt, topt = _rand_opt(rng, jp, step=900)
    jd, td = _dstate(rng, jp.capacity)
    cfg_kw = dict(cap_max=140)
    key = jax.random.PRNGKey(4)
    jp2, jopt2, jd2 = jax_strategy.mcmc_refine(
        JDensifyConfig(**cfg_kw), jp, jopt, jd, key, jnp.int32(900), 1.5)
    # the draw jax_strategy.mcmc_refine makes
    alive = jp.alive
    alpha = jnp.where(alive, jax.nn.sigmoid(jp.opacity), 0.0)
    probs = jnp.where(alive & ~(alpha < 0.005), alpha, 0.0)
    probs = probs / jnp.maximum(probs.sum(), 1e-8)
    k1, _ = jax.random.split(key)
    targets = jax.random.choice(k1, jp.capacity, shape=(jp.capacity,),
                                p=probs)
    np.testing.assert_allclose(
        S.mcmc_sampling_probs(DensifyConfig(**cfg_kw), tp).numpy(),
        _np(probs), rtol=1e-5, atol=1e-9)
    tp2, topt2, td2 = S.mcmc_refine(DensifyConfig(**cfg_kw), tp, topt, td,
                                    900, 1.5, targets=torch.tensor(
                                        _np(targets)))
    assert int(tp2.alive.sum()) == 100      # 96 alive, grown by 5 %
    _assert_params(tp2, jp2)
    _assert_opt(topt2, jopt2)
    _assert_dstate(td2, jd2)
    np.testing.assert_array_equal(S._reloc_denom_table(),
                                  jax_strategy._RELOC_DENOM)


def test_mcmc_noise_matches_jax():
    rng = np.random.default_rng(12)
    jp, tp = _rand_params(rng)
    # the noise is gated to near-transparent splats: make a few
    jp = jp.replace(opacity=jp.opacity.at[:12].set(-7.0))
    tp = dataclasses.replace(tp, opacity=torch.tensor(_np(jp.opacity)))
    key = jax.random.PRNGKey(5)
    jp2 = jax_strategy.mcmc_noise(JDensifyConfig(), JOptimConfig(), jp, key,
                                  jnp.int32(50), 2.0)
    eps = torch.tensor(_np(jax.random.normal(key, jp.means.shape)))
    tp2 = S.mcmc_noise(DensifyConfig(), OptimConfig(), tp, 50, 2.0, eps=eps)
    _assert_params(tp2, jp2, atol=1e-6)
    assert not torch.equal(tp2.means, tp.means)


@pytest.mark.parametrize("strategy", [0, 1])
def test_periodic_prune_matches_jax(strategy):
    rng = np.random.default_rng(13)
    jp, tp = _rand_params(rng)
    jopt, topt = _rand_opt(rng, jp, step=10)
    jd, td = _dstate(rng, jp.capacity)
    kw = dict(prune_strategy=strategy, prune_opacity=0.8)
    jp2, jopt2 = jax_strategy.periodic_prune(JDensifyConfig(**kw), jp, jopt,
                                             jd, 1.0)
    tp2, topt2 = S.periodic_prune(DensifyConfig(**kw), tp, topt, td, 1.0)
    assert int(tp2.alive.sum()) < int(tp.alive.sum())
    _assert_params(tp2, jp2)
    _assert_opt(topt2, jopt2)


# ---------------------------------------------------------------------------
# one whole step, and the trainer's loss bars


def _step_setup():
    rng = np.random.default_rng(14)
    gt = jax_random_scene(rng, 300, sh_degree=1)
    cams = jax_orbit(3, width=64)
    images = jax_render_gt(gt, cams, tile_capacity=512)
    jp = jax_random_scene(rng, 200, sh_degree=1, capacity=256)
    cfg = JTrainConfig(sh_degree=1)
    cfg.densify.strategy = DensifyStrategy.ADC_PLUS
    cfg.densify.refine_every = 1000
    return cams, images, jp, cfg


@functools.lru_cache(maxsize=None)
def _jax_steps():
    """Two JAX steps on its CPU route (``"tiles"``), the state carried
    across, then a third on view 1 -> (cameras, images, config, the state
    before the third step, after it, its metrics)."""
    cams, images, jp, cfg = _step_setup()
    jds = jax_trainer.Dataset.from_views(cams, images)
    rk = {"backend": "tiles", "tile_capacity": 512,
          "instance_capacity": 1 << 15}
    step = jax.jit(jax_trainer.make_train_step(cfg, jds, rk))
    state = jax_trainer.TrainState(
        params=jp, opt=jax_optim.AdamState.init(jp),
        dstate=jax_strategy.DensifyState.init(jp.capacity),
        key=jax.random.PRNGKey(0))
    with jax.default_matmul_precision("highest"):
        for v in (0, 2):
            state, _ = step(state, jnp.int32(v))
        j2, jm = step(state, jnp.int32(1))
    return cams, images, jds, state, j2, jm


@pytest.mark.parametrize("route", [
    {}, {"backend": "tiles", "tile_capacity": 512}],
    ids=["pallas", "tiles"])
def test_train_step_matches_jax(route):
    """Two JAX steps, the state carried across, then one step in each
    package on the same view: the loss, the gradients (read from the Adam
    moment), the densification statistics and the new parameters. The
    port steps on its kernel route and on JAX's own ``"tiles"``."""
    cams, images, jds, state, j2, jm = _jax_steps()

    carried = TrainState.from_numpy({
        "params": {f: _np(getattr(state.params, f)) for f in FIELDS},
        "mu": {f: _np(v) for f, v in state.opt.mu.items()},
        "nu": {f: _np(v) for f, v in state.opt.nu.items()},
        "step": int(state.opt.step),
        "dstate": {k: _np(getattr(state.dstate, k)) for k in (
            "grad_accum", "count", "max_radii")}}, device=CPU)
    tcfg = TrainConfig(sh_degree=1)
    tcfg.densify.strategy = DensifyStrategy.ADC_PLUS
    tcfg.densify.refine_every = 1000
    tds = Dataset.from_views([_camera(c) for c in cams], images)
    assert tds.scene_extent == pytest.approx(jds.scene_extent, rel=1e-6)
    t2, tm = make_train_step(tcfg, tds, {"instance_capacity": 1 << 15,
                                         **route})(carried, 1)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    assert int(tm["num_instances"]) > 0 and int(tm["num_alive"]) == 200
    if route:
        assert int(tm["num_instances"]) == int(jm["num_instances"])
        assert int(tm["max_tile_count"]) == int(jm["max_tile_count"])
    b1 = 0.9
    for f in PFIELDS:
        g_t = (t2.opt.mu[f].double() - b1 * carried.opt.mu[f].double()) / (
            1 - b1)
        g_j = (_np(j2.opt.mu[f]).astype(np.float64)
               - b1 * _np(state.opt.mu[f]).astype(np.float64)) / (1 - b1)
        np.testing.assert_allclose(g_t.numpy(), g_j, atol=3e-4, err_msg=f)
    np.testing.assert_allclose(t2.dstate.count.numpy(),
                               _np(j2.dstate.count))
    np.testing.assert_allclose(t2.dstate.grad_accum.numpy(),
                               _np(j2.dstate.grad_accum), atol=3e-4)
    assert t2.opt.step == int(j2.opt.step) == 3
