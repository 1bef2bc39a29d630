"""Parity of the port's tile binning and tiles compositor
(``divshot_tpu_torch/raster/tiles.py``) and of its dense compositor's
gradients with the JAX package on the CPU: the same seeded numpy inputs
through ``divshot_tpu/raster/tiles.py`` and ``dense.py`` and through
their counterparts.

Tolerances, each with its reason:
- ``bin_gaussians``: the counts, offsets, demand, tile ranges, sorted
  tiles and owners and ``exp2sorted`` exactly equal; ``ids_mat`` equal
  up to the order within runs of equal keys (both sorts are stable, so
  no such run differs here);
- ``composite_tiles``: image and alpha atol 3e-5 (the forward bar of
  ``tests/test_pallas_raster.py:38``); the hand-written backward atol
  3e-4 against ``jax.grad`` of JAX's custom VJP (the binned render's bar,
  ``tests/test_round5.py:103-106``) and 2e-3 of the largest value
  against the port's own autograd of the same forward (JAX's bar for its
  VJP against its autodiff, ``tests/test_raster.py:150``);
- ``composite_dense``'s gradients: 3e-3 of each gradient's largest value
  (``tests/test_pallas_raster.py:69-71``).
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from divshot_tpu.raster import dense as jax_dense
from divshot_tpu.raster import tiles as jax_tiles
from divshot_tpu.raster.project import Projection as JProjection
from divshot_tpu.raster.project import project_gaussians as jax_project
from divshot_tpu.splat.sh import eval_sh_color as jax_eval_sh_color

from divshot_tpu_torch.raster import dense as D
from divshot_tpu_torch.raster import tiles as T
from divshot_tpu_torch.raster.project import Projection
from tests.test_raster import make_scene

RES = 128


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _t(x, grad=False):
    return torch.tensor(np.asarray(x)).requires_grad_(grad)


@functools.lru_cache(maxsize=None)
def _setup(n, seed=0):
    """make_scene's splats projected by JAX with the tight rectangles:
    (projection, colours, opacities)."""
    params, cam = make_scene(np.random.default_rng(seed), n=n, sh_degree=0)

    @jax.jit
    def inputs(p):
        op = p.effective_opacity()
        proj = jax_project(p.means, p.scales, p.quats, cam, opacities=op)
        dirs = jnp.tile(jnp.asarray([[0.0, 0, 1]]), (p.capacity, 1))
        return proj, jax_eval_sh_color(p.sh0, p.shN, dirs), op
    return inputs(params)


_jax_bin = jax.jit(jax_tiles.bin_gaussians, static_argnames=(
    "width", "height", "tile_capacity", "instance_capacity",
    "build_ids_mat"))


def _bin_both(proj, tight, **kw):
    jb = _jax_bin(
        proj.means2d, proj.depths, proj.radii, width=RES, height=RES,
        radii_xy=proj.radii_xy if tight else None,
        rad2=proj.rad2 if tight else None, **kw)
    tb = T.bin_gaussians(
        _t(proj.means2d), _t(proj.depths), _t(proj.radii), RES, RES,
        radii_xy=_t(proj.radii_xy) if tight else None,
        rad2=_t(proj.rad2) if tight else None, **kw)
    return jb, tb


@pytest.mark.parametrize("tight,ids_mat,cap,n", [
    (False, True, 1 << 15, 300), (True, True, 1 << 15, 300),
    (False, False, 1 << 15, 300), (True, False, 1 << 15, 300),
    (True, False, 1 << 12, 2000), (True, True, 1 << 12, 2000)])
def test_bin_gaussians_matches_jax(tight, ids_mat, cap, n):
    """With and without the tight rectangles and the corner cull, with and
    without the id matrix, and in overflow (tests/test_round4.py:271's
    setting: 2000 splats into 2^12 instances)."""
    proj, _, _ = _setup(n)
    jb, tb = _bin_both(proj, tight, tile_capacity=512 if ids_mat else 2048,
                       instance_capacity=cap, build_ids_mat=ids_mat)
    for f in ("num_instances", "tile_counts", "tile_start", "inst_tile",
              "inst_gauss", "exp2sorted", "g_offsets", "g_counts"):
        got, want = getattr(tb, f).numpy(), np.asarray(getattr(jb, f))
        assert got.dtype == np.int32, f
        np.testing.assert_array_equal(got, want.astype(np.int32), err_msg=f)
    if cap < 1 << 15:
        assert int(tb.num_instances) > cap
    if ids_mat:
        # equal keys would be free to differ in order, but both sorts are
        # stable: the rows are equal
        np.testing.assert_array_equal(tb.ids_mat.numpy(),
                                      np.asarray(jb.ids_mat))
    else:
        assert tb.ids_mat is None
        assert int(tb.tile_start[-1]) <= max(cap - 2048, cap // 2)


def _composite_setup(n=300, tight=False):
    proj, colors, op = _setup(n)
    jb, tb = _bin_both(proj, tight, tile_capacity=512,
                       instance_capacity=1 << 15)
    target = np.random.default_rng(1).uniform(0, 1, (RES, RES, 3)).astype(
        np.float32)
    return proj, colors, op, jb, tb, target


def _jax_loss(args, ids, target, bg, use_ad=False, sink=None):
    img, alpha = jax_tiles.composite_tiles(
        *args, ids, RES, RES, chunk=32, background=bg, absgrad_sink=sink,
        _use_autodiff=use_ad)
    return jnp.sum((img - target) ** 2) + 0.37 * jnp.sum(alpha), (img, alpha)


def test_composite_tiles_forward_matches_jax():
    proj, colors, op, jb, tb, _ = _composite_setup()
    bg = np.asarray([0.3, 0.1, 0.6], np.float32)
    with jax.default_matmul_precision("highest"):
        j_img, j_alpha = jax_tiles.composite_tiles(
            proj.means2d, proj.conics, colors, op, jb.ids_mat, RES, RES,
            chunk=32, background=jnp.asarray(bg))
    img, alpha = T.composite_tiles(
        _t(proj.means2d), _t(proj.conics), _t(colors), _t(op), tb.ids_mat,
        RES, RES, chunk=32, background=_t(bg))
    np.testing.assert_allclose(img.numpy(), np.asarray(j_img), atol=3e-5)
    np.testing.assert_allclose(alpha.numpy(), np.asarray(j_alpha), atol=3e-5)
    assert float(alpha.max()) > 0.5


def test_composite_tiles_backward_matches_jax():
    """The hand-written backward against jax.grad of JAX's custom VJP, and
    against the port's autograd through the same forward."""
    proj, colors, op, jb, tb, target = _composite_setup()
    bg = np.asarray([0.3, 0.1, 0.6], np.float32)
    args = (proj.means2d, proj.conics, colors, op)
    with jax.default_matmul_precision("highest"):
        (_, _), g_j = jax.value_and_grad(
            lambda a: _jax_loss(a, jb.ids_mat, target, jnp.asarray(bg)),
            has_aux=True)(args)
    grads = {}
    for ad in (False, True):
        leaves = [_t(x, True) for x in args] + [_t(bg, True)]
        img, alpha = T.composite_tiles(*leaves[:4], tb.ids_mat, RES, RES,
                                       chunk=32, background=leaves[4],
                                       _use_autodiff=ad)
        loss = ((img - _t(target)) ** 2).sum() + 0.37 * alpha.sum()
        grads[ad] = torch.autograd.grad(loss, leaves)
    names = ("means2d", "conics", "colors", "opacity")
    for name, got, auto, want in zip(names, grads[False], grads[True], g_j):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, atol=3e-4,
                                   err_msg=name)
        scale = np.abs(auto.numpy()).max() + 1e-8
        assert np.abs(got.numpy() - auto.numpy()).max() / scale < 2e-3, name
        assert np.abs(want).max() > 1e-3, name
    # the background's gradient: the image cotangent times T_final
    np.testing.assert_allclose(grads[False][4].numpy(),
                               grads[True][4].numpy(), rtol=1e-4)


def test_composite_tiles_absgrad_matches_jax():
    """The AbsGS harvest (tests/test_raster.py:153): the sink's gradient
    equals JAX's, and bounds the signed gradient componentwise."""
    proj, colors, op, jb, tb, target = _composite_setup(200, tight=True)
    bg = jnp.zeros((3,), jnp.float32)
    sink0 = np.zeros((proj.means2d.shape[0], 2), np.float32)
    with jax.default_matmul_precision("highest"):
        g_abs_j = jax.grad(lambda s: _jax_loss(
            (proj.means2d, proj.conics, colors, op), jb.ids_mat, target, bg,
            sink=s)[0])(jnp.asarray(sink0))
    m2d, sink = _t(proj.means2d, True), _t(sink0, True)
    img, alpha = T.composite_tiles(m2d, _t(proj.conics), _t(colors), _t(op),
                                   tb.ids_mat, RES, RES, chunk=32,
                                   absgrad_sink=sink)
    loss = ((img - _t(target)) ** 2).sum() + 0.37 * alpha.sum()
    g_m, g_abs = torch.autograd.grad(loss, [m2d, sink])
    np.testing.assert_allclose(g_abs.numpy(), np.asarray(g_abs_j), atol=3e-4)
    assert float(g_abs.sum()) > 0
    assert bool((g_abs + 1e-4 >= g_m.abs()).all())


def test_composite_tiles_empty_and_short_rows():
    """An id matrix with no instance composites the background alone, and
    a backward through it gives only the background's gradient."""
    ids = torch.full((64, 64), -1, dtype=torch.int32)
    leaves = [torch.zeros((3, 2), requires_grad=True),
              torch.ones((3, 3), requires_grad=True),
              torch.ones((3, 3), requires_grad=True),
              torch.ones((3,), requires_grad=True)]
    bg = torch.tensor([0.2, 0.4, 0.6], requires_grad=True)
    img, alpha = T.composite_tiles(*leaves, ids, RES, RES, chunk=32,
                                   background=bg)
    assert torch.equal(img, bg.detach().expand(RES, RES, 3))
    assert float(alpha.detach().abs().max()) == 0.0
    grads = torch.autograd.grad(img.sum(), leaves + [bg])
    assert all(float(g.abs().max()) == 0.0 for g in grads[:4])
    np.testing.assert_allclose(grads[4].numpy(), [RES * RES] * 3)


def test_composite_dense_gradients_match_jax():
    """The dense compositor differentiates under autograd (it raised an
    in-place error before): its gradients against jax.grad of JAX's
    ``composite_dense``, 3e-3 of each gradient's largest value; the same
    call without autograd gives the same image."""
    proj, colors, op = _setup(120, seed=3)
    res = 48
    target = np.random.default_rng(2).uniform(0, 1, (res, res, 3)).astype(
        np.float32)
    bg = np.asarray([0.2, 0.3, 0.4], np.float32)
    geom = dict(depths=proj.depths, radii=proj.radii, cov2d=proj.cov2d)

    def jloss(m2d, con, col, o):
        jp = JProjection(means2d=m2d, conics=con, comp=jnp.ones_like(o),
                         **geom)
        img, alpha = jax_dense.composite_dense(jp, col, o, res, res,
                                               background=jnp.asarray(bg))
        return jnp.sum((img - target) ** 2) + 0.37 * jnp.sum(alpha)

    args = (proj.means2d, proj.conics, colors, op)
    with jax.default_matmul_precision("highest"):
        g_j = jax.jit(jax.grad(jloss, argnums=(0, 1, 2, 3)))(*args)
    leaves = [_t(x, True) for x in args]
    tp = Projection(means2d=leaves[0], conics=leaves[1],
                    comp=torch.ones(leaves[3].shape),
                    **{k: _t(v) for k, v in geom.items()})
    img, alpha = D.composite_dense(tp, leaves[2], leaves[3], res, res,
                                   background=_t(bg))
    loss = ((img - _t(target)) ** 2).sum() + 0.37 * alpha.sum()
    loss.backward()
    for name, x, want in zip(("means2d", "conics", "colors", "opacity"),
                             leaves, g_j):
        want = np.asarray(want)
        scale = np.abs(want).max()
        assert scale > 1e-3, name
        assert np.abs(x.grad.numpy() - want).max() / scale < 3e-3, name
    with torch.no_grad():
        img2, alpha2 = D.composite_dense(tp, leaves[2], leaves[3], res, res,
                                         background=_t(bg))
    assert torch.equal(img2, img.detach()) and torch.equal(alpha2,
                                                           alpha.detach())
