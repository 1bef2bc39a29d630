"""Every route of the port's ``render`` and ``render_fast`` against the
JAX package's same route on the CPU, on the same seeded scene: XLA's
``"tiles"`` and ``"dense"``, the XLA exact-2DGS compositor
(``"surfel"``), and the kernel compositing over XLA's binning
(``backend="pallas", binning="xla"``, the kernels' plain versions here);
the trainer's route overrides and its tile-overflow warning.

Tolerances, each with its reason:
- images and alphas atol 3e-5 (``tests/test_pallas_raster.py:38``) and
  the render's gradients atol 3e-4 (``tests/test_round5.py:103-106``),
  each route against JAX's own; the surfel route's gradients, whose
  ray-plane intersections amplify float32 rounding (3.3e-4 on a means
  gradient of largest value 47.3 here), within 3e-4 of each one's largest
  value, the surfel bar of ``tests/test_pallas_surfel.py:33-63`` that
  ``tests/test_torch_surfel_parity.py`` holds; ``binning="xla"`` against
  JAX's float32
  ``"tiles"`` (its Pallas kernels' bf16 prefix sums are not an f32
  oracle, ROADMAP.md "Properties of the reference"), and its forward
  once against JAX's own ``render_fast(binning="xla")`` in interpret
  mode; the binning's integer outputs exactly;
- the feature table atol 1e-5 (each package projects the splats itself,
  and XLA's and PyTorch's float32 ``exp`` and ``log`` differ by an ulp).
"""

import dataclasses
import functools
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from divshot_tpu.core.config import TrainConfig as JTrainConfig
from divshot_tpu.gsio.synthetic import orbit_cameras as jax_orbit
from divshot_tpu.gsio.synthetic import random_scene as jax_random_scene
from divshot_tpu.raster.render import render as jax_render
from divshot_tpu.raster.render import render_fast as jax_render_fast
from divshot_tpu.train import trainer as jax_trainer

from divshot_tpu_torch.core.config import TrainConfig
from divshot_tpu_torch.raster.render import render, render_fast
from divshot_tpu_torch.train.trainer import Dataset, Trainer
from tests.test_torch_train_parity import _camera, _params

FIELDS = ("means", "scales", "quats", "sh0", "opacity")
ICAP = 1 << 13

# port route -> (its render arguments, JAX's route to hold it against)
ROUTES = {
    "tiles": (dict(backend="tiles", tile_capacity=512), "tiles"),
    "dense": (dict(backend="dense"), "dense"),
    "surfel": (dict(backend="surfel", tile_capacity=512), "surfel"),
    "pallas_xla": (dict(backend="pallas", binning="xla"), "tiles"),
}
JAX_ROUTES = {"tiles": dict(backend="tiles", tile_capacity=512),
              "dense": dict(backend="dense"),
              "surfel": dict(backend="surfel", tile_capacity=512)}


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@functools.lru_cache(maxsize=None)
def _scene():
    """test_render_matches_jax's scene: 120 splats at SH 1, 64x48."""
    jp = jax_random_scene(np.random.default_rng(0), 120, sh_degree=1)
    jc = jax_orbit(1, width=64, height_px=48)[0]
    return jp, jc


def _loss(image, alpha):
    return (image * image).sum() + alpha.sum()


@functools.lru_cache(maxsize=None)
def _jax_route(name):
    """JAX's render on route ``name`` -> (image, alpha, gradients,
    num_instances, max_tile_count)."""
    jp, jc = _scene()

    def f(fl):
        out = jax_render(jp.replace(**fl), jc, instance_capacity=ICAP,
                         **JAX_ROUTES[name])
        return _loss(out.image, out.alpha), (out.image, out.alpha,
                                             out.num_instances,
                                             out.max_tile_count)
    with jax.default_matmul_precision("highest"):
        (_, (img, alpha, ni, mtc)), g = jax.jit(
            jax.value_and_grad(f, has_aux=True))(
                {k: getattr(jp, k) for k in FIELDS})
    return (np.asarray(img), np.asarray(alpha),
            {k: np.asarray(v) for k, v in g.items()},
            None if ni is None else int(ni),
            None if mtc is None else int(mtc))


def _port_route(**kw):
    jp, jc = _scene()
    tp = _params(jp)
    leaves = {k: getattr(tp, k).clone().requires_grad_() for k in FIELDS}
    out = render(dataclasses.replace(tp, **leaves), _camera(jc),
                 instance_capacity=ICAP, **kw)
    _loss(out.image, out.alpha).backward()
    return out, {k: v.grad.numpy() for k, v in leaves.items()}


@pytest.mark.parametrize("route", list(ROUTES))
def test_render_route_matches_jax(route):
    """The image, alpha, gradients and binning counters of each route."""
    kw, jname = ROUTES[route]
    img_j, alpha_j, g_j, ni_j, mtc_j = _jax_route(jname)
    out, g = _port_route(**kw)
    assert out.image.shape == (48, 64, 3)
    np.testing.assert_allclose(out.image.detach().numpy(), img_j, atol=3e-5)
    np.testing.assert_allclose(out.alpha.detach().numpy(), alpha_j,
                               atol=3e-5)
    assert float(out.alpha.detach().max()) > 0.3
    for k in FIELDS:
        scale = np.abs(g_j[k]).max()
        assert scale > 1e-2, k
        if route == "surfel":
            assert np.abs(g[k] - g_j[k]).max() < 3e-4 * scale, k
        else:
            np.testing.assert_allclose(g[k], g_j[k], atol=3e-4, err_msg=k)
    if route == "dense":
        assert out.num_instances is None and ni_j is None
    else:
        assert int(out.num_instances) == ni_j > 0
        assert int(out.max_tile_count) == mtc_j > 0


def test_routes_reject_extra_colors_off_pallas():
    jp, jc = _scene()
    tp = _params(jp)
    extra = torch.zeros((tp.capacity, 2))
    for backend in ("tiles", "dense"):
        with pytest.raises(ValueError, match="requires the pallas backend"):
            render(tp, _camera(jc), backend=backend, extra_colors=extra)
    out = render(tp, _camera(jc), backend="pallas", binning="xla",
                 extra_colors=extra, instance_capacity=ICAP)
    assert out.extra.shape == (48, 64, 2)
    assert float(out.extra.abs().max()) == 0.0


def test_render_fast_xla_matches_jax():
    """JAX's ``render_fast(binning="xla")`` (its forward kernel in
    interpret mode, the one interpret call of this file) against the
    port's: the bins exactly, the table, the image and alpha; the port's
    ``render(backend="pallas", binning="xla")`` forward equals its
    ``render_fast`` frame; a stale token raises on this branch too."""
    jp, jc = _scene()
    bg = np.asarray([0.1, 0.2, 0.3], np.float32)
    j_img, j_alpha, jb = jax_render_fast(
        jp, jc, background=jnp.asarray(bg), binning="xla",
        instance_capacity=ICAP)
    tp, cam = _params(jp), _camera(jc)
    img, alpha, tb = render_fast(tp, cam, background=torch.tensor(bg),
                                 binning="xla", instance_capacity=ICAP,
                                 params_token=7)
    np.testing.assert_array_equal(tb.tile_start.numpy(),
                                  np.asarray(jb.tile_start))
    assert int(tb.num_instances) == int(jb.num_instances) > 0
    # JAX's table pads its rows to a multiple of 8
    rows = tb.table.shape[0]
    np.testing.assert_allclose(tb.table.numpy(),
                               np.asarray(jb.table)[:rows], atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(img.numpy(), np.asarray(j_img), atol=3e-5)
    np.testing.assert_allclose(alpha.numpy(), np.asarray(j_alpha),
                               atol=3e-5)
    with torch.no_grad():
        out = render(tp, cam, background=torch.tensor(bg), backend="pallas",
                     binning="xla", instance_capacity=ICAP)
    assert torch.equal(out.image, img) and torch.equal(out.alpha, alpha)
    again, _, _ = render_fast(tp, cam, background=torch.tensor(bg),
                              binning="xla", bins=tb, params_token=7)
    assert torch.equal(again, img)
    with pytest.raises(ValueError, match="stale FastBins"):
        render_fast(tp, cam, binning="xla", bins=tb, params_token=8)


def _tiny_trainer_inputs():
    rng = np.random.default_rng(4)
    jp = jax_random_scene(rng, 150, sh_degree=0, capacity=160)
    jcams = jax_orbit(2, width=32)
    images = np.zeros((2, 32, 32, 3), np.uint8)
    return jp, jcams, images


def test_tile_overflow_warning_matches_jax():
    """The ``"tiles"`` route's per-tile overflow warning: JAX's and the
    port's ``check_overflow`` warn once, with the same message, when the
    densest tile passes ``tile_capacity``; not on another route. The
    port's trainer then warns from a step's measured count."""
    jp, jcams, images = _tiny_trainer_inputs()
    rk = {"backend": "tiles", "tile_capacity": 64}
    m = {"num_instances": 100, "max_tile_count": 65}
    msgs = {}
    for name, tr in (
            ("jax", jax_trainer.Trainer(
                JTrainConfig(), jax_trainer.Dataset.from_views(jcams, images),
                jp, render_kwargs=rk)),
            ("port", Trainer(TrainConfig(), Dataset.from_views(
                [_camera(c) for c in jcams], images), _params(jp),
                render_kwargs=rk))):
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            tr.check_overflow(m)
            tr.check_overflow(m)
        msgs[name] = [str(x.message) for x in w]
    assert msgs["port"] == msgs["jax"]
    assert len(msgs["port"]) == 1 and "tile_capacity 64" in msgs["port"][0]
    tr = Trainer(TrainConfig(), Dataset.from_views(
        [_camera(c) for c in jcams], images), _params(jp),
        render_kwargs={"backend": "pallas", "binning": "xla",
                       "tile_capacity": 64})
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        tr.check_overflow(m)
    assert not w
    tr = Trainer(TrainConfig(), Dataset.from_views(
        [_camera(c) for c in jcams], images), _params(jp),
        render_kwargs={"backend": "tiles", "tile_capacity": 32,
                       "instance_capacity": 1 << 14})
    with pytest.warns(RuntimeWarning, match="tile_capacity 32"):
        tr.run(2, log_every=1)
    assert tr.metrics_history[-1]["max_tile_count"] > 32
