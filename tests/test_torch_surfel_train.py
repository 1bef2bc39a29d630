"""The 2DGS training step of the port against the JAX package's on the
CPU, with the state carried across as in ``test_torch_train_parity``: the
exact route against JAX's float32 XLA surfel compositor, and the
flattened route and 3DGS with the geometry losses against JAX's XLA tile
rasterizer, each through the port's kernel routes (their plain versions)
and through its counterparts of JAX's own routes (``"surfel"`` and
``"tiles"``); then the 2DGS loss bar of ``tests/test_train.py:103-113``
met by the port's trainer.

Tolerances: the loss rtol 1e-5, the gradients (read from the Adam moment)
atol 3e-4, the densification counts exactly and their gradient sums atol
3e-4 (``test_torch_train_parity``'s whole-step bars), the largest radii
rtol 1e-6 (radius / max(W, H): one float32 ulp). The scene (seed 15) is
a typical one: its views hold grazing ray-surfel pairs (``_grazing``,
|u| > 1000), whose intersection depth is ill-conditioned in float32.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from divshot_tpu.core.config import TrainConfig as JTrainConfig
from divshot_tpu.gsio.synthetic import orbit_cameras as jax_orbit
from divshot_tpu.gsio.synthetic import random_scene as jax_random_scene
from divshot_tpu.gsio.synthetic import render_gt_images as jax_render_gt
from divshot_tpu.raster.surfel import project_surfels as jax_project
from divshot_tpu.raster.surfel import render_surfels as jax_render_surfels
from divshot_tpu.train import optim as jax_optim
from divshot_tpu.train import strategy as jax_strategy
from divshot_tpu.train import trainer as jax_trainer

from divshot_tpu_torch.core.config import DensifyStrategy, TrainConfig
from divshot_tpu_torch.raster.surfel_raster import render_surfels
from divshot_tpu_torch.splat.camera import Camera
from divshot_tpu_torch.train.trainer import (Dataset, Trainer, TrainState,
                                             make_train_step)
from tests.test_torch_trainer import _small_setup

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


def _camera(jc) -> Camera:
    return Camera.from_numpy({k: _np(getattr(jc, k)) for k in (
        "viewmat", "fx", "fy", "cx", "cy", "width", "height")}, device=CPU)


# the configurations under test: the exact 2DGS route with the normal loss
# from step 0, and the distortion loss either computed at weight 0 (not yet
# started) or on from step 0; the flattened route; 3DGS with both losses
# from step 0. Each keeps the signed screen gradients in the densification
# statistics (the XLA surfel route feeds its signed gradient to both sinks).
CASES = {
    "exact": dict(model_type=1, normal_start_iter=0, dist_loss_weight=1.0,
                  dist_start_iter=100),
    "exact_distortion": dict(model_type=1, normal_start_iter=0,
                             dist_loss_weight=1.0, dist_start_iter=0),
    "flattened": dict(model_type=1, surfel_exact=False, normal_start_iter=0,
                      normal_loss_weight=0.05),
    "3dgs_geometry": dict(normal_consistency_loss=True, normal_start_iter=0,
                          dist_loss_weight=1.0, dist_start_iter=0),
}


def _grazing(jp, cams, u_max: float = 1000.0) -> bool:
    """Whether a pixel of ``cams`` meets a splat of ``jp`` at a pair that
    passes the alpha and depth culls (float64) with |u| or |v| above
    ``u_max``."""
    op = np.asarray(jp.effective_opacity(), np.float64)
    for cam in cams:
        pr = {k: np.asarray(v, np.float64) for k, v in jax_project(
            jp.means, jp.scales, jp.quats, cam).items()}
        vis = pr["radii"] > 0
        T = pr["Tmat"][vis].reshape(-1, 9)[:, None, :]
        ys, xs = np.mgrid[0:cam.height, 0:cam.width] + 0.5
        x, y = xs.reshape(1, -1), ys.reshape(1, -1)
        hu = [x * T[..., 6 + i] - T[..., i] for i in range(3)]
        hv = [y * T[..., 6 + i] - T[..., 3 + i] for i in range(3)]
        p0 = hu[1] * hv[2] - hu[2] * hv[1]
        p1 = hu[2] * hv[0] - hu[0] * hv[2]
        p2 = hu[0] * hv[1] - hu[1] * hv[0]
        p2 = np.where(np.abs(p2) > 1e-9, p2, np.nan)
        u, v = p0 / p2, p1 / p2
        c2 = pr["center2d"][vis][:, None, :]
        d2 = (x - c2[..., 0]) ** 2 + (y - c2[..., 1]) ** 2
        rho = np.minimum(u * u + v * v, 2.0 * d2)
        z = pr["zplane"][vis][:, None, :] @ np.stack(
            [u, v, np.ones_like(u)], 1)
        a = op[vis][:, None] * np.exp(-0.5 * rho)
        ok = (a >= 1 / 255) & (z[:, 0] > 0.01)
        if (ok & (np.maximum(np.abs(u), np.abs(v)) > u_max)).any():
            return True
    return False


def _step_scene():
    """-> (cameras, GT images, model params) of seed 15, whose views hold
    grazing pairs."""
    rng = np.random.default_rng(15)
    gt = jax_random_scene(rng, 300, sh_degree=1)
    cams = jax_orbit(3, width=48)
    jp = jax_random_scene(rng, 60, sh_degree=1, capacity=128,
                          scale_range=(0.03, 0.12))
    assert _grazing(jp, cams)
    return cams, jax_render_gt(gt, cams, tile_capacity=512), jp


def _tie_bound(cfg, jparams, params, cam, jcam, rk):
    """The distortion loss max(z2 alpha - z^2, 0) is 0 in exact arithmetic
    at every pixel that one splat covers, so float32 rounding picks its
    side there, and with the depth weights detached its gradient on the
    active side (w z^2 dw) is not 0. No evaluation, float64 included,
    decides that tie, and JAX's own side depends on how XLA fuses the
    program (its render alone and inside a gradient round differently),
    so it cannot be read off a render. The tie pixels: |dist| within 1e-5
    of z2 alpha in the port's render or JAX's, or on different sides in
    the two. -> (per parameter field, wd / (H W) times the sum over the
    tie pixels of |d dist / d field|, which bounds what the sides there
    can move the step's gradient; the same for the means2d sink; the
    number of tie pixels)."""
    def jax_dist(p):
        out, _ = jax_render_surfels(p, jcam, with_geometry=True, **rk)
        return out.extra[..., 1] * out.alpha - out.extra[..., 0] ** 2

    j_dist = _np(jax.jit(jax_dist)(jparams)).astype(np.float64)
    leaves = {f: getattr(params, f).detach().requires_grad_(True)
              for f in PFIELDS}
    sink = torch.zeros((params.capacity, 2), requires_grad=True)
    out = render_surfels(dataclasses.replace(params, **leaves), cam,
                         with_geometry=True, means2d_sink=sink,
                         instance_capacity=rk["instance_capacity"])
    dist = out.extra[..., 1] * out.alpha - out.extra[..., 0] ** 2
    d_t = dist.detach().double().numpy()
    z2a = (out.extra[..., 1] * out.alpha).detach().abs().double().numpy()
    tie = ((((np.abs(d_t) <= 1e-5 * z2a) | (np.abs(j_dist) <= 1e-5 * z2a))
            & (z2a > 0)) | ((d_t > 0) != (j_dist > 0)))
    inputs = [*leaves.values(), sink]
    bound = [np.zeros(tuple(x.shape)) for x in inputs]
    for i, j in np.argwhere(tie):
        grads = torch.autograd.grad(dist[i, j], inputs, retain_graph=True,
                                    allow_unused=True)
        for b, g in zip(bound, grads):
            if g is not None:
                b += np.abs(g.double().numpy())
    scale = cfg.dist_loss_weight / dist.numel()
    return ({f: scale * b for f, b in zip(PFIELDS, bound)},
            scale * bound[-1], int(tie.sum()))


def _configure(cfg, case):
    cfg = dataclasses.replace(cfg, sh_degree=1, **CASES[case])
    cfg.densify.strategy = DensifyStrategy.ADC_PLUS
    cfg.densify.use_abs_grad = False
    cfg.densify.refine_every = 1000
    return cfg


@functools.lru_cache(maxsize=None)
def _jax_steps(case):
    """Two JAX steps on its CPU route, the state carried across, then a
    third on view 1 -> (cameras, images, its render arguments, the state
    before the third step, after it, its metrics)."""
    cams, images, jp = _step_scene()
    jcfg = _configure(JTrainConfig(), case)
    jds = jax_trainer.Dataset.from_views(cams, images)
    rk = {"backend": "surfel" if case.startswith("exact") else "tiles",
          "tile_capacity": 512, "instance_capacity": 1 << 14}
    step = jax.jit(jax_trainer.make_train_step(jcfg, jds, rk))
    state = jax_trainer.TrainState(
        params=jp, opt=jax_optim.AdamState.init(jp),
        dstate=jax_strategy.DensifyState.init(jp.capacity),
        key=jax.random.PRNGKey(0))
    with jax.default_matmul_precision("highest"):
        for v in (0, 2):
            state, _ = step(state, jnp.int32(v))
        j2, jm = step(state, jnp.int32(1))
    return cams, images, rk, state, j2, jm


# every case on the kernel route, and on JAX's own routes all but the
# distortion from step 0, whose tie bound takes a gradient a tie pixel
# (a minute through the checkpointed XLA surfel compositor)
STEP_CASES = [(c, "kernel") for c in CASES] + [
    (c, "xla") for c in CASES if c != "exact_distortion"]


@pytest.mark.parametrize("case,route", STEP_CASES)
def test_2dgs_train_step_matches_jax(case, route):
    """Two JAX steps, the state carried across, then one step in each
    package on the same view: the loss, the gradients, the densification
    statistics and the step count; the port on its kernel route and on
    JAX's own (``"surfel"`` or ``"tiles"``). On the kernel route the
    flattened and 3DGS cases do not compare the densification gradient
    sums: JAX's XLA tile route composites the geometry planes in two
    further renders that do not carry the means2d sink, so its statistic
    leaves out the geometry losses' screen gradient, which the port's
    single compositing pass (as JAX's kernel route) includes; the port's
    ``"tiles"`` route renders as JAX's, so there they are compared. With
    the distortion loss on, each gradient may differ by what the pixels
    at its tie can move it (``_tie_bound``), on top of the 3e-4."""
    cams, images, rk, state, j2, jm = _jax_steps(case)
    xla = route == "xla"

    carried = TrainState.from_numpy({
        "params": {f: _np(getattr(state.params, f)) for f in FIELDS},
        "mu": {f: _np(v) for f, v in state.opt.mu.items()},
        "nu": {f: _np(v) for f, v in state.opt.nu.items()},
        "step": int(state.opt.step),
        "dstate": {k: _np(getattr(state.dstate, k)) for k in (
            "grad_accum", "count", "max_radii")}}, device=CPU)
    tcfg = _configure(TrainConfig(), case)
    tds = Dataset.from_views([_camera(c) for c in cams], images)
    t2, tm = make_train_step(tcfg, tds, rk if xla else {
        "instance_capacity": 1 << 14})(carried, 1)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    assert int(tm["num_instances"]) > 0
    slack = {f: 0.0 for f in PFIELDS}
    ga_slack = 0.0
    if case == "exact_distortion":
        srk = {k: rk[k] for k in ("tile_capacity", "instance_capacity")}
        slack, m2d_slack, n_tie = _tie_bound(
            tcfg, state.params, carried.params, tds.cameras[1], cams[1], srk)
        assert n_tie > 0                      # the tie is met on this scene
        ndc = np.array([cams[1].width / 2.0, cams[1].height / 2.0])
        ga_slack = np.linalg.norm(m2d_slack * ndc, axis=-1)
    b1 = 0.9
    for f in PFIELDS:
        g_t = (t2.opt.mu[f].double() - b1 * carried.opt.mu[f].double()) / (
            1 - b1)
        g_j = (_np(j2.opt.mu[f]).astype(np.float64)
               - b1 * _np(state.opt.mu[f]).astype(np.float64)) / (1 - b1)
        assert f == "shN" or np.abs(g_j).max() > 0, f   # SH band 0 only
        np.testing.assert_array_less(np.abs(g_t.numpy() - g_j),
                                     slack[f] + 3e-4 + 1e-7 * np.abs(g_j),
                                     err_msg=f)
    np.testing.assert_array_equal(t2.dstate.count.numpy(),
                                  _np(j2.dstate.count))
    if case.startswith("exact") or xla:
        # the norm of the screen gradient moves by at most the norm of what
        # the tie pixels can move it by
        err = np.abs(t2.dstate.grad_accum.numpy().astype(np.float64)
                     - _np(j2.dstate.grad_accum))
        assert (err <= ga_slack + 3e-4).all(), err.max()
    np.testing.assert_allclose(t2.dstate.max_radii.numpy(),
                               _np(j2.dstate.max_radii), rtol=1e-6)
    assert t2.opt.step == int(j2.opt.step) == 3


def test_port_trainer_meets_2dgs_bar():
    """tests/test_train.py:103-113: 2DGS surfels with the normal-consistency
    loss from step 0 train stably, the mean loss of the last 10 of 60
    steps below the first 10, through the exact route."""
    cfg, ds, params = _small_setup(np.random.default_rng(0),
                                   DensifyStrategy.ADC_PLUS, res=48,
                                   n_views=6)
    cfg = cfg.replace(model_type=1, normal_consistency_loss=True,
                      normal_start_iter=0)
    tr = Trainer(cfg, ds, params,
                 render_kwargs={"instance_capacity": 1 << 15})
    losses = []
    tr.run(60, log_every=0,
           callback=lambda i, s, m: losses.append(float(m["loss"])))
    losses = np.asarray(losses)
    assert np.isfinite(losses).all()
    assert losses[-10:].mean() < losses[:10].mean()
    assert tr.state.step == 60
