"""The static trainer's options in the port against the JAX package on the
CPU: the background model's four functions; one train step from a
carried-across state with the envmap, with masks, with batches (3DGS and
exact 2DGS), at 1/2 and 1/4 resolution and with bf16 ``shN``; the
progressive schedule and its resume; bf16 ``shN`` through Adam, the
strategies and a checkpoint, the bar of ``tests/test_round3.py:125-158``
and the automatic raise of ``pack_level``; ``debug_nan``.

Tolerances (``tests/test_torch_train_parity.py``'s whole-step bars): the
loss rtol 1e-5, the gradients read from the Adam moment atol 3e-4, the
densification counts exactly and their gradient sums atol 3e-4; the
envmap's functions atol 1e-6 (float32 libm differences), plus for a
sample what two ulps of pi in XLA's arccos can move it; the envmap's new
parameters and moments within 1e-5 of their largest entry (its gradient
is a scatter-add whose float32 order differs from XLA's). A bf16 buffer
may differ by one bf16 ulp where the float32 values before rounding
differ, and the gradient read from a bf16 moment by ten such ulps (the
moment's 1 - b1 = 0.1).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from divshot_tpu.core.config import TrainConfig as JTrainConfig
from divshot_tpu.gsio.synthetic import orbit_cameras as jax_orbit
from divshot_tpu.gsio.synthetic import random_scene as jax_random_scene
from divshot_tpu.gsio.synthetic import render_gt_images as jax_render_gt
from divshot_tpu.models import background as JBG
from divshot_tpu.train import optim as jax_optim
from divshot_tpu.train import strategy as jax_strategy
from divshot_tpu.train import trainer as jax_trainer

from divshot_tpu_torch.core.config import DensifyStrategy, TrainConfig
from divshot_tpu_torch.gsio.synthetic import (orbit_cameras, random_scene,
                                              render_gt_images)
from divshot_tpu_torch.models import background as BG
from divshot_tpu_torch.splat.camera import Camera
from divshot_tpu_torch.splat.gaussians import GaussianParams
from divshot_tpu_torch.train import checkpoint as CK
from divshot_tpu_torch.train import strategy as S
from divshot_tpu_torch.train import trainer as TR
from divshot_tpu_torch.train.optim import (PARAM_FIELDS, AdamState,
                                           adam_update)
from divshot_tpu_torch.train.trainer import (Dataset, Trainer, TrainState,
                                             make_train_step)
from tests.test_torch_surfel_train import CASES as SURFEL_CASES
from tests.test_torch_surfel_train import _step_scene as surfel_scene

CPU = "cpu"
FIELDS = (*PARAM_FIELDS, "alive")
BF16 = torch.bfloat16


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


# ---------------------------------------------------------------------------
# the background model


def test_background_functions_match_jax():
    rng = np.random.default_rng(0)
    for color in ((1, 1, 1), (0, 0, 0), (0.2, 0.5, 0.9)):
        np.testing.assert_allclose(
            BG.init_envmap(init_color=color, device=CPU).numpy(),
            _np(JBG.init_envmap(init_color=color)), atol=1e-6)
    env = rng.normal(0, 2, (16, 32, 3)).astype(np.float32)
    # random directions, both poles, and azimuths on both sides of the
    # seam at phi = +-pi where u wraps
    d = rng.normal(size=(500, 3))
    seam = np.array([[-1.0, y, s * 1e-4] for y in (-0.5, 0.0, 0.7)
                     for s in (-1, 1)] + [[-1.0, 0.0, 0.0]])
    poles = np.array([[0.0, 1.0, 0.0], [0.0, -1.0, 0.0], [1e-5, 1.0, 0.0],
                      [0.0, -1.0, 1e-5]])
    d = np.concatenate([d, seam, poles])
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    # XLA's float32 arccos is off the correctly rounded value by up to two
    # ulps of pi for a fifth of the inputs, torch's is not: theta may
    # differ by that much, which moves a sample by at most its slope in v,
    # (He - 1) / pi times the largest step between rows, times the
    # sigmoid's largest slope 1/4
    slope = 0.25 * (env.shape[0] - 1) / np.pi * np.abs(np.diff(env, axis=0)
                                                       ).max()
    atol = 1e-6 + slope * 2 * np.spacing(np.float32(np.pi))
    out = BG.sample_envmap(torch.from_numpy(env), torch.from_numpy(d))
    ref = JBG.sample_envmap(jnp.asarray(env), jnp.asarray(d))
    np.testing.assert_allclose(out.numpy(), _np(ref), atol=atol)
    theta = np.arccos(np.clip(d[:, 1].astype(np.float64), -1, 1))
    np.testing.assert_allclose(
        torch.arccos(torch.from_numpy(d[:, 1])).numpy(), theta, rtol=0,
        atol=np.spacing(np.float32(np.pi)))
    for jc in jax_orbit(2, width=40, height_px=24):
        cam = _camera(jc)
        np.testing.assert_allclose(BG.pixel_ray_dirs(cam).numpy(),
                                   _np(JBG.pixel_ray_dirs(jc)), atol=1e-6)
        np.testing.assert_allclose(
            BG.render_background(torch.from_numpy(env), cam).numpy(),
            _np(JBG.render_background(jnp.asarray(env), jc)), atol=atol)
    # the gather's backward: the same envmap gradient as JAX's
    w = rng.normal(size=(d.shape[0], 3)).astype(np.float32)
    e = torch.from_numpy(env).requires_grad_()
    (BG.sample_envmap(e, torch.from_numpy(d)) * torch.from_numpy(w)
     ).sum().backward()
    g = jax.grad(lambda x: jnp.sum(JBG.sample_envmap(x, jnp.asarray(d))
                                   * w))(jnp.asarray(env))
    # each sample's bilinear weights move with v by at most dv, and its
    # sigmoid slope (at most 1/4) by at most 0.1 times its logit's move
    dv = (env.shape[0] - 1) / np.pi * 2 * np.spacing(np.float32(np.pi))
    row_step = np.abs(np.diff(env, axis=0)).max()
    He, We = env.shape[:2]
    v0 = np.clip(np.floor(np.arccos(np.clip(d[:, 1], -1, 1)) / np.pi
                          * (He - 1)).astype(int), 0, He - 2)
    u0 = np.floor((np.arctan2(d[:, 2], d[:, 0]) / (2 * np.pi) + 0.5) * We
                  - 0.5).astype(int)
    touch = np.zeros((He, We))
    for dv_, du in ((0, 0), (0, 1), (1, 0), (1, 1)):
        np.add.at(touch, (v0 + dv_, (u0 + du) % We), np.abs(w).max(-1))
    g_atol = 1e-6 + touch[..., None] * dv * (0.25 + 0.1 * row_step)
    np.testing.assert_array_less(np.abs(e.grad.numpy() - _np(g)),
                                 np.broadcast_to(g_atol, env.shape))


# ---------------------------------------------------------------------------
# one step from a carried-across state


def _bf16_ulp(x):
    x = np.abs(np.asarray(x, np.float64))
    return np.where(x > 0, 2.0 ** (np.floor(np.log2(np.maximum(x, 1e-38)))
                                   - 7), 0.0)


def _carry(state) -> TrainState:
    d = {"params": {f: _np(getattr(state.params, f)) for f in FIELDS},
         "mu": {f: _np(v) for f, v in state.opt.mu.items()},
         "nu": {f: _np(v) for f, v in state.opt.nu.items()},
         "step": int(state.opt.step),
         "dstate": {k: _np(getattr(state.dstate, k)) for k in (
             "grad_accum", "count", "max_radii")}}
    if state.bg is not None:
        d["bg"] = {k: _np(v) for k, v in state.bg.items()}
    return TrainState.from_numpy(d, device=CPU)


STEP_CASES = {
    "enable_bg": dict(cfg=dict(enable_bg=True)),
    "masks": dict(masks=True),
    "batch3": dict(views=([0, 2, 1], [2, 1, 0], [1, 0, 2])),
    "res2": dict(res_scale=2),
    "res4": dict(res_scale=4),
    "pack1": dict(pack=True),
}


def _step_scene():
    """A 74x58 scene: neither the full size nor its halves and quarters
    (37x29, 18x14) are whole tiles, and 74x58 is cropped to 72x56 before
    the quarter pool."""
    rng = np.random.default_rng(14)
    gt = jax_random_scene(rng, 300, sh_degree=1)
    cams = jax_orbit(3, width=74, height_px=58)
    images = jax_render_gt(gt, cams, tile_capacity=512)
    jp = jax_random_scene(rng, 200, sh_degree=1, capacity=256)
    return cams, images, jp


def _configure(cfg, signed=False, **kw):
    """``signed``: the densification statistics from the signed screen
    gradients, as JAX's XLA surfel route gives them to both sinks
    (``tests/test_torch_surfel_train.py``)."""
    cfg = dataclasses.replace(cfg, sh_degree=1, **kw)
    cfg.densify.strategy = DensifyStrategy.ADC_PLUS
    cfg.densify.refine_every = 1000
    if signed:
        cfg.densify.use_abs_grad = False
    return cfg


def _run_case(cams, images, jp, spec, cfg_kw, rk, icap):
    """Two JAX steps, the state carried across, then one step in each
    package, as ``spec`` (a ``STEP_CASES`` entry) says -> (JAX state
    before the last step, after it, its metrics, the carried state, the
    port's state after its step, its metrics)."""
    masks = None
    if spec.get("masks"):
        masks = np.full(images.shape[:3], 255, np.uint8)
        masks[:, :, : images.shape[2] // 2] = 0
        masks[:, ::3] = 128
    rs = spec.get("res_scale", 1)
    views = spec.get("views", (0, 2, 1))
    jcfg = _configure(JTrainConfig(), **cfg_kw, **spec.get("cfg", {}))
    jds = jax_trainer.Dataset.from_views(cams, images, masks=masks)
    step = jax.jit(jax_trainer.make_train_step(jcfg, jds, rk, res_scale=rs))
    if spec.get("pack"):
        jp = jp.replace(shN=jp.shN.astype(jnp.bfloat16))
    bg = None
    if jcfg.enable_bg:
        env = np.random.default_rng(3).normal(0, 1, (16, 32, 3))
        env = jnp.asarray(env, jnp.float32)
        bg = {"params": env, "mu": jnp.zeros_like(env),
              "nu": jnp.zeros_like(env)}
    state = jax_trainer.TrainState(
        params=jp, opt=jax_optim.AdamState.init(jp),
        dstate=jax_strategy.DensifyState.init(jp.capacity),
        key=jax.random.PRNGKey(0), bg=bg)
    with jax.default_matmul_precision("highest"):
        for v in views[:2]:
            state, _ = step(state, jnp.asarray(v, jnp.int32))
        j2, jm = step(state, jnp.asarray(views[2], jnp.int32))
    carried = _carry(state)
    tcfg = _configure(TrainConfig(), **cfg_kw, **spec.get("cfg", {}))
    tds = Dataset.from_views([_camera(c) for c in cams], images, masks=masks)
    t2, tm = make_train_step(tcfg, tds, {"instance_capacity": icap},
                             res_scale=rs)(carried, views[2])
    return state, j2, jm, carried, t2, tm


def _assert_step(state, j2, jm, carried, t2, tm, grad_slack=None):
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    assert int(tm["num_instances"]) > 0
    assert int(tm["num_instances"]) == int(jm["num_instances"])
    b1 = 0.9
    for f in PARAM_FIELDS:
        mu_t, mu_j = t2.opt.mu[f], _np(j2.opt.mu[f])
        assert mu_t.dtype == getattr(t2.params, f).dtype
        assert str(mu_t.dtype).endswith(str(mu_j.dtype)), (f, mu_t.dtype)
        g_t = (mu_t.double() - b1 * carried.opt.mu[f].double()) / (1 - b1)
        g_j = (mu_j.astype(np.float64)
               - b1 * _np(state.opt.mu[f]).astype(np.float64)) / (1 - b1)
        slack = 3e-4
        if mu_t.dtype == BF16:
            slack = slack + 10 * _bf16_ulp(np.maximum(
                np.abs(mu_t.double().numpy()), np.abs(mu_j.astype(
                    np.float64))))
            p_t = getattr(t2.params, f).double().numpy()
            p_j = _np(getattr(j2.params, f)).astype(np.float64)
            np.testing.assert_array_less(np.abs(p_t - p_j), _bf16_ulp(
                np.maximum(np.abs(p_t), np.abs(p_j))) + 1e-12, err_msg=f)
        np.testing.assert_array_less(np.abs(g_t.numpy() - g_j),
                                     slack + 1e-7 * np.abs(g_j), err_msg=f)
    np.testing.assert_array_equal(t2.dstate.count.numpy(),
                                  _np(j2.dstate.count))
    np.testing.assert_allclose(t2.dstate.grad_accum.numpy(),
                               _np(j2.dstate.grad_accum), atol=3e-4)
    np.testing.assert_allclose(t2.dstate.max_radii.numpy(),
                               _np(j2.dstate.max_radii), rtol=1e-6)
    assert t2.opt.step == int(j2.opt.step) == 3


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_option_step_matches_jax(case):
    cams, images, jp = _step_scene()
    rk = {"backend": "tiles", "tile_capacity": 512,
          "instance_capacity": 1 << 15}
    state, j2, jm, carried, t2, tm = _run_case(
        cams, images, jp, STEP_CASES[case], {}, rk, 1 << 15)
    _assert_step(state, j2, jm, carried, t2, tm)
    if case == "enable_bg":
        for k in ("params", "mu", "nu"):
            ref = _np(j2.bg[k])
            err = np.abs(t2.bg[k].numpy() - ref).max()
            assert err <= 1e-5 * np.abs(ref).max(), (k, err)
        assert float(np.abs(_np(j2.bg["mu"])).max()) > 0
    if case.startswith("res"):
        s = STEP_CASES[case]["res_scale"]
        assert t2.dstate.max_radii.shape == (256,)
        assert (74 // s, 58 // s) in ((37, 29), (18, 14))


def test_batched_exact_2dgs_step_matches_jax():
    """batch_size=2 through the surfel kernels' plain versions against
    JAX's XLA surfel compositor, on ``tests/test_torch_surfel_train``'s
    scene and its exact case."""
    cams, images, jp = surfel_scene()
    kw = dict(SURFEL_CASES["exact"], signed=True)
    rk = {"backend": "surfel", "tile_capacity": 512,
          "instance_capacity": 1 << 14}
    state, j2, jm, carried, t2, tm = _run_case(
        cams, images, jp, dict(views=([0, 2], [2, 1], [1, 2])), kw, rk,
        1 << 14)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    b1 = 0.9
    for f in PARAM_FIELDS:
        g_t = (t2.opt.mu[f].double() - b1 * carried.opt.mu[f].double()) / (
            1 - b1)
        g_j = (_np(j2.opt.mu[f]).astype(np.float64)
               - b1 * _np(state.opt.mu[f]).astype(np.float64)) / (1 - b1)
        np.testing.assert_array_less(np.abs(g_t.numpy() - g_j),
                                     3e-4 + 1e-7 * np.abs(g_j), err_msg=f)
    np.testing.assert_array_equal(t2.dstate.count.numpy(),
                                  _np(j2.dstate.count))
    np.testing.assert_allclose(t2.dstate.grad_accum.numpy(),
                               _np(j2.dstate.grad_accum), atol=3e-4)
    np.testing.assert_allclose(t2.dstate.max_radii.numpy(),
                               _np(j2.dstate.max_radii), rtol=1e-6)


def test_batched_sinks_are_the_mean_over_views():
    """A batch of the same view twice gives the single view's step: the
    loss, the densification statistics (the pixel counts included, which
    the kernels do not scale with the loss) and the parameters."""
    cfg, ds, params = _small(pixel_grad_scale=0.5)
    step = make_train_step(cfg, ds, {"instance_capacity": 1 << 13})
    st = TrainState.init(params, 0)
    one, m1 = step(st, 1)
    two, m2 = step(st, [1, 1])
    assert torch.equal(m1["loss"], m2["loss"])
    assert torch.equal(m1["num_instances"], m2["num_instances"])
    for k in ("grad_accum", "count", "max_radii"):
        np.testing.assert_allclose(getattr(two.dstate, k).numpy(),
                                   getattr(one.dstate, k).numpy(),
                                   rtol=1e-6, atol=1e-7)
    for f in PARAM_FIELDS:
        np.testing.assert_allclose(getattr(two.params, f).numpy(),
                                   getattr(one.params, f).numpy(),
                                   rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------------------
# the Trainer: progressive resolution, packing


def _small(n_views=3, res=32, **cfg_kw):
    rng = np.random.default_rng(7)
    gt = random_scene(rng, 150, sh_degree=1, device=CPU)
    cams = orbit_cameras(n_views, width=res, device=CPU)
    ds = Dataset.from_views(cams, render_gt_images(
        gt, cams, instance_capacity=1 << 13))
    params = random_scene(np.random.default_rng(8), 120, sh_degree=1,
                          capacity=160, device=CPU)
    cfg = TrainConfig(sh_degree=1, **cfg_kw)
    cfg.densify.cap_max = 160
    return cfg, ds, params


def test_progressive_schedule_and_resume(tmp_path):
    cfg, ds, params = _small(progressive_train=True, resolution_schedule=2)
    rk = {"instance_capacity": 1 << 13}
    tr = Trainer(cfg, ds, params, render_kwargs=rk)
    seen = []

    def spy(trainer):
        for s, fn in list(trainer._steps.items()):
            def wrapped(*a, _s=s, _fn=fn, **kw):
                seen.append((trainer.state.step, _s))
                return _fn(*a, **kw)
            trainer._steps[s] = wrapped

    spy(tr)
    for _ in range(3):
        tr.step_once()
    CK.save_trainer(str(tmp_path), tr, step=3, export_ply=False)
    for _ in range(3):
        tr.step_once()
    assert seen == [(0, 4), (1, 4), (2, 2), (3, 2), (4, 1), (5, 1)]
    assert [tr.res_scale(s) for s in (0, 1, 2, 3, 4, 99)] == [4, 4, 2, 2,
                                                              1, 1]
    resumed = Trainer(cfg, ds, params, render_kwargs=rk)
    CK.resume_trainer(str(tmp_path), resumed, 3)
    seen.clear()
    spy(resumed)
    for _ in range(3):
        resumed.step_once()
    assert seen == [(3, 2), (4, 1), (5, 1)]
    for f in FIELDS:
        assert torch.equal(getattr(resumed.state.params, f),
                           getattr(tr.state.params, f)), f
    off = Trainer(cfg.replace(progressive_train=False), ds, params,
                  render_kwargs=rk)
    assert list(off._steps) == [1] and off.res_scale(0) == 1


def _bf16_state(cap=64, seed=0):
    rng = np.random.default_rng(seed)
    params = random_scene(rng, cap - 8, sh_degree=2, capacity=cap,
                          device=CPU)
    params = dataclasses.replace(params, shN=params.shN.to(BF16))
    opt = AdamState.init(params)
    opt = AdamState(mu={f: torch.randn_like(v.float()).to(v.dtype)
                        for f, v in opt.mu.items()},
                    nu={f: torch.rand_like(v.float()).to(v.dtype)
                        for f, v in opt.nu.items()}, step=5)
    return params, opt


def _assert_packed(params, opt):
    assert params.shN.dtype == BF16
    assert opt.mu["shN"].dtype == BF16 and opt.nu["shN"].dtype == BF16
    for f in ("means", "scales", "quats", "opacity", "sh0"):
        assert getattr(params, f).dtype == torch.float32, f
        assert opt.mu[f].dtype == opt.nu[f].dtype == torch.float32, f


def test_bf16_shN_survives_adam_strategies_and_checkpoint(tmp_path):
    from divshot_tpu_torch.core.config import DensifyConfig, OptimConfig
    params, opt = _bf16_state()
    cap = params.capacity
    grads = {f: torch.randn_like(getattr(params, f).float()).to(
        getattr(params, f).dtype) for f in PARAM_FIELDS}
    p2, o2 = adam_update(OptimConfig(), params, grads, opt, 1.0,
                         torch.rand(cap) > 0.3)
    _assert_packed(p2, o2)
    # Adam in float32: the same as the float32 update rounded to bf16
    p32 = dataclasses.replace(params, shN=params.shN.float())
    o32 = AdamState(mu={**opt.mu, "shN": opt.mu["shN"].float()},
                    nu={**opt.nu, "shN": opt.nu["shN"].float()}, step=5)
    p3, o3 = adam_update(OptimConfig(), p32, grads, o32, 1.0)
    p2b, _ = adam_update(OptimConfig(), params, grads, opt, 1.0)
    assert torch.equal(p2b.shN, p3.shN.to(BF16))
    assert torch.equal(o2.mu["means"].isfinite(), o3.mu["means"].isfinite())
    # ADC clone and split: the copied rows keep their bf16 values
    dcfg = DensifyConfig(grow_grad2d=0.0, densify_scale3d=0.02,
                         warmup_length=0)
    ds = S.DensifyState(grad_accum=torch.full((cap,), 1.0),
                        count=torch.ones(cap), max_radii=torch.zeros(cap))
    p4, o4, _ = S.adc_refine(dcfg, p2, o2, ds, 10, 1.0,
                             gen=torch.Generator().manual_seed(0))
    _assert_packed(p4, o4)
    assert p4.num_alive > p2.num_alive
    new = p4.alive & ~p2.alive
    assert set(p4.shN[new].float().flatten().tolist()) <= set(
        p2.shN.float().flatten().tolist())
    # MCMC relocation and noise, alpha reset, the periodic prune
    p5 = dataclasses.replace(p4, opacity=torch.where(
        torch.arange(cap) % 5 == 0, torch.tensor(-9.0), p4.opacity))
    p6, o6, _ = S.mcmc_refine(DensifyConfig(cap_max=cap), p5, o4, ds, 10,
                              1.0, gen=torch.Generator().manual_seed(1))
    _assert_packed(p6, o6)
    p7 = S.mcmc_noise(DensifyConfig(), OptimConfig(), p6, 10, 1.0,
                      gen=torch.Generator().manual_seed(2))
    p8, o8 = S.alpha_reset(DensifyConfig(), p7, o6)
    _assert_packed(p8, o8)
    for strat in (0, 1):
        p9, o9 = S.periodic_prune(DensifyConfig(prune_strategy=strat,
                                                prune_opacity=0.3),
                                  p8, o8, ds, 1.0)
        _assert_packed(p9, o9)
    # a checkpoint round trip keeps the stored dtypes and the bits
    st = TrainState(params=p9, opt=o9, dstate=ds,
                    gen=torch.Generator().manual_seed(3))
    CK.save_checkpoint(str(tmp_path), st, step=7)
    back = CK.load_checkpoint(str(tmp_path), 7, st)
    _assert_packed(back.params, back.opt)
    for f in PARAM_FIELDS:
        assert torch.equal(getattr(back.params, f), getattr(p9, f))
        assert torch.equal(back.opt.mu[f], o9.mu[f])
        assert torch.equal(back.opt.nu[f], o9.nu[f])
    # export is float32, the values of the bf16 buffer
    d = p9.compact_numpy()
    assert d["shN"].dtype == np.float32
    np.testing.assert_array_equal(d["shN"], p9.shN[p9.alive].float().numpy())


def test_bf16_export_matches_jax_bytes(tmp_path):
    """A bf16 ``shN`` exports as float32: ``compact_numpy`` and
    ``save_ply`` give JAX's arrays and bytes for the same bf16 state."""
    from divshot_tpu.gsio.ply import save_ply as jax_save_ply
    from divshot_tpu_torch.gsio.ply import save_ply
    jp = jax_random_scene(np.random.default_rng(2), 90, sh_degree=2,
                          capacity=128)
    jp = jp.replace(shN=jp.shN.astype(jnp.bfloat16),
                    alive=jp.alive.at[::7].set(False))
    tp = GaussianParams.from_numpy({f: _np(getattr(jp, f)) for f in FIELDS},
                                   device=CPU)
    assert tp.shN.dtype == BF16 and tp.means.dtype == torch.float32
    jd, td = jp.compact_numpy(), tp.compact_numpy()
    for f in PARAM_FIELDS:
        assert td[f].dtype == np.float32
        np.testing.assert_array_equal(td[f], jd[f], err_msg=f)
    jax_save_ply(str(tmp_path / "j.ply"), jp)
    save_ply(str(tmp_path / "t.ply"), tp)
    assert (tmp_path / "t.ply").read_bytes() == \
        (tmp_path / "j.ply").read_bytes()


def test_pack_level_bf16_training_bar():
    """tests/test_round3.py:125-158 through the port: 40 steps with
    ``pack_level=1`` keep shN and its moments bf16 and converge, the loss
    below 0.54 and within 20 % of the float32 run's."""
    rng = np.random.default_rng(0)
    gt = random_scene(rng, 192, sh_degree=1, device=CPU)
    cams = orbit_cameras(3, width=48, device=CPU)
    ds = Dataset.from_views(cams, render_gt_images(
        gt, cams, instance_capacity=1 << 14))

    def run(pack):
        cfg = TrainConfig(sh_degree=1, num_iters=40, pack_level=pack)
        cfg.densify.cap_max = 256
        cfg.densify.warmup_length = 1000
        params = random_scene(np.random.default_rng(1), 256, sh_degree=1,
                              capacity=256, device=CPU)
        tr = Trainer(cfg, ds, params,
                     render_kwargs={"instance_capacity": 1 << 14})
        for _ in range(40):
            m = tr.step_once()
        return tr, float(m["loss"])

    tr0, l0 = run(0)
    tr1, l1 = run(1)
    assert tr1.pack_level == 1 and tr0.pack_level == 0
    _assert_packed(tr1.state.params, tr1.state.opt)
    assert tr0.state.params.shN.dtype == torch.float32
    assert l1 < 0.9 * 0.6 and abs(l1 - l0) / max(l0, 1e-6) < 0.2, (l0, l1)
    assert tr1.state.params.compact_numpy()["shN"].dtype == np.float32


def test_pack_level_auto_raise(monkeypatch):
    """tests/test_round3.py:161-185: the memory guard raises pack_level
    when 236 B x 10 a splat pass half the device's memory (JAX's 16 GiB
    fallback on the CPU; a card's total memory on a card)."""
    cfg, ds, params = _small()
    assert TR._device_memory_bytes(CPU) == 16 * 1024 ** 3
    assert Trainer(cfg, ds, params).pack_level == 0
    monkeypatch.setattr(TR, "_device_memory_bytes",
                        lambda device: 200 * 236 * 10)
    tr = Trainer(cfg, ds, params)
    assert tr.pack_level & 1 and tr.pack_level == 3
    _assert_packed(tr.state.params, tr.state.opt)
    assert np.isfinite(float(tr.step_once()["loss"]))
    _assert_packed(tr.state.params, tr.state.opt)


# ---------------------------------------------------------------------------
# debug_nan


def _jax_step_raises(jcfg, jds, jp, gt=None):
    step = jax_trainer.make_train_step(
        jcfg, jds, {"backend": "tiles", "tile_capacity": 512,
                    "instance_capacity": 1 << 14}, streamed=gt is not None)
    state = jax_trainer.TrainState(
        params=jp, opt=jax_optim.AdamState.init(jp),
        dstate=jax_strategy.DensifyState.init(jp.capacity),
        key=jax.random.PRNGKey(0))
    try:
        with jax.debug_nans(True):
            jax.block_until_ready(step(state, jnp.int32(0), gt))
    except FloatingPointError:
        return True
    return False


def test_debug_nan_raises_where_jax_raises():
    rng = np.random.default_rng(9)
    gt = jax_random_scene(rng, 150, sh_degree=1)
    cams = jax_orbit(2, width=32)
    images = jax_render_gt(gt, cams, tile_capacity=512)
    jp = jax_random_scene(rng, 100, sh_degree=1, capacity=128)
    jcfg = _configure(JTrainConfig(), debug_nan=True)
    jds = jax_trainer.Dataset.from_views(cams, images)
    tcfg = _configure(TrainConfig(), debug_nan=True)
    tds = Dataset.from_views([_camera(c) for c in cams], images)
    carried = _carry(jax_trainer.TrainState(
        params=jp, opt=jax_optim.AdamState.init(jp),
        dstate=jax_strategy.DensifyState.init(jp.capacity),
        key=jax.random.PRNGKey(0)))
    rk = {"instance_capacity": 1 << 14}
    # clean: neither raises, and the checks change nothing
    assert not _jax_step_raises(jcfg, jds, jp)
    t_dbg, m_dbg = make_train_step(tcfg, tds, rk)(carried, 0)
    t_off, m_off = make_train_step(tcfg.replace(debug_nan=False), tds, rk)(
        carried, 0)
    assert torch.equal(m_dbg["loss"], m_off["loss"])
    for f in FIELDS:
        assert torch.equal(getattr(t_dbg.params, f),
                           getattr(t_off.params, f)), f
    # a NaN mean: both raise, the port at the projection
    bad = jp.replace(means=jp.means.at[5, 1].set(jnp.nan))
    assert _jax_step_raises(jcfg, jds, bad)
    bad_t = dataclasses.replace(carried, params=dataclasses.replace(
        carried.params, means=carried.params.means.clone()))
    bad_t.params.means[5, 1] = float("nan")
    with pytest.raises(FloatingPointError, match="projection"):
        make_train_step(tcfg, tds, rk)(bad_t, 0)
    # a NaN ground-truth pixel (streamed, as float): both raise, the port
    # at the loss
    gt_nan = np.asarray(images[0], np.float32).copy()
    gt_nan[3, 4, 1] = np.nan
    assert _jax_step_raises(jcfg, jds, jp, jnp.asarray(gt_nan))
    with pytest.raises(FloatingPointError, match="loss"):
        make_train_step(tcfg, tds, rk, streamed=True)(
            carried, 0, torch.from_numpy(gt_nan))
