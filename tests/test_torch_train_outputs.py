"""The port's training outputs on the CPU: evaluation against JAX's,
the surfel eval invariance, checkpoint resume against an unbroken run, and
``apps.train`` end to end on a tiny procedural dataset.

Tolerances, each with its reason:
- ``evaluate`` against JAX's (JAX on its float32 XLA ``tiles`` route,
  which keeps the oracle cheap; the port's render through the kernels'
  plain versions): PSNR within 2e-3 dB and SSIM within 2e-5, the images'
  float32 compositing differences seen through two reductions;
- the surfel invariance: PSNR within 1e-3 dB (the images within 1e-5, the
  bar of ``tests/test_round5.py:278``);
- resume: bitwise, every tensor of the state and every step's metrics.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from divshot_tpu.gsio.synthetic import orbit_cameras as jax_orbit
from divshot_tpu.gsio.synthetic import random_scene as jax_random_scene
from divshot_tpu.train import trainer as jax_trainer
from divshot_tpu.train.evaluate import evaluate as jax_evaluate
from tests.test_surfel import make_surfel_scene

from divshot_tpu_torch.apps import train as train_app
from divshot_tpu_torch.core.config import DensifyStrategy, TrainConfig
from divshot_tpu_torch.gsio.ply import load_ply
from divshot_tpu_torch.gsio.procedural import generate_dataset
from divshot_tpu_torch.gsio.synthetic import (orbit_cameras, random_scene,
                                              render_gt_images)
from divshot_tpu_torch.raster.surfel_raster import render_surfels
from divshot_tpu_torch.splat.camera import Camera
from divshot_tpu_torch.splat.gaussians import GaussianParams, init_from_points
from divshot_tpu_torch.train import checkpoint as CK
from divshot_tpu_torch.train.evaluate import evaluate
from divshot_tpu_torch.train.geometry import FLAT_LOG_SCALE
from divshot_tpu_torch.train.trainer import Dataset, Trainer

CPU = "cpu"
FIELDS = ("means", "scales", "quats", "opacity", "sh0", "shN", "alive")


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _params(jp) -> GaussianParams:
    return GaussianParams.from_numpy({f: np.asarray(getattr(jp, f))
                                      for f in FIELDS}, device=CPU)


def _camera(jc) -> Camera:
    return Camera.from_numpy({k: np.asarray(getattr(jc, k)) for k in (
        "viewmat", "fx", "fy", "cx", "cy", "width", "height")}, device=CPU)


# ---------------------------------------------------------------------------
# evaluation


@pytest.mark.parametrize("white", [True, False])
def test_evaluate_matches_jax(white):
    rng = np.random.default_rng(4)
    jp = jax_random_scene(rng, 300, sh_degree=1)
    jcams = jax_orbit(3, width=40)
    # ground truth: a gradient with noise
    gt = (np.random.default_rng(5).uniform(0, 64, (3, 40, 40, 3))
          + np.linspace(0, 180, 40)[None, None, :, None]).astype(np.uint8)
    jds = jax_trainer.Dataset.from_views(jcams, gt)
    tds = Dataset.from_views([_camera(c) for c in jcams], gt)
    jbg = jnp.ones((3,), jnp.float32) if white else None
    tbg = torch.ones(3) if white else None
    ref = jax_evaluate(jp, jds, background=jbg,
                       render_kwargs={"backend": "tiles"})
    out = evaluate(_params(jp), tds, background=tbg,
                   render_kwargs={"instance_capacity": 1 << 14})
    assert set(out) == set(ref) and out["n_views"] == ref["n_views"] == 3
    np.testing.assert_allclose(out["per_view_psnr"], ref["per_view_psnr"],
                               atol=2e-3)
    assert abs(out["psnr"] - ref["psnr"]) <= 2e-3
    assert abs(out["ssim"] - ref["ssim"]) <= 2e-5
    assert 5.0 < out["psnr"] < 30.0
    sub = evaluate(_params(jp), tds, background=tbg, max_views=2,
                   render_kwargs={"instance_capacity": 1 << 14})
    assert sub["n_views"] == 2
    assert sub["per_view_psnr"] == out["per_view_psnr"][:2]


def test_evaluate_refuses_lpips_weights_it_cannot_use(monkeypatch,
                                                     tmp_path):
    """No LPIPS without weights, or with a path that names no file (as in
    JAX); with weights, the mean of ``lpips_fn`` over the rendered
    views."""
    from divshot_tpu_torch.raster.render import render
    from divshot_tpu_torch.train.lpips import (load_weights, lpips_fn,
                                               random_weights)
    rng = np.random.default_rng(0)
    params = random_scene(rng, 50, device=CPU)
    cams = orbit_cameras(2, width=16, device=CPU)
    gt = rng.integers(0, 256, (2, 16, 16, 3), dtype=np.uint8)
    ds = Dataset.from_views(cams, gt)
    monkeypatch.delenv("DIVSHOT_LPIPS_WEIGHTS", raising=False)
    assert "lpips" not in evaluate(params, ds)
    monkeypatch.setenv("DIVSHOT_LPIPS_WEIGHTS", str(tmp_path / "none.npz"))
    assert "lpips" not in evaluate(params, ds)
    path = random_weights(str(tmp_path / "w.npz"), seed=1)
    monkeypatch.setenv("DIVSHOT_LPIPS_WEIGHTS", path)
    out = evaluate(params, ds)
    fn = lpips_fn(load_weights(path))
    with torch.no_grad():
        want = [float(fn(render(params, c).image, torch.from_numpy(g) / 255.0))
                for c, g in zip(cams, gt)]
    assert out["lpips"] == pytest.approx(np.mean(want), rel=1e-6)
    assert out["lpips"] > 0


def test_surfel_eval_ignores_third_scale_axis():
    """``tests/test_round5.py:278`` through the port's ``evaluate``: on the
    surfel route the raw third log-scale does not change the eval, on the
    3DGS route it does (the r4 eval bug)."""
    jp, jc = make_surfel_scene(seed=3, n=40, size=32)
    params, cam = _params(jp), _camera(jc)
    fat = dataclasses.replace(params, scales=params.scales.clone())
    fat.scales[:, 2] = float(np.log(0.5))
    flat = dataclasses.replace(params, scales=params.scales.clone())
    flat.scales[:, 2] = float(np.log(1e-6))
    rk = dict(tile_size=16, instance_capacity=4096)
    with torch.no_grad():
        img_raw = render_surfels(fat, cam, **rk).image
        img_flat = render_surfels(flat, cam, **rk).image
    np.testing.assert_allclose(img_raw.numpy(), img_flat.numpy(), atol=1e-5)
    gt = (np.clip(img_flat.numpy(), 0, 1) * 255).astype(np.uint8)[None]
    ds = Dataset.from_views([cam], gt)
    ev_raw = evaluate(fat, ds, render_kwargs={"backend": "surfel_pallas",
                                              **rk})
    ev_flat = evaluate(flat, ds, render_kwargs={"backend": "surfel_pallas",
                                                **rk})
    ev_3d = evaluate(fat, ds, render_kwargs={"backend": "pallas", **rk})
    assert ev_flat["psnr"] > 40.0
    assert abs(ev_raw["psnr"] - ev_flat["psnr"]) <= 1e-3
    assert ev_3d["psnr"] < ev_raw["psnr"] - 3.0


# ---------------------------------------------------------------------------
# checkpoint resume


def _small_trainer(strategy, model_type=0, res=48):
    rng = np.random.default_rng(1)
    gt = random_scene(rng, 300, sh_degree=0, device=CPU)
    cams = orbit_cameras(6, width=res, device=CPU)
    ds = Dataset.from_views(cams, render_gt_images(
        gt, cams, instance_capacity=1 << 14))
    pts = gt.means.numpy()[:150] + 0.05 * rng.standard_normal((150, 3))
    cols = rng.uniform(0.2, 0.8, (150, 3))
    params = init_from_points(pts, cols, sh_degree=0, capacity=400,
                              device=CPU)
    cfg = TrainConfig(sh_degree=0, model_type=model_type)
    cfg.densify.strategy = strategy
    cfg.densify.warmup_length = 2
    cfg.densify.refine_every = 3
    cfg.densify.reset_alpha_every = 7
    cfg.densify.refine_stop_iter = 10_000
    cfg.densify.cap_max = 400
    return Trainer(cfg, ds, params,
                   render_kwargs={"instance_capacity": 1 << 14})


def _run(tr, n):
    out = []
    tr.run(n, log_every=0, callback=lambda i, s, m: out.append(
        {k: v.clone() for k, v in m.items()}))
    return out


def _assert_states_equal(a, b):
    for f in FIELDS:
        assert torch.equal(getattr(a.params, f), getattr(b.params, f)), f
    for f in a.opt.mu:
        assert torch.equal(a.opt.mu[f], b.opt.mu[f]), f
        assert torch.equal(a.opt.nu[f], b.opt.nu[f]), f
    assert a.opt.step == b.opt.step
    for f in ("grad_accum", "count", "max_radii"):
        assert torch.equal(getattr(a.dstate, f), getattr(b.dstate, f)), f
    assert torch.equal(a.gen.get_state(), b.gen.get_state())


@pytest.mark.parametrize("strategy,model_type", [
    (DensifyStrategy.MCMC, 0), (DensifyStrategy.ADC_PLUS, 0),
    (DensifyStrategy.ADC_PLUS, 1)])
def test_resume_equals_unbroken_run(tmp_path, strategy, model_type):
    """N steps unbroken against N/2, a checkpoint, a new ``Trainer``
    loaded from it and N/2 more: bitwise, with refines (relocation and
    noise on MCMC, clone, split and an alpha reset on ADC+) on both sides
    of the break, on 3DGS and exact 2DGS."""
    n = 12
    whole = _small_trainer(strategy, model_type)
    m_whole = _run(whole, n)
    first = _small_trainer(strategy, model_type)
    m_first = _run(first, n // 2)
    CK.save_trainer(str(tmp_path), first, step=n // 2)
    saved = CK.state_dict(first.state)
    _assert_states_equal(CK.load_checkpoint(str(tmp_path), n // 2,
                                            first.state), first.state)
    assert CK.latest_step(str(tmp_path)) == n // 2
    assert os.path.exists(tmp_path / f"iteration_{n // 2}" /
                          "point_cloud.ply")
    second = _small_trainer(strategy, model_type)
    CK.resume_trainer(str(tmp_path), second, n // 2)
    loaded = CK.state_dict(second.state)
    for k in ("params", "mu", "nu", "dstate"):
        for f, t in saved[k].items():
            assert torch.equal(loaded[k][f], t), (k, f)
    assert second.state.step == n // 2
    m_second = _run(second, n - n // 2)
    _assert_states_equal(second.state, whole.state)
    assert len(m_first + m_second) == len(m_whole) == n
    for i, (a, b) in enumerate(zip(m_first + m_second, m_whole)):
        for k in b:
            assert torch.equal(a[k], b[k]), (i, k)


# ---------------------------------------------------------------------------
# the app


@pytest.fixture(scope="module")
def bricks(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("bricks"))
    generate_dataset(out, n_train=4, n_test=2, width=32, height=32,
                     device=CPU)
    return out


@pytest.mark.parametrize("flags", [(), ("--model_type", "1",
                                        "--surfel_exact", "0")])
def test_train_app_writes_outputs_and_resumes(bricks, tmp_path, flags,
                                              capsys):
    """``apps.train --source_path`` on a tiny procedural dataset: 20 of
    30 steps, then ``--load_itr -2`` to the end; checkpoints past
    ``reset_alpha_every``, the eval curve (kept up to the resume step),
    ``metrics.csv`` and the final PLY (with the flat third axis on
    flattened 2DGS)."""
    out = str(tmp_path / "model")
    argv = ["--source_path", bricks, "--model_path", out, "--device", "cpu",
            "--white_background", "1", "--cap_max", "1024",
            "--iterations", "30", "--eval_every", "10",
            "--checkpoint_every", "5", "--reset_alpha_every", "7", *flags]
    tr = train_app.run(argv, max_steps=20)
    assert tr.state.step == 20
    assert sorted(d for d in os.listdir(out) if d.startswith("iter")) == [
        "iteration_10", "iteration_15", "iteration_20"]
    for name in ("metrics.csv", "eval_curve.json", "point_cloud.ply",
                 "iteration_20/state.pt", "iteration_20/point_cloud.ply"):
        assert os.path.exists(os.path.join(out, name)), name
    with open(os.path.join(out, "eval_curve.json")) as f:
        curve1 = json.load(f)
    assert [e["step"] for e in curve1] == [10, 20, 20]
    assert all(np.isfinite(e["psnr"]) and e["num_alive"] > 0
               for e in curve1)

    tr2 = train_app.run(argv + ["--load_itr", "-2"])
    assert tr2.state.step == 30
    assert "resumed from iteration_20" in capsys.readouterr().out
    with open(os.path.join(out, "eval_curve.json")) as f:
        curve2 = json.load(f)
    assert curve2[:3] == curve1
    assert [e["step"] for e in curve2] == [10, 20, 20, 30, 30]
    ply, _ = load_ply(os.path.join(out, "point_cloud.ply"), device=CPU)
    assert ply.num_alive == tr2.state.params.num_alive
    scales = ply.scales.numpy()[:, 2]
    if flags:
        assert (scales == FLAT_LOG_SCALE).all()
    else:
        np.testing.assert_array_equal(
            ply.scales.numpy(), tr2.state.params.compact_numpy()["scales"])
