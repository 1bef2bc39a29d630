"""The port's trainer and train app on the CPU: the loss bars of
``tests/test_train.py`` met through the port, the capacity growth from
measured demand, the carried-across state, the 2DGS demo, the app's option
flags, and the options that are not ported yet raising instead of being
ignored."""

import numpy as np
import pytest
import torch

from divshot_tpu_torch.apps import train as train_app
from divshot_tpu_torch.core.config import (DensifyStrategy, TrainConfig,
                                           config_from_flags)
from divshot_tpu_torch.gsio.synthetic import (orbit_cameras, random_scene,
                                              render_gt_images)
from divshot_tpu_torch.raster.render import render
from divshot_tpu_torch.splat.camera import batch_cameras
from divshot_tpu_torch.splat.gaussians import init_from_points
from divshot_tpu_torch.train.optim import PARAM_FIELDS
from divshot_tpu_torch.train.trainer import (Dataset, Trainer, TrainState,
                                             check_supported,
                                             make_train_step)

CPU = "cpu"


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _small_setup(rng, strategy, n_gt=400, capacity=1200, res=64,
                 n_views=10, n_init=200):
    """tests/test_train.py:17-38's small_setup through the port (the same
    numpy draws; the ground truth rendered by the port's render)."""
    gt = random_scene(rng, n_gt, sh_degree=0, device=CPU)
    cams = orbit_cameras(n_views, width=res, device=CPU)
    ds = Dataset.from_views(cams, render_gt_images(
        gt, cams, instance_capacity=1 << 15))
    pts = gt.means.numpy()[:n_init] + 0.05 * rng.standard_normal(
        (n_init, 3))
    cols = rng.uniform(0.2, 0.8, (n_init, 3))
    params = init_from_points(pts, cols, sh_degree=0, capacity=capacity,
                              device=CPU)
    cfg = TrainConfig(sh_degree=0, ssim_weight=0.2)
    cfg.densify.strategy = strategy
    cfg.densify.warmup_length = 30
    cfg.densify.refine_every = 40
    cfg.densify.reset_alpha_every = 10_000
    cfg.densify.refine_stop_iter = 10_000
    cfg.densify.cap_max = capacity
    return cfg, ds, params


@pytest.mark.parametrize("strategy,bar", [(DensifyStrategy.ADC_PLUS, 0.6),
                                          (DensifyStrategy.MCMC, 0.7)])
def test_port_trainer_meets_test_train_bars(strategy, bar):
    """tests/test_train.py:48-68: the mean loss of the last 10 of 150
    steps below 0.6x (ADC+) / 0.7x (MCMC) the first 10."""
    cfg, ds, params = _small_setup(np.random.default_rng(0), strategy)
    if strategy == DensifyStrategy.ADC_PLUS:
        cfg.densify.revised_opacity = True
    else:
        cfg.densify.cap_max = 800
    tr = Trainer(cfg, ds, params,
                 render_kwargs={"instance_capacity": 1 << 15})
    losses = []
    tr.run(150, log_every=0,
           callback=lambda i, s, m: losses.append(float(m["loss"])))
    losses = np.asarray(losses)
    assert np.isfinite(losses).all()
    first, last = losses[:10].mean(), losses[-10:].mean()
    assert last < bar * first, (first, last)
    alive = int(tr.state.params.alive.sum())
    assert 0 < alive <= cfg.densify.cap_max
    assert tr.state.step == 150


def _tiny(strategy=DensifyStrategy.MCMC):
    return _small_setup(np.random.default_rng(1), strategy, n_gt=60,
                        capacity=96, res=32, n_views=2, n_init=40)


def test_check_overflow_grows_the_instance_capacity():
    cfg, ds, params = _tiny()
    tr = Trainer(cfg, ds, params, render_kwargs={"instance_capacity": 1024})
    m = tr.step_once()
    demand = int(m["num_instances"])
    assert 0 < demand and tr._instance_capacity == 1024
    tr.check_overflow({"num_instances": 1000})
    assert tr._instance_capacity == 2048       # 1000 * 1.3 -> 2^11
    # below 0.9 x capacity: no growth, but inside the 2048-lane guard band
    with pytest.warns(RuntimeWarning, match="guard band"):
        tr.check_overflow({"num_instances": 100})
    assert tr._instance_capacity == 2048
    cfg.raster.auto_instance_capacity = False
    tr.check_overflow({"num_instances": 2047})
    assert tr._instance_capacity == 2048
    tr.step_once()
    assert tr.state.step == 2


def test_train_state_carry_across_and_step_schedule():
    cfg, ds, params = _tiny(DensifyStrategy.ADC_PLUS)
    rng = np.random.default_rng(2)
    d = {"params": {f: getattr(params, f).numpy() for f in (
        *PARAM_FIELDS, "alive")},
        "mu": {f: rng.standard_normal(getattr(params, f).shape)
               for f in PARAM_FIELDS},
        "nu": {f: rng.uniform(0, 1, getattr(params, f).shape)
               for f in PARAM_FIELDS},
        "step": 7, "dstate": {k: rng.uniform(0, 1, params.capacity)
                              for k in ("grad_accum", "count",
                                        "max_radii")}}
    st = TrainState.from_numpy(d, device=CPU)
    assert st.step == 7
    for f in PARAM_FIELDS:
        np.testing.assert_array_equal(st.opt.mu[f].numpy(),
                                      d["mu"][f].astype(np.float32))
        np.testing.assert_array_equal(getattr(st.params, f).numpy(),
                                      d["params"][f])
    np.testing.assert_array_equal(st.dstate.count.numpy(),
                                  d["dstate"]["count"].astype(np.float32))
    # a refine step (warm-up 30, every 40): densification statistics reset
    cfg.densify.warmup_length = 0
    cfg.densify.refine_every = 8
    st2, m = make_train_step(cfg, ds, {"instance_capacity": 1 << 12})(
        TrainState.from_numpy({**d, "step": 8}, device=CPU), 0)
    assert st2.step == 9 and float(st2.dstate.count.abs().max()) == 0.0
    assert np.isfinite(float(m["loss"]))


def test_unported_options_raise():
    """What the port still lacks raises: multi-chip training. The dynamic
    models and datasets (ported, through ``models/dynamic.py``) no longer
    do: the static ``Trainer`` takes a dataset with times, as JAX's does,
    and ignores them; nor do the non-kernel backends: ``render(backend=
    "tiles")`` matches the kernel route, and the trainer steps on the XLA
    surfel route for exact 2DGS and on ``"dense"``."""
    cfg, ds, params = _tiny()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        make_train_step(cfg, ds, grad_psum_axis="data")
    dynamic = Dataset.from_views(ds.cameras, ds.images.numpy(),
                                 times=np.linspace(0, 1, ds.num_views))
    for kw in (dict(model_type=2), dict(model_type=3)):
        check_supported(cfg.replace(**kw), dynamic)
    assert Trainer(cfg, dynamic, params).dataset.times is not None
    tiles = render(params, ds.cameras[0], backend="tiles")
    kernel = render(params, ds.cameras[0])
    assert float((tiles.image - kernel.image).abs().max()) < 3e-5
    assert int(tiles.num_instances) == int(kernel.num_instances) > 0
    for model_type, backend in ((1, "surfel"), (0, "dense")):
        st, m = make_train_step(cfg.replace(model_type=model_type), ds,
                                {"backend": backend})(
            TrainState.init(params, seed=0), 0)
        assert st.step == 1 and np.isfinite(float(m["loss"])), backend
    with pytest.raises(ValueError, match="uniform resolution"):
        batch_cameras([ds.cameras[0],
                       orbit_cameras(1, width=16, device=CPU)[0]])


@pytest.mark.parametrize("flag", [
    ["--mesh_resolution", "128"], ["--export_mesh", "1"],
    ["--model_type", "2"], ["--model_type", "3"]])
def test_train_app_unported_flags_raise(flag, monkeypatch, tmp_path):
    """These flags are ported now. The mesh flags are taken and, as in
    JAX's app, do nothing more; the dynamic model types train only on a
    dataset with times, so the demo scene (which has none) raises JAX's
    own ``ValueError`` for them."""
    monkeypatch.setattr(train_app, "DEMO_SPLATS", 300)
    monkeypatch.setattr(train_app, "DEMO_VIEWS", 2)
    monkeypatch.setattr(train_app, "DEMO_WIDTH", 32)
    argv = ["--demo", "--device", "cpu", "--iterations", "1", "--cap_max",
            "1024", "--model_path", str(tmp_path), *flag]
    train_app.check_flags(config_from_flags(flag))
    if flag[0] == "--model_type":
        with pytest.raises(ValueError, match="per-view times"):
            train_app.run(argv)
    else:
        tr = train_app.run(argv)
        assert tr.state.step == 1
        assert getattr(tr.cfg, flag[0][2:]) == int(flag[1])


@pytest.mark.parametrize("flag", [
    ["--enable_bg", "1"], ["--use_mask", "1"],
    ["--progressive_train", "1", "--resolution_schedule", "1"],
    ["--pack_level", "1"], ["--debug_nan", "1"]])
def test_train_app_runs_option_flags(flag, monkeypatch, tmp_path):
    """Each ported option flag trains a few ``--demo`` steps on the CPU,
    the demo scene cut small, and writes the outputs."""
    monkeypatch.setattr(train_app, "DEMO_SPLATS", 300)
    monkeypatch.setattr(train_app, "DEMO_VIEWS", 2)
    monkeypatch.setattr(train_app, "DEMO_WIDTH", 48)
    tr = train_app.run(["--demo", "--device", "cpu", "--iterations", "3",
                        "--cap_max", "1024", "--model_path", str(tmp_path),
                        *flag])
    assert tr is not None and tr.state.step == 3
    field = flag[0][2:]
    assert getattr(tr.cfg, field) == int(flag[1])
    assert (tr.state.bg is not None) == (field == "enable_bg")
    assert (tr.state.params.shN.dtype == torch.bfloat16) == (
        field == "pack_level")
    if field == "progressive_train":
        assert tr.res_scale(0) == 4 and tr.res_scale(1) == 2
    for name in ("point_cloud.ply", "iteration_3/state.pt",
                 "iteration_3/point_cloud.ply"):
        assert (tmp_path / name).exists(), name
    assert np.isfinite(float(tr.last_metrics["loss"]))


@pytest.mark.parametrize("exact", ["1", "0"])
def test_train_app_demo_2dgs(exact, monkeypatch, capsys, tmp_path):
    """``--demo --model_type 1`` trains on the CPU, on a demo scene cut to
    a few hundred splats at 48 px: the exact route through the surfel
    kernels' plain versions, ``--surfel_exact 0`` the flattened route
    through the 3DGS ones."""
    from divshot_tpu_torch.raster import raster as R
    from divshot_tpu_torch.raster import surfel_raster as SR
    monkeypatch.setattr(train_app, "DEMO_SPLATS", 300)
    monkeypatch.setattr(train_app, "DEMO_VIEWS", 2)
    monkeypatch.setattr(train_app, "DEMO_WIDTH", 48)
    calls = {"surfel": 0, "3dgs": 0}

    def counted(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(SR, "surfel_backward_plain", counted(
        "surfel", SR.surfel_backward_plain))
    monkeypatch.setattr(R, "rasterize_backward_plain", counted(
        "3dgs", R.rasterize_backward_plain))
    tr = train_app.run(["--demo", "--device", "cpu", "--model_type", "1",
                        "--surfel_exact", exact, "--iterations", "3",
                        "--cap_max", "1024", "--model_path", str(tmp_path)])
    assert tr is not None and tr.state.step == 3
    assert tr.cfg.model_type == 1 and tr.cfg.surfel_exact == (exact == "1")
    assert calls == ({"surfel": 3, "3dgs": 0} if exact == "1"
                     else {"surfel": 0, "3dgs": 3})
    last = [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("[")][-1]
    assert last.startswith("[3/3]")
    assert np.isfinite(float(last.split("loss=")[1].split()[0]))


def test_train_app_needs_demo(capsys):
    assert train_app.main(["--device", "cpu"]) == 2
    assert "--demo" in capsys.readouterr().out
