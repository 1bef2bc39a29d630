"""The port's live-training session on the CPU: ``TrainerSession`` (the
flows of ``tests/test_session.py:38-97`` through the kernels' plain
versions), ``Trainer.apply_config``, the ``LiveViewerServer`` (the flow
of ``tests/test_viewer.py:103-148``) and ``apps.viewer``; against the JAX
package where the two are meant to agree: one step after a live config
change, the accessors and the saved model of a session on the same
params.

Tolerances: ``apply_config``'s step as ``tests/test_torch_train_options.py``
holds one carried-across step (the loss rtol 1e-5, the gradients read from
the Adam moment atol 3e-4, the densification counts exactly and their
gradient sums atol 3e-4); the parameters after it within the Adam update's
float32 rounding of a learning rate times a moment ratio (atol 1e-6 plus
1e-3 of the largest update). The accessors, snapshots and saved files
exactly; a session's steps bitwise those of the same ``Trainer`` stepped
in a plain loop. Every wait on a thread has its own deadline.
"""

import dataclasses
import json
import os
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import jax

from divshot_tpu.core.config import TrainConfig as JTrainConfig
from divshot_tpu.train import session as jax_session
from divshot_tpu.train import trainer as jax_trainer
from divshot_tpu.gsio.synthetic import orbit_cameras as jax_orbit

from divshot_tpu_torch.apps import train as train_app
from divshot_tpu_torch.apps import viewer as viewer_app
from divshot_tpu_torch.core.config import TrainConfig
from divshot_tpu_torch.core.metrics import TrainingStatus
from divshot_tpu_torch.gsio.io import load_model
from divshot_tpu_torch.gsio.png import write_png
from divshot_tpu_torch.gsio.procedural import generate_dataset
from divshot_tpu_torch.gsio.synthetic import (orbit_cameras, random_scene,
                                              render_gt_images)
from divshot_tpu_torch.train.optim import PARAM_FIELDS
from divshot_tpu_torch.train.session import (TrainerSession,
                                             default_render_kwargs)
from divshot_tpu_torch.train.trainer import Dataset, Trainer
from divshot_tpu_torch.viewer.html_export import splat_bytes
from divshot_tpu_torch.viewer.live import LiveViewerServer
from tests.test_torch_host_services import _both, _scene
from tests.test_torch_train_options import (_assert_step, _camera, _carry,
                                            _configure, _step_scene)

CPU = "cpu"
RK = {"instance_capacity": 1 << 13}
DEADLINE_S = 120.0


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _wait(pred, what: str, timeout: float = DEADLINE_S) -> None:
    deadline = time.time() + timeout
    while not pred():
        if time.time() > deadline:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.02)


def _done(sess: TrainerSession) -> None:
    _wait(sess.is_terminated, "the session to end")
    sess.terminate(join=True)
    assert sess.status == TrainingStatus.TRAINING_DONE, sess.error


def _tiny_dataset(seed=0, views=4, res=64, n=400, stream=False):
    rng = np.random.default_rng(seed)
    gt = random_scene(rng, n, sh_degree=0, device=CPU)
    cams = orbit_cameras(views, width=res, device=CPU)
    images = render_gt_images(gt, cams, instance_capacity=1 << 13)
    return Dataset.from_views(cams, images, stream=stream)


def _params(seed=1, n=300, cap=1024):
    return random_scene(np.random.default_rng(seed), n, sh_degree=0,
                        capacity=cap, device=CPU)


def _cfg(num_iters=30, **kw):
    cfg = TrainConfig(sh_degree=0, num_iters=num_iters, **kw)
    cfg.densify.cap_max = 1024
    cfg.densify.warmup_length = 10_000   # no refine in these short runs
    return cfg


def _session(num_iters=30, snapshot_every=10, rk=RK, stream=False, **kw):
    sess = TrainerSession(_cfg(num_iters, **kw), render_kwargs=rk,
                          snapshot_every=snapshot_every, device=CPU)
    sess.load_synthetic(_tiny_dataset(stream=stream), _params())
    return sess


# ---------------------------------------------------------------------------
# the session on the port alone


def test_session_lifecycle(tmp_path):
    sess = _session()
    assert sess.status == TrainingStatus.PREPROCESS_DONE
    assert sess.num_cameras == 4
    assert sess.get_camera(0).width == 64
    assert sess.snapshot_generation == 1
    sess.start_train()
    _done(sess)
    assert sess.current_iteration == 30 and sess.progress == 1.0
    assert np.isfinite(sess.current_loss) and np.isfinite(sess.current_psnr)
    assert sess.num_gaussians == 300
    # the set-up, every 10 steps, the end
    assert sess.snapshot_generation == 5
    pos = sess.get_gaussian_positions()
    assert pos.shape == (300, 3) and pos.dtype == np.float32
    assert sess.get_gaussian_rotations().shape == (300, 4)
    assert sess.get_gaussian_shn().shape == (300, 0, 3)
    snap = sess.get_params_snapshot()
    assert snap.means.shape[0] == pos.shape[0] and snap.device.type == "cpu"
    np.testing.assert_array_equal(
        pos, sess.trainer.state.params.means[:300].numpy())
    assert sess.train_seconds > 0
    # export_mesh (it raised before viewer/mesh.py was ported) writes an
    # OBJ of the snapshot (tests/test_torch_mesh.py holds its mesh)
    sess.cfg = sess.cfg.replace(mesh_resolution=16)
    out = os.path.join(str(tmp_path), "mesh.obj")
    sess.export_mesh(out)
    assert open(out).readline().startswith("# divshot_tpu mesh export")


def test_session_pause_resume_and_config_queue():
    sess = _session(num_iters=10_000, snapshot_every=0)
    sess.start_train()
    try:
        _wait(lambda: sess.current_iteration >= 3, "three steps")
        assert sess.is_training()
        sess.pause_train()
        _wait(sess.is_paused, "the pause to take hold")
        it = sess.current_iteration
        time.sleep(0.3)
        assert sess.current_iteration == it          # paused: no progress
        assert not sess.is_training() and not sess.is_terminated()
        # a queued change, applied at the next iteration boundary
        sess.update_config(lambda c: c.replace(num_iters=it + 2))
        sess.resume()
        _done(sess)
        assert sess.current_iteration == it + 2
        assert sess.max_iterations == it + 2
    finally:
        sess.terminate()


def test_config_queue_hyper_and_structural_changes():
    """A learning-rate change is a hyper change: the next step takes it
    and the step functions stay the same objects; ``ssim_weight`` 0 is
    structural: they are rebuilt. A ``num_iters`` at the current step ends
    the run there."""
    sess = _session(num_iters=2, snapshot_every=0)
    tr = sess.trainer
    step0 = tr._steps[1]
    lr = sess.cfg.optim.pos_lr_init * 10
    sess.update_config(lambda c: c.replace(
        optim=dataclasses.replace(c.optim, pos_lr_init=lr)))
    sess.start_train()
    _done(sess)
    assert tr._steps[1] is step0
    assert tr._hypers["pos_lr_init"] == pytest.approx(lr, rel=1e-7)
    assert sess.cfg.optim.pos_lr_init == lr == tr.cfg.optim.pos_lr_init
    sess.update_config(lambda c: c.replace(ssim_weight=0.0, num_iters=4))
    sess.start_train()
    _done(sess)
    assert tr._steps[1] is not step0 and sess.current_iteration == 4
    assert tr.cfg.ssim_weight == 0.0 and tr._hypers["ssim_weight"] == 0.0
    sess.cfg = sess.cfg.replace(num_iters=10_000)
    sess.start_train()
    try:
        _wait(lambda: sess.current_iteration >= 6, "two more steps")
        sess.pause_train()
        _wait(sess.is_paused, "the pause to take hold")
        it = sess.current_iteration
        sess.update_config(lambda c: c.replace(num_iters=it))
        sess.resume()
        _done(sess)
    finally:
        sess.terminate()
    assert sess.current_iteration == it == tr.state.step


@pytest.mark.parametrize("model_type", [0, 1], ids=["3dgs", "2dgs"])
def test_session_steps_equal_a_plain_trainer_loop(model_type):
    """N session steps (snapshots in between) give the same state, bitwise,
    as N ``Trainer.step_once`` calls with the same seed; the session's
    default backend is the model type's, as the trainer's own default."""
    n = 5
    cfg = _cfg(n, model_type=model_type)
    rk = {**default_render_kwargs(cfg), "instance_capacity": 1 << 13}
    assert rk["backend"] == ("surfel_pallas" if model_type else "pallas")
    sess = TrainerSession(cfg, render_kwargs=rk, snapshot_every=2,
                          device=CPU)
    sess.load_synthetic(_tiny_dataset(), _params())
    sess.start_train()
    _done(sess)
    plain = Trainer(_cfg(n, model_type=model_type), _tiny_dataset(),
                    _params(), render_kwargs=RK)
    for _ in range(n):
        plain.step_once()
    a, b = sess.trainer.state, plain.state
    assert a.step == b.step == n
    for f in (*PARAM_FIELDS, "alive"):
        assert torch.equal(getattr(a.params, f), getattr(b.params, f)), f
    for f in PARAM_FIELDS:
        assert torch.equal(a.opt.mu[f], b.opt.mu[f]), f
        assert torch.equal(a.opt.nu[f], b.opt.nu[f]), f
    for k in ("grad_accum", "count", "max_radii"):
        assert torch.equal(getattr(a.dstate, k), getattr(b.dstate, k)), k


def test_streamed_session_equals_a_streamed_trainer_loop():
    n = 4
    sess = _session(num_iters=n, snapshot_every=1, stream=True)
    assert sess.trainer._streamed
    sess.start_train()
    _done(sess)
    plain = Trainer(_cfg(n), _tiny_dataset(stream=True), _params(),
                    render_kwargs=RK)
    try:
        for _ in range(n):
            plain.step_once()
        for f in PARAM_FIELDS:
            assert torch.equal(getattr(sess.trainer.state.params, f),
                               getattr(plain.state.params, f)), f
        assert sess.trainer.pending_views == plain.pending_views
    finally:
        plain.close()
        sess.close()


def test_snapshots_do_not_change_as_the_trainer_steps_on():
    sess = _session(num_iters=6, snapshot_every=0)
    held = sess._snapshot
    kept = {k: v.copy() for k, v in held.items()}
    params0 = sess.get_params_snapshot()
    means0 = params0.means.clone()
    shn0 = sess.get_gaussian_shn()
    before = sess.trainer.state.params.means.clone()
    sess.start_train()
    _done(sess)
    assert not torch.equal(sess.trainer.state.params.means, before)
    for k, v in held.items():
        np.testing.assert_array_equal(v, kept[k], err_msg=k)
    assert torch.equal(params0.means, means0)
    assert shn0.shape == (300, 0, 3)
    assert not np.array_equal(sess.get_gaussian_positions(),
                              kept["means"])


def test_load_train_data_without_poses_or_colmap_fails(tmp_path,
                                                       monkeypatch):
    monkeypatch.setenv("PATH", "")
    monkeypatch.delenv("DIVSHOT_COLMAP", raising=False)
    for i in range(2):
        write_png(str(tmp_path / f"{i}.png"), np.zeros((8, 8, 3), np.uint8))
    sess = TrainerSession(_cfg(), device=CPU)
    sess.load_train_data(str(tmp_path))
    assert sess.status == TrainingStatus.LOADING_FAILED
    assert "COLMAP" in sess.error and sess.is_terminated()
    with pytest.raises(RuntimeError, match="load_train_data"):
        sess.start_train()


# ---------------------------------------------------------------------------
# against the JAX package


def test_default_render_kwargs_follow_the_model_type():
    """A deliberate difference: JAX's session asks for ``"pallas"``
    whatever the model type (so it trains 2DGS as flattened gaussians);
    the port's takes the model type's route."""
    for mt, backend in ((0, "pallas"), (1, "surfel_pallas")):
        ours = TrainerSession(TrainConfig(model_type=mt), device=CPU)
        theirs = jax_session.TrainerSession(JTrainConfig(model_type=mt))
        assert ours.render_kwargs == {"backend": backend,
                                      "instance_capacity": 1 << 20}
        assert theirs.render_kwargs == {"backend": "pallas",
                                        "instance_capacity": 1 << 20}


def _sessions(d, degree):
    """A JAX and a port session on the same params ``d`` (numpy fields),
    loaded without training."""
    jp, tp = _both(d)
    rng = np.random.default_rng(5)
    images = rng.integers(0, 256, (2, 24, 32, 3), dtype=np.uint8)
    jcams = jax_orbit(2, width=32, height_px=24)
    jcfg = JTrainConfig(sh_degree=degree)
    jcfg.raster.mip_antialiased = True
    js = jax_session.TrainerSession(jcfg, render_kwargs={"backend": "tiles"})
    js.load_synthetic(jax_trainer.Dataset.from_views(jcams, images), jp)
    cfg = TrainConfig(sh_degree=degree)
    cfg.raster.mip_antialiased = True
    ts = TrainerSession(cfg, device=CPU)
    ts.load_synthetic(Dataset.from_views([_camera(c) for c in jcams],
                                         images), tp)
    return js, ts


@pytest.mark.parametrize("degree", [0, 3])
def test_accessors_match_jax(degree):
    js, ts = _sessions(_scene(n=50, dead=(0, 9, 10, 49), degree=degree),
                       degree)
    for name in ("positions", "sh0", "shn", "opacities", "scalings",
                 "rotations"):
        ours = getattr(ts, f"get_gaussian_{name}")()
        theirs = getattr(js, f"get_gaussian_{name}")()
        assert ours.dtype == theirs.dtype and ours.shape == theirs.shape
        np.testing.assert_array_equal(ours, theirs, err_msg=name)
    tp, jp = ts.get_params_snapshot(), js.get_params_snapshot()
    assert tp.capacity == jp.capacity == 46
    for f in ("means", "scales", "quats", "opacity", "sh0", "shN", "alive"):
        np.testing.assert_array_equal(getattr(tp, f).numpy(),
                                      np.asarray(getattr(jp, f)), err_msg=f)
    assert ts.num_cameras == js.num_cameras == 2
    assert ts.get_camera(1).width == js.get_camera(1).width == 32
    assert ts.get_camera(1).height == js.get_camera(1).height == 24
    for a, b in zip(ts.get_points3d(), js.get_points3d()):
        assert a.shape == b.shape == (0, 3)


@pytest.mark.parametrize("ext", [".ply", ".splat"])
def test_session_save_model_matches_jax_bytes(ext, tmp_path):
    js, ts = _sessions(_scene(n=30, dead=(2, 3, 17), degree=1), 1)
    js.save_model(str(tmp_path / f"j{ext}"))
    ts.save_model(str(tmp_path / f"t{ext}"))
    raw = (tmp_path / f"t{ext}").read_bytes()
    assert raw == (tmp_path / f"j{ext}").read_bytes()
    if ext == ".ply":
        back, meta = load_model(str(tmp_path / "t.ply"), device=CPU)
        assert back.capacity == 27 and meta.get("antialiased") is True
        js._sfm_points = ts._sfm_points = np.zeros((5, 3), np.float32)
        js.export_sparse_point_cloud(str(tmp_path / "j_pc.ply"))
        ts.export_sparse_point_cloud(str(tmp_path / "t_pc.ply"))
        assert ((tmp_path / "t_pc.ply").read_bytes()
                == (tmp_path / "j_pc.ply").read_bytes())


def _apply_case(change):
    """Two JAX ``Trainer`` steps, the state carried across to the port's
    ``Trainer`` (with the view sampler's state), ``change`` applied to
    both through ``apply_config``, then one ``step_once`` in each."""
    cams, images, jp = _step_scene()
    jcfg = _configure(JTrainConfig())
    jtr = jax_trainer.Trainer(
        jcfg, jax_trainer.Dataset.from_views(cams, images), jp,
        render_kwargs={"backend": "tiles", "tile_capacity": 512,
                       "instance_capacity": 1 << 15})
    with jax.default_matmul_precision("highest"):
        jtr.step_once()
        jtr.step_once()
        # a host copy: the JAX step donates its input state
        state = jax.tree.map(np.array, jtr.state)
        carried = _carry(state)
        ttr = Trainer(_configure(TrainConfig()),
                      Dataset.from_views([_camera(c) for c in cams], images),
                      carried.params, render_kwargs={
                          "instance_capacity": 1 << 15})
        ttr.state = carried
        ttr._np_rng.bit_generator.state = jtr._np_rng.bit_generator.state
        steps0 = ttr._steps[1]
        jtr.apply_config(change(jtr.cfg))
        ttr.apply_config(change(ttr.cfg))
        jm = jtr.step_once()
        tm = ttr.step_once()
    return state, jtr.state, jm, carried, ttr, tm, steps0


def _hyper(c):
    return c.replace(
        optim=dataclasses.replace(c.optim, pos_lr_init=c.optim.pos_lr_init
                                  * 20, scaling_lr=0.02, opacity_lr=0.1),
        densify=dataclasses.replace(c.densify, grow_grad2d=1e-4),
        ssim_weight=0.5)


def _structural(c):
    return c.replace(ssim_weight=0.0)


@pytest.mark.parametrize("change", [_hyper, _structural],
                         ids=["hyper", "structural"])
def test_apply_config_step_matches_jax(change):
    state, j2, jm, carried, ttr, tm, steps0 = _apply_case(change)
    _assert_step(state, j2, jm, carried, ttr.state, tm)
    assert (ttr._steps[1] is steps0) == (change is _hyper)
    assert ttr._hypers["ssim_weight"] == float(np.float32(
        0.5 if change is _hyper else 0.0))
    for f in PARAM_FIELDS:
        t = getattr(ttr.state.params, f).double().numpy()
        j = np.asarray(getattr(j2.params, f)).astype(np.float64)
        upd = np.abs(j - np.asarray(getattr(state.params, f))).max()
        np.testing.assert_allclose(t, j, rtol=0, atol=1e-6 + 1e-3 * upd,
                                   err_msg=f)


# ---------------------------------------------------------------------------
# the live viewer server and the app


def _get(url):
    with urllib.request.urlopen(url, timeout=30) as r:
        return r.status, dict(r.headers), r.read()


def test_live_viewer_server():
    """``tests/test_viewer.py:103-148`` through the port: the page, the
    status JSON, the ``.splat`` payload (equal to ``splat_bytes`` of the
    snapshot), ``?max=`` and the generation's 304."""
    rng = np.random.default_rng(0)
    gt = random_scene(rng, 128, sh_degree=0, device=CPU)
    cams = orbit_cameras(2, width=32, device=CPU)
    images = render_gt_images(gt, cams, instance_capacity=1 << 12)
    cfg = TrainConfig(sh_degree=0, num_iters=6)
    cfg.densify.cap_max = 128
    session = TrainerSession(cfg, render_kwargs={"instance_capacity": 1 << 12},
                             snapshot_every=2, device=CPU)
    session.load_synthetic(Dataset.from_views(cams, images),
                           params=random_scene(rng, 128, sh_degree=0,
                                               capacity=128, device=CPU))
    server = LiveViewerServer(session, port=0).start()
    try:
        base = f"http://127.0.0.1:{server.port}"
        page = _get(f"{base}/")[2].decode()
        assert "loadSplatBytes" in page and "splats?gen=" in page
        st0 = json.loads(_get(f"{base}/status")[2])
        assert st0["max_iterations"] == 6 and st0["loss"] is None
        assert st0["phase"] == "Preprocess_Done"
        gen0 = st0["generation"]
        code, headers, raw = _get(f"{base}/splats")
        assert len(raw) % 32 == 0 and len(raw) // 32 == 128
        assert raw == splat_bytes(session.get_params_snapshot())
        assert headers["X-Generation"] == str(gen0)
        assert len(_get(f"{base}/splats?max=40")[2]) == 40 * 32
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(f"{base}/splats?gen={gen0}")
        assert e.value.code == 304
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(f"{base}/nothing")
        assert e.value.code == 404

        session.start_train()
        _done(session)
        st1 = json.loads(_get(f"{base}/status")[2])
        assert st1["generation"] > gen0 and st1["iteration"] == 6
        assert st1["phase"] == "Training_Done" and st1["loss"] > 0
        raw1 = _get(f"{base}/splats")[2]
        assert raw1 == splat_bytes(session.get_params_snapshot())
        assert raw1 != raw
    finally:
        server.stop()


@pytest.fixture(scope="module")
def tiny_bricks(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("bricks") / "tpu_bricks")
    generate_dataset(out, n_train=4, n_test=2, width=32, height=32,
                     device=CPU)
    return out


def test_viewer_app_trains_a_blender_scene(tiny_bricks, capsys):
    assert viewer_app.main(["--source_path", tiny_bricks, "--device", CPU,
                            "--num_iters", "3", "--port", "0",
                            "--cap_max", "1024"]) == 0
    out = capsys.readouterr().out
    assert "live viewer: http://127.0.0.1:" in out
    assert "training done at iteration 3" in out


def test_viewer_app_demo_and_failures(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(train_app, "DEMO_SPLATS", 300)
    monkeypatch.setattr(train_app, "DEMO_VIEWS", 2)
    monkeypatch.setattr(train_app, "DEMO_WIDTH", 32)
    assert viewer_app.main(["--demo", "--device", CPU, "--num_iters", "2",
                            "--port", "0", "--cap_max", "512"]) == 0
    assert "training done at iteration 2" in capsys.readouterr().out
    sess = viewer_app.demo_session(_cfg(2), torch.device(CPU))
    assert sess.num_cameras == 2 and sess.trainer.state.params.num_alive \
        == 1024
    assert viewer_app.main(["--device", CPU, "--port", "0"]) == 2
    monkeypatch.setenv("PATH", "")
    monkeypatch.delenv("DIVSHOT_COLMAP", raising=False)
    write_png(str(tmp_path / "a.png"), np.zeros((8, 8, 3), np.uint8))
    assert viewer_app.main(["--source_path", str(tmp_path), "--device", CPU,
                            "--port", "0"]) == 1
    assert "COLMAP" in capsys.readouterr().out
    assert os.path.exists(tmp_path / "a.png")
