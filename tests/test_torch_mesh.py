"""Mesh extraction in the port against the JAX package on the CPU:
``render(override_colors=...)`` and ``render_depth`` (atol 3e-5 on the
image, the North star's forward tolerance; the override colours'
gradient atol 3e-4 against JAX's XLA route), ``tsdf_fuse`` (atol 1e-5),
``marching_tetrahedra`` (equal), ``extract_mesh`` with the export app and
``TrainerSession.export_mesh``. JAX renders through its XLA ``"tiles"``
route (its ``render_depth`` default), the port through the kernels'
plain versions.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from divshot_tpu.gsio.synthetic import orbit_cameras as jax_orbit
from divshot_tpu.gsio.synthetic import random_scene as jax_random_scene
from divshot_tpu.raster.render import render as jax_render
from divshot_tpu.viewer import mesh as JM

from divshot_tpu_torch.apps import export as export_app
from divshot_tpu_torch.core.config import TrainConfig
from divshot_tpu_torch.core.metrics import TrainingStatus
from divshot_tpu_torch.gsio.io import save_model
from divshot_tpu_torch.raster.render import render
from divshot_tpu_torch.splat.gaussians import GaussianParams
from divshot_tpu_torch.train.session import TrainerSession
from divshot_tpu_torch.viewer import mesh as TM
from tests.test_torch_train_options import _camera

CPU = "cpu"
FIELDS = ("means", "scales", "quats", "opacity", "sh0", "shN", "alive")
JRK = {"tile_capacity": 256, "instance_capacity": 1 << 13}
TRK = {"instance_capacity": 1 << 13}


def _carry(jp) -> GaussianParams:
    return GaussianParams.from_numpy(
        {f: np.asarray(getattr(jp, f)) for f in FIELDS}, device=CPU)


def _scene(n=300, seed=0):
    jp = jax_random_scene(np.random.default_rng(seed), n, sh_degree=1,
                          capacity=n + 20)
    return jp, _carry(jp)


def test_override_colors_forward_and_gradient():
    jp, tp = _scene()
    jc = jax_orbit(2, width=64, height_px=48)[1]
    cam = _camera(jc)
    cols = np.random.default_rng(1).uniform(-1, 3, (jp.capacity, 3)
                                            ).astype(np.float32)
    w = np.random.default_rng(2).normal(size=(48, 64, 3)).astype(np.float32)

    def jloss(c, means):
        out = jax_render(jp.replace(means=means), jc, override_colors=c,
                         **JRK)
        return jnp.sum(out.image * w) + jnp.sum(out.alpha), out

    with jax.default_matmul_precision("highest"):
        (_, jout), (jg_c, jg_m) = jax.value_and_grad(
            jloss, argnums=(0, 1), has_aux=True)(jnp.asarray(cols),
                                                 jp.means)
    c = torch.from_numpy(cols).requires_grad_(True)
    m = tp.means.clone().requires_grad_(True)
    out = render(dataclasses.replace(tp, means=m), cam, override_colors=c,
                 **TRK)
    (out.image * torch.from_numpy(w)).sum().add(out.alpha.sum()).backward()
    np.testing.assert_allclose(out.image.detach().numpy(),
                               np.asarray(jout.image), atol=3e-5)
    np.testing.assert_allclose(out.alpha.detach().numpy(),
                               np.asarray(jout.alpha), atol=3e-5)
    assert float(np.abs(np.asarray(jg_c)).max()) > 0
    np.testing.assert_allclose(c.grad.numpy(), np.asarray(jg_c), atol=3e-4)
    np.testing.assert_allclose(m.grad.numpy(), np.asarray(jg_m), atol=3e-4)
    # the SH colour is not read: the output ignores sh0
    same = render(dataclasses.replace(tp, sh0=tp.sh0 + 5), cam,
                  override_colors=c.detach(), **TRK)
    assert torch.equal(same.image, out.image.detach())


def _depths(jp, tp, jcams):
    out = []
    for jc in jcams:
        jd, ja = JM.render_depth(jp, jc, **JRK)
        td, ta = TM.render_depth(tp, _camera(jc), **TRK)
        out.append((jd, ja, td, ta))
    return out


def test_render_depth_matches_jax():
    jp, tp = _scene()
    for jd, ja, td, ta in _depths(jp, tp, jax_orbit(3, width=64,
                                                    height_px=48)):
        assert isinstance(td, torch.Tensor) and td.shape == (48, 64)
        np.testing.assert_allclose(ta.numpy(), ja, atol=3e-5)
        # the composited depth channel (the image), as the kernels give it
        np.testing.assert_allclose(
            td.numpy() * np.maximum(ta.numpy(), 1e-6),
            jd * np.maximum(ja, 1e-6), atol=3e-5)
        m = ja > 0.5
        assert m.any() and 1.0 < td.numpy()[m].mean() < 7.0


@pytest.mark.parametrize("bounds", [None, (np.array([-2.0, -1.5, -2.0]),
                                           np.array([2.0, 1.5, 2.5]))])
def test_tsdf_and_marching_tetrahedra_match_jax(bounds):
    jp, _ = _scene()
    jcams = jax_orbit(4, width=64, height_px=48)
    ds, als = zip(*(JM.render_depth(jp, jc, **JRK) for jc in jcams))
    kw = dict(resolution=24, bounds=bounds)
    jt, jlo, jcell = JM.tsdf_fuse(list(ds), list(als), jcams, **kw)
    tt, tlo, tcell = TM.tsdf_fuse([torch.from_numpy(np.asarray(d))
                                   for d in ds], list(als),
                                  [_camera(c) for c in jcams], chunk=5000,
                                  **kw)
    np.testing.assert_array_equal(tlo, jlo)
    assert tcell == jcell and tt.shape == (24, 24, 24)
    np.testing.assert_allclose(tt, jt, atol=1e-5)
    assert (tt < 0).any() and (tt > 0).any()
    tv, tf = TM.marching_tetrahedra(jt, jlo, jcell)
    jv, jf = JM.marching_tetrahedra(jt, jlo, jcell)
    assert len(tf) > 0
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(tf, jf)


def test_marching_tetrahedra_sphere():
    r = 32
    ii = np.linspace(-1, 1, r)
    gx, gy, gz = np.meshgrid(ii, ii, ii, indexing="ij")
    sdf = (np.sqrt(gx ** 2 + gy ** 2 + gz ** 2) - 0.6).astype(np.float32)
    lo = np.array([-1.0, -1, -1])
    tv, tf = TM.marching_tetrahedra(sdf, lo, 2.0 / (r - 1))
    jv, jf = JM.marching_tetrahedra(sdf, lo, 2.0 / (r - 1))
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(tf, jf)
    radii = np.linalg.norm(tv, axis=1)
    np.testing.assert_allclose(radii.mean(), 0.6, atol=0.05)
    empty = TM.marching_tetrahedra(np.ones((4, 4, 4), np.float32), lo, 0.5)
    assert empty[0].shape == (0, 3) and empty[1].shape == (0, 3)


def _obj_arrays(path):
    v, f = [], []
    for line in open(path):
        if line.startswith("v "):
            v.append([float(x) for x in line.split()[1:]])
        elif line.startswith("f "):
            f.append([int(x) for x in line.split()[1:]])
    return np.asarray(v), np.asarray(f) - 1


def test_extract_mesh_and_export_app(tmp_path):
    """``extract_mesh`` against JAX's on the same splats and cameras: the
    surfaces agree (each vertex within a cell of the other mesh); the OBJ
    holds what was returned. Then the export app's OBJ of the same splats
    from a PLY."""
    jp, tp = _scene(400, seed=3)
    jcams = jax_orbit(6, width=64)
    tv, tf = TM.extract_mesh(tp, [_camera(c) for c in jcams], resolution=32,
                             out_path=str(tmp_path / "t.obj"),
                             render_kw=TRK)
    jv, jf = JM.extract_mesh(jp, jcams, resolution=32, render_kw=JRK)
    assert len(tv) > 0 and len(tf) > 0 and tf.max() < len(tv)
    centers = np.stack([np.asarray(c.campos) for c in jcams])
    cell = 2 * 0.7 * np.linalg.norm(centers - centers.mean(0), axis=1).max() \
        / 32
    for a, b in ((tv, jv), (jv, tv)):
        d = np.sqrt(((a[:, None, :] - b[None, :, :]) ** 2).sum(-1)).min(1)
        assert d.max() < cell, d.max()
    assert abs(len(tf) - len(jf)) <= 0.05 * len(jf)
    ov, of = _obj_arrays(tmp_path / "t.obj")
    np.testing.assert_allclose(ov, tv, atol=1e-6)
    np.testing.assert_array_equal(of, tf)

    save_model(str(tmp_path / "m.ply"), tp)
    assert export_app.main(["--input", str(tmp_path / "m.ply"), "--output",
                            str(tmp_path / "app.obj"), "--views", "4",
                            "--mesh_resolution", "24", "--device",
                            "cpu"]) == 0
    av, af = _obj_arrays(tmp_path / "app.obj")
    assert len(av) > 0 and len(af) > 0 and af.max() < len(av)


def test_session_export_mesh(tmp_path):
    """``TrainerSession.export_mesh`` (it raised before the port had
    ``viewer/mesh.py``) writes the mesh of the session's snapshot, as
    ``extract_mesh`` on the same params and cameras gives it."""
    from tests.test_torch_session import _params, _tiny_dataset
    cfg = TrainConfig(sh_degree=0, num_iters=2, mesh_resolution=24)
    cfg.densify.cap_max = 1024
    sess = TrainerSession(cfg, render_kwargs=TRK, snapshot_every=0,
                          device=CPU)
    sess.load_synthetic(_tiny_dataset(), _params())
    assert sess.status == TrainingStatus.PREPROCESS_DONE
    sess.export_mesh(str(tmp_path / "s.obj"))
    v, f = _obj_arrays(tmp_path / "s.obj")
    cams = [sess.get_camera(i) for i in range(sess.num_cameras)]
    ev, ef = TM.extract_mesh(sess.get_params_snapshot(), cams,
                             resolution=24, render_kw=TRK)
    assert len(f) > 0
    np.testing.assert_allclose(v, ev, atol=1e-6)
    np.testing.assert_array_equal(f, ef)
