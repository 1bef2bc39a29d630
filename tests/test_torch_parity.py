"""Parity of the PyTorch port (``divshot_tpu_torch``) with the JAX package
on the CPU: the same numpy inputs go through the JAX function and its
counterpart (``device="cpu"``), and the outputs are held to the stated
tolerances. Pallas kernels run in interpret mode, as the JAX package's own
tests run them."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from divshot_tpu.gsio.ply import load_ply as jax_load_ply
from divshot_tpu.gsio.synthetic import orbit_cameras as jax_orbit
from divshot_tpu.gsio.synthetic import random_scene as jax_random_scene
from divshot_tpu.raster import pallas_bin as jax_bin
from divshot_tpu.raster import pallas_raster as jax_raster
from divshot_tpu.raster.project import project_gaussians as jax_project
from divshot_tpu.raster.render import render_fast as jax_render_fast
from divshot_tpu.splat.math import safe_normalize as jax_safe_normalize
from divshot_tpu.splat.sh import eval_sh_color as jax_eval_sh_color

from divshot_tpu_torch.apps.render import orbit_for_model
from divshot_tpu_torch.gsio.ply import load_ply
from divshot_tpu_torch.gsio.synthetic import orbit_cameras, random_scene
from divshot_tpu_torch.raster import bin as B
from divshot_tpu_torch.raster import raster as R
from divshot_tpu_torch.raster.project import project_gaussians
from divshot_tpu_torch.raster.render import frame_inputs, render_fast
from divshot_tpu_torch.splat.camera import Camera
from divshot_tpu_torch.splat.gaussians import GaussianParams
from divshot_tpu_torch.splat.sh import eval_sh_color

CPU = "cpu"
FIELDS = ("means", "scales", "quats", "opacity", "sh0", "shN", "alive")
MODEL = "runs/tpu_bricks_mcmc/point_cloud.ply"

# (seed, splats, width, height, sh degree)
SCENES = [(0, 200, 64, 64, 0), (1, 2000, 128, 96, 3), (2, 900, 96, 80, 3)]


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _to_torch_params(jp) -> GaussianParams:
    return GaussianParams.from_numpy(
        {f: np.asarray(getattr(jp, f)) for f in FIELDS}, device=CPU)


def _to_torch_camera(jc) -> Camera:
    return Camera.from_numpy(
        {k: np.asarray(getattr(jc, k)) for k in
         ("viewmat", "fx", "fy", "cx", "cy", "width", "height")},
        device=CPU)


def _scene(seed, n, w, h, sh):
    """The same scene in both packages; a padded dead tail included."""
    jp = jax_random_scene(np.random.default_rng(seed), n, sh_degree=sh,
                          capacity=n + 24)
    jc = jax_orbit(1, width=w, height_px=h)[0]
    return jp, jc, _to_torch_params(jp), _to_torch_camera(jc)


def _jax_frame_inputs(jp, jc):
    op = jp.effective_opacity()
    proj = jax_project(jp.means, jp.scales, jp.quats, jc, opacities=op)
    dirs = jax_safe_normalize(jp.means - jc.campos[None, :])
    colors = jax_eval_sh_color(jp.sh0, jp.shN, dirs, jp.sh_degree)
    return proj, colors, op * proj.comp


def test_carry_across_round_trip():
    jp, jc, tp, tc = _scene(0, 50, 64, 48, 3)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(tp, f).numpy(),
                                      np.asarray(getattr(jp, f)))
    np.testing.assert_array_equal(tc.viewmat, np.asarray(jc.viewmat))
    np.testing.assert_array_equal(tc.campos.numpy(), np.asarray(jc.campos))
    np.testing.assert_array_equal(
        tp.effective_opacity().numpy(), np.asarray(jp.effective_opacity()))
    want, got = jp.compact_numpy(), tp.compact_numpy()
    assert sorted(got) == sorted(want) and len(got["means"]) == 50
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_random_scene_and_orbit_match_jax():
    jp = jax_random_scene(np.random.default_rng(5), 300, sh_degree=3,
                          scale_range=(0.004, 0.025), capacity=320)
    tp = random_scene(np.random.default_rng(5), 300, sh_degree=3,
                      scale_range=(0.004, 0.025), capacity=320, device=CPU)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(tp, f).numpy(),
                                      np.asarray(getattr(jp, f)))
    for jc, tc in zip(jax_orbit(3, width=96, height_px=64),
                      orbit_cameras(3, width=96, height_px=64, device=CPU)):
        np.testing.assert_array_equal(tc.viewmat,
                                      np.asarray(jc.viewmat))
        assert (tc.fx, tc.fy, tc.cx, tc.cy) == tuple(
            float(np.asarray(getattr(jc, k))) for k in ("fx", "fy", "cx",
                                                        "cy"))


def test_orbit_for_model_matches_jax_app():
    """The render app's camera placement (``divshot_tpu/apps/render.py``:
    radius scaled by the model's extent) gives the same cameras."""
    jp, _, tp, _ = _scene(3, 400, 64, 48, 0)
    d = jp.compact_numpy()
    extent = float(np.abs(d["means"] - d["means"].mean(0)).max())
    want = jax_orbit(3, radius=4.0 * max(extent / 1.5, 0.5), width=96,
                     height_px=64, fov_y_deg=50.0)
    got = orbit_for_model(tp, 3, radius=4.0, width=96, height=64, fov=50.0)
    for jc, tc in zip(want, got):
        np.testing.assert_array_equal(tc.viewmat,
                                      np.asarray(jc.viewmat))


@pytest.mark.parametrize("scene", SCENES)
@pytest.mark.parametrize("antialiased", [False, True])
def test_project_gaussians_matches_jax(scene, antialiased):
    jp, jc, tp, tc = _scene(*scene)
    op = jp.effective_opacity()
    pj = jax_project(jp.means, jp.scales, jp.quats, jc, opacities=op,
                     antialiased=antialiased)
    pt = project_gaussians(tp.means, tp.scales, tp.quats, tc,
                           opacities=tp.effective_opacity(),
                           antialiased=antialiased)
    for f in pj._fields:
        want = np.asarray(getattr(pj, f))
        got = getattr(pt, f).numpy()
        # rad2 reaches hundreds of px^2 and passes through log and sqrt,
        # whose float32 libm results differ by an ulp between XLA and
        # PyTorch: 1e-5 there is below one ulp, so it is held relatively
        rtol = 2e-6 if f == "rad2" else 0.0
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=rtol,
                                   err_msg=f"projection field {f}")


@pytest.mark.parametrize("degree", [0, 1, 2, 3])
def test_eval_sh_color_matches_jax(degree):
    rng = np.random.default_rng(degree)
    n = 500
    k = {0: 0, 1: 3, 2: 8, 3: 15}[degree]
    sh0 = rng.standard_normal((n, 3)).astype(np.float32)
    shN = (0.3 * rng.standard_normal((n, 15, 3))).astype(np.float32)
    d = rng.standard_normal((n, 3))
    dirs = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    want = jax_eval_sh_color(jnp.asarray(sh0), jnp.asarray(shN[:, :k]),
                             jnp.asarray(dirs), degree)
    got = eval_sh_color(torch.as_tensor(sh0), torch.as_tensor(shN[:, :k]),
                        torch.as_tensor(dirs), degree)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


@pytest.mark.parametrize("scene", SCENES[:2])
def test_expand_sorted_matches_jax(scene):
    """Same projected inputs (JAX's, as numpy) into both binnings: counts,
    offsets, demand, tile counts and tile ranges equal; the owners of each
    tile equal as sets; feature rows bit-exact where the owners agree."""
    jp, jc, _, tc = _scene(*scene)
    proj, colors, opac = _jax_frame_inputs(jp, jc)
    cap = 1 << 14
    jb = jax_bin.expand_sorted(
        proj.means2d, proj.conics, proj.depths, proj.radii, proj.radii_xy,
        proj.rad2, colors, opac, width=jc.width, height=jc.height,
        instance_capacity=cap, interpret=True)
    t = {k: torch.as_tensor(np.array(v)) for k, v in dict(
        means2d=proj.means2d, conics=proj.conics, depths=proj.depths,
        radii=proj.radii, radii_xy=proj.radii_xy, rad2=proj.rad2,
        colors=colors, opacities=opac).items()}
    tb = B.expand_sorted(**t, width=tc.width, height=tc.height,
                         instance_capacity=cap)

    assert int(tb.num_instances) == int(jb.num_instances) > 0
    for f in ("g_counts", "g_offsets", "tile_counts", "tile_start"):
        np.testing.assert_array_equal(getattr(tb, f).numpy(),
                                      np.asarray(getattr(jb, f)),
                                      err_msg=f)
    ts = tb.tile_start.numpy()
    own_t, own_j = tb.s_owner.numpy(), np.asarray(jb.s_owner)
    for i in range(len(ts) - 1):
        s, e = ts[i], ts[i + 1]
        np.testing.assert_array_equal(np.sort(own_t[s:e]),
                                      np.sort(own_j[s:e]))
    agree = own_t == own_j
    got = tb.table.numpy()[:, agree]
    want = np.asarray(jb.table)[:tb.table.shape[0], agree]
    gathered = [r for r in range(got.shape[0]) if r != R.ROW_LOGOP]
    np.testing.assert_array_equal(got[gathered], want[gathered])
    # log(opacity) is computed, not gathered: XLA's and PyTorch's float32
    # log differ by up to an ulp
    np.testing.assert_allclose(got[R.ROW_LOGOP], want[R.ROW_LOGOP],
                               rtol=2.5e-7, atol=0)


@pytest.mark.parametrize("scene", SCENES)
def test_rasterize_forward_matches_jax(scene):
    """The JAX binning's table and tile ranges into both compositors, at
    the bar of test_pallas_forward_matches_tiles (atol 3e-5)."""
    jp, jc, _, tc = _scene(*scene)
    proj, colors, opac = _jax_frame_inputs(jp, jc)
    jb = jax_bin.expand_sorted(
        proj.means2d, proj.conics, proj.depths, proj.radii, proj.radii_xy,
        proj.rad2, colors, opac, width=jc.width, height=jc.height,
        instance_capacity=1 << 14, interpret=True)
    want = jax_raster.rasterize_forward(
        jb.table, jb.tile_start, width=jc.width, height=jc.height, nch=3,
        interpret=True)
    got = R.rasterize_forward(torch.as_tensor(np.array(jb.table)),
                              torch.as_tensor(np.array(jb.tile_start)),
                              width=tc.width, height=tc.height, nch=3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=3e-5)


@pytest.mark.parametrize("scene", SCENES)
def test_render_fast_matches_jax(scene):
    jp, jc, tp, tc = _scene(*scene)
    bg = np.asarray([0.2, 0.4, 0.6], np.float32)
    img_j, alpha_j, bins_j = jax_render_fast(
        jp, jc, background=jnp.asarray(bg), instance_capacity=1 << 14)
    img_t, alpha_t, bins_t = render_fast(
        tp, tc, background=torch.as_tensor(bg), instance_capacity=1 << 14)
    assert img_t.shape == (tc.height, tc.width, 3)
    assert int(bins_t.num_instances) == int(bins_j.num_instances)
    np.testing.assert_allclose(img_t.numpy(), np.asarray(img_j), atol=3e-4)
    np.testing.assert_allclose(alpha_t.numpy(), np.asarray(alpha_j),
                               atol=3e-4)
    assert float(alpha_t.max()) > 0.1


def test_render_fast_stale_bins_guard():
    """As tests/test_round5.py::test_render_fast_stale_bins_guard: same
    token reuses the bins bit-identically, a bumped token raises."""
    _, _, tp, tc = _scene(0, 200, 64, 48, 1)
    img, _, bins = render_fast(tp, tc, instance_capacity=1 << 13,
                               params_token=1)
    img2, _, _ = render_fast(tp, tc, bins=bins, instance_capacity=1 << 13,
                             params_token=1)
    np.testing.assert_array_equal(img.numpy(), img2.numpy())
    with pytest.raises(ValueError, match="stale FastBins"):
        render_fast(tp, tc, bins=bins, instance_capacity=1 << 13,
                    params_token=2)


def test_frame_inputs_match_jax():
    jp, jc, tp, tc = _scene(1, 2000, 128, 96, 3)
    _, colors_j, opac_j = _jax_frame_inputs(jp, jc)
    _, colors_t, opac_t = frame_inputs(tp, tc)
    np.testing.assert_allclose(colors_t.numpy(), np.asarray(colors_j),
                               atol=1e-6)
    np.testing.assert_allclose(opac_t.numpy(), np.asarray(opac_j), atol=1e-6)


def test_load_ply_matches_jax():
    jp, jmeta = jax_load_ply(MODEL)
    tp, tmeta = load_ply(MODEL, device=CPU)
    assert tmeta == jmeta
    assert tp.capacity == jp.capacity == 262144
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(tp, f).numpy(),
                                      np.asarray(getattr(jp, f)), err_msg=f)
