"""The mesh renderers in the port against the JAX package on the CPU
(``raster/mesh_raster.py``, ``path_trace.py``, ``gi.py``).

- ``rasterize_mesh``: the G-buffer at 64x48 and in a tile-overflow case
  (``tile_capacity`` and ``instance_capacity`` below the demand, so both
  drop the same instances): triangle ids equal outside the depth ties
  (pixels where the two packages pick different triangles at depths within
  1e-5 of each other: counted, at most 1 % of the hits), depth, normal
  and albedo within 1e-5 of the largest value there.
- ``shade_gbuffer``, ``shade_gbuffer_lights`` (``tests/test_round4.py``'s
  floor with point, spot, directional and rect lights),
  ``composite_splats_over_mesh`` and ``pick_triangle`` on JAX's own
  G-buffer: atol 1e-5.
- ``ray_occluded`` bitwise on random rays against random triangles.
- ``path_trace_mesh``, ``restir_direct`` and ``ssgi`` given JAX's draws
  (the port's ``_path_trace``, ``_restir`` and ``_ssgi`` take them): the
  images within 1e-5 of their largest value; the path tracer's sun term
  with the port's own draws under a near-black environment (radiance
  1e-3, so the draws move a pixel by at most ~1e-3) within 2e-3;
  ``deferred_shade_gi`` where it draws nothing (one light, no SSGI)
  equal to JAX's.
- Their Monte Carlo parts from the port's own ``torch.Generator``, held
  by statistics as ``tests/test_path_trace.py`` and ``tests/test_gi.py``
  hold JAX's: ReSTIR unbiased against the brute-force sum over lights,
  temporal reuse lowering the error, occlusion darkening.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from divshot_tpu.models.background import init_envmap as jax_envmap
from divshot_tpu.raster import gi as JG
from divshot_tpu.raster import mesh_raster as JM
from divshot_tpu.raster import path_trace as JP
from divshot_tpu.scene.components import Light as JLight
from divshot_tpu.scene.components import LightType as JLightType
from divshot_tpu.splat.camera import Camera as JCamera

from divshot_tpu_torch.models.background import init_envmap
from divshot_tpu_torch.raster import gi as TG
from divshot_tpu_torch.raster import mesh_raster as TM
from divshot_tpu_torch.raster import path_trace as TP
from divshot_tpu_torch.scene.components import Light, LightType
from divshot_tpu_torch.splat.camera import Camera

CPU = "cpu"
TOL = 1e-5

CUBE_V = np.array([[-1, -1, -1], [1, -1, -1], [1, 1, -1], [-1, 1, -1],
                   [-1, -1, 1], [1, -1, 1], [1, 1, 1], [-1, 1, 1]],
                  np.float32)
CUBE_F = np.array([[0, 2, 1], [0, 3, 2], [4, 5, 6], [4, 6, 7],
                   [0, 1, 5], [0, 5, 4], [2, 3, 7], [2, 7, 6],
                   [1, 2, 6], [1, 6, 5], [0, 4, 7], [0, 7, 3]], np.int32)


def _cams(eye, target, up, fov, w, h):
    return (JCamera.look_at(jnp.asarray(eye, jnp.float32),
                            jnp.asarray(target, jnp.float32),
                            jnp.asarray(up, jnp.float32), fov_y_deg=fov,
                            width=w, height=h),
            Camera.look_at(eye, target, up, fov, w, h, device=CPU))


def _soup(n=120, seed=0):
    rng = np.random.default_rng(seed)
    c = rng.uniform(-1.2, 1.2, (n, 1, 3))
    v = (c + rng.normal(0, 0.35, (n, 3, 3))).reshape(-1, 3)
    return v.astype(np.float32), np.arange(3 * n, dtype=np.int32).reshape(
        n, 3)


def _t(gb) -> TM.GBuffer:
    return TM.GBuffer(*(torch.as_tensor(np.array(x)) for x in gb))


def _close(a, b, tol=TOL, mask=None):
    a, b = np.asarray(a), np.asarray(b)
    if mask is not None:
        a, b = a[mask], b[mask]
    scale = max(float(np.abs(b).max()) if b.size else 0.0, 1.0)
    np.testing.assert_allclose(a, b, atol=tol * scale, rtol=0)


def _same_gbuffer(jg, tg):
    jd, td = np.asarray(jg.depth), tg.depth.numpy()
    hit = np.isfinite(jd)
    assert np.array_equal(hit, np.isfinite(td))
    assert hit.sum() > 50
    _close(td, jd, mask=hit)
    jid, tid = np.asarray(jg.tri_id), tg.tri_id.numpy()
    ties = jid != tid
    # a tie: both pick a triangle at the same depth (float rounding)
    assert not (ties & ~hit).any()
    assert np.all(np.abs(td[ties] - jd[ties])
                  <= TOL * np.abs(jd[hit]).max())
    assert ties.sum() <= 0.01 * hit.sum(), ties.sum()
    same = hit & ~ties
    _close(tg.normal.numpy(), np.asarray(jg.normal), mask=same)
    _close(tg.albedo.numpy(), np.asarray(jg.albedo), mask=same)
    assert np.array_equal(tid[~hit], jid[~hit])
    return int(ties.sum())


@pytest.mark.parametrize("case", ["cube_normals", "soup_face_colors",
                                  "soup_overflow"])
def test_gbuffer_matches_jax(case):
    if case == "cube_normals":
        v, f = CUBE_V * 0.8, CUBE_F
        kw = dict(normals=CUBE_V / np.linalg.norm(CUBE_V, axis=1,
                                                  keepdims=True),
                  colors=np.abs(CUBE_V) * 0.4 + 0.1)
        eye = (2.5, 1.8, 3.5)
    else:
        v, f = _soup()
        kw = dict(face_colors=np.random.default_rng(1).uniform(
            0, 1, (len(f), 3)).astype(np.float32))
        eye = (0.3, 0.5, 4.0)
    if case == "soup_overflow":
        # fewer tile slots and instances than the frame demands: both
        # packages drop the same instances (the chunk walk included)
        kw.update(tile_capacity=32, instance_capacity=1 << 9, chunk=8)
    jc, tc = _cams(eye, (0, 0, 0), (0, -1, 0), 55.0, 64, 48)
    jg = JM.rasterize_mesh(jnp.asarray(v), jnp.asarray(f), jc,
                           **{k: (jnp.asarray(x) if isinstance(
                               x, np.ndarray) else x)
                              for k, x in kw.items()})
    tg = TM.rasterize_mesh(v, f, tc, **kw)
    assert tg.tri_id.dtype == torch.int32
    _same_gbuffer(jg, tg)
    if case == "soup_overflow":
        full = TM.rasterize_mesh(v, f, tc, face_colors=kw["face_colors"])
        assert not torch.equal(full.tri_id, tg.tri_id), "nothing dropped"


def _floor_gbuffer():
    verts = np.array([[-2, 0, -2], [2, 0, -2], [2, 0, 2], [-2, 0, 2]],
                     np.float32)
    faces = np.array([[0, 2, 1], [0, 3, 2]], np.int32)
    normals = np.array([[0, 1, 0]] * 4, np.float32)
    colors = np.full((4, 3), 1.0, np.float32)
    jc, tc = _cams((0.0, 3.0, 3.0), (0, 0, 0), (0.0, 1, 0), 55.0, 96, 96)
    jg = JM.rasterize_mesh(jnp.asarray(verts), jnp.asarray(faces), jc,
                           normals=jnp.asarray(normals),
                           colors=jnp.asarray(colors))
    return jc, tc, jg


def _lights(J: bool):
    L, LT = (JLight, JLightType) if J else (Light, LightType)
    return [L(type=LT.POINT, position=(1.5, 0.8, 1.5), intensity=3.0,
              range=10.0),
            L(type=LT.SPOT, position=(0.0, 2.0, 0.0),
              direction=(0.0, -1.0, 0.0), intensity=6.0, range=10.0,
              inner_angle=0.2, outer_angle=0.35),
            L(type=LT.DIRECTIONAL, direction=(0.3, -1.0, 0.2),
              intensity=1.0),
            L(type=LT.RECT, position=(-1.0, 1.0, 0.5), intensity=0.7,
              range=6.0, size=(0.5, 2.0))]


def test_shading_compositing_and_picking_match_jax():
    jc, tc, jg = _floor_gbuffer()
    tg = _t(jg)
    _close(TM.shade_gbuffer(tg).numpy(), JM.shade_gbuffer(jg))
    _close(TM.shade_gbuffer(tg, light_dir=(0.1, 0.9, -0.2), ambient=0.1)
           .numpy(), JM.shade_gbuffer(jg, light_dir=(0.1, 0.9, -0.2),
                                      ambient=0.1))
    for i in range(4):
        j_one = JM.shade_gbuffer_lights(jg, jc, _lights(True)[i:i + 1],
                                        ambient=0.0)
        t_one = TM.shade_gbuffer_lights(tg, tc, _lights(False)[i:i + 1],
                                        ambient=0.0)
        assert float(np.asarray(j_one).max()) > 0.01
        _close(t_one.numpy(), j_one)
    _close(TM.shade_gbuffer_lights(tg, tc, _lights(False)).numpy(),
           JM.shade_gbuffer_lights(jg, jc, _lights(True)))

    rng = np.random.default_rng(3)
    h, w = jg.depth.shape
    srgb = rng.uniform(0, 1, (h, w, 3)).astype(np.float32)
    salpha = rng.uniform(0, 1, (h, w)).astype(np.float32)
    sdepth = rng.uniform(2.0, 6.0, (h, w)).astype(np.float32)
    mesh = np.array(JM.shade_gbuffer(jg))
    bg = np.asarray([0.1, 0.2, 0.3], np.float32)
    jout = JM.composite_splats_over_mesh(srgb, salpha, sdepth, jg, mesh,
                                         background=jnp.asarray(bg))
    tout = TM.composite_splats_over_mesh(
        torch.as_tensor(srgb), torch.as_tensor(salpha),
        torch.as_tensor(sdepth), tg, torch.as_tensor(mesh), background=bg)
    _close(tout.numpy(), jout)
    hit = np.isfinite(np.asarray(jg.depth))
    front = hit & (sdepth <= np.asarray(jg.depth))
    assert front.any() and (hit & ~front).any()
    for x, y in ((48, 60), (0, 0), (10, 80), (95, 95)):
        assert TM.pick_triangle(tg, x, y) == JM.pick_triangle(jg, x, y)
    assert TM.pick_triangle(tg, 0, 0) == -1


def test_ray_occluded_bitwise():
    rng = np.random.default_rng(5)
    v, f = _soup(80, seed=2)
    org = rng.uniform(-2, 2, (1500, 3)).astype(np.float32)
    d = rng.normal(size=(1500, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    tmax = rng.uniform(0.2, 4.0, 1500).astype(np.float32)
    for kw_j, kw_t in (({}, {}), ({"t_max": jnp.asarray(tmax)},
                                 {"t_max": torch.as_tensor(tmax)}),
                       ({"t_max": 1.5, "t_min": 0.05},
                        {"t_max": 1.5, "t_min": 0.05})):
        j = np.asarray(JP.ray_occluded(jnp.asarray(org), jnp.asarray(d),
                                       jnp.asarray(v), jnp.asarray(f),
                                       **kw_j))
        t = TP.ray_occluded(torch.as_tensor(org), torch.as_tensor(d), v, f,
                            chunk=16, **kw_t).numpy()
        assert 0.05 < j.mean() < 0.95
        assert np.array_equal(j, t)


def _floor_and_blocker():
    verts = np.array([[-2, 0, -2], [2, 0, -2], [2, 0, 2], [-2, 0, 2],
                      [-0.4, 0.6, -0.4], [0.4, 0.6, -0.4], [0.4, 0.6, 0.4],
                      [-0.4, 0.6, 0.4]], np.float32)
    faces = np.array([[0, 2, 1], [0, 3, 2], [4, 5, 6], [4, 6, 7]], np.int32)
    normals = np.array([[0, 1, 0]] * 4 + [[0, -1, 0]] * 4, np.float32)
    colors = np.full((8, 3), 0.8, np.float32)
    return verts, faces, normals, colors


def _jax_pt_uniforms(key, n_samples, h, w):
    """JAX's draws in ``path_trace_mesh``: one key a sample, split in two
    for ``_cosine_dirs``'s uniforms."""
    out = []
    for k in jax.random.split(key, n_samples):
        k1, k2 = jax.random.split(k)
        out.append([np.asarray(jax.random.uniform(k1, (h, w))),
                    np.asarray(jax.random.uniform(k2, (h, w)))])
    return torch.as_tensor(np.array(out))


def test_path_trace_matches_jax_with_its_draws():
    verts, faces, normals, colors = _floor_and_blocker()
    jc, tc = _cams((0.0, 2.5, 2.5), (0, 0, 0), (0.0, 1, 0), 55.0, 48, 40)
    jenv = jax_envmap(8, 16, init_color=(0.7, 0.8, 0.9))
    key = jax.random.PRNGKey(7)
    kw = dict(sun_dir=(0.3, 1.0, 0.2), sun_radiance=1.5)
    jout = JP.path_trace_mesh(jnp.asarray(verts), jnp.asarray(faces), jc,
                              jenv, key, normals=jnp.asarray(normals),
                              colors=jnp.asarray(colors), n_samples=3, **kw)
    tg = TM.rasterize_mesh(verts, faces, tc, normals=normals, colors=colors)
    _same_gbuffer(jout.gbuffer, tg)
    tout = TP._path_trace(tg, verts, faces, tc, torch.as_tensor(
        np.array(jenv)), _jax_pt_uniforms(key, 3, 40, 48), **kw)
    _close(tout.image.numpy(), jout.image)
    # the sun term alone: no environment light
    jdark = jax_envmap(4, 8, init_color=(1e-3, 1e-3, 1e-3))
    jsun = JP.path_trace_mesh(jnp.asarray(verts), jnp.asarray(faces), jc,
                              jdark, key, normals=jnp.asarray(normals),
                              colors=jnp.asarray(colors), n_samples=1, **kw)
    tsun = TP.path_trace_mesh(verts, faces, tc, init_envmap(
        4, 8, init_color=(1e-3, 1e-3, 1e-3), device=CPU),
        torch.Generator().manual_seed(0), normals=normals, colors=colors,
        n_samples=1, **kw)
    _close(tsun.image.numpy(), jsun.image, tol=2e-3)


def test_path_trace_occlusion_darkens_and_hybrid_background():
    """tests/test_path_trace.py's checks through the port's own draws."""
    verts, faces, normals, colors = _floor_and_blocker()
    _, tc = _cams((0.0, 2.5, 2.5), (0, 0, 0), (0.0, 1, 0), 55.0, 96, 96)
    env = init_envmap(16, 32, init_color=(0.99, 0.99, 0.99), device=CPU)
    out = TP.path_trace_mesh(verts, faces, tc, env,
                             torch.Generator().manual_seed(0),
                             normals=normals, colors=colors, n_samples=16,
                             sun_dir=(0.0, 1.0, 0.0))
    img = out.image.numpy()
    assert np.isfinite(img).all()
    tid = out.gbuffer.tri_id.numpy()
    H, W = tid.shape
    ys, xs = np.mgrid[0:H, 0:W]
    floor = (tid == 0) | (tid == 1)
    center = floor & (np.abs(xs - W / 2) < W * 0.08) & \
        (np.abs(ys - H * 0.55) < H * 0.1)
    border = floor & (xs < W * 0.2)
    assert center.sum() > 10 and border.sum() > 10
    lum = img.mean(-1)
    assert lum[center].mean() < 0.6 * lum[border].mean()

    class SplatOut:
        image = torch.zeros((64, 64, 3))
        alpha = torch.zeros((64, 64))

    _, tc = _cams((0.0, 2.5, 2.5), (0, 0, 0), (0.0, 1, 0), 55.0, 64, 64)
    img, pt = TP.render_hybrid_pt(
        SplatOut, verts, faces, tc, init_envmap(8, 16, device=CPU),
        torch.Generator().manual_seed(1),
        splat_depth=torch.full((64, 64), float("inf")), n_samples=4,
        normals=normals, colors=colors, background=(0.1, 0.1, 0.1))
    img = img.numpy()
    miss = ~np.isfinite(pt.gbuffer.depth.numpy())
    assert img.shape == (64, 64, 3) and np.isfinite(img).all() and miss.any()
    np.testing.assert_allclose(img[miss], 0.1, atol=1e-5)


def _plane(res=32):
    positions = np.array([[-3, -3, 0], [3, -3, 0], [3, 3, 0], [-3, 3, 0]],
                         np.float32)
    faces = np.array([[0, 2, 1], [0, 3, 2]], np.int32)
    jc, tc = _cams((0, 0, -4.0), (0, 0, 0), (0, -1, 0), 60.0, res, res)
    jg = JM.rasterize_mesh(jnp.asarray(positions), jnp.asarray(faces), jc)
    return positions, faces, jc, tc, jg


def _point_lights(n, seed, J):
    L, LT = (JLight, JLightType) if J else (Light, LightType)
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        p = rng.uniform(-2, 2, 3)
        p[2] = -rng.uniform(0.5, 2.5)
        out.append(L(type=LT.POINT, position=tuple(p),
                     color=tuple(rng.uniform(0.2, 1.0, 3)),
                     intensity=float(rng.uniform(0.5, 2.0)), range=20.0))
    return out


def _jax_restir_draws(key, n_candidates, taps, L, h, w):
    k_cand, k_res, k_t, k_s = jax.random.split(key, 4)
    u_s = [np.asarray(jax.random.uniform(kk, (h, w)))
           for kk in jax.random.split(k_s, taps)] if taps else []
    return TG.RestirDraws(
        cand=torch.as_tensor(np.array(jax.random.randint(
            k_cand, (n_candidates, h, w), 0, L))),
        us=torch.as_tensor(np.array(jax.random.uniform(
            k_res, (n_candidates, h, w)))),
        u_t=torch.as_tensor(np.array(jax.random.uniform(k_t, (h, w)))),
        u_s=torch.as_tensor(np.array(u_s, np.float32).reshape(taps, h, w)))


def test_restir_and_ssgi_match_jax_with_their_draws():
    positions, faces, jc, tc, jg = _plane(res=40)
    tg = _t(jg)
    jl, tl = _point_lights(9, 0, True), _point_lights(9, 0, False)
    jl.append(JLight(type=JLightType.SPOT, position=(0, 0, -2.5),
                     direction=(0, 0, 1), intensity=2.0, range=20.0,
                     inner_angle=0.3, outer_angle=0.7))
    tl.append(Light(type=LightType.SPOT, position=(0, 0, -2.5),
                    direction=(0, 0, 1), intensity=2.0, range=20.0,
                    inner_angle=0.3, outer_angle=0.7))
    jsoa, tsoa = JG.lights_to_soa(jl), TG.lights_to_soa(tl, CPU)
    for f in jsoa._fields:
        _close(getattr(tsoa, f).numpy(), getattr(jsoa, f), tol=0)
    blocker = (np.concatenate([positions, positions * 0.15 + [0, 0, -1.0]]),
               np.concatenate([faces, faces + 4]))
    state_j = state_t = None
    for i, (occl, taps) in enumerate(((None, 2), (blocker, 2),
                                      (None, 0))):
        key = jax.random.PRNGKey(11 + i)
        jimg, state_j = JG.restir_direct(
            jg, jc, jsoa, key, state=state_j, spatial_taps=taps,
            occluders=None if occl is None else tuple(
                jnp.asarray(x) for x in occl), ambient=0.05)
        draws = _jax_restir_draws(key, 8, taps, 10, 40, 40)
        timg, state_t = TG._restir(
            tg, tc, tsoa, draws, state=state_t, n_candidates=8,
            spatial_taps=taps, spatial_radius=8, m_cap=160,
            occluders=occl, ambient=0.05)
        _close(timg.numpy(), jimg)
        assert np.array_equal(state_t.y.numpy(), np.asarray(state_j.y))
        assert np.array_equal(state_t.m.numpy(), np.asarray(state_j.m))
    # SSGI over the lit image, with JAX's angle field
    key = jax.random.PRNGKey(3)
    ang0 = jax.random.uniform(key, (40, 40)) * (2.0 * np.pi)
    jao, jind = JG.ssgi(jg, jc, jimg, key, taps=6, radius_px=10)
    tao, tind = TG._ssgi(tg, tc, torch.as_tensor(np.array(jimg)),
                         torch.as_tensor(np.array(ang0)), taps=6,
                         radius_px=10, indirect_strength=1.0)
    _close(tao.numpy(), jao)
    _close(tind.numpy(), jind)
    # one light and no SSGI: the combine draws nothing that matters
    one_j = [JLight(type=JLightType.POINT, position=(0.3, -0.2, -1.5),
                    intensity=3.0, range=30.0)]
    one_t = [Light(type=LightType.POINT, position=(0.3, -0.2, -1.5),
                   intensity=3.0, range=30.0)]
    jimg, _ = JG.deferred_shade_gi(jg, jc, one_j, jax.random.PRNGKey(0),
                                   with_ssgi=False, occluders=tuple(
                                       jnp.asarray(x) for x in blocker))
    timg, _ = TG.deferred_shade_gi(tg, tc, one_t,
                                   torch.Generator().manual_seed(0),
                                   with_ssgi=False, occluders=blocker)
    _close(timg.numpy(), jimg)


def test_restir_statistics_with_the_ports_draws():
    """tests/test_gi.py's estimator checks through the port's generator:
    unbiased against the brute-force sum, temporal reuse lowering the
    error, the shadow ray darkening, SSGI's corner darker than the open
    floor, the full combine finite."""
    positions, faces, _, tc, jg = _plane()
    gb = TM.rasterize_mesh(positions, faces, tc)
    lights = _point_lights(12, 0, False)
    soa = TG.lights_to_soa(lights, CPU)
    ref = TM.shade_gbuffer_lights(gb, tc, lights, ambient=0.0).numpy()
    hit = np.isfinite(gb.depth.numpy())
    assert ref[hit].mean() > 1e-3
    g = torch.Generator().manual_seed(0)
    acc = np.zeros_like(ref)
    for _ in range(64):
        acc += TG.restir_direct(gb, tc, soa, g, n_candidates=8,
                                spatial_taps=0)[0].numpy()
    err = np.abs(acc / 64 - ref)[hit].mean() / ref[hit].mean()
    assert err < 0.08, err

    img1, st = TG.restir_direct(gb, tc, soa, g, n_candidates=4,
                                spatial_taps=0)
    e1 = np.abs(img1.numpy() - ref)[hit].mean()
    img = img1
    for _ in range(11):
        img, st = TG.restir_direct(gb, tc, soa, g, state=st, n_candidates=4,
                                   spatial_taps=0)
    assert np.abs(img.numpy() - ref)[hit].mean() < 0.75 * e1

    _, _, _, tc48, jg48 = _plane(res=48)
    gb48 = _t(jg48)
    one = TG.lights_to_soa([Light(type=LightType.POINT,
                                  position=(0.0, 0.0, -2.0), intensity=4.0,
                                  range=30.0)], CPU)
    bp = np.array([[-0.6, -0.6, -1.0], [0.6, -0.6, -1.0], [0.6, 0.6, -1.0],
                   [-0.6, 0.6, -1.0]], np.float32)
    occl = (np.concatenate([positions, bp]),
            np.concatenate([faces, faces + 4]))
    img_open, _ = TG.restir_direct(gb48, tc48, one, g, spatial_taps=0)
    img_shad, _ = TG.restir_direct(gb48, tc48, one, g, spatial_taps=0,
                                   occluders=occl)
    assert float(img_open[24, 24].mean()) > 0.01
    assert float(img_shad[24, 24].mean()) < 0.2 * float(
        img_open[24, 24].mean())
    assert float(img_shad[4, 4].mean()) > 0.0

    lp = np.array([[-3, -3, 0], [3, -3, 0], [3, 3, 0], [-3, 3, 0],
                   [-3, 0, 0], [3, 0, 0], [3, 0, -3], [-3, 0, -3]],
                  np.float32)
    lf = np.array([[0, 2, 1], [0, 3, 2], [4, 6, 5], [4, 7, 6]], np.int32)
    _, cam = _cams((0, -2.0, -3.5), (0, 0.3, 0), (0, -1, 0), 60.0, 48, 48)
    gbl = TM.rasterize_mesh(lp, lf, cam)
    ao, ind = TG.ssgi(gbl, cam, torch.ones((48, 48, 3)), g, taps=8,
                      radius_px=12)
    ao = ao.numpy()
    hl = np.isfinite(gbl.depth.numpy())
    ys = np.where(hl.any(1))[0]
    mid = (ys.min() + ys.max()) // 2
    rows = np.arange(48)[:, None]
    assert ao[hl & (np.abs(rows - mid) < 4)].mean() < \
        ao[hl & (rows > mid + 10)].mean() - 0.03
    assert (ind.numpy() >= 0).all()

    more = lights[:6] + [Light(type=LightType.DIRECTIONAL,
                               direction=(0.3, 0.2, 0.9), intensity=0.5)]
    img, st = TG.deferred_shade_gi(gb, tc, more, g,
                                   occluders=(positions, faces))
    img2, _ = TG.deferred_shade_gi(gb, tc, more, g, state=st)
    assert torch.isfinite(img).all() and torch.isfinite(img2).all()
    assert float(img.max()) > 0.0
