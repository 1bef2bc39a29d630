"""The scene and its render modes in the port against the JAX package on
the CPU. JAX renders through its XLA ``"tiles"`` route (its default),
with its largest tile count asserted to fit ``tile_capacity``; the port
through the kernels' plain versions (``"pallas"``, its default; the
``tile_capacity`` keyword passes through and is ignored, as JAX's Pallas
route ignores it).

- ``transform_params``: atol 1e-5, SH within 1e-5 of its largest value;
- ``render_component`` in all seven types, ``render_scene``,
  ``render_with_selection``: images and alphas within atol 3e-5, the
  North star's forward tolerance; DEPTH and NORMAL's normalised images
  (composite / alpha, DEPTH also over its 5-95 % depth range) within
  ``NORMALISED_ATOL`` where the alpha exceeds 0.1, and their alphas at
  3e-5; ``selection_outline`` equal. Two splats whose depths lie within
  2^-14 of each other (relative) may composite in either order: the two
  routes quantise the depth key differently (a deliberate difference,
  ROADMAP.md). The pixels that both splats of such a pair reach are
  counted, bounded (``MAX_TIE_PIXELS``) and left out of the image
  comparison; the alpha, which the order does not change, is compared
  everywhere;
- the scene files: each package reads the other's JSON + NPZ, and the
  loaded scenes render the same;
- the environment plate (PURE, SUN_SKY, PNG): within one level of 255.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import divshot_tpu.scene as JS
from divshot_tpu.gsio.synthetic import orbit_cameras as jax_orbit
from divshot_tpu.gsio.synthetic import random_scene as jax_random_scene
from divshot_tpu.raster.render import render as jax_render
from divshot_tpu.viewer import scene_render as JR

import divshot_tpu_torch.scene as TS
from divshot_tpu_torch.gsio.png import write_png
from divshot_tpu_torch.raster.render import render
from divshot_tpu_torch.splat.gaussians import GaussianParams
from divshot_tpu_torch.viewer import scene_render as TR
from tests.test_torch_train_options import _camera

CPU = "cpu"
FIELDS = ("means", "scales", "quats", "opacity", "sh0", "shN", "alive")
RK = {"tile_capacity": 256, "instance_capacity": 1 << 13}
NORMALISED_ATOL = 2e-3
W, H = 64, 48
MAX_TIE_PIXELS = 0.02 * W * H


def _carry(jp) -> GaussianParams:
    return GaussianParams.from_numpy(
        {f: np.asarray(getattr(jp, f)) for f in FIELDS}, device=CPU)


def _scene(n=250, capacity=270, seed=0, sh_degree=1):
    jp = jax_random_scene(np.random.default_rng(seed), n,
                          sh_degree=sh_degree, capacity=capacity)
    return jp, _carry(jp)


def _cams(view=1, num=3):
    jc = jax_orbit(num, width=W, height_px=H)[view]
    return jc, _camera(jc)


def _world():
    th = 0.4
    m = np.eye(4, dtype=np.float32)
    m[:3, :3] = np.array([[np.cos(th), 0, np.sin(th)], [0, 1, 0],
                          [-np.sin(th), 0, np.cos(th)]]) * 0.9
    m[:3, 3] = [0.1, -0.2, 0.15]
    return m


def _fits(jp, jc):
    out = jax_render(jp, jc, **RK)
    assert int(out.max_tile_count) <= RK["tile_capacity"]
    return out


def _components(jp, tp, render_type):
    kw = dict(brightness=0.05, black_point=0.02, white_point=0.95,
              albedo_color=(0.9, 1.0, 1.1), transparency=0.8,
              render_type=render_type)
    jc = JS.GaussianCrop()
    jc.add(JS.CropVolume(type=JS.CropType.SPHERE, center=(0, 0, 0),
                         radius=1.6))
    tc = TS.GaussianCrop()
    tc.add(TS.CropVolume(type=TS.CropType.SPHERE, center=(0, 0, 0),
                         radius=1.6))
    return (JS.GaussianComponent(params=jp, crop=jc, **kw),
            TS.GaussianComponent(params=tp, crop=tc,
                                 render_type=TS.GaussianRenderType(
                                     int(render_type)),
                                 **{k: v for k, v in kw.items()
                                    if k != "render_type"}))


def _same(a, b, atol=3e-5, skip=None):
    a, b = np.asarray(a), np.asarray(b)
    if skip is not None:
        a, b = a[~skip], b[~skip]
    np.testing.assert_allclose(a, b, rtol=0, atol=atol)


def _tie_pixels(params, cam) -> np.ndarray:
    """(H, W) pixels that both splats of a near-tied pair (depths within
    2^-14 relative) reach, each splat taken as the disc of its radius."""
    from divshot_tpu_torch.raster.project import project_gaussians
    pr = project_gaussians(params.means, params.scales, params.quats, cam,
                           opacities=params.effective_opacity())
    idx = np.nonzero((params.alive & (pr.radii > 0)).numpy())[0]
    d = pr.depths.numpy()[idx]
    o = idx[np.argsort(d, kind="stable")]
    dd = np.diff(pr.depths.numpy()[o]) / pr.depths.numpy()[o][1:]
    yy, xx = np.mgrid[0:H, 0:W] + 0.5
    m2d, rad = pr.means2d.numpy(), pr.radii.numpy()
    mask = np.zeros((H, W), bool)
    for k in np.nonzero(dd < 2.0 ** -14)[0]:
        inside = [((xx - m2d[g, 0]) ** 2 + (yy - m2d[g, 1]) ** 2)
                  <= rad[g] ** 2 for g in (o[k], o[k + 1])]
        mask |= inside[0] & inside[1]
    assert mask.sum() <= MAX_TIE_PIXELS, mask.sum()
    return mask


def test_transform_params_and_grading_match_jax():
    jp, tp = _scene(sh_degree=3)
    m = _world()
    jo, to = JR.transform_params(jp, m), TR.transform_params(tp, m)
    for f in FIELDS:
        a, b = getattr(to, f).numpy(), np.asarray(getattr(jo, f))
        tol = 1e-5 * float(np.abs(b).max()) if f == "shN" else 1e-5
        np.testing.assert_allclose(a, b, rtol=0, atol=tol, err_msg=f)
    assert TR.transform_params(tp, np.eye(4)) is tp
    jcomp, tcomp = _components(jp, tp, JS.GaussianRenderType.SPLAT)
    jg, tg = jcomp.graded_params(), tcomp.graded_params(CPU)
    for f in FIELDS:
        np.testing.assert_allclose(getattr(tg, f).numpy(),
                                   np.asarray(getattr(jg, f)), rtol=0,
                                   atol=1e-5, err_msg=f)
    assert not tg.alive.all()
    # the identity grading is the params themselves
    assert TS.GaussianComponent(params=tp).graded_params(CPU) is tp


@pytest.mark.parametrize("rt", list(JS.GaussianRenderType))
def test_render_component_matches_jax(rt):
    jp, tp = _scene()
    jcam, cam = _cams()
    jcomp, tcomp = _components(jp, tp, rt)
    world = _world()
    if rt in (JS.GaussianRenderType.SPLAT, JS.GaussianRenderType.DEPTH,
              JS.GaussianRenderType.NORMAL):
        _fits(JR.transform_params(jcomp.graded_params(), world), jcam)
    ji, ja = JR.render_component(jcomp, jcam, world, **RK)
    ti, ta = TR.render_component(tcomp, cam, world, **RK)
    assert ti.shape == (H, W, 3) and float(ta.max()) > 0.3
    _same(ta, ja)
    ties = _tie_pixels(TR.transform_params(tcomp.graded_params(CPU), world),
                       cam)
    if rt in (JS.GaussianRenderType.DEPTH, JS.GaussianRenderType.NORMAL):
        m = (np.asarray(ja) > 0.1) & ~ties
        assert m.sum() > 50
        np.testing.assert_allclose(ti.numpy()[m], np.asarray(ji)[m], rtol=0,
                                   atol=NORMALISED_ATOL)
    elif rt == JS.GaussianRenderType.SPLAT:
        _same(ti, ji, skip=ties)
    else:
        _same(ti, ji)


def _two_entity_scenes(jp, tp):
    j2, t2 = _scene(n=120, capacity=120, seed=7, sh_degree=0)
    out = []
    for P, params, other in ((JS, jp, j2), (TS, tp, t2)):
        sc = P.Scene("two")
        root = sc.create_entity("root")
        root.transform[:3, 3] = [0.0, 0.1, 0.0]
        a = sc.create_entity("edited", parent="root",
                             transform=_world())
        jc, tc = _components(jp, tp, JS.GaussianRenderType.SPLAT)
        a.add(jc if P is JS else tc)
        b = sc.create_entity("second")
        b.transform[:3, 3] = [0.8, 0.0, -0.5]
        b.add(P.GaussianComponent(params=other, brightness=0.1))
        hidden = sc.create_entity("hidden", active=False)
        hidden.add(P.GaussianComponent(params=other))
        sky = sc.create_entity("sky")
        sky.add(P.Environment(mode=P.EnvironmentMode.SUN_SKY,
                              intensity=0.7))
        out.append(sc)
    return out


def test_render_scene_matches_jax():
    jp, tp = _scene()
    jcam, cam = _cams()
    js, ts = _two_entity_scenes(jp, tp)
    ji = JR.render_scene(js, jcam, **RK)
    ti = TR.render_scene(ts, cam, **RK)
    assert isinstance(ti, torch.Tensor) and ti.shape == (H, W, 3)
    _same(ti, ji, skip=_scene_ties(ts, cam))


def _scene_ties(ts, cam) -> np.ndarray:
    mask = np.zeros((H, W), bool)
    for e in ts.entities_with(TS.GaussianComponent):
        if e.active:
            comp = e.get(TS.GaussianComponent)
            mask |= _tie_pixels(TR.transform_params(
                comp.graded_params(CPU), e.world_transform(ts)), cam)
    assert mask.sum() <= MAX_TIE_PIXELS
    return mask


def test_selection_tint_and_outline_match_jax():
    jp, tp = _scene()
    jcam, cam = _cams(view=0)
    sel = np.zeros(270, bool)
    sel[np.random.default_rng(2).permutation(250)[:90]] = True
    jsel, tsel = jnp.asarray(sel), torch.as_tensor(sel)
    _fits(jp.replace(alive=jp.alive & jsel), jcam)
    ji, ja = JR.render_with_selection(jp, jcam, jsel, **RK)
    ti, ta = TR.render_with_selection(tp, cam, tsel, **RK)
    _same(ti, ji, skip=_tie_pixels(tp, cam))
    _same(ta, ja)
    for thick in (1, 2):
        jo = np.asarray(JR.selection_outline(jp, jcam, jsel, thickness=thick,
                                             **RK))
        to = TR.selection_outline(tp, cam, tsel, thickness=thick, **RK)
        assert jo.sum() > 10
        np.testing.assert_array_equal(to.numpy(), jo)
        np.testing.assert_allclose(
            TR.composite_outline(ti, to).numpy(),
            np.asarray(JR.composite_outline(ji, jnp.asarray(jo))),
            rtol=0, atol=1e-6)


def test_scene_files_cross_read(tmp_path):
    jp, tp = _scene()
    jcam, cam = _cams()
    js, ts = _two_entity_scenes(jp, tp)
    light = dict(type=2, position=(1.0, 2.0, 3.0), intensity=4.0,
                 size=(2.0, 0.5))
    js.create_entity("lamp").add(JS.Light(**{
        **light, "type": JS.LightType(2)}))
    ts.create_entity("lamp").add(TS.Light(**{
        **light, "type": TS.LightType(2)}))
    js.save(str(tmp_path / "jax.json"))
    ts.save(str(tmp_path / "port.json"))
    jdoc = json.load(open(tmp_path / "jax.json"))
    tdoc = json.load(open(tmp_path / "port.json"))
    assert tdoc == jdoc
    tl = TS.Scene.load(str(tmp_path / "jax.json"), device=CPU)
    jl = JS.Scene.load(str(tmp_path / "port.json"))
    assert [e.name for e in tl.entities] == [e.name for e in js.entities]
    assert tl.find("edited").parent == "root"
    np.testing.assert_array_equal(tl.find("edited").world_transform(tl),
                                  js.find("edited").world_transform(js))
    assert tl.find("lamp").get(TS.Light).type == TS.LightType.SPOT
    c = tl.find("edited").get(TS.GaussianComponent)
    assert c.crop.volumes[0].type == TS.CropType.SPHERE
    assert c.params.capacity == 250 and c.params.device.type == CPU
    _same(TR.render_scene(tl, cam, **RK), JR.render_scene(jl, jcam, **RK),
          skip=_scene_ties(tl, cam))
    assert tl.remove("lamp") and not tl.remove("lamp")
    assert [e.name for e in tl.entities_with(TS.Environment)] == ["sky"]


def test_component_loads_its_path(tmp_path):
    from divshot_tpu_torch.gsio.io import save_model
    _, tp = _scene(n=40, capacity=40)
    path = str(tmp_path / "m.ply")
    save_model(path, tp)
    comp = TS.GaussianComponent(path=path)
    p = comp.load(CPU)
    assert p.num_alive == 40 and comp.load(CPU) is p
    from divshot_tpu_torch.scene.components import component_to_dict
    assert component_to_dict(comp)["path"] == path
    vol = TS.CropVolume(type=TS.CropType.PLANE, center=(0, 0, 0.1),
                        transform=np.eye(4))
    pts = np.array([[0, 0, 0.0], [0, 0, 0.5]])
    np.testing.assert_array_equal(vol.contains(torch.as_tensor(pts)),
                                  [True, False])
    jvol = JS.CropVolume(type=JS.CropType.PLANE, center=(0, 0, 0.1),
                         transform=np.eye(4), invert=True)
    np.testing.assert_array_equal(
        dataclasses.replace(vol, invert=True).contains(torch.as_tensor(pts)),
        jvol.contains(pts))


@pytest.mark.parametrize("kind", ["BOX", "SPHERE", "PLANE"])
@pytest.mark.parametrize("invert", [False, True])
def test_crop_volumes_match_jax(kind, invert):
    """Each crop volume, with a world-to-local transform, on torch tensors
    against JAX's numpy mask of the same points; the chain of volumes
    too."""
    rng = np.random.default_rng(5)
    pts = rng.uniform(-2, 2, (4000, 3)).astype(np.float32)
    kw = dict(center=(0.2, -0.1, 0.15), radius=1.3, pmin=(-1.0, -0.8, -1.2),
              pmax=(0.9, 1.1, 0.7), transform=_world(), invert=invert)
    tv = TS.CropVolume(type=TS.CropType[kind], **kw)
    jv = JS.CropVolume(type=JS.CropType[kind], **kw)
    got = tv.contains(torch.as_tensor(pts))
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), jv.contains(pts))
    tc, jc = TS.GaussianCrop(), JS.GaussianCrop()
    for t in TS.CropType:
        tc.add(dataclasses.replace(tv, type=t))
        jc.add(dataclasses.replace(jv, type=JS.CropType(int(t))))
    np.testing.assert_array_equal(
        tc.keep_mask(torch.as_tensor(pts)).numpy(), jc.keep_mask(pts))


def _plate_png(tmp_path):
    rng = np.random.default_rng(0)
    img = np.zeros((21, 34, 3), np.uint8)
    img[..., 0] = rng.integers(0, 3, (21, 34))      # 0, 1, 2
    img[4:15, 8:26, 1] = 200
    img[..., 2] = (np.arange(34) % 5 == 0) * 9
    path = str(tmp_path / "sky.png")
    write_png(path, img)
    return path, img


@pytest.mark.parametrize("size", [(34, 21), (20, 13), (70, 50), (40, 9)])
def test_environment_plates_match_jax(tmp_path, size):
    w, h = size
    path, img = _plate_png(tmp_path)
    for mode, kw in ((0, dict(sky_ambient=(0.2, 0.4, 0.6), intensity=0.9)),
                     (1, dict(intensity=0.7)), (2, dict(hdr_path=path))):
        je = JS.Environment(mode=JS.EnvironmentMode(mode), **kw)
        te = TS.Environment(mode=TS.EnvironmentMode(mode), **kw)
        jb, tb = je.sample_background(w, h), te.sample_background(w, h)
        assert tb.shape == jb.shape == (h, w, 3)
        assert np.abs(tb - jb).max() <= 1.0 / 255 + 1e-6, mode
    # a property of the reference: the 0-255 values are scaled by 255
    # again and clipped, so every non-zero channel becomes 255
    te = TS.Environment(hdr_path=path)
    te.load_hdr()
    plate = te.sample_background(34, 21)
    np.testing.assert_array_equal(plate, (img > 0).astype(np.float32))
    assert te.mode == TS.EnvironmentMode.HDR
    np.testing.assert_allclose(te.sun_direction(),
                               JS.Environment().sun_direction())


def test_environment_rejects_non_png(tmp_path):
    """A plate that is neither Radiance, PNG nor JPEG (a BMP under a
    ``.jpg`` name) raises."""
    from PIL import Image
    Image.fromarray(np.zeros((4, 4, 3), np.uint8)).save(
        tmp_path / "sky.jpg", format="BMP")
    with pytest.raises(ValueError, match="PNG"):
        TS.Environment(mode=TS.EnvironmentMode.HDR,
                       hdr_path=str(tmp_path / "sky.jpg")
                       ).sample_background(8, 8)


def test_other_backends_match_jax():
    """``render(backend="tiles" | "dense")`` (they raised before their
    port) against JAX's same route, image and alpha atol 3e-5; the
    tiles route's binning counters equal JAX's."""
    jp, tp = _scene(n=20, capacity=20)
    jc, cam = _cams()
    for backend in ("tiles", "dense"):
        want = jax.jit(lambda p: jax_render(p, jc, backend=backend,
                                            **RK))(jp)
        got = render(tp, cam, backend=backend, **RK)
        _same(got.image, want.image)
        _same(got.alpha, want.alpha)
        assert float(got.alpha.max()) > 0.1
        if backend == "tiles":
            assert int(got.num_instances) == int(want.num_instances) > 0


@pytest.mark.parametrize("channels", [None, 3, 4])
def test_resize_bicubic_matches_pillow(channels):
    """The plate's resize: Pillow's default ``Image.resize`` (bicubic),
    bitwise, shrinking and growing each axis; and at the image's own size
    an untouched copy, as Pillow returns it (the Lanczos resize too: it
    premultiplied an RGBA image's alpha there, which is lossy)."""
    from PIL import Image
    from divshot_tpu_torch.gsio.png import resize_bicubic, resize_lanczos
    rng = np.random.default_rng(channels or 1)
    shape = (23, 37) if channels is None else (23, 37, channels)
    img = rng.integers(0, 256, shape).astype(np.uint8)
    for size in ((37, 23), (20, 13), (70, 50), (40, 9), (7, 90)):
        np.testing.assert_array_equal(
            resize_bicubic(img, *size),
            np.asarray(Image.fromarray(img).resize(size)))
    np.testing.assert_array_equal(resize_lanczos(img, 37, 23), img)
