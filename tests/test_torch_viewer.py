"""The viewer's offline side in the port against the JAX package on the
CPU: keyframe cameras (atol 1e-6), the post ops (atol 1e-6) and
``render_taa`` (3e-5), histograms (equal), ``render_views`` /
``render_path`` PNGs (equal but for one level at <= 0.1 % of pixels,
near depth ties left out as in ``tests/test_torch_scene.py``), the MJPEG
AVI (bytes equal to JAX's writer given the same JPEG payloads) and the
port's own JPEG encoder decoded by Pillow here (Pillow's quantisation
tables at each quality, 4:2:0, PSNR no more than 0.5 dB below Pillow's
own encoding), and ``apps.render`` without ``--fast`` and with
``--video``. JAX renders through its XLA ``"tiles"`` route.
"""

import io
import os

import numpy as np
import pytest
import torch
from PIL import Image, JpegImagePlugin

import jax.numpy as jnp

from divshot_tpu.apps import render as jax_render_app
from divshot_tpu.gsio.io import save_model as jax_save_model
from divshot_tpu.gsio.synthetic import orbit_cameras as jax_orbit
from divshot_tpu.gsio.synthetic import random_scene as jax_random_scene
from divshot_tpu.raster.render import render as jax_render
from divshot_tpu.viewer import histogram as JH
from divshot_tpu.viewer import keyframes as JK
from divshot_tpu.viewer import offline as JOFF
from divshot_tpu.viewer import post as JP
from divshot_tpu.viewer import video as JV

from divshot_tpu_torch.apps import render as render_app
from divshot_tpu_torch.gsio.png import read_png
from divshot_tpu_torch.raster.render import render
from divshot_tpu_torch.splat.gaussians import GaussianParams
from divshot_tpu_torch.viewer import histogram as TH
from divshot_tpu_torch.viewer import jpeg as TJ
from divshot_tpu_torch.viewer import keyframes as TK
from divshot_tpu_torch.viewer import offline as TOFF
from divshot_tpu_torch.viewer import post as TP
from divshot_tpu_torch.viewer import video as TV
from tests.test_torch_scene import _tie_pixels
from tests.test_torch_train_options import _camera

CPU = "cpu"
FIELDS = ("means", "scales", "quats", "opacity", "sh0", "shN", "alive")
RK = {"tile_capacity": 256, "instance_capacity": 1 << 13}


def _carry(jp) -> GaussianParams:
    return GaussianParams.from_numpy(
        {f: np.asarray(getattr(jp, f)) for f in FIELDS}, device=CPU)


def _scene(n=150, seed=0, sh_degree=0):
    jp = jax_random_scene(np.random.default_rng(seed), n,
                          sh_degree=sh_degree)
    return jp, _carry(jp)


def _timeline(P):
    tl = P.KeyFrameTimeline()
    for i, t in enumerate([0.0, 1.0, 2.0, 2.5]):
        a = t * np.pi / 4
        tl.add(P.CameraKeyFrame(
            time=t, quat=np.array([np.cos(a / 2), 0, np.sin(a / 2), 0]),
            pos=np.array([np.sin(a) * 4, 0.3 * i, -np.cos(a) * 4]),
            fov_y_deg=50 + 10 * i, aperture=0.1 * i))
    return tl


def _same_camera(tc, jc):
    np.testing.assert_allclose(tc.viewmat, np.asarray(jc.viewmat), rtol=0,
                               atol=1e-6)
    for k in ("fx", "fy", "cx", "cy"):
        assert abs(getattr(tc, k) - float(getattr(jc, k))) <= 1e-6 * max(
            1.0, abs(float(getattr(jc, k)))), k
    assert (tc.width, tc.height) == (jc.width, jc.height)


@pytest.mark.parametrize("spline", [True, False])
def test_keyframe_cameras_match_jax(spline):
    jt, tt = _timeline(JK), _timeline(TK)
    jt.spline = tt.spline = spline
    assert tt.duration == jt.duration == 2.5
    for t in (-1.0, 0.0, 0.3, 1.0, 1.7, 2.2, 2.5, 9.0):
        a, b = tt.sample(t), jt.sample(t)
        np.testing.assert_allclose(a.quat, b.quat, rtol=0, atol=1e-12)
        np.testing.assert_allclose(a.pos, b.pos, rtol=0, atol=1e-12)
        assert (a.fov_y_deg, a.aperture) == (b.fov_y_deg, b.aperture)
        _same_camera(tt.camera_at(t, 64, 48, device=CPU),
                     jt.camera_at(t, 64, 48))
    with pytest.raises(ValueError, match="empty"):
        TK.KeyFrameTimeline().sample(0.0)


def test_post_ops_match_jax():
    rng = np.random.default_rng(0)
    img = rng.uniform(-0.2, 3.0, (20, 28, 3)).astype(np.float32)
    hist = rng.uniform(0, 1, (20, 28, 3)).astype(np.float32)
    ti, ji = torch.as_tensor(img), jnp.asarray(img)

    def same(a, b):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-6)

    for op in ("linear", "reinhard", "aces"):
        for exposure, gamma in ((0.0, 1.0), (0.5, 2.2), (-1.0, 1.8)):
            same(TP.apply_tonemap(ti, op, exposure=exposure, gamma=gamma),
                 JP.apply_tonemap(ji, op, exposure=exposure, gamma=gamma))
    clipped = np.clip(img, 0, 1)
    same(TP.sharpen(torch.as_tensor(clipped), 0.4),
         JP.sharpen(jnp.asarray(clipped), 0.4))
    same(TP.taa_blend(torch.as_tensor(hist), ti, 0.2),
         JP.taa_blend(jnp.asarray(hist), ji, 0.2))
    same(TP.post_process(ti, tonemap="aces", exposure=0.3, gamma=2.0,
                         sharpen_amount=0.3),
         JP.post_process(ji, tonemap="aces", exposure=0.3, gamma=2.0,
                         sharpen_amount=0.3))
    for f in range(10):
        assert TP.taa_jitter(f) == JP.taa_jitter(f)
    jc = jax_orbit(1, width=40, height_px=30)[0]
    for f in (0, 3, 7):
        _same_camera(TP.jitter_camera(_camera(jc), f),
                     JP.jitter_camera(jc, f))
        assert TP.jitter_camera(_camera(jc), f).cx == float(
            JP.jitter_camera(jc, f).cx)


def test_render_taa_matches_jax():
    jp, tp = _scene()
    jc = jax_orbit(2, width=48, height_px=40)[1]
    cam = _camera(jc)
    jt = JP.render_taa(lambda c: jax_render(jp, c, **RK).image, jc, 4)
    tt = TP.render_taa(lambda c: render(tp, c, **RK).image, cam, 4)
    assert int(jax_render(jp, jc, **RK).max_tile_count) <= 256
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), rtol=0,
                               atol=3e-5)


def test_histogram_matches_jax():
    img = np.random.default_rng(1).uniform(-0.1, 1.1, (30, 40, 3)).astype(
        np.float32)
    jh, th = JH.image_histogram(img, 64), TH.image_histogram(img, 64)
    assert jh.keys() == th.keys()
    for k in jh:
        np.testing.assert_array_equal(th[k], jh[k])
    assert TH.suggest_levels(img, 1.0) == JH.suggest_levels(img, 1.0)
    np.testing.assert_array_equal(
        TH.apply_levels(img, 0.1, 0.9, 0.05, (1.0, 0.8, 1.2)),
        JH.apply_levels(img, 0.1, 0.9, 0.05, (1.0, 0.8, 1.2)))


def _png_close(tdir, jdir, names, ties_of):
    for i, name in enumerate(names):
        a = read_png(os.path.join(tdir, name)).astype(np.int64)
        b = np.asarray(Image.open(os.path.join(jdir, name))).astype(np.int64)
        keep = ~ties_of(i)
        d = np.abs(a - b)[keep]
        assert d.max(initial=0) <= 1, name
        assert (d > 0).mean() <= 1e-3, (name, (d > 0).mean())


def test_render_views_and_path_match_jax(tmp_path):
    jp, tp = _scene()
    jcams = jax_orbit(3, width=48, height_px=40)
    cams = [_camera(c) for c in jcams]
    bg = [0.1, 0.2, 0.3]
    jimgs = JOFF.render_views(jp, jcams, background=bg,
                              out_dir=str(tmp_path / "j"), **RK)
    timgs = TOFF.render_views(tp, cams, background=bg,
                              out_dir=str(tmp_path / "t"), **RK)
    assert len(timgs) == 3 and timgs[0].shape == (40, 48, 3)
    names = [f"{i:05d}.png" for i in range(3)]
    assert sorted(os.listdir(tmp_path / "t")) == names
    _png_close(tmp_path / "t", tmp_path / "j", names,
               lambda i: _tie_pixels_at(tp, cams[i]))
    # a keyframed fly-through with its video
    jtl, ttl = _timeline(JK), _timeline(TK)
    jf = JOFF.render_path(jp, jtl, width=48, height=40, fps=2,
                          video_path=str(tmp_path / "j.avi"), **RK)
    tf = TOFF.render_path(tp, ttl, width=48, height=40, fps=2,
                          video_path=str(tmp_path / "t.avi"), **RK)
    assert len(tf) == len(jf) == 6
    tcams = [ttl.camera_at(i / 2, 48, 40, device=CPU) for i in range(6)]
    for i, (a, b) in enumerate(zip(tf, jf)):
        a = (a.numpy() * 255).astype(np.uint8).astype(np.int64)
        b = (np.asarray(b) * 255).astype(np.uint8).astype(np.int64)
        d = np.abs(a - b)[~_tie_pixels_at(tp, tcams[i])]
        assert d.max(initial=0) <= 1 and (d > 0).mean() <= 1e-3
    assert len(TV.read_mjpeg_avi(str(tmp_path / "t.avi"))) == 6
    assert len(TV.read_mjpeg_avi(str(tmp_path / "j.avi"))) == 6


def _tie_pixels_at(tp, cam):
    import tests.test_torch_scene as S
    h, w = S.H, S.W
    S.H, S.W = cam.height, cam.width
    try:
        return _tie_pixels(tp, cam)
    finally:
        S.H, S.W = h, w


# --------------------------------------------------------------------------
# video and JPEG


def test_avi_bytes_match_jax_given_the_same_payloads(tmp_path):
    rng = np.random.default_rng(2)
    payloads = [bytes(rng.integers(0, 256, n, dtype=np.uint8))
                for n in (100, 251, 64)]
    for fps in (30, 12):
        jw = JV.MJPEGWriter(str(tmp_path / "j.avi"), fps=fps)
        tw = TV.MJPEGWriter(str(tmp_path / "t.avi"), fps=fps)
        for w in (jw, tw):
            w.frames = [p + b"\x00" * (len(p) % 2) for p in payloads]
            w.size = (48, 40)
            w.close()
        assert (tmp_path / "t.avi").read_bytes() == \
            (tmp_path / "j.avi").read_bytes()
        assert TV.read_mjpeg_avi(str(tmp_path / "t.avi")) == \
            [p + b"\x00" * (len(p) % 2) for p in payloads]
    with pytest.raises(ValueError, match="no frames"):
        TV.MJPEGWriter(str(tmp_path / "x.avi")).close()


def _smooth_image(h, w, seed=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    img = np.stack([128 + 90 * np.sin(xx / 9.0 + yy / 23.0),
                    128 + 80 * np.cos(yy / 7.0),
                    100 + 0.5 * xx + 0.3 * yy], -1)
    img[h // 3:h // 2, w // 4:w // 2] = [250, 30, 40]   # a hard edge
    return np.clip(img + rng.normal(0, 3, img.shape), 0, 255).astype(
        np.uint8)


def _psnr(a, b):
    d = np.asarray(a, np.float64) - np.asarray(b, np.float64)
    return 10 * np.log10(255.0 ** 2 / (d * d).mean())


@pytest.mark.parametrize("size,quality", [((48, 64), 90), ((37, 53), 90),
                                          ((120, 96), 75), ((21, 19), 30)])
def test_jpeg_decodes_in_pillow_with_its_tables(size, quality):
    img = _smooth_image(*size)
    mine = TJ.encode_jpeg(torch.as_tensor(img), quality)
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG", quality=quality)
    ours, pil = Image.open(io.BytesIO(mine)), Image.open(io.BytesIO(
        buf.getvalue()))
    assert ours.size == (size[1], size[0]) and ours.mode == "RGB"
    assert ours.quantization == pil.quantization
    assert JpegImagePlugin.get_sampling(ours) == 2     # 4:2:0
    p_ours, p_pil = _psnr(ours.convert("RGB"), img), _psnr(
        pil.convert("RGB"), img)
    print(f"{size} q{quality}: PSNR {p_ours:.3f} dB (Pillow {p_pil:.3f}), "
          f"{len(mine)} bytes (Pillow {len(buf.getvalue())})")
    assert p_ours >= p_pil - 0.5
    assert mine[:2] == b"\xff\xd8" and mine[-2:] == b"\xff\xd9"


def test_jpeg_rejects_other_inputs():
    with pytest.raises(ValueError, match="uint8"):
        TJ.encode_jpeg(torch.zeros((8, 8, 3)), 90)
    with pytest.raises(ValueError, match="uint8"):
        TJ.encode_jpeg(np.zeros((8, 8), np.uint8), 90)


def test_video_frames_are_the_encoders(tmp_path):
    frames = [_smooth_image(40, 48, s) for s in range(3)]
    floats = [torch.as_tensor(f).float() / 255.0 for f in frames]
    TV.write_video(str(tmp_path / "v.avi"), floats, fps=10)
    got = TV.read_mjpeg_avi(str(tmp_path / "v.avi"))
    assert len(got) == 3
    for f, g, x in zip(floats, got, frames):
        want = TJ.encode_jpeg(TV.to_uint8(f), 90)
        assert g == want + b"\x00" * (len(want) % 2)
        dec = np.asarray(Image.open(io.BytesIO(g)).convert("RGB"))
        assert _psnr(dec, x) > 30


# --------------------------------------------------------------------------
# apps.render


def test_render_app_views_and_video_match_jax(tmp_path):
    jp = jax_random_scene(np.random.default_rng(3), 200, sh_degree=1)
    src = str(tmp_path / "m.ply")
    jax_save_model(src, jp)
    common = ["--model", src, "--orbit", "3", "--width", "40", "--height",
              "32", "--fps", "5"]
    assert jax_render_app.main(common + [
        "--out", str(tmp_path / "j"), "--video",
        str(tmp_path / "j.avi")]) == 0
    assert render_app.main(common + [
        "--out", str(tmp_path / "t"), "--video", str(tmp_path / "t.avi"),
        "--device", CPU]) == 0
    tp = _carry(jp)
    cams = render_app.orbit_for_model(tp, 3, radius=4.0, width=40,
                                      height=32, fov=50.0)
    names = [f"{i:05d}.png" for i in range(3)]
    _png_close(tmp_path / "t", tmp_path / "j", names,
               lambda i: _tie_pixels_at(tp, cams[i]))
    frames = TV.read_mjpeg_avi(str(tmp_path / "t.avi"))
    assert len(frames) == 3 == len(TV.read_mjpeg_avi(str(tmp_path /
                                                         "j.avi")))
    for f, name in zip(frames, names):
        assert f[:2] == b"\xff\xd8" and f.rstrip(b"\x00")[-2:] == b"\xff\xd9"
        src = read_png(str(tmp_path / "t" / name))
        buf = io.BytesIO()
        Image.fromarray(src).save(buf, "JPEG", quality=90)
        dec = Image.open(io.BytesIO(f)).convert("RGB")
        assert _psnr(dec, src) >= _psnr(Image.open(buf).convert("RGB"),
                                        src) - 0.5
    # the fast path writes its video too
    assert render_app.main(common + [
        "--out", str(tmp_path / "f"), "--video", str(tmp_path / "f.avi"),
        "--fast", "--device", CPU]) == 0
    assert len(TV.read_mjpeg_avi(str(tmp_path / "f.avi"))) == 3
    # JAX's own route, "tiles" (its default): the same binning key, so
    # no near-tie pixel is left out
    assert render_app.main(common + ["--out", str(tmp_path / "x"),
                                     "--backend", "tiles", "--device",
                                     CPU]) == 0
    _png_close(tmp_path / "x", tmp_path / "j", names,
               lambda i: np.zeros((32, 40), bool))


def test_render_app_grows_its_capacity_to_the_demand(tmp_path, monkeypatch,
                                                     capsys):
    """Where the views' tile-instance demand passes the app's least
    capacity (JAX's fixed 2^20, cut here to 2^10 so that a small model
    passes it), the app bins into the next power of two that holds the
    demand and the guard lanes: the demand it prints is binning's own
    (``render_fast``'s count), and the PNGs of both paths are those of a
    run whose 2^20 holds every view."""
    from divshot_tpu_torch.gsio.io import load_model, save_model
    src = str(tmp_path / "m.ply")
    save_model(src, _carry(jax_random_scene(np.random.default_rng(4), 300,
                                            sh_degree=1)))
    tp, _ = load_model(src, device=CPU)
    common = ["--model", src, "--orbit", "2", "--width", "48", "--height",
              "40", "--device", CPU]
    cams = render_app.orbit_for_model(tp, 2, radius=4.0, width=48,
                                      height=40, fov=50.0)
    want = max(int(render_app.render_fast(tp, c, instance_capacity=1 << 16)
                   [2].num_instances) for c in cams)
    assert want > 0
    names = [f"{i:05d}.png" for i in range(2)]
    for flags in ([], ["--fast"]):
        whole, grown = (str(tmp_path / (k + "".join(flags)))
                        for k in ("whole", "grown"))
        with monkeypatch.context() as m:
            assert render_app.main(common + ["--out", whole, *flags]) == 0
            assert "[capacity]" not in capsys.readouterr().out
            m.setattr(render_app, "APP_CAPACITY", 1 << 10)
            assert render_app.main(common + ["--out", grown, *flags]) == 0
        out = capsys.readouterr().out
        line = next(s for s in out.splitlines() if s.startswith("[capacity]"))
        demand, least, cap = (int(w.rstrip(":")) for w in line.split()
                              if w.rstrip(":").isdigit())
        assert least == 1 << 10, line
        assert demand == want, line
        assert cap == 1 << (demand + render_app.GUARD_LANES - 1).bit_length()
        for name in names:
            np.testing.assert_array_equal(
                read_png(os.path.join(grown, name)),
                read_png(os.path.join(whole, name)))
