"""The port's host services against the JAX package on the CPU: the
console variables and the settings store (the flows of
``tests/test_viewer.py:80-91`` and ``:177-192``, run through both
packages' modules), LPIPS, the profiling helpers, the live viewer's page
and ``.splat`` payload, ``save_model``'s dispatch, and the SfM pipeline
(``needs_sfm``, the missing binaries, the video frame selection and the
COLMAP command lines).

Tolerances: LPIPS within 1e-5 relative of JAX's (float32 convolutions
summed in another order); every byte stream (pages, ``.splat`` payloads,
INI files) and every frame index exactly.
"""

import os
import stat
import sys

import numpy as np
import pytest
import torch

from divshot_tpu.core import cmdvars as jax_cmdvars
from divshot_tpu.core import profiling as jax_profiling
from divshot_tpu.core import settings as jax_settings
from divshot_tpu.gsio import sfm as jax_sfm
from divshot_tpu.splat.gaussians import GaussianParams as JParams
from divshot_tpu.train import lpips as jax_lpips
from divshot_tpu.viewer import html_export as jax_html

from divshot_tpu_torch.core import cmdvars, profiling, settings
from divshot_tpu_torch.gsio import sfm
from divshot_tpu_torch.gsio.io import load_model, save_model
from divshot_tpu_torch.gsio.png import read_png
from divshot_tpu_torch.splat.gaussians import GaussianParams
from divshot_tpu_torch.train import lpips
from divshot_tpu_torch.viewer import html_export

CPU = "cpu"
FIELDS = ("means", "scales", "quats", "opacity", "sh0", "shN", "alive")

# ---------------------------------------------------------------------------
# console variables and settings


def _cmdvars_flow(mod, monkeypatch) -> list:
    """``tests/test_viewer.py:80-91``'s flow, then the environment
    override and the bool parsing -> what it observed."""
    reg = mod.CmdVarRegistry.instance()
    v = mod.cvar("torchport.someFlag", 3, "doc")
    seen = []
    v.on_change(seen.append)
    reg.set("torchport.someFlag", "7")
    out = [v.value, list(seen)]
    reg.apply_cli(["torchport.someFlag=9"])
    out += [v.value, mod.cvar("torchport.someFlag", 0) is v, v.type]
    monkeypatch.setenv("DIVSHOT_CVAR_TORCHPORT_FROMENV", "42")
    e = mod.cvar("torchport.fromEnv", 1)
    b = mod.cvar("torchport.aBool", False)
    b.set("on")
    out += [e.value, type(e.value), b.value, reg.get("torchport.missing")]
    with pytest.raises(KeyError):
        reg.set("torchport.missing", 1)
    out += [mod.ENABLE_OUTLINE.value, mod.VIDEO_EXPORT_THREADS.value]
    return out


def test_cmdvars_match_jax(monkeypatch):
    ours = _cmdvars_flow(cmdvars, monkeypatch)
    theirs = _cmdvars_flow(jax_cmdvars, monkeypatch)
    assert ours == theirs
    assert ours[:3] == [7, [7], 9] and ours[5] == 42
    # the port's registry is its own
    assert cmdvars.CmdVarRegistry.instance() is not \
        jax_cmdvars.CmdVarRegistry.instance()


def _settings_flow(mod, path: str) -> list:
    """``tests/test_viewer.py:177-192``'s flow -> what it read back and the
    file's bytes."""
    s = mod.SettingsStore(path)
    s.set("window", "width", 1920)
    s.set("window", "vsync", True)
    s.set("paths", "last_scene", "/data/lego")
    s.set("view", "fov", 47.5)
    s2 = mod.SettingsStore(path)
    out = [s2.get("window", "width", 0), s2.get("window", "vsync", False),
           s2.get("paths", "last_scene", ""), s2.get("window", "missing", 7),
           s2.get("view", "fov", 0.0), s2.sections(), s2.items("window"),
           s2.items("nothing")]
    s2.remove("window", "vsync")
    out.append(mod.SettingsStore(path).get("window", "vsync", False))
    s2.remove("paths")
    out.append(open(path, "rb").read())
    return out


def test_settings_store_matches_jax(tmp_path):
    ours = _settings_flow(settings, str(tmp_path / "t" / "editor.ini"))
    theirs = _settings_flow(jax_settings, str(tmp_path / "j" / "editor.ini"))
    assert ours == theirs
    assert ours[:5] == [1920, True, "/data/lego", 7, 47.5]
    assert ours[8] is False
    assert sorted(os.listdir(tmp_path / "t")) == ["editor.ini"]


# ---------------------------------------------------------------------------
# LPIPS


@pytest.fixture(scope="module")
def lpips_weights(tmp_path_factory):
    return lpips.random_weights(str(tmp_path_factory.mktemp("lpips")
                                    / "w.npz"))


@pytest.mark.parametrize("shape", [(32, 32), (48, 64)])
def test_lpips_matches_jax(lpips_weights, shape):
    rng = np.random.default_rng(sum(shape))
    a = rng.uniform(0, 1, (*shape, 3)).astype(np.float32)
    b = np.clip(a + 0.1 * rng.standard_normal(a.shape), 0, 1).astype(
        np.float32)
    ref = float(jax_lpips.lpips_fn(jax_lpips.load_weights(lpips_weights))(
        a, b))
    fn = lpips.lpips_fn(lpips.load_weights(lpips_weights))
    out = float(fn(torch.from_numpy(a), torch.from_numpy(b)))
    assert ref > 0
    assert abs(out - ref) <= 1e-5 * abs(ref), (out, ref)
    assert float(fn(torch.from_numpy(a), torch.from_numpy(a))) == 0.0


def test_default_lpips_reads_the_variable(lpips_weights, monkeypatch,
                                          tmp_path):
    monkeypatch.delenv("DIVSHOT_LPIPS_WEIGHTS", raising=False)
    assert lpips.default_lpips() is None
    monkeypatch.setenv("DIVSHOT_LPIPS_WEIGHTS", str(tmp_path / "none.npz"))
    assert lpips.default_lpips() is None
    monkeypatch.setenv("DIVSHOT_LPIPS_WEIGHTS", lpips_weights)
    fn = lpips.default_lpips()
    assert fn is not None and lpips.default_lpips() is fn
    img = torch.rand(16, 16, 3, generator=torch.Generator().manual_seed(0))
    assert float(fn(img, img.flip(0))) > 0


# ---------------------------------------------------------------------------
# profiling


def _timer_flow(mod, fence):
    t = mod.StepTimer(fence_every=2)
    for i in range(3):
        with t.scope("step", fence_on=fence):
            with mod.profile_scope("inner"):
                _ = sum(range(1000))
    with t.scope("eval"):
        pass
    return t.summary()


def test_step_timer_matches_jax():
    import jax.numpy as jnp
    ours = _timer_flow(profiling, torch.ones(3))
    theirs = _timer_flow(jax_profiling, jnp.ones(3))
    assert ours.keys() == theirs.keys() == {"step", "eval"}
    for k in ours:
        assert ours[k].keys() == theirs[k].keys() == {
            "mean_ms", "last_ms", "count"}
        assert ours[k]["count"] == theirs[k]["count"]
        assert ours[k]["mean_ms"] >= 0 and ours[k]["last_ms"] >= 0
    assert ours["step"]["count"] == 3 and ours["eval"]["count"] == 1
    assert profiling.StepTimer().summary() == {}


def test_profile_scopes_reach_the_trace(tmp_path):
    @profiling.profile_function
    def work(x):
        return (x * 2).sum()

    with profiling.device_trace(str(tmp_path / "trace")) as prof:
        with profiling.profile_scope("outer_scope"):
            work(torch.ones(8))
    names = {e.key for e in prof.key_averages()}
    assert "outer_scope" in names
    assert any(n.endswith("work") for n in names), names
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 0


# ---------------------------------------------------------------------------
# the viewer's page and payload, save_model


def _scene(n=40, dead=(3, 7, 8, 21), degree=1, seed=0):
    """Numpy fields of ``n`` splats, some dead, with tied opacities."""
    rng = np.random.default_rng(seed)
    k = {0: 0, 1: 3, 2: 8, 3: 15}[degree]
    d = {"means": rng.standard_normal((n, 3)),
         "scales": rng.uniform(-4, -1, (n, 3)),
         "quats": rng.standard_normal((n, 4)),
         "opacity": np.round(rng.uniform(-2, 3, (n,)), 0),
         "sh0": rng.standard_normal((n, 3)),
         "shN": 0.1 * rng.standard_normal((n, k, 3))}
    d = {f: v.astype(np.float32) for f, v in d.items()}
    d["alive"] = np.ones((n,), bool)
    d["alive"][list(dead)] = False
    return d


def _both(d):
    jp = JParams.create(d["means"], scales=d["scales"], quats=d["quats"],
                        opacity=d["opacity"], sh0=d["sh0"], shN=d["shN"],
                        sh_degree={0: 0, 3: 1, 8: 2, 15: 3}[
                            d["shN"].shape[1]])
    import jax.numpy as jnp
    jp = jp.replace(alive=jnp.asarray(d["alive"]))
    return jp, GaussianParams.from_numpy(d, device=CPU)


@pytest.mark.parametrize("max_splats", [1_000_000, 36, 20, 5])
def test_splat_bytes_match_jax(max_splats):
    jp, tp = _both(_scene())
    ours = html_export.splat_bytes(tp, max_splats)
    assert ours == jax_html.splat_bytes(jp, max_splats)
    assert len(ours) == 32 * min(36, max_splats)


def test_pages_match_jax(tmp_path):
    assert html_export.live_page() == jax_html.live_page()
    assert html_export.live_page(250, 4096) == jax_html.live_page(250, 4096)
    assert html_export.render_template("X") == jax_html.render_template("X")
    jp, tp = _both(_scene(degree=0))
    html_export.export_html(str(tmp_path / "t.html"), tp, max_splats=10)
    jax_html.export_html(str(tmp_path / "j.html"), jp, max_splats=10)
    assert ((tmp_path / "t.html").read_bytes()
            == (tmp_path / "j.html").read_bytes())


def test_save_model_dispatch(tmp_path):
    _, tp = _both(_scene())
    save_model(str(tmp_path / "m.ply"), tp, antialiased=True)
    back, meta = load_model(str(tmp_path / "m.ply"), device=CPU)
    assert back.capacity == 36 and meta.get("antialiased") is True
    save_model(str(tmp_path / "m.splat"), tp)
    assert (tmp_path / "m.splat").read_bytes() == html_export.splat_bytes(tp)
    # the other formats, ported since (tests/test_torch_formats.py holds
    # their bytes against JAX's; the reduced PLY needs SH degree 3)
    _, tp3 = _both(_scene(degree=3))
    for name, p in (("m.compressed.ply", tp), ("m.reduced.ply", tp3),
                    ("m.spz", tp), ("m.dvsplat", tp)):
        save_model(str(tmp_path / name), p)
        back, _ = load_model(str(tmp_path / name), device=CPU)
        assert back.capacity == p.num_alive
    with pytest.raises(ValueError, match="unknown"):
        save_model(str(tmp_path / "m.obj"), tp)


# ---------------------------------------------------------------------------
# the SfM pipeline


def _needs_sfm_flow(mod, root) -> list:
    """``tests/test_session.py:120-138``'s cases -> each answer."""
    d = root / "scene"
    (d / "images").mkdir(parents=True)
    out = [mod.needs_sfm(str(d))]
    (d / "transforms_train.json").write_text("{}")
    out.append(mod.needs_sfm(str(d)))
    d2 = root / "scene2"
    (d2 / "sparse" / "0").mkdir(parents=True)
    (d2 / "sparse" / "0" / "cameras.bin").write_bytes(b"")
    out.append(mod.needs_sfm(str(d2)))
    v = root / "clip.mp4"
    v.write_bytes(b"x")
    out += [mod.needs_sfm(str(v)), mod.needs_sfm(str(root / "missing")),
            mod.needs_sfm(str(root / "scene2" / "sparse" / "0" /
                              "cameras.bin"))]
    return out


def test_needs_sfm_matches_jax(tmp_path):
    (tmp_path / "t").mkdir()
    (tmp_path / "j").mkdir()
    ours = _needs_sfm_flow(sfm, tmp_path / "t")
    assert ours == _needs_sfm_flow(jax_sfm, tmp_path / "j")
    assert ours == [True, False, False, True, False, False]


@pytest.mark.parametrize("mod", [sfm, jax_sfm], ids=["port", "jax"])
def test_sfm_raises_without_binary(mod, tmp_path, monkeypatch):
    monkeypatch.setenv("PATH", "")
    monkeypatch.delenv("DIVSHOT_COLMAP", raising=False)
    with pytest.raises(RuntimeError, match="COLMAP"):
        mod.run_sfm(str(tmp_path))


def test_video_decode_raises_without_ffmpeg(tmp_path, monkeypatch):
    monkeypatch.setenv("PATH", "")
    monkeypatch.delenv("DIVSHOT_FFMPEG", raising=False)
    with pytest.raises(RuntimeError, match="ffmpeg"):
        sfm.extract_video_frames(str(tmp_path / "clip.mp4"),
                                 str(tmp_path / "out"))


def _frames():
    """``tests/test_session.py:149-168``'s stream: a moving bar + noise."""
    frames = []
    rng = np.random.default_rng(0)
    for i in range(40):
        base = np.zeros((48, 64, 3), np.uint8)
        base[:, (i * 2) % 64] = 255
        base += rng.integers(0, 30, base.shape, dtype=np.uint8)
        frames.append(base)
    return frames


def _indices(paths) -> list[int]:
    return [int(os.path.basename(p).split("_")[1].split(".")[0])
            for p in paths]


@pytest.mark.parametrize("strategy", [0, 1, 2, 3])
@pytest.mark.parametrize("fps,max_frames", [(5.0, 20), (2.0, 3)])
def test_video_frame_selection_matches_jax(strategy, fps, max_frames,
                                           tmp_path):
    frames = _frames()
    kw = dict(strategy=strategy, fps=fps, max_frames=max_frames,
              _src_fps=10.0)
    ours = sfm.extract_video_frames("unused.mp4", str(tmp_path / "t"),
                                    _frames=iter(frames), **kw)
    theirs = jax_sfm.extract_video_frames("unused.mp4", str(tmp_path / "j"),
                                          _frames=iter(frames), **kw)
    assert len(ours) > 0
    assert _indices(ours) == _indices(theirs)
    for p in ours:
        assert os.path.basename(p).endswith(".png")
        np.testing.assert_array_equal(read_png(p), frames[_indices([p])[0]])


_FAKE_FFMPEG = r"""#!{python}
import os, sys
import numpy as np
frames = np.load(os.environ["FAKE_FFMPEG_FRAMES"])
if "-f" not in sys.argv:
    sys.stderr.write("Input #0, avi, from 'clip.avi':\n"
                     "  Stream #0:0: Video: rawvideo (RGB[24] / 0x18424752), "
                     "rgb24, %dx%d, 10 fps, 10 tbr\n"
                     % (frames.shape[2], frames.shape[1]))
    sys.exit(1)
sys.stdout.buffer.write(frames.tobytes())
"""


def test_video_decoded_through_ffmpeg_matches_the_injected_stream(
        tmp_path, monkeypatch):
    """A video file goes through an ``ffmpeg`` binary (a stand-in that
    prints a stream line and pipes raw rgb24): its size and rate are read
    from the stream line, and the frames kept are those of the same
    stream injected."""
    frames = np.stack(_frames())
    np.save(tmp_path / "frames.npy", frames)
    binary = tmp_path / "bin" / "ffmpeg"
    binary.parent.mkdir()
    binary.write_text(_FAKE_FFMPEG.format(python=sys.executable))
    binary.chmod(binary.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("DIVSHOT_FFMPEG", str(binary))
    monkeypatch.setenv("FAKE_FFMPEG_FRAMES", str(tmp_path / "frames.npy"))
    assert sfm.probe_video("clip.avi") == (64, 48, 10.0)
    for strategy in (0, 3):
        kw = dict(strategy=strategy, fps=5.0, max_frames=20)
        ours = sfm.extract_video_frames("clip.avi", str(tmp_path / "v"),
                                        **kw)
        want = sfm.extract_video_frames(
            "clip.avi", str(tmp_path / "i"), _frames=iter(frames),
            _src_fps=10.0, **kw)
        assert len(ours) > 0 and _indices(ours) == _indices(want)
        for p in ours:
            np.testing.assert_array_equal(read_png(p),
                                          frames[_indices([p])[0]])


_FAKE_COLMAP = r"""#!{python}
import os, sys
with open(os.environ["FAKE_COLMAP_LOG"], "a") as f:
    f.write(" ".join([os.path.basename(sys.argv[0])] + sys.argv[1:]) + "\n")
if sys.argv[1] == "mapper":
    out = os.path.join(sys.argv[sys.argv.index("--output_path") + 1], "0")
    os.makedirs(out, exist_ok=True)
    imgs = sorted(os.listdir(sys.argv[sys.argv.index("--image_path") + 1]))
    open(os.path.join(out, "cameras.txt"), "w").write(
        "1 SIMPLE_PINHOLE 32 24 30 16 12\n")
    with open(os.path.join(out, "images.txt"), "w") as f:
        for i, name in enumerate(imgs):
            f.write(f"{{i + 1}} 1 0 0 0 0 0 {{i}} 1 {{name}}\n0 0 -1\n")
    open(os.path.join(out, "points3D.txt"), "w").write(
        "1 0 0 0 255 0 0 0\n2 1 1 1 0 255 0 0\n3 0 1 0 0 0 255 0\n")
"""


@pytest.mark.parametrize("quality", [0, 2])
def test_run_sfm_command_lines_match_jax(quality, tmp_path, monkeypatch):
    """Both packages' ``run_sfm`` on a bare folder of images through a
    stand-in COLMAP binary that logs its command lines and writes a text
    model."""
    binary = tmp_path / "bin" / "colmap"
    binary.parent.mkdir()
    binary.write_text(_FAKE_COLMAP.format(python=sys.executable))
    binary.chmod(binary.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("DIVSHOT_COLMAP", str(binary))
    logs, results = {}, {}
    for name, mod in (("t", sfm), ("j", jax_sfm)):
        scene = tmp_path / name / "scene"
        scene.mkdir(parents=True)
        for i in range(3):
            (scene / f"{i:03d}.png").write_bytes(b"not read")
        log = tmp_path / f"{name}.log"
        monkeypatch.setenv("FAKE_COLMAP_LOG", str(log))
        stages = []
        res = mod.run_sfm(str(scene), quality=quality,
                          progress_cb=lambda s, f: stages.append((s, f)))
        logs[name] = log.read_text().replace(str(tmp_path / name), "ROOT")
        results[name] = (os.path.relpath(res.scene_dir, tmp_path / name),
                         res.num_images, res.num_points, stages,
                         sorted(os.listdir(scene / "images")))
    assert logs["t"] == logs["j"]
    assert results["t"] == results["j"]
    assert results["t"][1:3] == (3, 3)
    assert logs["t"].count("\n") == 3
