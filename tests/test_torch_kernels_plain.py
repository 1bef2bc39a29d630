"""The port's kernel modules on the CPU: each kernel's plain PyTorch version
against an independent numpy loop, the wrappers' CPU dispatch and input
checks, the kernel build's failure paths, and the render app's PNG path.

The CUDA kernels themselves run only on a card; ``python3 chip_smoke.py``
holds them against these plain versions there."""

import dataclasses
import os
import stat
import struct
import zlib

import numpy as np
import pytest
import torch

from divshot_tpu_torch import _build
from divshot_tpu_torch.apps import render as app
from divshot_tpu_torch.gsio.io import load_model
from divshot_tpu_torch.gsio.synthetic import orbit_cameras, random_scene
from divshot_tpu_torch.raster import bin as B
from divshot_tpu_torch.raster import raster as R
from divshot_tpu_torch.raster.render import frame_inputs

CPU = "cpu"
f32 = np.float32


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _prep(seed=0, n=300, w=80, h=64, mt=64):
    params = random_scene(np.random.default_rng(seed), n, sh_degree=1,
                          capacity=n + 8, device=CPU)
    cam = orbit_cameras(1, width=w, height_px=h, device=CPU)[0]
    proj, colors, opac = frame_inputs(params, cam)
    p = B.prep(proj.means2d, proj.depths, proj.radii, proj.radii_xy,
               proj.rad2, w, h, 16, mt)
    return p, (proj, colors, opac), cam


def _expand_loop(p: B.Prep, cap, width, height, ts=16):
    """Slot-by-slot numpy reference of the expand kernel."""
    _, depth_bits = B.key_bits(width, height, ts)
    tw = -(-width // ts)
    keys = np.full(cap, 0xFFFFFFFF, np.uint64)
    owners = np.full(cap, B.NO_OWNER, np.int64)
    a = {k: v.numpy() for k, v in p._asdict().items()}
    for g in range(len(a["u"])):
        for j in range(a["counts"][g]):
            i = a["offsets"][g] + j
            if i >= cap:
                break
            w = max(a["nx"][g], 1)
            tx, ty = a["tmin_x"][g] + j % w, a["tmin_y"][g] + j // w
            ttx, tty = f32(tx) * f32(ts), f32(ty) * f32(ts)
            u, v = a["u"][g], a["v"][g]
            dx = max(max(ttx - u, u - (ttx + f32(ts))), f32(0))
            dy = max(max(tty - v, v - (tty + f32(ts))), f32(0))
            owners[i] = g
            if f32(dx * dx) + f32(dy * dy) <= a["rad2"][g]:
                keys[i] = ((ty * tw + tx) << depth_bits) | a["depth_key"][g]
    return keys, owners


@pytest.mark.parametrize("seed,mt,cap", [(0, 64, 1 << 13), (1, 4, 1 << 12),
                                         (2, 64, 400)])
def test_expand_plain_matches_loop(seed, mt, cap):
    p, _, cam = _prep(seed, mt=mt)
    keys, owners = B.expand_instances_plain(p, cap, width=cam.width,
                                            height=cam.height)
    want_k, want_o = _expand_loop(p, cap, cam.width, cam.height)
    np.testing.assert_array_equal(keys.numpy().view(np.uint32),
                                  want_k.astype(np.uint32))
    np.testing.assert_array_equal(owners.numpy(), want_o)
    assert int(p.total) == int(p.counts.sum())
    assert (int(p.total) > cap) == (cap == 400)


def _forward_loop(table, tile_start, width, height, nch, ts=16):
    """Pixel-by-pixel numpy reference of the forward kernel -> (out, pairs
    evaluated, instances read per tile)."""
    tx_n = -(-width // ts)
    num_tiles = tx_n * -(-height // ts)
    out = np.zeros((num_tiles, 8, ts * ts), np.float32)
    pairs, reach = 0, np.zeros(num_tiles, np.int64)
    amin, amax = f32(R.LOG_AMIN), f32(R.LOG_AMAX)
    for t in range(num_tiles):
        for p in range(ts * ts):
            x = f32((t % tx_n) * ts + p % ts) + f32(0.5)
            y = f32((t // tx_n) * ts + p // ts) + f32(0.5)
            T = f32(1)
            acc = np.zeros(nch, np.float32)
            seen = tile_start[t + 1] - tile_start[t]
            for k in range(tile_start[t], tile_start[t + 1]):
                u, v, a, b, c, lo = table[:6, k]
                dx, dy = x - u, y - v
                s = lo - f32(0.5) * ((a * dx * dx + f32(2) * b * dx * dy)
                                     + c * dy * dy)
                if s < amin:
                    continue
                alpha = np.exp(min(s, amax))
                q = T * (f32(1) - alpha)
                if q < f32(R.T_EPS):
                    seen = k - tile_start[t] + 1
                    break
                acc += (alpha * T) * table[6:6 + nch, k]
                T = q
            out[t, :nch, p] = acc
            out[t, 7, p] = T
            pairs += seen
            reach[t] = max(reach[t], seen)
    return out, pairs, reach


@pytest.mark.parametrize("nch", [3, 1])
def test_forward_plain_matches_loop(nch):
    _, (proj, colors, opac), _ = _prep(3, n=120, w=40, h=24)
    w, h = 40, 24
    sb = B.expand_sorted(proj.means2d, proj.conics, proj.depths, proj.radii,
                         proj.radii_xy, proj.rad2, colors[:, :nch], opac,
                         width=w, height=h, instance_capacity=1 << 12)
    got, pairs, reach = R.rasterize_forward_plain(
        sb.table, sb.tile_start, width=w, height=h, nch=nch,
        count_pairs=True)
    want, want_pairs, want_reach = _forward_loop(
        sb.table.numpy(), sb.tile_start.numpy(), w, h, nch)
    assert int(sb.tile_start[-1]) > 0
    np.testing.assert_allclose(got.numpy(), want, atol=3e-5)
    assert int(pairs) == want_pairs
    np.testing.assert_array_equal(reach.numpy(), want_reach)


def test_forward_plain_counts_pairs_and_stops():
    """Three opaque splats over the whole tile: the first is applied, the
    second takes T below t_eps, so every pixel stops there without it, and
    the third is never read."""
    ts = 16
    table = torch.zeros((9, 3))
    table[:, 0] = torch.tensor([8.0, 8.0, 1e-6, 0, 1e-6, 0.0, 1, 0, 0])
    table[:, 1] = torch.tensor([8.0, 8.0, 1e-6, 0, 1e-6, 0.0, 0, 1, 0])
    table[:, 2] = torch.tensor([8.0, 8.0, 1e-6, 0, 1e-6, 0.0, 0, 0, 1])
    start = torch.tensor([0, 3], dtype=torch.int32)
    out, pairs, reach = R.rasterize_forward_plain(
        table, start, width=ts, height=ts, count_pairs=True)
    a = float(np.exp(f32(R.LOG_AMAX)))
    np.testing.assert_allclose(out[0, 0].numpy(), a, rtol=1e-6)
    np.testing.assert_allclose(out[0, 7].numpy(), 1 - a, rtol=1e-4)
    assert float(out[0, 1:3].abs().max()) == 0.0
    assert int(pairs) == 256 * 2
    assert reach.tolist() == [2]


def test_frame_inputs_read_nothing_back_from_the_device():
    """A frame's projection and colours run with the splats and the camera
    on the meta device, where reading any tensor's value raises: a frame
    never waits on the card for its camera pose or its data."""
    params = random_scene(np.random.default_rng(0), 50, sh_degree=3,
                          capacity=56, device=CPU)
    meta = type(params)(**{f.name: getattr(params, f.name).to("meta")
                           for f in dataclasses.fields(params)})
    cam = orbit_cameras(1, width=64, height_px=48, device="meta")[0]
    proj, colors, opac = frame_inputs(meta, cam)
    assert proj.means2d.device.type == "meta"
    assert colors.shape == (56, 3) and opac.shape == (56,)


def test_wrappers_take_the_plain_version_on_cpu():
    p, (proj, colors, opac), cam = _prep(4)
    _build.reset_launches()
    k1, o1 = B.expand_instances(p, 4096, width=cam.width, height=cam.height)
    k2, o2 = B.expand_instances_plain(p, 4096, width=cam.width,
                                      height=cam.height)
    assert torch.equal(k1, k2) and torch.equal(o1, o2)
    sb = B.expand_sorted(proj.means2d, proj.conics, proj.depths, proj.radii,
                         proj.radii_xy, proj.rad2, colors, opac,
                         width=cam.width, height=cam.height,
                         instance_capacity=4096)
    f1 = R.rasterize_forward(sb.table, sb.tile_start, width=cam.width,
                             height=cam.height)
    f2 = R.rasterize_forward_plain(sb.table, sb.tile_start, width=cam.width,
                                   height=cam.height)
    assert torch.equal(f1, f2)
    assert _build.LAUNCHES == {"expand": 0, "forward": 0}


def test_non_cpu_tensors_never_reach_the_plain_version():
    """A tensor on any device but the CPU goes to the kernel path, whose
    input checks reject what is not a CUDA tensor."""
    p, _, cam = _prep(5)
    meta = B.Prep(*[t.to("meta") for t in p])
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        B.expand_instances(meta, 1024, width=cam.width, height=cam.height)
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        R.rasterize_forward(torch.zeros((9, 4), device="meta"),
                            torch.zeros(21, dtype=torch.int32,
                                        device="meta"),
                            width=cam.width, height=cam.height)


class _OnCard:
    """A CPU tensor that reports a CUDA device, to reach the checks that
    follow the device check in ``_build.require``."""
    device = torch.device("cuda", 0)

    def __init__(self, t):
        self.t = t
        self.dtype, self.shape = t.dtype, t.shape

    def is_contiguous(self):
        return self.t.is_contiguous()


@pytest.mark.parametrize("bad,match", [
    (lambda t: t.double(), "dtype"),
    (lambda t: t[:4], "shape"),
    (lambda t: torch.zeros(16)[::2], None),
])
def test_require_rejects_bad_inputs(bad, match):
    t = torch.zeros(8, dtype=torch.float32)
    _build.require(_OnCard(t), "x", torch.float32, (8,))
    with pytest.raises(ValueError, match=match or "contiguous"):
        _build.require(_OnCard(bad(t)), "x", torch.float32, (8,))


def test_sort_instances_ranges_and_guard():
    depth_bits = 20
    tiles = np.array([3, 0, 3, 1, 0, 3], np.int64)
    keys = torch.tensor(((tiles << depth_bits) | np.arange(6)).astype(
        np.int32).tolist() + [-1, -1], dtype=torch.int32)
    owners = torch.arange(8, dtype=torch.int32)
    s_key, s_owner, start = B.sort_instances(keys, owners, num_tiles=4,
                                             depth_bits=depth_bits,
                                             guard_lanes=0)
    assert start.tolist() == [0, 2, 3, 3, 6]
    assert s_owner.tolist() == [1, 4, 3, 0, 2, 5, 6, 7]
    assert s_key[-1] == B.CULLED_KEY
    _, _, clamped = B.sort_instances(keys, owners, num_tiles=4,
                                     depth_bits=depth_bits, guard_lanes=3)
    assert clamped.tolist() == [0, 2, 3, 3, 5]


def test_key_bits():
    assert B.key_bits(1920, 1080, 16) == (8160, 19)
    assert B.key_bits(64, 48, 16) == (12, 28)
    with pytest.raises(ValueError):
        B.key_bits(1 << 14, 1 << 14, 16)


def test_feature_table_and_tile_image_layout():
    n = 5
    means2d = torch.arange(2 * n, dtype=torch.float32).reshape(n, 2)
    conics = torch.ones((n, 3))
    colors = torch.rand((n, 3))
    opac = torch.tensor([0.5, 1.0, 0.0, 0.25, 1e-40])
    inst = torch.tensor([4, -1, 0, 2, 3], dtype=torch.int32)
    tab = R.build_feature_table(means2d, conics, colors, opac, inst)
    assert tab.shape == (9, 5)
    assert tab[0].tolist() == [8.0, 0.0, 0.0, 4.0, 6.0]
    assert tab[R.ROW_LOGOP, 1] == R.LOGOP_FLOOR          # dead instance
    assert tab[R.ROW_LOGOP, 3] == R.LOGOP_FLOOR          # zero opacity
    assert torch.equal(tab[6:, 2], colors[0])

    rows = torch.arange(6 * 2 * 16, dtype=torch.float32).reshape(6, 2, 16)
    img = R._tiles_to_image(rows, 3, 2, 4, 10, 7)
    assert img.shape == (7, 10, 2)
    # pixel (y, x) lies in tile (y // 4) * 3 + x // 4 at (y % 4) * 4 + x % 4
    assert img[5, 9, 1] == rows[1 * 3 + 2, 1, 1 * 4 + 1]


def test_build_raises_without_nvcc(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("NVCC", str(tmp_path / "missing"))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()


def test_build_reports_nvcc_stderr(tmp_path, monkeypatch):
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'error: no sm_90a here' >&2\nexit 2\n")
    fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("NVCC", str(fake))
    with pytest.raises(RuntimeError, match="no sm_90a here"):
        _build.build()
    assert not list((tmp_path / "build").glob("*.so"))


def test_library_path_follows_the_sources(tmp_path, monkeypatch):
    src = tmp_path / "csrc"
    src.mkdir()
    for f in _build.CSRC.iterdir():
        (src / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(_build, "CSRC", src)
    before = _build.library_path()
    assert before == _build.library_path()
    (src / "forward.cu").write_text((src / "forward.cu").read_text() + "\n")
    assert _build.library_path() != before


def _read_png(path):
    data = open(path, "rb").read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, chunks = 8, {}
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        assert crc == zlib.crc32(tag + body) & 0xFFFFFFFF
        chunks[tag] = body
        pos += 12 + n
    w, h = struct.unpack(">II", chunks[b"IHDR"][:8])
    raw = np.frombuffer(zlib.decompress(chunks[b"IDAT"]), np.uint8)
    rows = raw.reshape(h, 1 + 3 * w)
    assert (rows[:, 0] == 0).all()
    return rows[:, 1:].reshape(h, w, 3)


def test_write_png_round_trip(tmp_path):
    img = np.random.default_rng(0).integers(0, 256, (7, 5, 3), np.uint8)
    app.write_png(str(tmp_path / "a.png"), img)
    np.testing.assert_array_equal(_read_png(str(tmp_path / "a.png")), img)


def _write_ply(path, n, rng):
    names = (["x", "y", "z", "f_dc_0", "f_dc_1", "f_dc_2"]
             + [f"f_rest_{i}" for i in range(45)]
             + ["opacity", "scale_0", "scale_1", "scale_2",
                "rot_0", "rot_1", "rot_2", "rot_3"])
    rec = rng.standard_normal((n, 59)).astype(np.float32)
    rec[:, 0:3] *= 0.5
    rec[:, 6:51] *= 0.05
    rec[:, 51] = 2.0
    rec[:, 52:55] = np.log(0.05)
    head = ("ply\nformat binary_little_endian 1.0\n"
            f"element vertex {n}\n"
            + "".join(f"property float {nm}\n" for nm in names)
            + "end_header\n")
    with open(path, "wb") as f:
        f.write(head.encode() + rec.tobytes())
    return rec


def test_render_app_fast_path(tmp_path):
    rec = _write_ply(tmp_path / "m.ply", 200, np.random.default_rng(1))
    params, meta = load_model(str(tmp_path / "m.ply"), device=CPU)
    assert meta == {"antialiased": False, "sh_degree": 3}
    np.testing.assert_array_equal(params.means.numpy(), rec[:, :3])
    np.testing.assert_array_equal(params.shN[:, :, 1].numpy(),
                                  rec[:, 21:36])
    out = tmp_path / "shots"
    assert app.main(["--model", str(tmp_path / "m.ply"), "--out", str(out),
                     "--orbit", "2", "--width", "40", "--height", "24",
                     "--fast", "--device", CPU]) == 0
    pngs = sorted(os.listdir(out))
    assert pngs == ["00000.png", "00001.png"]
    img = _read_png(str(out / pngs[0]))
    assert img.shape == (24, 40, 3) and img.max() > 0


def test_render_app_unported_options(tmp_path):
    _write_ply(tmp_path / "m.ply", 10, np.random.default_rng(2))
    with pytest.raises(NotImplementedError, match="--fast"):
        app.main(["--model", str(tmp_path / "m.ply"), "--device", CPU])
    with pytest.raises(NotImplementedError, match="--video"):
        app.main(["--model", str(tmp_path / "m.ply"), "--fast",
                  "--video", "x.avi", "--device", CPU])
    for name in ("m.splat", "m.compressed.ply", "m.spz"):
        (tmp_path / name).write_bytes(b"ply\n")
        with pytest.raises(NotImplementedError):
            load_model(str(tmp_path / name), device=CPU)
