"""The port's file formats and binning prep on the CPU, held against the
JAX package and, for PNG and resizing, against Pillow (which the test may
use and the port may not):

- ``bin.prep`` on NaN and infinite means and radii equals JAX's
  ``prep_gdata`` exactly (counts, offsets, tile rectangles; small grids
  are exact in bf16);
- ``save_ply``, ``save_splat`` and ``save_point_cloud_ply`` write JAX's
  bytes; ``load_splat`` reads JAX's fields;
- ``gsio/png.py`` decodes every row filter as Pillow does, for greyscale,
  RGB and RGBA, refuses what it does not read, writes files Pillow reads
  back, and resizes within 1 uint8 level of Pillow's LANCZOS.
"""

import struct
import zlib

import numpy as np
import pytest
import torch
from PIL import Image

import jax.numpy as jnp

from divshot_tpu.gsio import ply as JP
from divshot_tpu.raster import pallas_bin as jax_bin
from divshot_tpu.splat.gaussians import GaussianParams as JParams

from divshot_tpu_torch.gsio import ply as P
from divshot_tpu_torch.gsio import png as PNG
from divshot_tpu_torch.raster import bin as B
from divshot_tpu_torch.splat.gaussians import GaussianParams

CPU = "cpu"
FIELDS = ("means", "scales", "quats", "opacity", "sh0", "shN", "alive")


# ---------------------------------------------------------------------------
# binning prep on non-finite inputs


def test_prep_matches_jax_on_nan_and_inf():
    """Means and radii at NaN and +-inf: the port's tile rectangles (NaN
    converted to 0 before the int32 cast, as XLA does) equal JAX's."""
    rng = np.random.default_rng(3)
    n, w, h, mt = 64, 128, 128, 64
    u = rng.uniform(-20, 150, n).astype(np.float32)
    v = rng.uniform(-20, 150, n).astype(np.float32)
    rad = rng.uniform(0, 30, n).astype(np.float32)
    inf, nan = np.float32(np.inf), np.float32(np.nan)
    u[0], rad[0] = inf, inf           # +inf mean, infinite radius
    u[1], rad[1] = -inf, inf
    u[2] = nan
    v[3] = nan
    rad[4] = nan
    rad[5] = inf                      # finite mean, infinite radius
    v[6], rad[6] = inf, inf
    u[7], v[7] = inf, -inf
    depths = rng.uniform(0.5, 9.0, n).astype(np.float32)
    rad2 = (rad * rad).astype(np.float32)
    means2d = np.stack([u, v], 1)

    p = B.prep(torch.tensor(means2d), torch.tensor(depths),
               torch.tensor(rad), None, torch.tensor(rad2), w, h, 16, mt)
    gdata, counts, offsets, total, _, _ = jax_bin.prep_gdata(
        jnp.asarray(means2d), jnp.zeros((n, 3)), jnp.asarray(depths),
        jnp.asarray(rad), None, jnp.asarray(rad2), jnp.zeros((n, 3)),
        jnp.ones((n,)), w, h, 16, mt)
    rows = np.asarray(gdata[:n, :5].astype(jnp.float32)).astype(np.int64)
    np.testing.assert_array_equal(p.counts.numpy(), np.asarray(counts))
    np.testing.assert_array_equal(p.counts.numpy(), rows[:, 0])
    np.testing.assert_array_equal(p.offsets.numpy(), np.asarray(offsets))
    assert int(p.total) == int(total)
    np.testing.assert_array_equal(p.nx.numpy(), rows[:, 1] * 256 + rows[:, 2])
    np.testing.assert_array_equal(p.tmin_x.numpy(), rows[:, 3])
    np.testing.assert_array_equal(p.tmin_y.numpy(), rows[:, 4])
    # the cases above do reach the NaN conversion
    assert (p.tmin_x.numpy()[[0, 2, 4]] == 0).all()


# ---------------------------------------------------------------------------
# PLY, .splat and point clouds: JAX's bytes


def _random_params(sh_degree, seed=0, n=40, capacity=56):
    """The same numpy params in both packages, with dead splats in the
    middle and a padded dead tail."""
    rng = np.random.default_rng(seed)
    k = {0: 0, 1: 3, 3: 15}[sh_degree]
    arrays = dict(
        means=rng.normal(size=(n, 3)),
        scales=rng.normal(-3, 0.5, (n, 3)),
        quats=rng.normal(size=(n, 4)),
        opacity=rng.normal(size=n),
        sh0=rng.normal(size=(n, 3)),
        shN=rng.normal(size=(n, k, 3)) if k else None)
    jp = JParams.create(**{f: (None if a is None else a.astype(np.float32))
                           for f, a in arrays.items() if f != "means"},
                        means=arrays["means"].astype(np.float32),
                        sh_degree=sh_degree, capacity=capacity)
    alive = np.asarray(jp.alive).copy()
    alive[[3, 17, 30]] = False
    jp = jp.replace(alive=jnp.asarray(alive))
    tp = GaussianParams.from_numpy({f: np.asarray(getattr(jp, f))
                                    for f in FIELDS}, device=CPU)
    return jp, tp


@pytest.mark.parametrize("sh_degree", [0, 1, 3])
@pytest.mark.parametrize("antialiased", [False, True])
def test_save_ply_bytes_match_jax(tmp_path, sh_degree, antialiased):
    jp, tp = _random_params(sh_degree, seed=sh_degree)
    JP.save_ply(str(tmp_path / "j.ply"), jp, antialiased=antialiased)
    P.save_ply(str(tmp_path / "t.ply"), tp, antialiased=antialiased)
    ref = (tmp_path / "j.ply").read_bytes()
    assert (tmp_path / "t.ply").read_bytes() == ref
    back, meta = P.load_ply(str(tmp_path / "t.ply"), device=CPU)
    assert back.num_alive == tp.num_alive == 37
    assert meta["antialiased"] == antialiased
    for f, a in back.compact_numpy().items():
        b = tp.compact_numpy()[f]
        if f == "shN" and b.shape[1] < 15:
            a = a[:, :b.shape[1]]
        np.testing.assert_array_equal(a, b)


def test_save_splat_bytes_and_load_match_jax(tmp_path):
    jp, tp = _random_params(3, seed=7)
    JP.save_splat(str(tmp_path / "j.splat"), jp)
    P.save_splat(str(tmp_path / "t.splat"), tp)
    assert ((tmp_path / "t.splat").read_bytes()
            == (tmp_path / "j.splat").read_bytes())
    jl = JP.load_splat(str(tmp_path / "j.splat"))
    tl = P.load_splat(str(tmp_path / "j.splat"), device=CPU)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(tl, f).numpy(),
                                      np.asarray(getattr(jl, f)), err_msg=f)


@pytest.mark.parametrize("with_colors", [False, True])
def test_save_point_cloud_ply_bytes_match_jax(tmp_path, with_colors):
    rng = np.random.default_rng(5)
    pts = rng.normal(size=(33, 3))
    cols = rng.uniform(-0.1, 1.1, (33, 3)).astype(np.float32) \
        if with_colors else None
    JP.save_point_cloud_ply(str(tmp_path / "j.ply"), pts, cols)
    P.save_point_cloud_ply(str(tmp_path / "t.ply"), pts, cols)
    assert ((tmp_path / "t.ply").read_bytes()
            == (tmp_path / "j.ply").read_bytes())


# ---------------------------------------------------------------------------
# PNG against Pillow

MODES = {"L": 1, "RGB": 3, "RGBA": 4}


def _image(mode, h=23, w=37, seed=0):
    """Smooth gradients plus noise (so every filter is worth something),
    RGBA with transparent, opaque and partial alpha."""
    rng = np.random.default_rng(seed)
    ch = MODES[mode]
    y, x = np.mgrid[0:h, 0:w]
    img = np.stack([(np.sin(x / 5.0 + c) + np.cos(y / 4.0 - c)) * 60 + 128
                    for c in range(ch)], -1) + rng.normal(0, 12, (h, w, ch))
    img = np.clip(img, 0, 255).astype(np.uint8)
    if mode == "RGBA":
        img[..., 3][img[..., 3] < 90] = 0
        img[:4, :, 3] = 255
    return img[..., 0] if ch == 1 else img


def _chunk(tag, data):
    body = tag + data
    return (struct.pack(">I", len(data)) + body
            + struct.pack(">I", zlib.crc32(body) & 0xFFFFFFFF))


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _write_filtered(path, img, filters):
    """Write ``img`` with the given filter type on each row (cycled)."""
    ch = 1 if img.ndim == 2 else img.shape[2]
    h, w = img.shape[:2]
    rows = img.reshape(h, w * ch).astype(np.int64)
    out = []
    for y in range(h):
        x = rows[y]
        prev = rows[y - 1] if y else np.zeros_like(x)
        left = np.concatenate([np.zeros(ch, np.int64), x[:-ch]])
        upleft = np.concatenate([np.zeros(ch, np.int64), prev[:-ch]])
        ftype = filters[y % len(filters)]
        pred = [0, left, prev, (left + prev) // 2,
                _paeth(left, prev, upleft)][ftype]
        out.append(bytes([ftype]) + ((x - pred) % 256).astype(np.uint8)
                   .tobytes())
    colour = {1: 0, 3: 2, 4: 6}[ch]
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, colour, 0,
                                            0, 0)))
        data = zlib.compress(b"".join(out), 9)
        # two IDAT chunks: a reader must join them
        f.write(_chunk(b"IDAT", data[:len(data) // 2]))
        f.write(_chunk(b"IDAT", data[len(data) // 2:]))
        f.write(_chunk(b"IEND", b""))


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("ftype", [0, 1, 2, 3, 4])
def test_png_each_filter_decodes_as_pillow(tmp_path, mode, ftype):
    img = _image(mode, seed=ftype)
    path = str(tmp_path / "f.png")
    # the forced filter on every row but the third, which cycles through
    # the others
    _write_filtered(path, img, [ftype, ftype, (ftype + 1) % 5])
    ref = np.asarray(Image.open(path))
    np.testing.assert_array_equal(ref, img)
    out = PNG.read_png(path)
    assert out.dtype == np.uint8 and out.shape == img.shape
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("mode", list(MODES))
def test_png_pillow_adaptive_files_decode(tmp_path, mode):
    path = str(tmp_path / "p.png")
    Image.fromarray(_image(mode, 41, 53, seed=9), mode).save(path)
    raw = zlib.decompress(b"".join(
        body for tag, body in PNG._chunks(open(path, "rb").read())
        if tag == b"IDAT"))
    stride = 53 * MODES[mode] + 1
    assert len(set(raw[::stride][:41])) >= 2   # Pillow mixed its filters
    np.testing.assert_array_equal(PNG.read_png(path),
                                  np.asarray(Image.open(path)))


@pytest.mark.parametrize("mode", list(MODES))
def test_png_writer_round_trips(tmp_path, mode):
    img = _image(mode, seed=4)
    path = str(tmp_path / "w.png")
    PNG.write_png(path, img)
    np.testing.assert_array_equal(np.asarray(Image.open(path)), img)
    np.testing.assert_array_equal(PNG.read_png(path), img)


@pytest.mark.parametrize("kind", ["16-bit", "palette", "LA", "interlaced"])
def test_png_unsupported_formats_raise(tmp_path, kind):
    path = str(tmp_path / "u.png")
    img = _image("RGB")
    if kind == "16-bit":
        Image.fromarray(img[..., 0].astype(np.uint16) * 200).save(path)
        match = "16-bit"
    elif kind == "palette":
        Image.fromarray(img).convert("P").save(path)
        match = "palette"
    elif kind == "LA":
        Image.fromarray(img[..., :2].copy(), "LA").save(path)
        match = "LA"
    else:
        _write_filtered(path, img, [0])
        data = bytearray(open(path, "rb").read())
        data[8 + 8 + 12] = 1                  # IHDR interlace byte
        crc = zlib.crc32(bytes(data[12:12 + 17])) & 0xFFFFFFFF
        data[12 + 17:12 + 21] = struct.pack(">I", crc)
        open(path, "wb").write(bytes(data))
        match = "interlaced"
    with pytest.raises(ValueError, match=match):
        PNG.read_png(path)


@pytest.mark.parametrize("mode", ["RGB", "RGBA"])
@pytest.mark.parametrize("size", [(18, 11), (12, 8), (7, 5)])
def test_resize_lanczos_matches_pillow(mode, size):
    """Downscales by about 2, 3 and 5, within
    1 uint8 level of Pillow's LANCZOS; RGBA through premultiplied alpha."""
    img = _image(mode, seed=11)
    ref = np.asarray(Image.fromarray(img, mode).resize(size, Image.LANCZOS))
    out = PNG.resize_lanczos(img, *size)
    assert out.shape == ref.shape and out.dtype == np.uint8
    assert np.abs(out.astype(int) - ref.astype(int)).max() <= 1
