"""The port's image readers and host library against the oracles here on
the CPU, every fixture made at run time.

- ``gsio/jpeg.read_jpeg`` bitwise equal to Pillow's ``np.asarray(
  Image.open(...))`` (libjpeg-turbo's ISLOW IDCT and fancy upsampling):
  greyscale, 4:4:4, 4:2:2 and 4:2:0 at qualities 50, 90 and 100, sizes
  1x1, 17x9, 33x47 and 257x130; restart markers (Pillow's
  ``restart_marker_blocks`` and ``restart_marker_rows``); 4:4:0 and
  4:1:1 files written by OpenCV; the Adobe APP14 transform flag and the
  'R', 'G', 'B' component ids (markers rewritten in a Pillow file); the
  port's own encoder's files, their quantised coefficients equal to
  ``viewer/jpeg.quantized_blocks``. The SOF size equals Pillow's
  ``size``; progressive and CMYK files raise naming the file, the feature
  and ROADMAP Queue A item 9; ``read_image`` dispatches on the magic
  bytes.
- ``gsio/hdr.read_hdr`` equal to ``imageio.v3.imread`` (OpenCV's Radiance
  reader here) on hand-written flat and run-length files whose values hit
  the rounding (127.5) and saturation edges; the environment plates from
  a Radiance and a JPEG file against JAX's.
- A COLMAP capture with JPEG images and a blender capture with a JPEG
  mask folder load bitwise equal to JAX's ``gsio/datasets`` (also
  downscaled by the Lanczos resize); the pose readers size a JPEG as JAX.
- ``core/native.py`` with and without the host library: the COLMAP
  parsers, ``save_ply`` and the compressed PLY equal to JAX's (its
  ``tests/test_native.py`` checks), the Morton codes equal to JAX's
  native coder.
"""

import json
import os
import struct

import imageio.v3 as iio
import numpy as np
import pytest
import torch
from PIL import Image

from divshot_tpu.core import native as jax_native
from divshot_tpu.gsio import colmap as JC
from divshot_tpu.gsio import compressed as JCOMP
from divshot_tpu.gsio import ply as JPLY
from divshot_tpu.gsio.datasets import load_dataset as jax_load_dataset
from divshot_tpu.gsio.readers import load_nerfstudio as jax_nerfstudio
from divshot_tpu.gsio.synthetic import random_scene as jax_random_scene
from divshot_tpu.scene import components as JS

from divshot_tpu_torch.core import native
from divshot_tpu_torch.gsio import colmap as TC
from divshot_tpu_torch.gsio import compressed as TCOMP
from divshot_tpu_torch.gsio import ply as TPLY
from divshot_tpu_torch.gsio.datasets import load_dataset
from divshot_tpu_torch.gsio.hdr import read_hdr
from divshot_tpu_torch.gsio.image import image_size, read_image
from divshot_tpu_torch.gsio.jpeg import (decode_coefficients, jpeg_size,
                                         read_jpeg)
from divshot_tpu_torch.gsio.readers import load_nerfstudio
from divshot_tpu_torch.scene import components as TS
from divshot_tpu_torch.splat.gaussians import GaussianParams
from divshot_tpu_torch.viewer.jpeg import encode_jpeg, quantized_blocks
from tests.test_readers import _gl_c2w
from tests.test_torch_datasets import _assert_same_dataset

CPU = "cpu"
SIZES = [(1, 1), (17, 9), (33, 47), (257, 130)]


def _photo(w, h, ch, seed):
    """A smooth image with noise (what a camera gives): an upscaled random
    field plus noise, uint8 (h, w, ch)."""
    rng = np.random.default_rng(seed)
    small = rng.integers(0, 256, (h // 4 + 2, w // 4 + 2, ch), np.uint8)
    up = np.stack([np.asarray(Image.fromarray(small[..., c]).resize(
        (w, h), Image.BICUBIC)) for c in range(ch)], -1).astype(np.int64)
    return np.clip(up + rng.integers(-24, 25, up.shape), 0, 255).astype(
        np.uint8)


def _pil(img):
    return Image.fromarray(img[..., 0] if img.shape[2] == 1 else img)


@pytest.mark.parametrize("quality", [50, 90, 100])
@pytest.mark.parametrize("sampling", ["grey", "4:4:4", "4:2:2", "4:2:0"])
def test_decoder_matches_pillow_bitwise(tmp_path, sampling, quality):
    for i, (w, h) in enumerate(SIZES):
        img = _photo(w, h, 1 if sampling == "grey" else 3, seed=quality + i)
        path = str(tmp_path / f"{w}x{h}.jpg")
        kw = {} if sampling == "grey" else {"subsampling": sampling}
        _pil(img).save(path, quality=quality, **kw)
        ref = np.asarray(Image.open(path))
        got = read_jpeg(path)
        assert got.dtype == np.uint8 and got.shape == ref.shape
        np.testing.assert_array_equal(got, ref)
        assert jpeg_size(path) == Image.open(path).size == (w, h)


def _segments(data):
    """(marker, start, end) of each segment before the scan."""
    out, pos = [], 2
    while data[pos + 1] != 0xDA:
        (n,) = struct.unpack(">H", data[pos + 2:pos + 4])
        out.append((data[pos + 1], pos, pos + 2 + n))
        pos += 2 + n
    return out


def _rewrite(data, jfif, adobe=None, ids=None):
    """The Pillow file with its JFIF APP0 kept or dropped, an Adobe APP14
    with the given transform flag inserted, the component ids replaced."""
    out = bytearray(data[:2])
    for m, a, b in _segments(data):
        seg = bytearray(data[a:b])
        if m == 0xE0 and not jfif:
            continue
        if m == 0xC0 and ids:
            for i, cid in enumerate(ids):
                seg[10 + 3 * i] = cid
        out += seg
    if adobe is not None:
        out[2:2] = (b"\xff\xee" + struct.pack(">H", 14) + b"Adobe"
                    + bytes([0, 100, 0, 0, 0, 0, adobe]))
    scan = max(b for _, _, b in _segments(data))
    tail = bytearray(data[scan:])
    if ids:                                   # the SOS's component ids
        for i, cid in enumerate(ids):
            tail[5 + 2 * i] = cid
    return bytes(out + tail)


def test_restarts_samplings_and_colour_spaces_match_pillow(tmp_path):
    import cv2
    img = _photo(130, 75, 3, seed=1)
    path = str(tmp_path / "t.jpg")
    for kw in ({"restart_marker_blocks": 3},
               {"restart_marker_rows": 1, "subsampling": "4:4:4"},
               {"restart_marker_blocks": 1, "subsampling": "4:2:2"}):
        _pil(img).save(path, quality=85, **kw)
        assert b"\xff\xdd" in open(path, "rb").read()
        np.testing.assert_array_equal(read_jpeg(path),
                                      np.asarray(Image.open(path)))
    for factor in ("440", "411"):
        flag = getattr(cv2, f"IMWRITE_JPEG_SAMPLING_FACTOR_{factor}")
        for w, h in ((33, 47), (257, 130), (3, 2)):
            cv2.imwrite(path, np.ascontiguousarray(_photo(w, h, 3, 5)),
                        [cv2.IMWRITE_JPEG_QUALITY, 90,
                         cv2.IMWRITE_JPEG_SAMPLING_FACTOR, flag])
            np.testing.assert_array_equal(read_jpeg(path),
                                          np.asarray(Image.open(path)))
    _pil(img).save(path, quality=90, subsampling="4:4:4")
    data = open(path, "rb").read()
    ycc = np.asarray(Image.open(path))
    seen = []
    for variant in (dict(jfif=False, adobe=0), dict(jfif=False, adobe=1),
                    dict(jfif=False, ids=(82, 71, 66)),
                    dict(jfif=True, adobe=0)):
        open(path, "wb").write(_rewrite(data, **variant))
        ref = np.asarray(Image.open(path))
        np.testing.assert_array_equal(read_jpeg(path), ref)
        seen.append(np.array_equal(ref, ycc))
    # Adobe 0 and 'RGB' ids skip the colour conversion; JFIF wins
    assert seen == [False, True, False, True]


@pytest.mark.parametrize("w,h", [(64, 48), (33, 47), (800, 16)])
def test_port_encoder_files_decode_as_pillow(tmp_path, w, h):
    img = _photo(w, h, 3, seed=w)
    path = str(tmp_path / "e.jpg")
    with open(path, "wb") as f:
        f.write(encode_jpeg(img, 90))
    np.testing.assert_array_equal(read_jpeg(path),
                                  np.asarray(Image.open(path)))
    np.testing.assert_array_equal(decode_coefficients(path),
                                  quantized_blocks(torch.as_tensor(img), 90))
    np.testing.assert_array_equal(read_image(path), read_jpeg(path))


def test_unsupported_jpegs_and_other_files_raise(tmp_path):
    img = _photo(40, 24, 3, seed=2)
    p = str(tmp_path / "p.jpg")
    _pil(img).save(p, progressive=True)
    with pytest.raises(ValueError, match=r"p\.jpg: progressive JPEG .*"
                       r"ROADMAP Queue A item 9"):
        read_jpeg(p)
    assert jpeg_size(p) == (40, 24)
    k = str(tmp_path / "k.jpg")
    _pil(img).convert("CMYK").save(k)
    assert np.asarray(Image.open(k)).shape == (24, 40, 4)
    with pytest.raises(ValueError, match=r"k\.jpg: CMYK or YCCK .*"
                       r"ROADMAP Queue A item 9"):
        read_image(k)
    # the magic bytes pick the reader, not the extension
    a, b = str(tmp_path / "a.jpg"), str(tmp_path / "b.png")
    _pil(img).save(a, format="PNG")
    _pil(img).save(b, format="JPEG", quality=70)
    np.testing.assert_array_equal(read_image(a), img)
    np.testing.assert_array_equal(read_image(b), np.asarray(Image.open(b)))
    assert image_size(a) == image_size(b) == (40, 24)
    bmp = str(tmp_path / "c.jpg")
    _pil(img).save(bmp, format="BMP")
    with pytest.raises(ValueError, match="not a PNG or JPEG"):
        read_image(bmp)
    assert image_size(bmp) is None


def _rle(row):
    """New-style run-length encoding of one (w, 4) scanline: runs of 4+
    equal bytes as runs, the rest as literals."""
    out = bytearray([2, 2, len(row) >> 8, len(row) & 255])
    for ch in range(4):
        vals = row[:, ch]
        i = 0
        while i < len(vals):
            j = i
            while j < len(vals) and j - i < 127 and vals[j] == vals[i]:
                j += 1
            if j - i >= 4:
                out += bytes([128 + j - i, vals[i]])
                i = j
                continue
            j = i
            while j < len(vals) and j - i < 128 and not (
                    j + 3 < len(vals) and vals[j] == vals[j + 1]
                    == vals[j + 2] == vals[j + 3]):
                j += 1
            j = max(j, i + 1)
            out += bytes([j - i]) + bytes(vals[i:j].tolist())
            i = j
    return bytes(out)


def _write_hdr(path, px, rle):
    h, w = px.shape[:2]
    with open(path, "wb") as f:
        f.write(b"#?RADIANCE\n# made in a test\nFORMAT=32-bit_rle_rgbe\n"
                b"EXPOSURE=1.0\n\n" + f"-Y {h} +X {w}\n".encode())
        f.write(b"".join(_rle(r) for r in px) if rle else px.tobytes())


def _rgbe(h, w, seed):
    rng = np.random.default_rng(seed)
    px = rng.integers(0, 256, (h, w, 4)).astype(np.uint8)
    px[..., 3] = rng.integers(118, 140, (h, w))
    px[: h // 3, : w // 2] = [10, 10, 10, 131]              # a long run
    edges = np.array([[1, 1, 1, 135], [1, 2, 3, 135], [255, 0, 128, 128],
                      [3, 5, 7, 136], [7, 9, 0, 0], [128, 64, 32, 136],
                      [200, 100, 50, 126], [255, 255, 255, 129]], np.uint8)
    px[-1, :len(edges)] = edges
    return px


@pytest.mark.parametrize("rle", [False, True])
def test_hdr_matches_imageio(tmp_path, rle):
    px = _rgbe(21, 37, seed=int(rle))
    path = str(tmp_path / "sky.hdr")
    _write_hdr(path, px, rle)
    if rle:
        assert os.path.getsize(path) < px.size
    ref = iio.imread(path)
    got = read_hdr(path)
    assert ref.dtype == got.dtype == np.uint8 and ref.shape == got.shape
    np.testing.assert_array_equal(got, ref)
    assert 128 in got[-1, 0] and (got == 255).any()    # 127.5 and saturated
    # the environment's plate from the file, as JAX makes it
    je = JS.Environment(mode=JS.EnvironmentMode.HDR, hdr_path=path)
    te = TS.Environment(mode=TS.EnvironmentMode.HDR, hdr_path=path)
    np.testing.assert_array_equal(te.load_hdr(), je.load_hdr())
    for w, h in ((37, 21), (20, 13)):
        assert np.abs(te.sample_background(w, h)
                      - je.sample_background(w, h)).max() <= 1 / 255 + 1e-6


def test_hdr_orientation_and_jpeg_plate(tmp_path):
    path = str(tmp_path / "flip.hdr")
    with open(path, "wb") as f:
        f.write(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n+Y 2 +X 2\n"
                + bytes(16))
    with pytest.raises(ValueError, match="orientation"):
        read_hdr(path)
    jpg = str(tmp_path / "plate.jpg")
    _pil(_photo(30, 20, 3, seed=4)).save(jpg, quality=90)
    je = JS.Environment(mode=JS.EnvironmentMode.HDR, hdr_path=jpg)
    te = TS.Environment(mode=TS.EnvironmentMode.HDR, hdr_path=jpg)
    np.testing.assert_array_equal(te.load_hdr(), je.load_hdr())


def _jpeg_colmap(root, rng, n=5):
    """A COLMAP bin capture whose images are JPEG (RGB and greyscale,
    4:2:0 and 4:4:4) of 40x30, with a 25-point cloud."""
    sparse = os.path.join(root, "sparse", "0")
    os.makedirs(sparse)
    os.makedirs(os.path.join(root, "images"))
    cams = {1: JC.ColmapCamera("PINHOLE", 40, 30,
                               np.array([35.0, 36.0, 20.5, 14.5]))}
    imgs = {}
    for i in range(n):
        q = rng.standard_normal(4)
        q /= np.linalg.norm(q)
        name = f"IMG_{i:04d}.JPG"
        imgs[i + 1] = JC.ColmapImage(name, 1, q, rng.normal(0, 1, 3)
                                     + [0, 0, 4])
        img = _photo(40, 30, 1 if i == 2 else 3, seed=10 + i)
        _pil(img).save(os.path.join(root, "images", name), quality=92,
                       subsampling="4:4:4" if i == 3 else "4:2:0")
    TC.write_cameras_bin(os.path.join(sparse, "cameras.bin"), cams)
    TC.write_images_bin(os.path.join(sparse, "images.bin"), imgs)
    TC.write_points3d_bin(os.path.join(sparse, "points3D.bin"),
                          rng.standard_normal((25, 3)).astype(np.float32),
                          rng.uniform(0, 1, (25, 3)).astype(np.float32))


@pytest.mark.parametrize("max_width", [2048, 24])
def test_jpeg_captures_load_as_jax(tmp_path, max_width):
    _jpeg_colmap(str(tmp_path / "colmap"), np.random.default_rng(3))
    kw = dict(eval_holdout=2, max_width=max_width)
    train, test = load_dataset(str(tmp_path / "colmap"), device=CPU, **kw)
    jtrain, jtest = jax_load_dataset(str(tmp_path / "colmap"), **kw)
    assert train.num_views == 2 and test.num_views == 3
    _assert_same_dataset(train, jtrain)
    _assert_same_dataset(test, jtest)
    # blender, JPEG images and a JPEG masks folder (resized nearest)
    root = tmp_path / "blender"
    (root / "train" / "masks").mkdir(parents=True)
    frames = []
    for i in range(3):
        _pil(_photo(32, 24, 3, seed=i)).save(root / "train" / f"r_{i}.jpg",
                                             quality=90)
        m = np.zeros((17, 45), np.uint8)
        m[:, : 10 * (i + 1)] = 255
        m[:5] = 128
        _pil(m[..., None]).save(root / "train" / "masks" / f"r_{i}.jpg",
                                quality=95)
        frames.append({"file_path": f"./train/r_{i}",
                       "transform_matrix": _gl_c2w([2, 1, 2 + i]).tolist()})
    (root / "transforms_train.json").write_text(json.dumps(
        {"camera_angle_x": 0.7, "frames": frames}))
    kw = dict(use_mask=True, white_background=True, max_width=max_width)
    train, _ = load_dataset(str(root), "blender", device=CPU, **kw)
    jtrain, _ = jax_load_dataset(str(root), "blender", **kw)
    _assert_same_dataset(train, jtrain)
    np.testing.assert_array_equal(train.masks.numpy(),
                                  np.asarray(jtrain.masks))
    assert 0 < train.masks.float().mean() < 255
    # a nerfstudio frame without w / h: the JPEG's size from its header
    meta = {"fl_x": 30.0, "frames": [
        {"file_path": "train/r_0.jpg",
         "transform_matrix": _gl_c2w([2, 1, 2]).tolist()}]}
    (root / "transforms.json").write_text(json.dumps(meta))
    cams, _, _, _ = load_nerfstudio(str(root / "transforms.json"),
                                    device=CPU)
    jcams, _, _, _ = jax_nerfstudio(str(root / "transforms.json"))
    assert (cams[0].width, cams[0].height) == (jcams[0].width,
                                               jcams[0].height) == (32, 24)


@pytest.fixture(params=["library", "numpy"])
def with_library(request, monkeypatch):
    """Both packages with their host libraries, or both without."""
    if request.param == "library":
        assert native.get_lib() is not None, native.BUILD_ERROR
        assert jax_native.get_lib() is not None
    else:
        monkeypatch.setattr(native, "get_lib", lambda: None)
        monkeypatch.setattr(jax_native, "get_lib", lambda: None)
    return request.param


def test_native_paths_match_jax(tmp_path, with_library):
    rng = np.random.default_rng(0)
    cams = {1: TC.ColmapCamera("PINHOLE", 64, 48,
                               np.array([50.0, 51.0, 32.0, 24.0]))}
    imgs = {}
    for i in range(5):
        q = rng.standard_normal(4)
        q /= np.linalg.norm(q)
        imgs[i + 1] = TC.ColmapImage(f"im_{i:03d}.jpg", 1, q,
                                     rng.standard_normal(3))
    pts = rng.standard_normal((500, 3)).astype(np.float32)
    cols = rng.uniform(0, 1, (500, 3)).astype(np.float32)
    TC.write_images_bin(str(tmp_path / "images.bin"), imgs)
    TC.write_points3d_bin(str(tmp_path / "points3D.bin"), pts, cols)
    got = TC.read_images_bin(str(tmp_path / "images.bin"))
    want = JC.read_images_bin(str(tmp_path / "images.bin"))
    assert list(got) == list(want) == [1, 2, 3, 4, 5]
    for k in got:
        assert got[k].name == want[k].name and got[k].camera_id == 1
        np.testing.assert_array_equal(got[k].qvec, want[k].qvec)
        np.testing.assert_array_equal(got[k].tvec, want[k].tvec)
    for a, b in zip(TC.read_points3d_bin(str(tmp_path / "points3D.bin")),
                    JC.read_points3d_bin(str(tmp_path / "points3D.bin"))):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)

    jp = jax_random_scene(np.random.default_rng(1), 300, sh_degree=2)
    tp = GaussianParams.from_numpy(
        {f: np.asarray(getattr(jp, f)) for f in
         ("means", "scales", "quats", "opacity", "sh0", "shN", "alive")},
        device=CPU)
    for mod_t, mod_j, name in ((TPLY, JPLY, "save_ply"),
                               (TCOMP, JCOMP, "save_compressed_ply")):
        getattr(mod_t, name)(str(tmp_path / "t.ply"), tp)
        getattr(mod_j, name)(str(tmp_path / "j.ply"), jp)
        assert (tmp_path / "t.ply").read_bytes() == \
            (tmp_path / "j.ply").read_bytes(), name
    pos = rng.standard_normal((2000, 3)).astype(np.float32)
    np.testing.assert_array_equal(TCOMP.morton_order(pos),
                                  JCOMP.morton_order(pos))
    if with_library == "library":
        np.testing.assert_array_equal(native.morton_codes(pos),
                                      jax_native.morton_codes(pos))
    else:
        assert native.morton_codes(pos) is None
