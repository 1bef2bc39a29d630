"""The port's dataset path on the CPU against the JAX package: the
procedural scene's ray tracer, the blender and COLMAP loaders, and the
port's own generated dataset read by both packages.

Tolerances, each with its reason:
- tracer against JAX's ``render_view`` evaluated op by op
  (``jax.disable_jit``): rgb and alpha atol 1e-5, except where one ulp
  flips a hit (a silhouette or a shadow edge), at most 0.5 % of the
  pixels (none at these poses);
- tracer against JAX's jitted ``render_view``, what JAX's generator
  writes: the fused float32 evaluation of the glossy spheres' highlights
  (``ndh ** 96`` of a normal from a cancelling quadratic) differs from
  the op-by-op one by up to 2.3e-3 at these poses, and both differ from
  float64 by ~1e-3 there; so atol 5e-3, and the stored uint8 pixels
  equal but for at most 1 % off by one level;
- loaders: images bitwise; viewmats and intrinsics rtol 1e-6; the split,
  the points and the colours equal.
"""

import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

import jax

from divshot_tpu.gsio import colmap as JC
from divshot_tpu.gsio import procedural as JPROC
from divshot_tpu.gsio.datasets import load_dataset as jax_load_dataset

from divshot_tpu_torch.gsio import procedural as PROC
from divshot_tpu_torch.gsio.datasets import load_dataset

CPU = "cpu"
POSES = [(0.3, 0.2), (2.0, 0.6), (4.1, 1.0)]


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _focal(res):
    return 0.5 * res / np.tan(0.5 * np.deg2rad(40.0))


@pytest.mark.parametrize("pose", POSES)
def test_tracer_matches_jax(pose):
    spec = JPROC.make_scene()
    c2w = JPROC._hemisphere_c2w(*pose, 3.6)
    out = PROC.render_view(spec, c2w, 64, 64, _focal(64), device=CPU)
    assert out.shape == (64, 64, 4) and out.dtype == np.float32
    with jax.disable_jit():
        ref = JPROC.render_view(spec, c2w, 64, 64, _focal(64), chunk=4096)
    flips = (np.abs(out - ref) > 1e-5).any(-1)
    assert flips.mean() <= 0.005, flips.sum()
    jit = JPROC.render_view(spec, c2w, 64, 64, _focal(64))
    assert np.abs(out - jit).max() <= 5e-3
    q = lambda x: (np.clip(x, 0, 1) * 255).astype(np.uint8)  # noqa: E731
    d = np.abs(q(out).astype(int) - q(jit).astype(int))
    assert d.max() <= 1 and (d > 0).any(-1).mean() <= 0.01
    assert 0.2 < out[..., 3].mean() <= 1.0


def _assert_same_dataset(td, jd):
    """The port's ``Dataset`` against JAX's: images bitwise, cameras rtol
    1e-6, points and colours equal."""
    np.testing.assert_array_equal(td.images.numpy(), np.asarray(jd.images))
    cams = jd.cameras
    np.testing.assert_allclose(np.stack([c.viewmat for c in td.cameras]),
                               np.asarray(cams.viewmat), rtol=1e-6,
                               atol=1e-7)
    for k in ("fx", "fy", "cx", "cy"):
        np.testing.assert_allclose([getattr(c, k) for c in td.cameras],
                                   np.asarray(getattr(cams, k)), rtol=1e-6)
    assert td.cameras[0].width == int(cams.width)
    assert td.cameras[0].height == int(cams.height)
    np.testing.assert_allclose(td.scene_extent, jd.scene_extent, rtol=1e-6)
    for k in ("points", "colors"):
        a, b = getattr(td, k), getattr(jd, k)
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def jax_bricks(tmp_path_factory):
    """JAX's ``generate_dataset`` at 48 px: 4 train and 2 test views."""
    out = str(tmp_path_factory.mktemp("jax_bricks"))
    JPROC.generate_dataset(out, n_train=4, n_test=2, width=48, height=48)
    return out


@pytest.mark.parametrize("white,max_width", [(True, 2048), (False, 2048),
                                             (True, 31)])
def test_blender_loader_matches_jax(jax_bricks, white, max_width):
    """JAX's own dataset (its PNGs written by Pillow, adaptive filters),
    over white and black, and downscaled 48 -> 31 by the Lanczos resize."""
    kw = dict(white_background=white, max_width=max_width)
    train, test = load_dataset(jax_bricks, device=CPU, **kw)
    jtrain, jtest = jax_load_dataset(jax_bricks, **kw)
    assert train.num_views == 4 and test.num_views == 2
    _assert_same_dataset(train, jtrain)
    _assert_same_dataset(test, jtest)
    assert train.images.shape[1:] == ((48, 48, 3) if max_width > 48
                                      else (31, 31, 3))


def _colmap_scene(root, rng):
    """A COLMAP bin scene: two cameras (PINHOLE, SIMPLE_RADIAL), five
    images (RGB, greyscale, RGBA) of 40x30, a 25-point cloud."""
    sparse = os.path.join(root, "sparse", "0")
    os.makedirs(sparse)
    os.makedirs(os.path.join(root, "images"))
    cams = {1: JC.ColmapCamera("PINHOLE", 40, 30,
                               np.array([35.0, 36.0, 20.5, 14.5])),
            2: JC.ColmapCamera("SIMPLE_RADIAL", 40, 30,
                               np.array([33.0, 19.0, 15.0, 0.01]))}
    imgs = {}
    for i in range(5):
        q = rng.standard_normal(4)
        q /= np.linalg.norm(q)
        name = f"img{4 - i:03d}.png"      # names sort against the ids
        imgs[i + 1] = JC.ColmapImage(name, 1 + i % 2, q,
                                     rng.normal(0, 1, 3) + [0, 0, 4])
        mode = ("RGB", "L", "RGBA")[i % 3]
        ch = {"RGB": 3, "L": 1, "RGBA": 4}[mode]
        arr = (rng.uniform(0, 1, (30, 40, ch)) * 255).astype(np.uint8)
        Image.fromarray(arr[..., 0] if ch == 1 else arr, mode).save(
            os.path.join(root, "images", name))
    pts = rng.standard_normal((25, 3)).astype(np.float32)
    cols = rng.uniform(0, 1, (25, 3)).astype(np.float32)
    JC.write_cameras_bin(os.path.join(sparse, "cameras.bin"), cams)
    JC.write_images_bin(os.path.join(sparse, "images.bin"), imgs)
    JC.write_points3d_bin(os.path.join(sparse, "points3D.bin"), pts, cols)


@pytest.mark.parametrize("max_width", [2048, 24])
def test_colmap_loader_matches_jax(tmp_path, max_width):
    """Intrinsics rescaled to the loaded size (40x30 -> 24x18 with a max
    width of 24), every second view held out."""
    _colmap_scene(str(tmp_path), np.random.default_rng(2))
    kw = dict(eval_holdout=2, max_width=max_width)
    train, test = load_dataset(str(tmp_path), device=CPU, **kw)
    jtrain, jtest = jax_load_dataset(str(tmp_path), **kw)
    assert train.num_views == 2 and test.num_views == 3
    _assert_same_dataset(train, jtrain)
    _assert_same_dataset(test, jtest)
    assert train.images.shape[1:3] == ((30, 40) if max_width > 40
                                       else (18, 24))


def test_generated_dataset_loads_equal_in_both_packages(tmp_path):
    out = str(tmp_path / "bricks")
    PROC.generate_dataset(out, n_train=3, n_test=2, width=40, height=40,
                          device=CPU)
    with open(os.path.join(out, "transforms_train.json")) as f:
        assert len(json.load(f)["frames"]) == 3
    train, test = load_dataset(out, device=CPU, white_background=True)
    jtrain, jtest = jax_load_dataset(out, white_background=True)
    _assert_same_dataset(train, jtrain)
    _assert_same_dataset(test, jtest)
    assert train.points is None and test.num_views == 2


@pytest.mark.parametrize("what", ["use_mask", "nerfstudio"])
def test_unported_dataset_options_raise(tmp_path, what):
    """Both are ported now. ``use_mask`` loads the COLMAP scene's masks
    bitwise as JAX's loader does; the nerfstudio reader, asked for a
    directory without a ``transforms.json``, fails as JAX's does
    (``tests/test_torch_formats.py`` holds the readers on their
    scenes)."""
    _colmap_scene(str(tmp_path), np.random.default_rng(0))
    if what == "use_mask":
        train, _ = load_dataset(str(tmp_path), "colmap", device=CPU,
                                use_mask=True)
        jtrain, _ = jax_load_dataset(str(tmp_path), "colmap", use_mask=True)
        assert train.masks.dtype == torch.uint8
        np.testing.assert_array_equal(train.masks.numpy(),
                                      np.asarray(jtrain.masks))
        return
    with pytest.raises(FileNotFoundError, match="transforms.json"):
        load_dataset(str(tmp_path), what, device=CPU)
    with pytest.raises(FileNotFoundError, match="transforms.json"):
        jax_load_dataset(str(tmp_path), what)
