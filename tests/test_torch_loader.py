"""The port's mask loading and its streamed images on the CPU: masks from a
masks folder, from the PNG's alpha and keep-all, bitwise equal to the JAX
loaders on ``tests/test_readers.py``'s scenes; ``resize_nearest`` and
``to_grey`` bitwise equal to Pillow; the host image store, the prefetcher
and the streaming loop; a streamed ``Trainer`` bitwise equal to a
device-resident one, and a streamed run checkpointed and resumed bitwise
equal to an unbroken one."""

import json

import numpy as np
import pytest
import torch
from PIL import Image

from divshot_tpu.gsio.datasets import load_dataset as jax_load_dataset

from divshot_tpu_torch.core.config import TrainConfig
from divshot_tpu_torch.gsio.datasets import load_dataset
from divshot_tpu_torch.gsio.loader import (HostImageStore, Prefetcher,
                                           StreamingLoop)
from divshot_tpu_torch.gsio.png import read_png, resize_nearest, to_grey
from divshot_tpu_torch.gsio.synthetic import (orbit_cameras, random_scene,
                                              render_gt_images)
from divshot_tpu_torch.train import checkpoint as CK
from divshot_tpu_torch.train.optim import PARAM_FIELDS
from divshot_tpu_torch.train.trainer import Dataset, Trainer
from tests.test_readers import _gl_c2w, _write_img

CPU = "cpu"


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


# ---------------------------------------------------------------------------
# masks


def _blender(root, n, alpha=None, mask_shape=None, mask_mode="L"):
    """tests/test_readers.py:165-200's scenes: ``n`` random 32x24 views,
    RGBA with ``alpha`` when given, and with ``mask_shape`` a masks folder
    of that (h, w) in ``mask_mode``."""
    (root / "train").mkdir(parents=True)
    if mask_shape is not None:
        (root / "train" / "masks").mkdir()
    frames = []
    for i in range(n):
        _write_img(str(root / "train" / f"r_{i}.png"), seed=i, alpha=alpha)
        if mask_shape is not None:
            h, w = mask_shape
            m = np.zeros((h, w), np.float32)
            m[:, : w * (i + 1) // 4 + w // 4] = 1.0
            m[: h // 3] = 0.5
            m = (m * 255).astype(np.uint8)
            if mask_mode == "RGB":
                m = np.stack([m, m // 2, 255 - m], -1)
            Image.fromarray(m, mask_mode).save(
                root / "train" / "masks" / f"r_{i}.png")
        frames.append({"file_path": f"./train/r_{i}",
                       "transform_matrix": _gl_c2w([2, 1, 2 + i]).tolist()})
    with open(root / "transforms_train.json", "w") as f:
        json.dump({"camera_angle_x": 0.7, "frames": frames}, f)
    return str(root)


@pytest.mark.parametrize("case", ["folder", "folder_resized", "folder_rgb",
                                  "alpha", "keep_all"])
def test_masks_match_jax_loaders(tmp_path, case):
    alpha = None
    if case == "alpha":
        alpha = np.zeros((24, 32), np.float32)
        alpha[:12] = 1.0
        alpha[12:, :7] = 0.4
    shape = {"folder": (24, 32), "folder_resized": (17, 45),
             "folder_rgb": (24, 32)}.get(case)
    src = _blender(tmp_path / case, 2, alpha=alpha, mask_shape=shape,
                   mask_mode="RGB" if case == "folder_rgb" else "L")
    ref, _ = jax_load_dataset(src, "blender", use_mask=True)
    train, _ = load_dataset(src, "blender", use_mask=True, device=CPU)
    assert train.masks.dtype == torch.uint8
    np.testing.assert_array_equal(train.masks.numpy(), np.asarray(ref.masks))
    np.testing.assert_array_equal(train.images.numpy(),
                                  np.asarray(ref.images))
    if case == "keep_all":
        assert (train.masks.numpy() == 255).all()
    no_mask, _ = load_dataset(src, "blender", device=CPU)
    assert no_mask.masks is None


def test_mask_in_another_format_raises(tmp_path):
    """A mask file that is neither PNG nor JPEG (a BMP under a ``.jpg``
    name, which Pillow would open) raises; a JPEG mask loads as JAX's."""
    src = _blender(tmp_path / "jpg", 1)
    (tmp_path / "jpg" / "train" / "masks").mkdir()
    mask = tmp_path / "jpg" / "train" / "masks" / "r_0.jpg"
    m = np.full((24, 32), 255, np.uint8)
    m[:, :9] = 0
    Image.fromarray(m, "L").save(mask, format="BMP")
    with pytest.raises(ValueError, match="PNG"):
        load_dataset(src, "blender", use_mask=True, device=CPU)
    Image.fromarray(m, "L").save(mask)
    train, _ = load_dataset(src, "blender", use_mask=True, device=CPU)
    ref, _ = jax_load_dataset(src, "blender", use_mask=True)
    np.testing.assert_array_equal(train.masks.numpy(), np.asarray(ref.masks))


@pytest.mark.parametrize("mode", ["L", "RGB", "RGBA"])
@pytest.mark.parametrize("size", [(7, 5), (45, 33), (64, 48), (13, 90)])
def test_resize_nearest_and_grey_match_pillow(mode, size):
    rng = np.random.default_rng(sum(size))
    ch = {"L": (), "RGB": (3,), "RGBA": (4,)}[mode]
    img = rng.integers(0, 256, (24, 32, *ch), dtype=np.uint8)
    ref = Image.fromarray(img, mode)
    np.testing.assert_array_equal(resize_nearest(img, *size),
                                  np.asarray(ref.resize(size, Image.NEAREST)))
    np.testing.assert_array_equal(to_grey(img),
                                  np.asarray(ref.convert("L")))


# ---------------------------------------------------------------------------
# the loader


def test_host_store_prefetcher_and_loop(tmp_path):
    rng = np.random.default_rng(0)
    imgs = rng.integers(0, 256, (5, 6, 7, 3), dtype=np.uint8)
    masks = rng.integers(0, 256, (5, 6, 7), dtype=np.uint8)
    store = HostImageStore(images=imgs)
    assert store.num_views == 5
    np.testing.assert_array_equal(store.get(3).numpy(), imgs[3])
    # decoded on demand, with an LRU of two frames
    from divshot_tpu_torch.gsio.png import write_png
    paths = []
    for i in range(5):
        paths.append(str(tmp_path / f"v{i}.png"))
        write_png(paths[-1], imgs[i])
    decoded = []

    def decode(p):
        decoded.append(p)
        return read_png(p)

    lazy = HostImageStore(paths=paths, decode=decode, cache_size=2)
    for i in (0, 1, 0, 2, 1):
        np.testing.assert_array_equal(lazy.get(i).numpy(), imgs[i])
    assert decoded == [paths[0], paths[1], paths[2], paths[1]]
    pf = Prefetcher(store, depth=2, masks=masks)
    for v in (4, 1, 1, 0):
        pf.schedule(v)
    for v in (4, 1, 1, 0):
        view, img, mask = pf.get()
        assert view == v and img.device.type == "cpu"
        np.testing.assert_array_equal(img.numpy(), imgs[v])
        np.testing.assert_array_equal(mask.numpy(), masks[v])
    pf.close()
    loop = StreamingLoop(store, np.random.default_rng(3), depth=2)
    order = np.random.default_rng(3).integers(5, size=6)
    got = [v for v, img, mask in loop.views(6)]
    loop.close()
    assert got == [int(v) for v in order]


def _setup(stream, masks=None):
    rng = np.random.default_rng(4)
    gt = random_scene(rng, 150, sh_degree=1, device=CPU)
    cams = orbit_cameras(4, width=32, device=CPU)
    images = render_gt_images(gt, cams, instance_capacity=1 << 13)
    ds = Dataset.from_views(cams, images, stream=stream, masks=masks)
    params = random_scene(np.random.default_rng(5), 120, sh_degree=1,
                          capacity=160, device=CPU)
    cfg = TrainConfig(sh_degree=1, use_mask=masks is not None)
    cfg.densify.cap_max = 160
    cfg.densify.warmup_length = 0
    cfg.densify.refine_every = 3
    return cfg, ds, params


def _state_equal(a, b):
    for f in (*PARAM_FIELDS, "alive"):
        assert torch.equal(getattr(a.params, f), getattr(b.params, f)), f
    for f in PARAM_FIELDS:
        assert torch.equal(a.opt.mu[f], b.opt.mu[f]), f
        assert torch.equal(a.opt.nu[f], b.opt.nu[f]), f
    assert a.step == b.step


@pytest.mark.parametrize("with_masks", [False, True])
def test_streamed_equals_device_resident(with_masks):
    masks = None
    if with_masks:
        masks = np.full((4, 32, 32), 255, np.uint8)
        masks[:, :, :16] = 0
    runs = []
    for stream in (False, True):
        cfg, ds, params = _setup(stream, masks)
        assert ds.streamed == stream
        tr = Trainer(cfg, ds, params,
                     render_kwargs={"instance_capacity": 1 << 13})
        losses = [tr.step_once()["loss"] for _ in range(6)]
        tr.close()
        runs.append((tr, torch.stack(losses)))
    assert torch.equal(runs[0][1], runs[1][1])
    _state_equal(runs[0][0].state, runs[1][0].state)
    assert runs[1][0].pending_views and not runs[0][0].pending_views


def test_streamed_resume_equals_unbroken(tmp_path):
    cfg, ds, params = _setup(True)
    rk = {"instance_capacity": 1 << 13}
    whole = Trainer(cfg, ds, params, render_kwargs=rk)
    w_losses = [whole.step_once()["loss"] for _ in range(7)]
    whole.close()
    first = Trainer(cfg, ds, params, render_kwargs=rk)
    losses = [first.step_once()["loss"] for _ in range(4)]
    CK.save_trainer(str(tmp_path), first, step=4, export_ply=False)
    first.close()
    assert CK.load_state_dict(str(tmp_path), 4)["pending_views"] == \
        first.pending_views
    resumed = Trainer(cfg, ds, params, render_kwargs=rk)
    CK.resume_trainer(str(tmp_path), resumed, 4)
    losses += [resumed.step_once()["loss"] for _ in range(3)]
    resumed.close()
    assert torch.equal(torch.stack(losses), torch.stack(w_losses))
    _state_equal(resumed.state, whole.state)


def test_streamed_batches_refused():
    cfg, ds, params = _setup(True)
    tr = Trainer(cfg.replace(batch_size=2), ds, params,
                 render_kwargs={"instance_capacity": 1 << 13})
    with pytest.raises(NotImplementedError, match="in-HBM images"):
        tr.step_once()
    tr.close()
