"""Dataset loading (counterpart of ``divshot_tpu/gsio/datasets.py``):
COLMAP scenes and Blender / NeRF-synthetic scenes into the trainer's
``Dataset`` (images, cameras and SfM seed points) on ``device``.

Images are read by ``gsio/image.read_image``: PNG (8-bit greyscale, RGB
or RGBA) and JPEG (greyscale or RGB, decoded bitwise as Pillow decodes
it; a CMYK JPEG raises, where JAX would read its four channels as RGBA);
downscaling to ``max_width`` x ``max_height`` is Pillow's Lanczos, as in
JAX. The arithmetic from uint8 pixels to the
stored uint8 image (alpha compositing over a white or black background,
greyscale repeated to three channels) is JAX's, float32 for float32.

Masks (``use_mask``), as in JAX: a file of the image's stem in a
``masks`` folder beside the images or beside their folder wins (PNG or
JPEG, converted to greyscale and resized nearest to the image), then the
PNG's alpha, then keep-all; stored uint8 ``m * 255``.

External poses (nerfstudio, OpenSfM, RealityCapture, Metashape) are read
by ``gsio/readers.py`` and their images loaded by
``load_external_pose_dataset``, the intrinsics rescaled to the loaded
size.
"""

from __future__ import annotations

import json
import os

import numpy as np

from divshot_tpu_torch.gsio import colmap as C
from divshot_tpu_torch.gsio.image import read_image
from divshot_tpu_torch.gsio.png import (resize_lanczos, resize_nearest,
                                        to_grey)
from divshot_tpu_torch.splat.camera import Camera
from divshot_tpu_torch.train.trainer import Dataset


def _load_image(path: str, max_w: int, max_h: int,
                white_bg: bool = False):
    """-> ((H, W, 3) float32 in [0, 1], RGBA composited over the
    background; the alpha (H, W) float32, or None without one)."""
    img = read_image(path)
    h, w = img.shape[:2]
    scale = min(1.0, max_w / w, max_h / h)
    if scale < 1.0:
        img = resize_lanczos(img, round(w * scale), round(h * scale))
    arr = img.astype(np.float32) / 255.0
    if arr.ndim == 2:
        arr = np.repeat(arr[..., None], 3, -1)
    alpha = None
    if arr.shape[-1] == 4:
        rgb, a = arr[..., :3], arr[..., 3:4]
        alpha = a[..., 0]
        arr = rgb * a + (1.0 - a) * (1.0 if white_bg else 0.0)
    return arr, alpha


def _find_mask_path(img_path: str) -> str | None:
    """``useMask``: a file with the image's stem and a common extension in
    ``<img_dir>/masks/`` or ``<img_dir>/../masks/``."""
    d = os.path.dirname(img_path)
    stem = os.path.splitext(os.path.basename(img_path))[0]
    for mdir in (os.path.join(d, "masks"),
                 os.path.join(os.path.dirname(d), "masks")):
        for ext in (".png", ".jpg", ".jpeg", ".JPG", ".PNG"):
            p = os.path.join(mdir, stem + ext)
            if os.path.exists(p):
                return p
    return None


def _load_mask(img_path: str, alpha: np.ndarray | None,
               shape: tuple) -> np.ndarray:
    """Per-image mask (H, W) float32 in [0, 1]: the masks-folder file
    wins, then the PNG's alpha, then keep-all."""
    mp = _find_mask_path(img_path)
    if mp is not None:
        m = to_grey(read_image(mp))
        if m.shape != tuple(shape[:2]):
            m = resize_nearest(m, shape[1], shape[0])
        return m.astype(np.float32) / 255.0
    if alpha is not None:
        return alpha.astype(np.float32)
    return np.ones(shape[:2], np.float32)


def _mask_u8(path: str, alpha, shape) -> np.ndarray:
    return (_load_mask(path, alpha, shape) * 255).astype(np.uint8)


def _split_datasets(cameras, images, masks, points, colors,
                    eval_holdout: int, stream: bool = False):
    """Holdout split (every ``eval_holdout``-th view, from view 0, is
    held out) -> (train, eval or None); ``masks`` may be empty."""
    images = np.stack(images)
    marr = np.stack(masks) if masks else None
    train_idx = [i for i in range(len(cameras))
                 if not eval_holdout or i % eval_holdout != 0]
    eval_idx = [i for i in range(len(cameras))
                if eval_holdout and i % eval_holdout == 0]

    def make(idx):
        return Dataset.from_views(
            [cameras[i] for i in idx], images[idx], points=points,
            colors=colors, stream=stream,
            masks=None if marr is None else marr[idx])

    return make(train_idx), (make(eval_idx) if eval_idx else None)


def load_colmap_dataset(
    source: str, *, images_dir: str = "images", max_width: int = 2048,
    max_height: int = 2048, eval_holdout: int = 0, max_images: int = 0,
    use_mask: bool = False, device="cuda",
) -> tuple[Dataset, Dataset | None]:
    """-> (train_ds, eval_ds or None); the intrinsics are rescaled to the
    loaded image size."""
    sparse = C.find_sparse_dir(source)
    cams, imgs, pts, cols = C.load_sparse_model(sparse)
    img_root = os.path.join(source, images_dir)

    cameras, images, masks = [], [], []
    items = sorted(imgs.items(), key=lambda kv: kv[1].name)
    if max_images:
        items = items[:max_images]
    for _iid, im in items:
        cc = cams[im.camera_id]
        fx, fy, cx, cy = C.intrinsics(cc)
        path = os.path.join(img_root, im.name)
        if not os.path.exists(path):
            continue
        arr, alpha = _load_image(path, max_width, max_height)
        sx = arr.shape[1] / cc.width
        sy = arr.shape[0] / cc.height
        R = C.qvec_to_rotmat(im.qvec)
        cameras.append(Camera.from_Rt(
            R, im.tvec, fx * sx, fy * sy, cx * sx, cy * sy,
            arr.shape[1], arr.shape[0], device=device))
        images.append((arr * 255).astype(np.uint8))
        if use_mask:
            masks.append(_mask_u8(path, alpha, arr.shape))

    if not cameras:
        raise FileNotFoundError(f"no images found under {img_root}")
    return _split_datasets(cameras, images, masks, pts, cols, eval_holdout)


def load_blender_dataset(
    source: str, *, split: str = "train", white_background: bool = False,
    max_width: int = 2048, max_height: int = 2048, max_images: int = 0,
    use_mask: bool = False, device="cuda",
) -> Dataset:
    """NeRF-synthetic ``transforms_{split}.json`` loader. Blender cameras
    are OpenGL-convention camera-to-world (looking down -Z), converted to
    the COLMAP-style +Z-forward world-to-camera."""
    with open(os.path.join(source, f"transforms_{split}.json")) as f:
        meta = json.load(f)
    frames = meta["frames"]
    if max_images:
        frames = frames[:max_images]

    cameras, images, masks, times = [], [], [], []
    for fr in frames:
        path = os.path.join(source, fr["file_path"])
        for ext in ("", ".png", ".jpg", ".JPG", ".jpeg"):
            if os.path.exists(path + ext):
                path = path + ext
                break
        arr, alpha = _load_image(path, max_width, max_height,
                                 white_bg=white_background)
        h, w = arr.shape[:2]
        if "camera_angle_x" in meta:
            fx = 0.5 * w / np.tan(0.5 * float(meta["camera_angle_x"]))
            fy = fx
        else:
            fx, fy = float(fr["fl_x"]), float(fr["fl_y"])
        c2w = np.array(fr["transform_matrix"], np.float64)
        c2w[:3, 1:3] *= -1.0  # OpenGL -> COLMAP axes
        w2c = np.linalg.inv(c2w)
        cameras.append(Camera.from_Rt(
            w2c[:3, :3], w2c[:3, 3], fx, fy, w / 2, h / 2, w, h,
            device=device))
        images.append((arr * 255).astype(np.uint8))
        if use_mask:
            masks.append(_mask_u8(path, alpha, arr.shape))
        if "time" in fr:   # D-NeRF dynamic scenes
            times.append(float(fr["time"]))

    ds = Dataset.from_views(cameras, np.stack(images),
                            masks=np.stack(masks) if masks else None)
    if times and len(times) == len(cameras):
        ds.times = np.asarray(times, np.float32)
    return ds


def load_external_pose_dataset(
    cameras, paths, points, colors, *, max_width: int = 2048,
    max_height: int = 2048, eval_holdout: int = 0, max_images: int = 0,
    use_mask: bool = False, white_background: bool = False, device="cuda",
) -> tuple[Dataset, Dataset | None]:
    """The images of externally read poses (``gsio/readers.py``), each
    camera's intrinsics rescaled to its loaded image (float32, as JAX's
    ``Camera.replace`` computes them); a pose whose image is missing is
    dropped."""
    if max_images:
        cameras, paths = cameras[:max_images], paths[:max_images]
    out_cams, images, masks = [], [], []
    f32 = np.float32
    for cam, path in zip(cameras, paths):
        if not os.path.exists(path):
            continue
        arr, alpha = _load_image(path, max_width, max_height,
                                 white_bg=white_background)
        sx = f32(arr.shape[1] / cam.width)
        sy = f32(arr.shape[0] / cam.height)
        out_cams.append(Camera(
            viewmat=cam.viewmat, fx=float(f32(cam.fx) * sx),
            fy=float(f32(cam.fy) * sy), cx=float(f32(cam.cx) * sx),
            cy=float(f32(cam.cy) * sy), width=arr.shape[1],
            height=arr.shape[0], device=device))
        images.append((arr * 255).astype(np.uint8))
        if use_mask:
            masks.append(_mask_u8(path, alpha, arr.shape))
    if not out_cams:
        raise FileNotFoundError(f"no images found for {len(paths)} poses")
    return _split_datasets(out_cams, images, masks, points, colors,
                           eval_holdout)


# the reference's datasetType codes (its file dialog's order)
_TYPE_NAMES = {0: "nerfstudio", 1: "colmap", 2: "colmap_txt",
               3: "realitycapture", 4: "metashape"}


def sniff_dataset_type(source: str) -> str:
    """'auto' resolution from the directory or file layout."""
    if os.path.isfile(source):
        ext = os.path.splitext(source)[1].lower()
        return {".json": "nerfstudio", ".csv": "realitycapture",
                ".xml": "metashape", ".bin": "colmap",
                ".txt": "colmap"}.get(ext, "colmap")
    if os.path.exists(os.path.join(source, "transforms_train.json")):
        return "blender"
    if os.path.exists(os.path.join(source, "transforms.json")):
        return "nerfstudio"
    if os.path.exists(os.path.join(source, "reconstruction.json")):
        return "opensfm"
    return "colmap"


def load_dataset(source: str, dataset_type: str | int = "auto", *,
                 device="cuda", **kw):
    """-> (train, eval or None). Dispatches on the dataset type; 'auto'
    sniffs the directory layout; the reference's integer datasetType
    codes are accepted. Blender scenes take their eval views from
    ``transforms_test.json`` (``eval_holdout`` is ignored there)."""
    if isinstance(dataset_type, int):
        dataset_type = _TYPE_NAMES.get(dataset_type, "colmap")
    if dataset_type == "auto":
        dataset_type = sniff_dataset_type(source)
    if dataset_type == "blender":
        wb = kw.pop("white_background", False)
        kw.pop("eval_holdout", None)
        train = load_blender_dataset(source, split="train",
                                     white_background=wb, device=device,
                                     **kw)
        evald = None
        if os.path.exists(os.path.join(source, "transforms_test.json")):
            try:
                evald = load_blender_dataset(source, split="test",
                                             white_background=wb,
                                             device=device, **kw)
            except FileNotFoundError:
                pass
        return train, evald
    if dataset_type in ("nerfstudio", "opensfm", "realitycapture",
                        "metashape"):
        from divshot_tpu_torch.gsio import readers as R
        if os.path.isdir(source):
            cand = {"nerfstudio": "transforms.json",
                    "opensfm": "reconstruction.json",
                    "realitycapture": "cameras.csv",
                    "metashape": "cameras.xml"}[dataset_type]
            source = os.path.join(source, cand)
        loader = {"nerfstudio": R.load_nerfstudio,
                  "opensfm": R.load_opensfm,
                  "realitycapture": R.load_realitycapture,
                  "metashape": R.load_metashape}[dataset_type]
        cameras, paths, pts, cols = loader(source, device=device)
        return load_external_pose_dataset(cameras, paths, pts, cols,
                                          device=device, **kw)
    kw.pop("white_background", None)
    return load_colmap_dataset(source, device=device, **kw)
