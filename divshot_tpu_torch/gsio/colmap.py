"""COLMAP sparse-model readers and writers, bin and txt (counterpart of
``divshot_tpu/gsio/colmap.py``, numpy and ``struct``, copied). As in JAX,
the binary ``images.bin`` and ``points3D.bin`` readers parse through the
host library (``core/native.py``) when it is built, and take their
pure-Python paths, with the same results, when it is not. Formats per the
public COLMAP documentation.
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass

import numpy as np


@dataclass
class ColmapCamera:
    model: str
    width: int
    height: int
    params: np.ndarray  # model-specific


@dataclass
class ColmapImage:
    name: str
    camera_id: int
    qvec: np.ndarray  # (4,) wxyz world->cam rotation
    tvec: np.ndarray  # (3,)


CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3), 1: ("PINHOLE", 4),
    2: ("SIMPLE_RADIAL", 4), 3: ("RADIAL", 5),
    4: ("OPENCV", 8), 5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12), 7: ("FOV", 5),
    8: ("SIMPLE_RADIAL_FISHEYE", 4), 9: ("RADIAL_FISHEYE", 5),
    10: ("THIN_PRISM_FISHEYE", 12),
}
MODEL_IDS = {name: (mid, n) for mid, (name, n) in CAMERA_MODELS.items()}


def _read(f, fmt):
    return struct.unpack(fmt, f.read(struct.calcsize(fmt)))


def read_cameras_bin(path: str) -> dict[int, ColmapCamera]:
    out = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            cid, model_id, w, h = _read(f, "<iiQQ")
            name, np_ = CAMERA_MODELS[model_id]
            params = np.array(_read(f, f"<{np_}d"))
            out[cid] = ColmapCamera(name, int(w), int(h), params)
    return out


def read_images_bin(path: str) -> dict[int, ColmapImage]:
    from divshot_tpu_torch.core import native
    with open(path, "rb") as f:
        res = native.parse_images_bin(f.read())
    if res is not None:
        return {iid: ColmapImage(name, cid, q, t)
                for iid, q, t, cid, name in res}
    return read_images_bin_py(path)


def read_images_bin_py(path: str) -> dict[int, ColmapImage]:
    """``read_images_bin``'s pure-Python path."""
    out = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            iid = _read(f, "<i")[0]
            q = np.array(_read(f, "<4d"))
            t = np.array(_read(f, "<3d"))
            cam_id = _read(f, "<i")[0]
            name = b""
            while True:
                c = f.read(1)
                if c == b"\x00":
                    break
                name += c
            (npts,) = _read(f, "<Q")
            f.read(24 * npts)  # xys + point3D ids
            out[iid] = ColmapImage(name.decode(), cam_id, q, t)
    return out


def read_points3d_bin(path: str) -> tuple[np.ndarray, np.ndarray]:
    from divshot_tpu_torch.core import native
    with open(path, "rb") as f:
        res = native.parse_points3d_bin(f.read())
    if res is not None:
        return res
    return read_points3d_bin_py(path)


def read_points3d_bin_py(path: str) -> tuple[np.ndarray, np.ndarray]:
    """``read_points3d_bin``'s pure-Python path."""
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        pts = np.empty((n, 3), np.float64)
        cols = np.empty((n, 3), np.uint8)
        for i in range(n):
            _pid = _read(f, "<Q")
            pts[i] = _read(f, "<3d")
            cols[i] = _read(f, "<3B")
            _err = _read(f, "<d")
            (track_len,) = _read(f, "<Q")
            f.read(8 * track_len)
    return pts.astype(np.float32), cols.astype(np.float32) / 255.0


def read_cameras_txt(path: str) -> dict[int, ColmapCamera]:
    out = {}
    for line in open(path):
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        tok = line.split()
        out[int(tok[0])] = ColmapCamera(
            tok[1], int(tok[2]), int(tok[3]),
            np.array([float(x) for x in tok[4:]]))
    return out


def read_images_txt(path: str) -> dict[int, ColmapImage]:
    out = {}
    lines = [l.strip() for l in open(path)
             if l.strip() and not l.startswith("#")]
    for i in range(0, len(lines), 2):  # every other line is 2D points
        tok = lines[i].split()
        out[int(tok[0])] = ColmapImage(
            tok[9], int(tok[8]),
            np.array([float(x) for x in tok[1:5]]),
            np.array([float(x) for x in tok[5:8]]))
    return out


def read_points3d_txt(path: str) -> tuple[np.ndarray, np.ndarray]:
    pts, cols = [], []
    for line in open(path):
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        tok = line.split()
        pts.append([float(x) for x in tok[1:4]])
        cols.append([float(x) for x in tok[4:7]])
    return (np.asarray(pts, np.float32),
            np.asarray(cols, np.float32) / 255.0)


def qvec_to_rotmat(q: np.ndarray) -> np.ndarray:
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def intrinsics(cam: ColmapCamera) -> tuple[float, float, float, float]:
    """(fx, fy, cx, cy); distortion params beyond pinhole are ignored (the
    reference restricts SfM to SIMPLE_PINHOLE, editor.cpp:1809)."""
    p = cam.params
    if cam.model in ("SIMPLE_PINHOLE", "SIMPLE_RADIAL", "RADIAL",
                     "SIMPLE_RADIAL_FISHEYE", "RADIAL_FISHEYE"):
        return p[0], p[0], p[1], p[2]
    return p[0], p[1], p[2], p[3]


def find_sparse_dir(source: str) -> str:
    for cand in ("sparse/0", "sparse", "colmap/sparse/0", "."):
        d = os.path.join(source, cand)
        if (os.path.exists(os.path.join(d, "cameras.bin"))
                or os.path.exists(os.path.join(d, "cameras.txt"))):
            return d
    raise FileNotFoundError(f"no COLMAP sparse model under {source}")


def load_sparse_model(sparse_dir: str):
    """-> (cameras dict, images dict, points (P,3), colors (P,3))."""
    if os.path.exists(os.path.join(sparse_dir, "cameras.bin")):
        cams = read_cameras_bin(os.path.join(sparse_dir, "cameras.bin"))
        imgs = read_images_bin(os.path.join(sparse_dir, "images.bin"))
        p3d = os.path.join(sparse_dir, "points3D.bin")
        pts, cols = read_points3d_bin(p3d) if os.path.exists(p3d) else (None, None)
    else:
        cams = read_cameras_txt(os.path.join(sparse_dir, "cameras.txt"))
        imgs = read_images_txt(os.path.join(sparse_dir, "images.txt"))
        p3d = os.path.join(sparse_dir, "points3D.txt")
        pts, cols = read_points3d_txt(p3d) if os.path.exists(p3d) else (None, None)
    return cams, imgs, pts, cols


# ---------------------------------------------------------------------------
# writers (round-trip tests + exportSparsePointCloud parity)


def write_cameras_bin(path: str, cams: dict[int, ColmapCamera]) -> None:
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(cams)))
        for cid, c in cams.items():
            mid, np_ = MODEL_IDS[c.model]
            f.write(struct.pack("<iiQQ", cid, mid, c.width, c.height))
            f.write(struct.pack(f"<{np_}d", *c.params[:np_]))


def write_images_bin(path: str, imgs: dict[int, ColmapImage]) -> None:
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(imgs)))
        for iid, im in imgs.items():
            f.write(struct.pack("<i", iid))
            f.write(struct.pack("<4d", *im.qvec))
            f.write(struct.pack("<3d", *im.tvec))
            f.write(struct.pack("<i", im.camera_id))
            f.write(im.name.encode() + b"\x00")
            f.write(struct.pack("<Q", 0))


def write_points3d_bin(path: str, pts: np.ndarray, cols: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(pts)))
        for i in range(len(pts)):
            f.write(struct.pack("<Q", i))
            f.write(struct.pack("<3d", *pts[i].astype(np.float64)))
            f.write(struct.pack("<3B", *np.clip(cols[i] * 255, 0, 255
                                                ).astype(np.uint8)))
            f.write(struct.pack("<d", 0.0))
            f.write(struct.pack("<Q", 0))
