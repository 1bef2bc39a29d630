"""Camera-pose readers for nerfstudio, OpenSfM, RealityCapture CSV and
Agisoft Metashape XML (counterpart of ``divshot_tpu/gsio/readers.py``).
Each returns ``(cameras, image_paths, points, colors)``: COLMAP-convention
world-to-camera (+Z forward) cameras on ``device``, and the seed cloud or
None; ``gsio/datasets.load_dataset`` turns them into a ``Dataset``.

Where JAX reads an image's size with Pillow (a nerfstudio frame without
``w`` / ``h``, a RealityCapture row without ``width`` / ``height``), the
port reads it from the file's header (``gsio/image.image_size``: a PNG's
IHDR chunk, a JPEG's SOF header); a file that is neither raises the JAX
function's own error there ("image size unknown; pass width=/height=").
"""

from __future__ import annotations

import json
import os
import xml.etree.ElementTree as ET

import numpy as np

from divshot_tpu_torch.gsio.ply import read_ply_header
from divshot_tpu_torch.gsio.image import image_size
from divshot_tpu_torch.splat.camera import Camera


def _image_size(path: str) -> tuple[int, int]:
    size = image_size(path) if os.path.exists(path) else None
    if size is None:
        raise ValueError("image size unknown; pass width=/height=")
    return size


def _rotmat_from_c2w_gl(c2w: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """OpenGL-convention camera-to-world -> (R, t) world-to-camera,
    COLMAP axes."""
    c2w = np.asarray(c2w, np.float64).copy()
    if c2w.shape == (3, 4):
        c2w = np.vstack([c2w, [0, 0, 0, 1]])
    c2w[:3, 1:3] *= -1.0
    w2c = np.linalg.inv(c2w)
    return w2c[:3, :3], w2c[:3, 3]


# ---------------------------------------------------------------------------
# nerfstudio transforms.json


def load_nerfstudio(path: str, *, device="cuda"):
    """``transforms.json``: per-frame or global intrinsics (fl_x, fl_y,
    cx, cy, w, h), an OpenGL camera-to-world ``transform_matrix``, and an
    optional ``ply_file_path`` seed cloud."""
    root = os.path.dirname(os.path.abspath(path))
    with open(path) as f:
        meta = json.load(f)

    def g(fr, key, default=None):
        return fr.get(key, meta.get(key, default))

    cameras, paths = [], []
    for fr in meta["frames"]:
        w, h = int(g(fr, "w", 0)), int(g(fr, "h", 0))
        fx = float(g(fr, "fl_x"))
        fy = float(g(fr, "fl_y", fx))
        cx = float(g(fr, "cx", w / 2))
        cy = float(g(fr, "cy", h / 2))
        R, t = _rotmat_from_c2w_gl(np.array(fr["transform_matrix"]))
        img = fr["file_path"]
        img_path = img if os.path.isabs(img) else os.path.join(root, img)
        if w == 0 or h == 0:
            w, h = _image_size(img_path)
        cameras.append(Camera.from_Rt(R, t, fx, fy, cx, cy, w, h,
                                      device=device))
        paths.append(img_path)

    points = colors = None
    ply_rel = meta.get("ply_file_path")
    if ply_rel:
        ply_path = os.path.join(root, ply_rel)
        if os.path.exists(ply_path):
            points, colors = _load_seed_ply(ply_path)
    return cameras, paths, points, colors


def _load_seed_ply(path: str):
    """An xyz (+ rgb) point-cloud PLY -> (points, colours in [0, 1] or
    None); (None, None) when it cannot be read."""
    try:
        with open(path, "rb") as f:
            elements, _comments, _fmt = read_ply_header(f)
            for el in elements:
                dt = np.dtype([(name, t) for t, name in el.props])
                el.data = np.frombuffer(f.read(dt.itemsize * el.count),
                                        dtype=dt, count=el.count)
    except Exception:
        return None, None
    v = next((el.data for el in elements if el.name == "vertex"), None)
    if v is None or "x" not in v.dtype.names:
        return None, None
    pts = np.stack([v["x"], v["y"], v["z"]], -1).astype(np.float32)
    cols = None
    if "red" in v.dtype.names:
        cols = np.stack([v["red"], v["green"], v["blue"]],
                        -1).astype(np.float32)
        if cols.max() > 1.5:
            cols /= 255.0
    return pts, cols


# ---------------------------------------------------------------------------
# OpenSfM reconstruction.json


def load_opensfm(path: str, *, device="cuda"):
    """``reconstruction.json``: a list of reconstructions, each with
    ``cameras`` (perspective, normalised focal), ``shots`` (axis-angle
    rotation and translation, world-to-camera) and ``points``."""
    with open(path) as f:
        recs = json.load(f)
    if isinstance(recs, dict):
        recs = [recs]
    root = os.path.dirname(os.path.abspath(path))
    img_root = os.path.join(root, "images")

    cameras, paths = [], []
    all_pts, all_cols = [], []
    for rec in recs:
        cams = rec.get("cameras", {})
        for name, shot in sorted(rec.get("shots", {}).items()):
            cm = cams.get(shot.get("camera"), {})
            w = int(cm.get("width", 0))
            h = int(cm.get("height", 0))
            if w == 0 or h == 0:
                continue
            # normalised focal: f in pixels = f * max(w, h)
            scale = max(w, h)
            proj = cm.get("projection_type", "perspective")
            if proj not in ("perspective", "brown", "simple_radial"):
                continue   # fisheye and spherical are not taken
            fx = float(cm.get("focal", cm.get("focal_x", 0.85))) * scale
            fy = float(cm.get("focal_y", cm.get("focal", 0.85))) * scale \
                if "focal_y" in cm else fx
            cx = w / 2 + float(cm.get("c_x", 0.0)) * scale
            cy = h / 2 + float(cm.get("c_y", 0.0)) * scale
            R = _axis_angle_to_R(np.asarray(shot["rotation"], np.float64))
            t = np.asarray(shot["translation"], np.float64)
            cameras.append(Camera.from_Rt(R, t, fx, fy, cx, cy, w, h,
                                          device=device))
            paths.append(os.path.join(img_root, name))
        for p in rec.get("points", {}).values():
            all_pts.append(p["coordinates"])
            all_cols.append(np.asarray(p.get("color", [128, 128, 128]),
                                       np.float32) / 255.0)
    pts = np.asarray(all_pts, np.float32) if all_pts else None
    cols = np.asarray(all_cols, np.float32) if all_cols else None
    return cameras, paths, pts, cols


def _axis_angle_to_R(rvec: np.ndarray) -> np.ndarray:
    theta = np.linalg.norm(rvec)
    if theta < 1e-12:
        return np.eye(3)
    k = rvec / theta
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(theta) * K + (1 - np.cos(theta)) * (K @ K)


# ---------------------------------------------------------------------------
# RealityCapture CSV (the internal / external camera parameters export)


def load_realitycapture(path: str, *, width: int = 0, height: int = 0,
                        sensor_width_mm: float = 36.0, device="cuda"):
    """RealityCapture CSV: a header ``#name,x,y,z,heading,pitch,roll,f,px,
    py,k1...``; the position in world units, heading, pitch and roll in
    degrees, f the 35 mm-equivalent focal. The image size comes from each
    PNG's header (or ``width`` / ``height``)."""
    rows = []
    header = None
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            if line.startswith("#"):
                header = [c.strip().lower() for c in line[1:].split(",")]
                continue
            rows.append([c.strip() for c in line.split(",")])
    if header is None:
        header = ["name", "x", "y", "z", "heading", "pitch", "roll",
                  "f", "px", "py"]
    idx = {k: i for i, k in enumerate(header)}
    if not {"name", "x", "heading", "f"} <= set(idx):
        raise ValueError(f"unrecognized RealityCapture CSV header: {header}")

    root = os.path.dirname(os.path.abspath(path))
    cameras, paths = [], []
    for r in rows:
        name = r[idx["name"]]
        img_path = name if os.path.isabs(name) else os.path.join(root, name)
        w, h = width, height
        if w == 0 or h == 0:
            w, h = _image_size(img_path)
        x, y, z = (float(r[idx[k]]) for k in ("x", "y", "z"))
        heading, pitch, roll = (float(r[idx[k]])
                                for k in ("heading", "pitch", "roll"))
        f35 = float(r[idx["f"]])
        fx = f35 / sensor_width_mm * max(w, h)
        cx = w / 2 + (float(r[idx["px"]]) * w if "px" in idx else 0.0)
        cy = h / 2 + (float(r[idx["py"]]) * h if "py" in idx else 0.0)
        R = _ypr_to_R(heading, pitch, roll).T
        t = -R @ np.array([x, y, z], np.float64)
        cameras.append(Camera.from_Rt(R, t, fx, fx, cx, cy, w, h,
                                      device=device))
        paths.append(img_path)
    return cameras, paths, None, None


def _ypr_to_R(heading: float, pitch: float, roll: float) -> np.ndarray:
    """Yaw-pitch-roll (degrees) -> camera-to-world rotation."""
    a, b, c = np.deg2rad([heading, pitch, roll])
    cz = np.array([[np.cos(a), -np.sin(a), 0],
                   [np.sin(a), np.cos(a), 0], [0, 0, 1]])
    cy_ = np.array([[np.cos(b), 0, np.sin(b)], [0, 1, 0],
                    [-np.sin(b), 0, np.cos(b)]])
    cx_ = np.array([[1, 0, 0], [0, np.cos(c), -np.sin(c)],
                    [0, np.sin(c), np.cos(c)]])
    return cz @ cy_ @ cx_


# ---------------------------------------------------------------------------
# Agisoft Metashape camera XML


def load_metashape(path: str, *, images_dir: str | None = None,
                   device="cuda"):
    """Metashape ``doc.xml`` or exported cameras XML: each sensor's
    calibration (f, cx and cy offsets, resolution) and each camera's 4x4
    camera-to-world ``transform`` in chunk coordinates, under an optional
    chunk transform (rotation, translation, scale)."""
    root_el = ET.parse(path).getroot()
    chunk = root_el.find(".//chunk")
    if chunk is None:
        chunk = root_el

    sensors = {}
    for s in chunk.findall(".//sensor"):
        calib = s.find("calibration")
        if calib is None:
            continue
        res = calib.find("resolution")
        w = int(res.get("width")) if res is not None else 0
        h = int(res.get("height")) if res is not None else 0

        def fl(tag, default=0.0):
            el = calib.find(tag)
            return float(el.text) if el is not None and el.text else default

        f = fl("f")
        fx = fl("fx", f)
        fy = fl("fy", f)
        sensors[s.get("id")] = (fx or f, fy or f, w / 2 + fl("cx"),
                                h / 2 + fl("cy"), w, h)

    # the chunk transform (region -> world); cameras are in chunk space
    T_chunk = np.eye(4)
    tr = chunk.find("transform")
    if tr is not None:
        rot = tr.find("rotation")
        tra = tr.find("translation")
        sc = tr.find("scale")
        if rot is not None and rot.text:
            T_chunk[:3, :3] = np.fromstring(rot.text, sep=" ").reshape(3, 3)
        if sc is not None and sc.text:
            T_chunk[:3, :3] *= float(sc.text)
        if tra is not None and tra.text:
            T_chunk[:3, 3] = np.fromstring(tra.text, sep=" ")

    src_root = os.path.dirname(os.path.abspath(path))
    img_root = images_dir or os.path.join(src_root, "images")
    cameras, paths = [], []
    for cam in chunk.findall(".//camera"):
        tr_el = cam.find("transform")
        if tr_el is None or not tr_el.text:
            continue
        c2w = T_chunk @ np.fromstring(tr_el.text, sep=" ").reshape(4, 4)
        w2c = np.linalg.inv(c2w)       # Metashape cameras look down +Z
        sid = cam.get("sensor_id")
        if sid not in sensors:
            continue
        fx, fy, cx, cy, w, h = sensors[sid]
        label = cam.get("label") or cam.get("id")
        cameras.append(Camera.from_Rt(w2c[:3, :3], w2c[:3, 3], fx, fy, cx,
                                      cy, w, h, device=device))
        paths.append(os.path.join(img_root, label))
    return cameras, paths, None, None
