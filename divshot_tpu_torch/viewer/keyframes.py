"""Camera keyframe timeline (counterpart of
``divshot_tpu/viewer/keyframes.py``): keyframes of rotation (quaternion),
position, field of view, slice, scale and aperture, interpolated by slerp
and Catmull-Rom (or linearly). Host numpy; ``camera_at`` builds the
port's ``Camera`` on a device.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from divshot_tpu_torch.splat.camera import Camera
from divshot_tpu_torch.splat.math import quat_to_rotmat


@dataclass
class CameraKeyFrame:
    time: float
    quat: np.ndarray       # (4,) wxyz camera rotation (world from camera)
    pos: np.ndarray        # (3,) camera centre
    fov_y_deg: float = 50.0
    slice: float = 0.0     # legacy 4D slice variable
    scale: float = 1.0
    aperture: float = 0.0


def _slerp(q0, q1, t):
    d = float(np.dot(q0, q1))
    if d < 0:
        q1, d = -q1, -d
    if d > 0.9995:
        out = q0 + t * (q1 - q0)
        return out / np.linalg.norm(out)
    th = np.arccos(np.clip(d, -1, 1))
    return (np.sin((1 - t) * th) * q0 + np.sin(t * th) * q1) / np.sin(th)


def _catmull_rom(p0, p1, p2, p3, t):
    t2, t3 = t * t, t * t * t
    return 0.5 * ((2 * p1) + (-p0 + p2) * t
                  + (2 * p0 - 5 * p1 + 4 * p2 - p3) * t2
                  + (-p0 + 3 * p1 - 3 * p2 + p3) * t3)


@dataclass
class KeyFrameTimeline:
    frames: list[CameraKeyFrame] = field(default_factory=list)
    spline: bool = True      # Catmull-Rom positions

    def add(self, kf: CameraKeyFrame) -> None:
        self.frames.append(kf)
        self.frames.sort(key=lambda f: f.time)

    @property
    def duration(self) -> float:
        return self.frames[-1].time if self.frames else 0.0

    def sample(self, t: float) -> CameraKeyFrame:
        fs = self.frames
        if not fs:
            raise ValueError("empty timeline")
        if t <= fs[0].time or len(fs) == 1:
            return fs[0]
        if t >= fs[-1].time:
            return fs[-1]
        i = max(0, next(k for k in range(len(fs) - 1)
                        if fs[k + 1].time > t))
        f0, f1 = fs[i], fs[i + 1]
        u = (t - f0.time) / max(f1.time - f0.time, 1e-9)
        if self.spline and len(fs) >= 2:
            pm = fs[max(i - 1, 0)].pos
            pp = fs[min(i + 2, len(fs) - 1)].pos
            pos = _catmull_rom(np.asarray(pm), np.asarray(f0.pos),
                               np.asarray(f1.pos), np.asarray(pp), u)
        else:
            pos = (1 - u) * np.asarray(f0.pos) + u * np.asarray(f1.pos)
        quat = _slerp(np.asarray(f0.quat, np.float64),
                      np.asarray(f1.quat, np.float64), u)
        return CameraKeyFrame(
            time=t, quat=quat, pos=pos,
            fov_y_deg=(1 - u) * f0.fov_y_deg + u * f1.fov_y_deg,
            slice=(1 - u) * f0.slice + u * f1.slice,
            scale=(1 - u) * f0.scale + u * f1.scale,
            aperture=(1 - u) * f0.aperture + u * f1.aperture)

    def camera_at(self, t: float, width: int, height: int, *,
                  device="cuda") -> Camera:
        kf = self.sample(t)
        q = torch.as_tensor(np.asarray(kf.quat, np.float32))
        Rwc = quat_to_rotmat(q).numpy()
        R = Rwc.T                       # world to camera
        tvec = -R @ np.asarray(kf.pos)
        fy = 0.5 * height / np.tan(np.radians(kf.fov_y_deg) / 2)
        return Camera.from_Rt(R, tvec, fy, fy, width / 2, height / 2,
                              width, height, device=device)
