"""Pinhole camera (counterpart of ``divshot_tpu/splat/camera.py:16-79``).

Convention: COLMAP / standard 3DGS. View space looks down +Z, ``viewmat`` is
world-to-camera (R|t), pixel (0, 0) is the top-left corner and the principal
point (cx, cy) is in pixels.

The intrinsics are Python floats holding float32 values, exactly what the
JAX camera keeps as float32 scalars. ``viewmat`` is a (4, 4) float32 numpy
array on the host, so the projection reads the pose as Python floats
without waiting on the card; ``campos`` is made once, on the camera's
device, when the camera is built.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch


def _f32(x) -> float:
    return float(np.float32(x))


@dataclass(frozen=True, eq=False)
class Camera:
    viewmat: np.ndarray  # (4, 4) float32 world-to-camera, on the host
    fx: float
    fy: float
    cx: float
    cy: float
    width: int
    height: int
    device: torch.device | str = "cuda"
    # camera centre in world space, -R^T t, (3,) on ``device``
    campos: torch.Tensor = field(init=False, repr=False)

    def __post_init__(self):
        viewmat = np.array(self.viewmat, np.float32).reshape(4, 4)
        vm = torch.from_numpy(viewmat)
        campos = -torch.einsum("ji,j->i", vm[:3, :3], vm[:3, 3])
        object.__setattr__(self, "viewmat", viewmat)
        object.__setattr__(self, "device", torch.device(self.device))
        object.__setattr__(self, "campos", campos.to(self.device))

    @property
    def rotation(self) -> list[list[float]]:
        """The 3x3 rotation as nested Python floats (float32 values)."""
        return self.viewmat[:3, :3].tolist()

    @property
    def translation(self) -> list[float]:
        return self.viewmat[:3, 3].tolist()

    @property
    def tan_fovx(self) -> float:
        return _f32(np.float32(0.5 * self.width) / np.float32(self.fx))

    @property
    def tan_fovy(self) -> float:
        return _f32(np.float32(0.5 * self.height) / np.float32(self.fy))

    @classmethod
    def from_Rt(cls, R: np.ndarray, t: np.ndarray, fx, fy, cx, cy,
                width: int, height: int, *, device="cuda") -> "Camera":
        viewmat = np.eye(4, dtype=np.float32)
        viewmat[:3, :3] = R
        viewmat[:3, 3] = t
        return cls(viewmat=viewmat, fx=_f32(fx), fy=_f32(fy), cx=_f32(cx),
                   cy=_f32(cy), width=int(width), height=int(height),
                   device=device)

    @classmethod
    def from_numpy(cls, d: dict, *, device="cuda") -> "Camera":
        """Carry a JAX camera across: ``d`` holds its fields as numpy
        values (``viewmat``, ``fx``, ``fy``, ``cx``, ``cy``, ``width``,
        ``height``)."""
        return cls(viewmat=d["viewmat"], fx=_f32(d["fx"]), fy=_f32(d["fy"]),
                   cx=_f32(d["cx"]), cy=_f32(d["cy"]), width=int(d["width"]),
                   height=int(d["height"]), device=device)

    @classmethod
    def look_at(cls, eye, target, up, fov_y_deg: float, width: int,
                height: int, *, device="cuda") -> "Camera":
        eye = np.asarray(eye, np.float64)
        fwd = np.asarray(target, np.float64) - eye
        fwd /= np.linalg.norm(fwd)
        right = np.cross(fwd, np.asarray(up, np.float64))
        right /= np.linalg.norm(right)
        down = np.cross(fwd, right)
        R = np.stack([right, down, fwd])  # rows: camera axes in world
        t = -R @ eye
        fy = 0.5 * height / np.tan(np.radians(fov_y_deg) / 2)
        return cls.from_Rt(R, t, fy, fy, width / 2, height / 2, width,
                           height, device=device)
