"""Scene components (counterpart of ``divshot_tpu/scene/components.py``):
``GaussianComponent`` (render type, SH0-domain colour grading, crop),
``GaussianCrop`` (at most 8 box / sphere / plane volumes),
``Environment`` (pure colour, analytic sun-sky, image plate) and the
light descriptors.

The environment's image is read by its magic bytes: a Radiance ``.hdr``
with ``gsio/hdr.read_hdr`` (uint8 RGB, each float value times 255, as
``imageio`` returns it through OpenCV), a PNG or JPEG with
``gsio/image.read_image``. It is resized as Pillow's default
``Image.resize`` (bicubic), with JAX's arithmetic kept: the raw 0-255
values are scaled by 255 again and clipped, so every non-zero channel
becomes 255.
"""

from __future__ import annotations

import dataclasses
import enum
from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch

SH_C0 = 0.282094791773878


class GaussianRenderType(enum.IntEnum):
    SPLAT = 0
    POINT = 1
    DEPTH = 2
    NORMAL = 3
    RINGS = 4
    ELLIPSOIDS = 5
    CENTERS = 6


class CropType(enum.IntEnum):
    BOX = 0
    SPHERE = 1
    PLANE = 2


@dataclass
class CropVolume:
    """One crop volume; ``transform`` maps world to crop-local space."""
    type: CropType = CropType.BOX
    center: tuple = (0.0, 0.0, 0.0)
    radius: float = 1.0
    pmin: tuple = (-1.0, -1.0, -1.0)
    pmax: tuple = (1.0, 1.0, 1.0)
    transform: Any = None          # optional (4, 4) world -> local
    invert: bool = False           # keep outside instead of inside

    def contains(self, points: torch.Tensor) -> torch.Tensor:
        """(N,) bool on the points' device: inside the volume (outside
        with ``invert``)."""
        p = points.to(torch.float32)

        def f32(x):
            return torch.as_tensor(np.asarray(x, np.float32),
                                   device=p.device)
        if self.transform is not None:
            m = f32(self.transform)
            p = p @ m[:3, :3].T + m[:3, 3]
        if self.type == CropType.SPHERE:
            inside = torch.linalg.vector_norm(
                p - f32(self.center), dim=-1) <= self.radius
        elif self.type == CropType.PLANE:
            # the half-space below the plane through the centre, normal +Z
            inside = (p[:, 2] - float(self.center[2])) <= 0
        else:
            inside = torch.all((p >= f32(self.pmin)) & (p <= f32(self.pmax)),
                               dim=-1)
        return ~inside if self.invert else inside


@dataclass
class GaussianCrop:
    """Up to 8 volumes; a splat survives if every volume keeps it."""
    volumes: list = field(default_factory=list)
    MAX_VOLUMES = 8

    def add(self, vol: CropVolume) -> None:
        if len(self.volumes) >= self.MAX_VOLUMES:
            raise ValueError("at most 8 crop volumes")
        self.volumes.append(vol)

    def keep_mask(self, points: torch.Tensor) -> torch.Tensor:
        keep = torch.ones((points.shape[0],), dtype=torch.bool,
                          device=points.device)
        for v in self.volumes:
            keep &= v.contains(points)
        return keep


@dataclass
class GaussianComponent:
    """Per-entity splat settings. ``params`` is a ``GaussianParams`` (or
    None until ``load``)."""
    params: Any = None
    path: str = ""
    render_type: GaussianRenderType = GaussianRenderType.SPLAT
    participate_render: bool = True
    skip_render: bool = False
    sh_degree: int = 3
    # SH0-domain colour grading; brightness is an additive offset
    transparency: float = 1.0
    brightness: float = 0.0
    white_point: float = 1.0
    black_point: float = 0.0
    albedo_color: tuple = (1.0, 1.0, 1.0)
    crop: GaussianCrop | None = None

    def load(self, device="cuda"):
        """The params, read from ``path`` onto ``device`` the first
        time."""
        if self.params is None and self.path:
            from divshot_tpu_torch.gsio.io import load_model
            self.params, _ = load_model(self.path, device=device)
        return self.params

    def graded_params(self, device="cuda"):
        """A copy of the params with the colour grading applied: c' =
        from(offset + to(c) * albedo * scale) with to / from the SH0 <->
        colour maps, offset = brightness - black, scale = 1 / (white -
        black); opacity' = logit(sigmoid(o) * transparency); the crop
        clears ``alive`` outside the kept volumes."""
        p = self.load(device)
        albedo = np.asarray(self.albedo_color, np.float32)
        graded = p
        if (np.any(albedo != 1.0) or self.black_point != 0.0
                or self.white_point != 1.0 or self.brightness != 0.0):
            offset = -self.black_point + self.brightness
            scale = 1.0 / max(self.white_point - self.black_point, 1e-6)
            alb = torch.as_tensor(albedo, device=p.device)
            sh0 = ((offset + (p.sh0 * SH_C0 + 0.5) * alb * scale) - 0.5) \
                / SH_C0
            graded = dataclasses.replace(graded, sh0=sh0)
        if self.transparency != 1.0:
            sig = 1.0 / (1.0 + torch.exp(-p.opacity))
            v = torch.clamp(sig * self.transparency, 1e-7, 1.0 - 1e-7)
            graded = dataclasses.replace(
                graded, opacity=torch.log(v) - torch.log1p(-v))
        if self.crop is not None and self.crop.volumes:
            graded = dataclasses.replace(
                graded, alive=graded.alive & self.crop.keep_mask(
                    p.means.detach()))
        return graded


class EnvironmentMode(enum.IntEnum):
    PURE = 0
    SUN_SKY = 1
    HDR = 2


@dataclass
class Environment:
    """Sky / background component."""
    mode: EnvironmentMode = EnvironmentMode.PURE
    sky_ambient: tuple = (0.0, 0.0, 0.0)
    sun_color: tuple = (1.0, 1.0, 1.0)
    intensity: float = 1.0
    theta: float = 0.0          # sun elevation
    phi: float = 0.0            # sun azimuth
    sun_size_multiplier: float = 1.0
    hdr_path: str = ""
    _hdr: Any = None

    def sun_direction(self) -> np.ndarray:
        st, ct = np.sin(self.theta), np.cos(self.theta)
        sp, cp = np.sin(self.phi), np.cos(self.phi)
        return np.asarray([st * cp, ct, st * sp], np.float32)

    def load_hdr(self, path: str | None = None):
        """Read the plate's image (Radiance, PNG or JPEG) as float32
        0-255 values."""
        from divshot_tpu_torch.gsio.hdr import is_hdr, read_hdr
        from divshot_tpu_torch.gsio.image import read_image
        self.hdr_path = path or self.hdr_path
        with open(self.hdr_path, "rb") as f:
            radiance = is_hdr(f.read(2))
        img = read_hdr(self.hdr_path) if radiance else read_image(
            self.hdr_path)
        self._hdr = np.asarray(img, np.float32)
        self.mode = EnvironmentMode.HDR
        return self._hdr

    def background_color(self) -> np.ndarray:
        return np.asarray(self.sky_ambient, np.float32) * self.intensity

    def sample_background(self, width: int, height: int) -> np.ndarray:
        """(H, W, 3) float32 background plate behind the splats."""
        if self.mode == EnvironmentMode.HDR and (
                self._hdr is not None or self.hdr_path):
            from divshot_tpu_torch.gsio.png import resize_bicubic
            if self._hdr is None:
                self.load_hdr()
            img = np.clip(self._hdr * 255, 0, 255).astype(np.uint8)
            img = resize_bicubic(img, width, height)
            return np.asarray(img, np.float32) / 255.0 * self.intensity
        if self.mode == EnvironmentMode.SUN_SKY:
            # analytic gradient sky
            y = np.linspace(1, -1, height, dtype=np.float32)[:, None]
            horizon = np.asarray([0.8, 0.85, 0.95], np.float32)
            zenith = np.asarray([0.25, 0.45, 0.85], np.float32)
            t = np.clip((y + 1) / 2, 0, 1)[..., None]
            sky = horizon * (1 - t) + zenith * t
            return np.broadcast_to(sky, (height, width, 3)) * self.intensity
        return np.broadcast_to(self.background_color(),
                               (height, width, 3)).copy()


class LightType(enum.IntEnum):
    DIRECTIONAL = 0
    POINT = 1
    SPOT = 2
    RECT = 3
    DISK = 4
    CYLINDER = 5


@dataclass
class Light:
    """Analytic light descriptor (splat rendering is emissive)."""
    type: LightType = LightType.POINT
    position: tuple = (0.0, 0.0, 0.0)
    direction: tuple = (0.0, -1.0, 0.0)
    color: tuple = (1.0, 1.0, 1.0)
    intensity: float = 1.0
    range: float = 10.0
    inner_angle: float = 0.3
    outer_angle: float = 0.5
    size: tuple = (1.0, 1.0)


def component_to_dict(obj) -> dict:
    """A component dataclass as JSON-safe primitives."""
    def conv(v):
        if isinstance(v, enum.IntEnum):
            return int(v)
        if isinstance(v, np.ndarray):
            return v.tolist()
        if isinstance(v, (list, tuple)):
            return [conv(x) for x in v]
        if dataclasses.is_dataclass(v) and not isinstance(v, type):
            return component_to_dict(v)
        return v
    out = {"__type__": type(obj).__name__}
    for f in dataclasses.fields(obj):
        if f.name.startswith("_") or f.name in ("params",):
            continue
        out[f.name] = conv(getattr(obj, f.name))
    return out
