"""Post-processing (counterpart of ``divshot_tpu/viewer/post.py``):
tonemaps (linear, Reinhard, ACES, exposure and gamma), TAA (Halton
jitter of the principal point, the 3x3-clamped history blend, the offline
average of jittered renders) and the unsharp-mask sharpen. Tensor ops on
the image's device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F


# -- tonemap ------------------------------------------------------------------


def tonemap_linear(img: torch.Tensor) -> torch.Tensor:
    return torch.clamp(img, 0.0, 1.0)


def tonemap_reinhard(img: torch.Tensor) -> torch.Tensor:
    x = torch.clamp_min(img, 0.0)
    return x / (1.0 + x)


def tonemap_aces(img: torch.Tensor) -> torch.Tensor:
    """Narkowicz's ACES filmic fit."""
    x = torch.clamp_min(img, 0.0)
    a, b, c, d, e = 2.51, 0.03, 2.43, 0.59, 0.14
    return torch.clamp((x * (a * x + b)) / (x * (c * x + d) + e), 0.0, 1.0)


_TONEMAPS = {"linear": tonemap_linear, "reinhard": tonemap_reinhard,
             "aces": tonemap_aces}


def apply_tonemap(img: torch.Tensor, operator: str = "linear", *,
                  exposure: float = 0.0, gamma: float = 1.0) -> torch.Tensor:
    """``exposure`` in stops (2^e); ``gamma`` after the operator."""
    x = img * (2.0 ** exposure)
    x = _TONEMAPS[operator](x)
    if gamma != 1.0:
        x = torch.pow(torch.clamp_min(x, 1e-8), 1.0 / gamma)
    return x


# -- TAA ----------------------------------------------------------------------


def halton(i: int, base: int) -> float:
    f, r = 1.0, 0.0
    while i > 0:
        f /= base
        r += f * (i % base)
        i //= base
    return r


def taa_jitter(frame: int) -> tuple[float, float]:
    """Subpixel jitter in [-0.5, 0.5]^2 of a frame index (Halton 2, 3)."""
    return halton(frame % 8 + 1, 2) - 0.5, halton(frame % 8 + 1, 3) - 0.5


def jitter_camera(camera, frame: int):
    """The camera with the TAA offset on its principal point, added in
    float32 as JAX adds it."""
    jx, jy = taa_jitter(frame)
    return dataclasses.replace(
        camera, cx=float(np.float32(camera.cx) + np.float32(jx)),
        cy=float(np.float32(camera.cy) + np.float32(jy)))


def window_max(x: torch.Tensor, k: int) -> torch.Tensor:
    """k x k max (k odd) over the (H, W) axes of an (H, W) or (H, W, C)
    tensor, "SAME" padded with -inf, as XLA's ``reduce_window``."""
    img = x[None, None] if x.ndim == 2 else x.permute(2, 0, 1)[None]
    out = F.max_pool2d(img, k, stride=1, padding=k // 2)[0]
    return out[0] if x.ndim == 2 else out.permute(1, 2, 0)


def taa_blend(history: torch.Tensor, current: torch.Tensor,
              alpha: float = 0.1) -> torch.Tensor:
    """One TAA history update: the history clamped to the 3x3 min / max
    of the current frame, then the exponential blend."""
    mx = window_max(current, 3)
    mn = -window_max(-current, 3)
    hist = torch.minimum(torch.maximum(history, mn), mx)
    return alpha * current + (1.0 - alpha) * hist


def render_taa(render_fn, camera, n_frames: int = 8) -> torch.Tensor:
    """Offline TAA: the mean of ``n_frames`` camera-jittered renders
    (``render_fn(camera) -> (H, W, C)``)."""
    acc = None
    for i in range(n_frames):
        img = render_fn(jitter_camera(camera, i))
        acc = img if acc is None else acc + img
    return acc / n_frames


# -- sharpen ------------------------------------------------------------------


def sharpen(img: torch.Tensor, amount: float = 0.25) -> torch.Tensor:
    """Unsharp mask with a 3x3 box blur (zero "SAME" padding)."""
    c = img.shape[-1]
    k = torch.full((c, 1, 3, 3), 1.0 / 9.0, dtype=img.dtype,
                   device=img.device)
    blur = F.conv2d(img.permute(2, 0, 1)[None], k, padding=1,
                    groups=c)[0].permute(1, 2, 0)
    return torch.clamp(img + amount * (img - blur), 0.0, 1.0)


def post_process(img: torch.Tensor, *, tonemap: str = "linear",
                 exposure: float = 0.0, gamma: float = 1.0,
                 sharpen_amount: float = 0.0) -> torch.Tensor:
    """The post chain in the reference's order: tonemap, then sharpen."""
    out = apply_tonemap(img, tonemap, exposure=exposure, gamma=gamma)
    if sharpen_amount > 0:
        out = sharpen(out, sharpen_amount)
    return out
