"""Offscreen rendering (counterpart of ``divshot_tpu/viewer/offline.py``):
batches of views to numbered PNGs (``gsio/png.write_png``) and keyframed
fly-throughs to MJPEG video, through ``render`` on any of its routes
(``backend``, passed through with the other render arguments). JAX's
default backend is XLA's ``"tiles"``; the port's is the kernel route,
``"pallas"`` (the expand and forward kernels on a card).
"""

from __future__ import annotations

import os

import torch

from divshot_tpu_torch.gsio.png import write_png
from divshot_tpu_torch.raster.render import render
from divshot_tpu_torch.splat.camera import Camera
from divshot_tpu_torch.splat.gaussians import GaussianParams
from divshot_tpu_torch.viewer.keyframes import KeyFrameTimeline


def render_views(params: GaussianParams, cameras: list[Camera], *,
                 background=None, out_dir: str | None = None,
                 backend: str = "pallas", **render_kw) -> list[torch.Tensor]:
    """Render each camera (no autograd) -> (H, W, 3) images clipped to
    [0, 1] on the params' device; with ``out_dir``, also ``{i:05d}.png``
    there."""
    dev = params.device
    bg = torch.zeros((3,), device=dev) if background is None else \
        torch.as_tensor(background, dtype=torch.float32, device=dev)
    imgs = []
    with torch.no_grad():
        for i, cam in enumerate(cameras):
            img = render(params, cam, background=bg, backend=backend,
                         **render_kw).image.clamp(0, 1)
            imgs.append(img)
            if out_dir:
                os.makedirs(out_dir, exist_ok=True)
                write_png(os.path.join(out_dir, f"{i:05d}.png"),
                          (img * 255).to(torch.uint8).cpu().numpy())
    return imgs


def render_path(params: GaussianParams, timeline: KeyFrameTimeline, *,
                width: int = 1280, height: int = 720, fps: int = 30,
                video_path: str | None = None, background=None,
                backend: str = "pallas", **render_kw) -> list[torch.Tensor]:
    """Render a keyframed fly-through; with ``video_path``, also an MJPEG
    AVI."""
    n_frames = max(1, int(round(timeline.duration * fps)) + 1)
    cams = [timeline.camera_at(i / fps, width, height, device=params.device)
            for i in range(n_frames)]
    frames = render_views(params, cams, background=background,
                          backend=backend, **render_kw)
    if video_path:
        from divshot_tpu_torch.viewer.video import write_video
        write_video(video_path, frames, fps=fps)
    return frames
