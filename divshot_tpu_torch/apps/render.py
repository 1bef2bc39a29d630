"""Render CLI, the headless player (counterpart of
``divshot_tpu/apps/render.py``): load a splat model, render orbit views
to numbered PNGs and, with ``--video``, an MJPEG AVI.

  python -m divshot_tpu_torch.apps.render --model m.ply --out shots/ \
      --orbit 24 --width 800 --height 600 [--fast] [--video fly.avi]

Without ``--fast`` the views go through ``viewer/offline.render_views``
(``render`` on the route ``--backend`` names: ``"pallas"``, the kernel
route and the port's default, or JAX's ``"tiles"``, its default,
``"dense"`` and ``"surfel"``); ``--fast`` through ``render_fast``. As in
JAX, the ``"tiles"`` route keeps at most ``tile_capacity`` (1024)
instances a tile and drops the farthest past it.

JAX's app bins into a fixed 2^20 instances and drops the rest; the port
keeps 2^20 as the least capacity and grows it to the views' largest
tile-instance demand (``orbit_capacity``), so a model of a million
splats or more renders whole.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

from divshot_tpu_torch.gsio.io import load_model
from divshot_tpu_torch.gsio.png import write_png
from divshot_tpu_torch.gsio.synthetic import orbit_cameras
from divshot_tpu_torch.raster.bin import prep
from divshot_tpu_torch.raster.project import project_gaussians
from divshot_tpu_torch.raster.render import FastBins, render_fast
from divshot_tpu_torch.splat.camera import Camera
from divshot_tpu_torch.splat.gaussians import GaussianParams
from divshot_tpu_torch.viewer.offline import render_views
from divshot_tpu_torch.viewer.video import write_video


def orbit_for_model(params: GaussianParams, num: int, *, radius: float,
                    width: int, height: int, fov: float) -> list[Camera]:
    """Orbit cameras with the radius scaled to the model's extent."""
    means = params.compact_numpy()["means"]
    center = means.mean(0)
    extent = float(np.abs(means - center).max())
    return orbit_cameras(num, radius=radius * max(extent / 1.5, 0.5),
                         width=width, height_px=height, fov_y_deg=fov,
                         device=params.device)


APP_CAPACITY = 1 << 20    # JAX's fixed instance capacity, the least here
GUARD_LANES = 2048        # binning's tail that no tile's range reaches


def orbit_capacity(params: GaussianParams, cams: list[Camera], *,
                   tile_size: int = 16, mt: int = 64) -> tuple[int, int]:
    """-> (instance capacity, the views' largest tile-instance demand):
    ``APP_CAPACITY``, or the next power of two that holds the demand and
    the guard lanes where that is more. The demand is binning's own count
    (``raster/bin.prep``) on the projection both render paths make."""
    demand = 0
    with torch.no_grad():
        opac = params.effective_opacity()
        for cam in cams:
            proj = project_gaussians(params.means, params.scales,
                                     params.quats, cam, opacities=opac)
            p = prep(proj.means2d, proj.depths, proj.radii, proj.radii_xy,
                     proj.rad2, cam.width, cam.height, tile_size, mt)
            demand = max(demand, int(p.total))
    need = demand + GUARD_LANES
    return max(APP_CAPACITY, 1 << (need - 1).bit_length()), demand


def render_orbit(params: GaussianParams, cams: list[Camera], *,
                 background: torch.Tensor, instance_capacity: int,
                 out_dir: str | None = None
                 ) -> list[tuple[torch.Tensor, torch.Tensor, FastBins]]:
    """Render each camera with ``render_fast``; write ``{i:05d}.png`` under
    ``out_dir`` when given. -> per view (image, alpha, bins)."""
    frames = []
    for i, cam in enumerate(cams):
        img, alpha, bins = render_fast(params, cam, background=background,
                                       instance_capacity=instance_capacity)
        if out_dir is not None:
            arr = (torch.clamp(img, 0, 1) * 255).to(torch.uint8)
            write_png(os.path.join(out_dir, f"{i:05d}.png"),
                      arr.cpu().numpy())
        frames.append((img, alpha, bins))
    return frames


def main(argv=None) -> int:
    p = argparse.ArgumentParser("divshot-tpu-torch render")
    p.add_argument("--model", required=True)
    p.add_argument("--out", default="renders")
    p.add_argument("--orbit", type=int, default=12,
                   help="number of orbit cameras")
    p.add_argument("--radius", type=float, default=4.0)
    p.add_argument("--width", type=int, default=800)
    p.add_argument("--height", type=int, default=600)
    p.add_argument("--fov", type=float, default=50.0)
    p.add_argument("--video", default=None, help="write MJPEG .avi")
    p.add_argument("--fps", type=int, default=30)
    p.add_argument("--backend", default="pallas")
    p.add_argument("--fast", action="store_true",
                   help="inference-only fast path (render_fast)")
    p.add_argument("--white_background", action="store_true")
    p.add_argument("--device", default="cuda")
    ns = p.parse_args(argv)

    params, meta = load_model(ns.model, device=ns.device)
    print(f"loaded {params.num_alive} splats (sh degree {params.sh_degree}, "
          f"AA {meta.get('antialiased')})")
    cams = orbit_for_model(params, ns.orbit, radius=ns.radius,
                           width=ns.width, height=ns.height, fov=ns.fov)
    bg = [1.0, 1.0, 1.0] if ns.white_background else [0.0, 0.0, 0.0]
    cap, demand = orbit_capacity(params, cams)
    if cap > APP_CAPACITY:
        print(f"[capacity] the views' largest tile-instance demand {demand} "
              f"passes {APP_CAPACITY}: instance capacity {cap}")
    if ns.fast:
        os.makedirs(ns.out, exist_ok=True)
        frames = [img for img, _alpha, _bins in render_orbit(
            params, cams, background=torch.tensor(bg, device=params.device),
            instance_capacity=cap, out_dir=ns.out)]
    else:
        frames = render_views(params, cams, background=bg, out_dir=ns.out,
                              backend=ns.backend, instance_capacity=cap)
    if ns.video:
        write_video(ns.video, frames, fps=ns.fps)
        print(f"wrote {ns.video}")
    print(f"rendered {len(frames)} views to {ns.out}/")
    return 0


if __name__ == "__main__":
    sys.exit(main())
