"""Render CLI, the headless player's fast path (counterpart of
``divshot_tpu/apps/render.py``): load a splat model, render orbit views
with ``render_fast`` and write PNGs.

  python -m divshot_tpu_torch.apps.render --model m.ply --out shots/ \
      --orbit 24 --width 800 --height 600 --fast

Only ``--fast`` is ported. ``--video`` and the differentiable backends
(``--backend``) are not yet, and say so.
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
from divshot_tpu_torch.raster.render import FastBins, render_fast
from divshot_tpu_torch.splat.camera import Camera
from divshot_tpu_torch.splat.gaussians import GaussianParams


def orbit_for_model(params: GaussianParams, num: int, *, radius: float,
                    width: int, height: int, fov: float) -> list[Camera]:
    """Orbit cameras with the radius scaled to the model's extent."""
    means = params.compact_numpy()["means"]
    center = means.mean(0)
    extent = float(np.abs(means - center).max())
    return orbit_cameras(num, radius=radius * max(extent / 1.5, 0.5),
                         width=width, height_px=height, fov_y_deg=fov,
                         device=params.device)


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
    p.add_argument("--video", default=None, help="not ported yet")
    p.add_argument("--fps", type=int, default=30)
    p.add_argument("--backend", default="tiles", help="not ported yet")
    p.add_argument("--fast", action="store_true",
                   help="inference-only fast path (render_fast)")
    p.add_argument("--white_background", action="store_true")
    p.add_argument("--device", default="cuda")
    ns = p.parse_args(argv)
    if not ns.fast:
        raise NotImplementedError(
            "only --fast is ported; the differentiable backends are not yet")
    if ns.video:
        raise NotImplementedError("--video is not ported yet")

    params, meta = load_model(ns.model, device=ns.device)
    print(f"loaded {params.num_alive} splats (sh degree {params.sh_degree}, "
          f"AA {meta.get('antialiased')})")
    cams = orbit_for_model(params, ns.orbit, radius=ns.radius,
                           width=ns.width, height=ns.height, fov=ns.fov)
    bg = [1.0, 1.0, 1.0] if ns.white_background else [0.0, 0.0, 0.0]
    os.makedirs(ns.out, exist_ok=True)
    frames = render_orbit(params, cams,
                          background=torch.tensor(bg, device=params.device),
                          instance_capacity=1 << 20, out_dir=ns.out)
    print(f"rendered {len(frames)} views to {ns.out}/")
    return 0


if __name__ == "__main__":
    sys.exit(main())
