"""Headless trainer CLI (counterpart of ``divshot_tpu/apps/train.py``).

  python -m divshot_tpu_torch.apps.train --demo [--iterations N]
      [--device cuda|cpu] [other trainer flags]

``--demo`` trains on a synthetic scene, as the JAX app does: 20K ground-
truth splats rendered from 32 orbit views at 400 px, and a fresh model
initialised from every fourth ground-truth centre. Progress goes to
standard output; the app writes no file.

Ported: the static trainer, 3DGS and 2DGS (``--model_type 1``, exact
surfels by default, ``--surfel_exact 0`` the flattened approximation),
the geometry losses, and the ADC, ADC+ and MCMC strategies. The flags of
what is not ported yet (datasets, checkpoints, evaluation, PLY and mesh
export and the other options the trainer rejects) raise
``NotImplementedError`` naming ROADMAP.md.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

# the --demo scene, as in the JAX app: ground-truth splats, orbit views and
# their width in pixels
DEMO_SPLATS = 20_000
DEMO_VIEWS = 32
DEMO_WIDTH = 400

# flags of the JAX app whose features are not ported, as (config field,
# what it needs)
_UNPORTED_FIELDS = (
    ("source_path", "dataset loaders"),
    ("dataset_type", "dataset loaders"),
    ("max_image_width", "dataset loaders"),
    ("max_image_height", "dataset loaders"),
    ("max_image_count", "dataset loaders"),
    ("model_path", "checkpoints and PLY export"),
    ("checkpoint_every", "checkpoints"),
    ("load_itr", "checkpoint resume"),
    ("eval_holdout", "evaluation"),
    ("eval_every", "evaluation"),
    ("export_mesh", "mesh export"),
    ("mesh_resolution", "mesh export"),
)


def check_flags(cfg) -> None:
    """Raise ``NotImplementedError`` for a flag whose feature is not
    ported."""
    from divshot_tpu_torch.core.config import TrainConfig
    from divshot_tpu_torch.train.trainer import check_supported
    default = TrainConfig()
    for field, what in _UNPORTED_FIELDS:
        if getattr(cfg, field) != getattr(default, field):
            raise NotImplementedError(
                f"--{field}: {what} are not ported to divshot_tpu_torch "
                f"yet (ROADMAP.md, Queue A)")
    check_supported(cfg)


def run(argv=None, callback=None):
    """What the command line runs -> the ``Trainer`` after its steps, or
    None when no data source is given. ``callback(i, state, metrics)``,
    when given, is called after each step."""
    import torch

    from divshot_tpu_torch.core.config import (auto_tune_config,
                                               config_from_flags)
    from divshot_tpu_torch.gsio.synthetic import (orbit_cameras,
                                                  random_scene,
                                                  render_gt_images)
    from divshot_tpu_torch.splat.gaussians import init_from_points
    from divshot_tpu_torch.train.trainer import Dataset, Trainer

    p = argparse.ArgumentParser(add_help=False, allow_abbrev=False)
    p.add_argument("--demo", action="store_true")
    p.add_argument("--device", default="cuda")
    ns, rest = p.parse_known_args(sys.argv[1:] if argv is None else argv)
    device = torch.device(ns.device)
    cfg = config_from_flags(rest)
    check_flags(cfg)
    if not ns.demo:
        print("error: --demo is the only data source ported so far "
              "(dataset loaders: ROADMAP.md, Queue A)")
        return None

    t0 = time.perf_counter()
    rng = np.random.default_rng(cfg.seed)
    gt = random_scene(rng, DEMO_SPLATS, sh_degree=cfg.sh_degree,
                      scale_range=(0.004, 0.03), device=device)
    cams = orbit_cameras(DEMO_VIEWS, width=DEMO_WIDTH, device=device)
    bg = [1.0, 1.0, 1.0] if cfg.white_background else None
    images = render_gt_images(gt, cams, background=bg,
                              instance_capacity=1 << 19)
    ds = Dataset.from_views(cams, images)
    points = gt.means.cpu().numpy()[::4]
    colors = np.full((points.shape[0], 3), 0.5, np.float32)
    cfg = auto_tune_config(cfg, ds.num_views)
    params = init_from_points(points, colors, sh_degree=cfg.sh_degree,
                              capacity=int(cfg.densify.cap_max),
                              device=device)
    trainer = Trainer(cfg, ds, params)
    n = cfg.num_iters
    print(f"demo: {ds.num_views} views at {cams[0].width}x{cams[0].height}, "
          f"{points.shape[0]} initial splats, capacity {params.capacity}, "
          f"{n} iterations on {device} (set-up "
          f"{time.perf_counter() - t0:.1f} s)", flush=True)

    every = max(1, min(100, n // 10))
    t_run = time.perf_counter()

    def report(i, state, m):
        step = i + 1
        if step == 1 or step % every == 0 or step == n:
            trainer.check_overflow(m)
            print(f"[{step}/{n}] loss={float(m['loss']):.4f} "
                  f"psnr={float(m['psnr']):.2f} "
                  f"alive={int(m['num_alive'])} "
                  f"({step / (time.perf_counter() - t_run):.1f} it/s)",
                  flush=True)
        if callback is not None:
            callback(i, state, m)

    trainer.run(n, log_every=0, callback=report)
    return trainer


def main(argv=None) -> int:
    return 2 if run(argv) is None else 0


if __name__ == "__main__":
    sys.exit(main())
