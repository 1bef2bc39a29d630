"""Live training viewer CLI (counterpart of ``divshot_tpu/apps/viewer.py``):
train a scene while serving the WebGL2 viewer over HTTP (the headless
analog of the reference editor's in-viewport live training view,
``editor.cpp:1556-1575``).

  python -m divshot_tpu_torch.apps.viewer --source_path <scene> \\
      [--port 8123] [--device cuda|cpu] [other trainer flags]
  python -m divshot_tpu_torch.apps.viewer --demo [--num_iters N]

``--demo`` trains from a random init of 100,000 points (in the default
capacity) towards 32 orbit views at 400 px of a 20,000-splat scene, as
JAX's demo does. Runs on the card unless ``--device cpu`` is given.
Returns 1 when the session ends with an error, 2 without a data source.
"""

from __future__ import annotations

import argparse
import sys
import time


def demo_session(cfg, device, **session_kw):
    """The ``--demo`` session, loaded and ready to train: ground truth
    from ``apps.train``'s demo scene (``DEMO_SPLATS`` splats,
    ``DEMO_VIEWS`` orbit views at ``DEMO_WIDTH`` px, black background), no
    seed points, so ``TrainerSession`` initialises 100,000 random points
    in ``cap_max`` capacity. ``session_kw`` goes to ``TrainerSession``."""
    import numpy as np

    from divshot_tpu_torch.apps import train as train_app
    from divshot_tpu_torch.gsio.synthetic import (orbit_cameras,
                                                  random_scene,
                                                  render_gt_images)
    from divshot_tpu_torch.train.session import TrainerSession
    from divshot_tpu_torch.train.trainer import Dataset
    rng = np.random.default_rng(cfg.seed)
    gt = random_scene(rng, train_app.DEMO_SPLATS, sh_degree=cfg.sh_degree,
                      scale_range=(0.004, 0.03), device=device)
    cams = orbit_cameras(train_app.DEMO_VIEWS, width=train_app.DEMO_WIDTH,
                         device=device)
    images = render_gt_images(gt, cams, instance_capacity=1 << 19)
    session = TrainerSession(cfg, device=device, **session_kw)
    session.load_synthetic(Dataset.from_views(cams, images))
    return session


def main(argv=None) -> int:
    import torch

    from divshot_tpu_torch.apps.train import check_flags
    from divshot_tpu_torch.core.config import config_from_flags
    from divshot_tpu_torch.train.session import TrainerSession
    from divshot_tpu_torch.viewer.live import LiveViewerServer

    p = argparse.ArgumentParser(add_help=False, allow_abbrev=False)
    p.add_argument("--demo", action="store_true")
    p.add_argument("--port", type=int, default=8123)
    p.add_argument("--device", default="cuda")
    ns, rest = p.parse_known_args(sys.argv[1:] if argv is None else argv)
    device = torch.device(ns.device)
    cfg = config_from_flags(rest)
    check_flags(cfg)

    if ns.demo:
        session = demo_session(cfg, device)
    else:
        if not cfg.source_path:
            print("error: --source_path required (or --demo)")
            return 2
        session = TrainerSession(cfg, device=device)
        session.load_train_data()
        if session.error:
            print(session.error)
            return 1

    server = LiveViewerServer(session, port=ns.port).start()
    print(f"live viewer: http://127.0.0.1:{server.port}/", flush=True)
    session.start_train()
    try:
        while not session.is_terminated():
            time.sleep(0.2)
    except KeyboardInterrupt:
        session.terminate()
    finally:
        server.stop()
        session.close()
    if session.error:
        print(session.error)
        return 1
    its = session.current_iteration / max(session.train_seconds, 1e-9)
    print(f"training done at iteration {session.current_iteration} "
          f"({its:.1f} it/s); viewer stopped", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
