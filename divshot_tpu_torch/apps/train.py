"""Headless trainer CLI (counterpart of ``divshot_tpu/apps/train.py``).

  python -m divshot_tpu_torch.apps.train --source_path <scene> \\
      --model_path out/ [--eval_every N] [--checkpoint_every M] \\
      [--load_itr -2] [--device cuda|cpu] [other trainer flags]
  python -m divshot_tpu_torch.apps.train --demo [--iterations N]

The JAX app's flow: load the dataset (blender or COLMAP, ``gsio/datasets``;
with no seed points, a random init in the cube +-1.3) or, with ``--demo``,
the synthetic scene (20K ground-truth splats rendered from 32 orbit views
at 400 px, no eval split); resume from ``--load_itr`` (-2: the latest
checkpoint); train, writing ``metrics.csv`` every 100 steps, a checkpoint
every ``checkpoint_every`` steps once past ``reset_alpha_every``, and the
eval curve ``eval_curve.json`` every ``eval_every`` steps (a resumed run
keeps the entries up to its start); then the final checkpoint, the final
``point_cloud.ply`` (on 2DGS with the flat third axis) and the final eval.
Progress goes to standard output. Runs on the card unless ``--device cpu``
is given.

Ported: the static trainer, 3DGS and 2DGS (``--model_type 1``, exact
surfels by default, ``--surfel_exact 0`` the flattened approximation),
the geometry losses, the ADC, ADC+ and MCMC strategies, and the options
``--enable_bg`` (the envmap background; eval keeps JAX's flat
background), ``--use_mask`` (masks from a masks folder or the PNGs'
alpha), ``--progressive_train`` with ``--resolution_schedule``,
``--pack_level`` and ``--debug_nan`` (``FloatingPointError`` naming the
stage that made a NaN). As in JAX there is no batch-size flag, and
``--export_mesh`` / ``--mesh_resolution`` are taken and do nothing more.

``--model_type 2`` (the deformation MLP) and ``3`` (the HexPlane field)
train the dynamic models on a dataset with per-view times (the D-NeRF
layout: ``time`` in each blender frame) through ``models/dynamic.py``,
the kernels' route on every platform (JAX: XLA's tiles off the TPU):
``metrics.csv``, the whole dynamic state in ``iteration_N/state.pt`` every
``checkpoint_every`` steps and at the end, ``eval_curve.json`` at each
test view's own time, and the canonical ``point_cloud.ply``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

# the --demo scene, as in the JAX app: ground-truth splats, orbit views and
# their width in pixels
DEMO_SPLATS = 20_000
DEMO_VIEWS = 32
DEMO_WIDTH = 400

def check_flags(cfg) -> None:
    """Raise ``NotImplementedError`` for a flag whose feature is not
    ported (only multi-chip training is not). ``--export_mesh`` and
    ``--mesh_resolution`` are taken and, as in JAX's app, do nothing more
    here."""
    from divshot_tpu_torch.train.trainer import check_supported
    check_supported(cfg)


def _demo_data(cfg, device):
    from divshot_tpu_torch.gsio.synthetic import (orbit_cameras,
                                                  random_scene,
                                                  render_gt_images)
    from divshot_tpu_torch.train.trainer import Dataset
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
    return ds, None, points, colors


def _dataset(cfg, device):
    from divshot_tpu_torch.gsio.datasets import load_dataset
    ds, eval_ds = load_dataset(
        cfg.source_path, cfg.dataset_type, device=device,
        max_width=cfg.max_image_width, max_height=cfg.max_image_height,
        eval_holdout=cfg.eval_holdout, max_images=cfg.max_image_count,
        white_background=cfg.white_background, use_mask=cfg.use_mask)
    points, colors = ds.points, ds.colors
    if points is None:
        # no SfM cloud (blender): a random init in the cameras' bounds
        rng = np.random.default_rng(cfg.seed)
        n0 = min(100_000, int(cfg.densify.cap_max))
        points = rng.uniform(-1.3, 1.3, (n0, 3)).astype(np.float32)
        colors = rng.uniform(0, 1, (n0, 3)).astype(np.float32)
    return ds, eval_ds, points, colors


def run(argv=None, callback=None, max_steps: int | None = None):
    """What the command line runs -> the ``Trainer`` after its steps, or
    None when no data source is given. ``callback(i, state, metrics)``,
    when given, is called after each step. ``max_steps`` stops the run
    after that many steps of this call (the schedules still follow
    ``num_iters``); the final checkpoint, PLY and eval are then at the
    step reached."""
    import torch

    from divshot_tpu_torch.core.config import (ModelType, auto_tune_config,
                                               config_from_flags)
    from divshot_tpu_torch.core.metrics import (MetricsWriter, PhaseTracker,
                                                TrainingStatus)
    from divshot_tpu_torch.gsio.ply import save_ply
    from divshot_tpu_torch.splat.gaussians import init_from_points
    from divshot_tpu_torch.train import checkpoint as CK
    from divshot_tpu_torch.train.evaluate import evaluate
    from divshot_tpu_torch.train.geometry import flatten_to_surfels
    from divshot_tpu_torch.train.trainer import Trainer

    p = argparse.ArgumentParser(add_help=False, allow_abbrev=False)
    p.add_argument("--demo", action="store_true")
    p.add_argument("--device", default="cuda")
    ns, rest = p.parse_known_args(sys.argv[1:] if argv is None else argv)
    device = torch.device(ns.device)
    cfg = config_from_flags(rest)
    check_flags(cfg)
    phase = PhaseTracker()
    phase.set(TrainingStatus.LOADING_PREPARE)

    t0 = time.perf_counter()
    if ns.demo:
        ds, eval_ds, points, colors = _demo_data(cfg, device)
    elif not cfg.source_path:
        print("error: --source_path required (or --demo)")
        return None
    else:
        ds, eval_ds, points, colors = _dataset(cfg, device)
    cfg = auto_tune_config(cfg, ds.num_views)
    phase.set(TrainingStatus.GS)
    params = init_from_points(points, colors, sh_degree=cfg.sh_degree,
                              capacity=int(cfg.densify.cap_max),
                              device=device)
    phase.set(TrainingStatus.PREPROCESS_DONE)
    model_path = cfg.model_path or "output"
    os.makedirs(model_path, exist_ok=True)
    if cfg.model_type in (ModelType.DEFORM, ModelType.HEXPLANE):
        return _train_dynamic(cfg, ds, eval_ds, params, model_path, phase,
                              callback, max_steps)
    surfel2d = cfg.model_type == ModelType.GS2D
    trainer = Trainer(cfg, ds, params)
    cam0 = ds.cameras[0]
    print(f"{'demo' if ns.demo else cfg.source_path}: {ds.num_views} "
          f"views at {cam0.width}x{cam0.height}"
          + (f" ({eval_ds.num_views} eval)" if eval_ds is not None else "")
          + f", {points.shape[0]} initial splats, capacity "
          f"{params.capacity}, {cfg.num_iters} iterations on {device} "
          f"(set-up {time.perf_counter() - t0:.1f} s)", flush=True)

    load_itr = cfg.load_itr
    if load_itr == -2:  # latest
        load_itr = CK.latest_step(model_path) or -1
    if load_itr > 0:
        CK.resume_trainer(model_path, trainer, load_itr)
        print(f"resumed from iteration_{load_itr}", flush=True)

    phase.set(TrainingStatus.TRAINING)
    metrics_csv = MetricsWriter(os.path.join(model_path, "metrics.csv"))
    start = trainer.state.step
    n = cfg.num_iters - start
    if max_steps is not None:
        n = max(0, min(n, max_steps))
    end = start + n
    bg = torch.ones((3,), device=device) if cfg.white_background else None
    curve_path = os.path.join(model_path, "eval_curve.json")
    eval_curve: list[dict] = []
    if start > 0 and os.path.exists(curve_path):
        # on resume, keep the earlier entries: the eval history is the
        # quality record
        with open(curve_path) as f:
            eval_curve = [e for e in json.load(f) if e["step"] <= start]
    timer = {"eval_s": 0.0, "save_s": 0.0}

    def run_eval(step):
        if eval_ds is None:
            return None
        t = time.perf_counter()
        p_eval = trainer.state.params
        if surfel2d and not cfg.surfel_exact:
            # the flattened route renders through the 3DGS kernels: eval
            # the surfel convention (third axis clamped), as the step does
            p_eval = flatten_to_surfels(p_eval)
        # the instance capacity is read at each eval: the trainer grows it
        ev = evaluate(p_eval, eval_ds, background=bg, render_kwargs={
            "backend": "surfel_pallas" if surfel2d and cfg.surfel_exact
            else "pallas",
            "instance_capacity": trainer.instance_capacity,
            "antialiased": cfg.raster.mip_antialiased})
        entry = {"step": step, "psnr": ev["psnr"], "ssim": ev["ssim"],
                 "num_alive": trainer.state.params.num_alive}
        if "lpips" in ev:
            entry["lpips"] = ev["lpips"]
        eval_curve.append(entry)
        metrics_csv.write(step, {"eval_psnr": ev["psnr"],
                                 "eval_ssim": ev["ssim"]})
        with open(curve_path, "w") as f:
            json.dump(eval_curve, f, indent=1)
        timer["eval_s"] += time.perf_counter() - t
        return ev

    every = max(1, min(100, n // 10))
    t_run = time.perf_counter()

    def step_done(i, state, m):
        step = start + i + 1
        if step % 100 == 0:
            metrics_csv.write(step, m)
            trainer.check_overflow(m)
        if step == start + 1 or (i + 1) % every == 0 or step == end:
            elapsed = time.perf_counter() - t_run - timer["eval_s"] \
                - timer["save_s"]
            print(f"[{step}/{cfg.num_iters}] loss={float(m['loss']):.4f} "
                  f"psnr={float(m['psnr']):.2f} "
                  f"alive={int(m['num_alive'])} "
                  f"({(i + 1) / elapsed:.1f} it/s)", flush=True)
        if (step % cfg.checkpoint_every == 0
                and step > cfg.densify.reset_alpha_every):
            t = time.perf_counter()
            CK.save_trainer(model_path, trainer, step=step)
            timer["save_s"] += time.perf_counter() - t
        if cfg.eval_every and step % cfg.eval_every == 0:
            ev = run_eval(step)
            if ev:
                print(f"[eval @ {step}] PSNR {ev['psnr']:.2f} dB  SSIM "
                      f"{ev['ssim']:.4f} ({ev['n_views']} views, "
                      f"{ev['views_per_s']:.1f} views/s)", flush=True)
        phase.progress = step / cfg.num_iters
        if callback is not None:
            callback(i, state, m)

    trainer.run(n, log_every=0, callback=step_done)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    train_s = time.perf_counter() - t_run - timer["eval_s"] - timer["save_s"]
    print(f"trained {n} steps in {train_s:.2f} s ({n / max(train_s, 1e-9):.2f}"
          f" it/s, evals and checkpoints excluded)", flush=True)
    phase.set(TrainingStatus.TRAINING_DONE, 1.0)

    CK.save_trainer(model_path, trainer, step=end)
    out_ply = os.path.join(model_path, "point_cloud.ply")
    save_params = trainer.state.params
    if surfel2d:
        # persist the surfel convention: the third axis at the flat
        # log-scale, so the PLY renders the same through any 3DGS consumer
        save_params = flatten_to_surfels(save_params)
    save_ply(out_ply, save_params, antialiased=cfg.raster.mip_antialiased)
    print(f"saved {out_ply}")

    ev = run_eval(end)
    if ev is not None:
        print(f"final eval over {ev['n_views']} views: PSNR "
              f"{ev['psnr']:.2f} dB  SSIM {ev['ssim']:.4f} "
              f"({ev['views_per_s']:.1f} views/s)", flush=True)
    metrics_csv.close()
    return trainer


def _train_dynamic(cfg, ds, eval_ds, params, model_path, phase, callback,
                   max_steps):
    """The dynamic models' loop (``model_type`` 2, the deformation MLP, or
    3, the HexPlane field), JAX's ``_train_dynamic``: progress, a
    ``metrics.csv`` row every 100 steps, the whole dynamic state saved to
    ``iteration_N/state.pt`` every ``checkpoint_every`` steps and at the
    end, the eval curve at each test view's own time, the canonical
    ``point_cloud.ply``. The render route is the kernels' on every
    platform. -> the ``DynamicTrainer``."""
    import torch

    from divshot_tpu_torch.core.metrics import MetricsWriter, TrainingStatus
    from divshot_tpu_torch.gsio.ply import save_ply
    from divshot_tpu_torch.models.dynamic import (DynamicTrainer,
                                                  evaluate_dynamic)
    from divshot_tpu_torch.train import checkpoint as CK

    device = params.device
    trainer = DynamicTrainer(cfg, ds, params)
    phase.set(TrainingStatus.TRAINING)
    metrics_csv = MetricsWriter(os.path.join(model_path, "metrics.csv"))
    curve_path = os.path.join(model_path, "eval_curve.json")
    eval_curve: list[dict] = []
    n = cfg.num_iters if max_steps is None else max(
        0, min(cfg.num_iters, max_steps))
    bg = torch.ones((3,), device=device) if cfg.white_background else None
    timer = {"eval_s": 0.0, "save_s": 0.0}

    def run_eval(step):
        if eval_ds is None or eval_ds.times is None:
            return None
        t = time.perf_counter()
        ev = evaluate_dynamic(trainer.state, trainer.net, eval_ds,
                              render_kwargs={
                                  "instance_capacity":
                                  trainer.instance_capacity},
                              background=bg)
        eval_curve.append({"step": step, **ev})
        with open(curve_path, "w") as f:
            json.dump(eval_curve, f, indent=1)
        timer["eval_s"] += time.perf_counter() - t
        return ev

    def save(step):
        t = time.perf_counter()
        CK.save_dynamic(model_path, trainer, step=step)
        timer["save_s"] += time.perf_counter() - t

    every = max(1, min(100, n // 10))
    t_run = time.perf_counter()

    def step_done(i, state, m):
        step = i + 1
        if step % 100 == 0:
            metrics_csv.write(step, m)
        if step == 1 or step % every == 0 or step == n:
            elapsed = time.perf_counter() - t_run - timer["eval_s"] \
                - timer["save_s"]
            print(f"[{step}/{cfg.num_iters}] loss={float(m['loss']):.4f} "
                  f"psnr={float(m['psnr']):.2f} "
                  f"alive={int(m['num_alive'])} "
                  f"({step / elapsed:.1f} it/s)", flush=True)
        if step % cfg.checkpoint_every == 0:
            save(step)
        if cfg.eval_every and step % cfg.eval_every == 0:
            ev = run_eval(step)
            if ev:
                print(f"[eval @ {step}] PSNR {ev['psnr']:.2f} dB  SSIM "
                      f"{ev['ssim']:.4f} ({ev['n_views']} views, "
                      f"{ev['views_per_s']:.1f} views/s)", flush=True)
        phase.progress = step / cfg.num_iters
        if callback is not None:
            callback(i, state, m)

    trainer.run(n, callback=step_done)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    train_s = time.perf_counter() - t_run - timer["eval_s"] - timer["save_s"]
    print(f"trained {n} steps in {train_s:.2f} s ({n / max(train_s, 1e-9):.2f}"
          f" it/s, evals and checkpoints excluded)", flush=True)
    phase.set(TrainingStatus.TRAINING_DONE, 1.0)
    save(n)
    out_ply = os.path.join(model_path, "point_cloud.ply")
    save_ply(out_ply, trainer.state.params)
    print(f"saved canonical {out_ply}")
    ev = run_eval(n)
    if ev is not None:
        print(f"final eval over {ev['n_views']} views: PSNR "
              f"{ev['psnr']:.2f} dB  SSIM {ev['ssim']:.4f}", flush=True)
    metrics_csv.close()
    return trainer


def main(argv=None) -> int:
    return 2 if run(argv) is None else 0


if __name__ == "__main__":
    sys.exit(main())
