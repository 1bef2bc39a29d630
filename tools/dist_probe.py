#!/usr/bin/env python3
"""The measurements behind ``chip_smoke.py``'s phase 14 and the steps of
its loss bars, on the card.

    python3 tools/dist_probe.py [--bars] [--early-wave]
                                [--device cuda] [--tiny]

With no option it runs both; each prints ``PROBE`` lines.
``--tiny`` takes ``chip_smoke.TINY``'s train cell (for the CPU).

``--bars``: the loss bars of phases 5(a) and 12(c) (ADC+ and MCMC through
the kernel route and ``"tiles"``), 6(a) and 12(c)'s 2DGS (the surfel
kernels and ``"surfel"``) and 10(a)'s deformation MLP, each over the
reference's steps (150; 60 for 2DGS), printing the loss ratio over each
prefix of n steps (the mean of the last 10 of the n over the first 10; 15
for the dynamic bar): the fewest steps at which a bar holds
(``chip_smoke.BAR_STEPS``, ``Scale.dyn_bars``). A prefix of a run is the
run of that many steps: nothing in these steps depends on the total.

``--early-wave``: where the SH gradients' all-reduces start in the train
cell's backward, in a world of one (NCCL on a card, gloo on the CPU):
the ms from the backward's start to each all-reduce, to the backward's
end and to the late wave.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke as CS  # noqa: E402
import chip_smoke_dist as CSD  # noqa: E402
import chip_smoke_routes as RT  # noqa: E402
from divshot_tpu_torch.core.config import TrainConfig  # noqa: E402
from divshot_tpu_torch.models import dynamic as DYN  # noqa: E402
from divshot_tpu_torch.train.trainer import (TrainState, Trainer,  # noqa: E402
                                             make_train_step)


def log(msg: str) -> None:
    print(f"PROBE {msg}", flush=True)


def prefix_ratios(losses, ns, k: int = 10) -> dict:
    return {n: round(float(np.mean(losses[n - k:n]) / np.mean(losses[:k])),
                     4) for n in ns if n <= len(losses)}


def bar_losses(device, case, rk: dict, steps: int):
    name, strategy, bar, setup_kw, cfg_kw, densify_kw = case
    cfg, ds, params = CS.small_setup(np.random.default_rng(0), strategy,
                                     device, **setup_kw)
    cfg = dataclasses.replace(cfg, densify=dataclasses.replace(
        cfg.densify, strategy=strategy), **cfg_kw)
    for k, v in densify_kw.items():
        setattr(cfg.densify, k, v)
    tr = Trainer(cfg, ds, params,
                 render_kwargs={"instance_capacity": 1 << 15, **rk})
    losses = []
    t0 = time.perf_counter()
    tr.run(steps, log_every=0,
           callback=lambda i, st, m: losses.append(m["loss"]))
    return torch.stack(losses).cpu().numpy(), time.perf_counter() - t0


def bars(device) -> None:
    ns = (20, 30, 40, 50, 60, 75, 90, 100, 120, 150)
    tiles = {"backend": "tiles", "chunk": RT.BAR_CHUNK}
    for cases, steps, routes in (
            (CS.BARS_3DGS, 150, (("kernels", {}), ("tiles", tiles))),
            (CS.BARS_2DGS, 60, (("surfel kernels", {}), (
                "surfel", {"backend": "surfel", "chunk": RT.BAR_CHUNK})))):
        for case in cases:
            for label, rk in routes:
                losses, secs = bar_losses(device, case, rk, steps)
                log(f"bar {case[0]} through {label} (bar {case[2]}): "
                    f"{steps} steps in {secs:.2f} s; ratio over the first "
                    f"n steps {prefix_ratios(losses, ns)}")
    res, n_times, _, _ = CS.FULL.dyn_bars
    ds, params = CS.dyn_setup(device, np.random.default_rng(0), res, n_times)
    cfg = TrainConfig(sh_degree=0)
    cfg.densify.warmup_length = 20
    cfg.densify.refine_every = 10_000
    cfg.densify.cap_max = params.capacity
    net = DYN.DeformationMLP(width=64, depth=3, device=device)
    init_fn, step_fn = DYN.make_dynamic_train_step(
        cfg, ds, net, render_kwargs={"instance_capacity": 1 << 14},
        net_lr=2e-3)
    state, losses = init_fn(params, 0), []
    for v in np.random.default_rng(0).integers(ds.num_views, size=150):
        state, m = step_fn(state, int(v))
        losses.append(m["loss"])
    losses = torch.stack(losses).cpu().numpy()
    log(f"bar deform (bar 0.75): ratio over the first n steps "
        f"{prefix_ratios(losses, (45, 60, 75, 90, 100, 120, 150), k=15)}")


def early_wave(device, scale) -> None:
    backend = "nccl" if device.type == "cuda" else "gloo"
    dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        cfg, ds, params, rk = CSD.cell(device, scale)
        group = dist.new_group([0])
        step = make_train_step(cfg, ds, rk, grad_psum_axis=group)
        events = []
        all_reduce, grad = dist.all_reduce, torch.autograd.grad

        def rec_reduce(t, *a, **kw):
            CS.sync(device)
            node = torch._C._current_autograd_node()
            where = node.name() if node is not None else "no node"
            events.append((time.perf_counter(),
                           f"all-reduce of {t.numel()} in {where}"))
            return all_reduce(t, *a, **kw)

        def rec_grad(*a, **kw):
            CS.sync(device)
            events.append((time.perf_counter(), "backward start"))
            out = grad(*a, **kw)
            CS.sync(device)
            events.append((time.perf_counter(), "backward end"))
            return out

        dist.all_reduce, torch.autograd.grad = rec_reduce, rec_grad
        state = TrainState.init(params, seed=0)
        try:
            for _ in range(3):       # the last step's events
                events.clear()
                state, _ = step(state, [0])
        finally:
            dist.all_reduce, torch.autograd.grad = all_reduce, grad
        t0 = events[0][0]
        log(f"early wave ({backend}, the train cell, the sync before each "
            f"event included): " + "; ".join(
                f"{what} at {(t - t0) * 1e3:.3f} ms" for t, what in events))
    finally:
        dist.destroy_process_group()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--bars", action="store_true")
    ap.add_argument("--early-wave", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--tiny", action="store_true")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    scale = CS.TINY if args.tiny else CS.FULL
    every = not (args.bars or args.early_wave)
    if device.type == "cuda":
        CS.phase_identity(device, CS.FULL)
        CS.phase_build(device, CS.FULL)
    if every or args.bars:
        bars(device)
    if every or args.early_wave:
        early_wave(device, scale)
    return 0


if __name__ == "__main__":
    sys.exit(main())
