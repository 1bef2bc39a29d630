#!/usr/bin/env python3
"""Where a train step differs between two runs on the card, stage by stage.

    python3 tools/repro_probe.py [--cells train,train2d] [--tiny]
                                 [--device cuda]

For each cell (``chip_smoke.py``'s 5(b) train cell, 100K splats at
800x800 trained as 3DGS, and its 6(b) train2d cell, the same scene as
exact 2DGS surfels), in PyTorch's default mode:

1. the train step run twice from one state: the first step from the
   fresh state and 2 steps from the state after 4 warm-up steps, with the
   largest difference of the loss and of every state tensor (parameters,
   Adam moments, densify statistics, the generator); then the same with
   JAX's formula for the per-splat reduce (the differences of one float32
   cumsum over the capacity, which the port ran before the segment kernel)
   put back in its place;
2. each stage of view 0's render forward + backward at the warm state, run
   twice on the same inputs: projection and SH, the binning and the
   table, the forward kernel, the loss's cotangent, the backward kernel,
   the reduce (the segment kernel, and JAX's formula), autograd through
   projection and SH from the reduce's sums, the background's gradient
   (``einsum("hwc,hw->c")``) and the whole render forward + backward;
3. with ``train`` in the cells, the order-dependent sums off the main
   path: the ``"tiles"`` route's forward + backward on the train cell
   (its float ``index_add_``) and the export's k-means
   (``gsio/kmeans.kmeans_1d``, ``index_add_``) on 2^20 values, each twice.

Every line starts with ``PROBE``; a difference is the largest absolute
one, 0 when the two runs are bitwise equal. ``--tiny`` takes
``chip_smoke.TINY``'s cells (for the CPU, where every sum is in a fixed
order).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke as CS  # noqa: E402
import chip_smoke_repro as CR  # noqa: E402
import chip_smoke_routes as RT  # noqa: E402
from divshot_tpu_torch.gsio import kmeans as KM  # noqa: E402
from divshot_tpu_torch.raster import bin as B  # noqa: E402
from divshot_tpu_torch.train.trainer import (TrainState,  # noqa: E402
                                             make_train_step)


def log(msg: str) -> None:
    print(f"PROBE {msg}", flush=True)


def prefix_formula(grads, tile_start, perm, g_offsets, g_counts, rows):
    """JAX's per-splat reduce (``pallas_bin.segment_rows_sorted``) in
    PyTorch: each sum the difference of two entries of one float32 cumsum
    per row over the capacity, the rows gathered to expansion order through
    the inverse of the sort's permutation ``perm``."""
    icap = grads.shape[1]
    dev = grads.device
    zero = torch.zeros((), device=dev)
    live = torch.arange(icap, device=dev) < tile_start[-1]
    g = torch.where(live[None, :], grads[list(rows)], zero)
    exp2sorted = torch.empty_like(perm)
    exp2sorted[perm] = torch.arange(icap, device=dev)
    ge = torch.index_select(g, 1, exp2sorted)
    cs = torch.stack([torch.cumsum(row, 0) for row in ge])
    hi = (g_offsets + g_counts - 1).long()
    e = torch.where(hi[None, :] >= 0, cs[:, torch.clamp(hi, 0, icap - 1)],
                    zero)
    e_prev = torch.cat([e.new_zeros((len(g), 1)), e[:, :-1]], 1)
    return torch.where((g_counts > 0)[None, :], e - e_prev, zero)


class prefix_reduce:
    """Within: the port's per-splat reduce is JAX's formula."""

    def __enter__(self):
        self.was = B.segment_rows
        B.segment_rows = prefix_formula

    def __exit__(self, *exc):
        B.segment_rows = self.was


def flat(x) -> list[torch.Tensor]:
    if torch.is_tensor(x):
        return [x]
    if isinstance(x, dict):
        return [t for v in x.values() for t in flat(v)]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in flat(v)]
    if dataclasses.is_dataclass(x):
        return [t for f in dataclasses.fields(x)
                for t in flat(getattr(x, f.name))]
    return []


def twice(fn) -> float:
    """The largest difference between two calls of ``fn`` over every
    tensor of their results (0: bitwise equal)."""
    a, b = flat(fn()), flat(fn())
    worst = 0.0
    for x, y in zip(a, b):
        if not torch.equal(x, y):
            worst = max(worst, CR.max_diff(x, y), 1e-300)
    return worst


def steps(cfg, ds, params, icap: int, label: str, device) -> TrainState:
    step_fn = make_train_step(cfg, ds, {"instance_capacity": icap})
    state = TrainState.init(params, seed=0)
    fresh = CR.clone_state(state)
    for i in range(4):
        state, _ = step_fn(state, i % ds.num_views)
    CS.sync(device)
    for reduce in ("segment kernel", "JAX's prefix formula"):
        with prefix_reduce() if reduce != "segment kernel" else \
                contextlib.nullcontext():
            first = CR.steps_twice(step_fn, fresh, [0], label, check=False)
            warm = CR.steps_twice(step_fn, state, [0, 1], label,
                                  check=False)
        for what, d in (("first step", first), ("2 steps from step 4",
                                                 warm)):
            differ = {k: v for k, v in d.items() if v}
            log(f"{label} {what} twice, reduce {reduce}: "
                + ("bitwise equal" if not differ else f"differ {differ}"))
    return state


def stages(cfg, ds, state, icap: int, route, label: str, **bkw) -> None:
    params = state.params
    cam = ds.cameras[0]
    geometry = route is CS.SURFEL
    loss_fn = CS.train_loss(cfg, ds.images[0], cam, state.step)
    fr = CS.make_frame(params, cam, icap, grad=True, route=route)
    w, h, nch = cam.width, cam.height, fr.nch
    cot = CS.loss_cotangent(fr, loss_fn)
    fwd = route.fwd(fr.table, fr.tile_start, width=w, height=h, nch=nch)
    grads = route.bwd(fr.table, fr.tile_start, cot, fwd, width=w, height=h,
                      nch=nch, **bkw)
    gouts = route.reduce(grads, fr.bins, nch)

    def project_backward():
        outs = route.table_inputs(*route.inputs(fr.params, cam, geometry))
        return torch.autograd.grad(outs, list(fr.leaves.values()), gouts,
                                   allow_unused=True)

    def prefix():
        with prefix_reduce():
            return route.reduce(grads, fr.bins, nch)

    g_img = torch.rand((h, w, 3), device=fwd.device)
    t_px = torch.rand((h, w), device=fwd.device)
    diffs = {
        "projection+SH": twice(lambda: route.inputs(fr.params, cam,
                                                    geometry)),
        "binning+table": twice(lambda: CS.make_frame(
            params, cam, icap, route=route).bins),
        "forward kernel": twice(lambda: route.fwd(
            fr.table, fr.tile_start, width=w, height=h, nch=nch)),
        "loss cotangent": twice(lambda: CS.loss_cotangent(fr, loss_fn)),
        # the columns it writes: those past tile_start[-1] are left as
        # they were
        "backward kernel": twice(lambda: route.bwd(
            fr.table, fr.tile_start, cot, fwd, width=w, height=h, nch=nch,
            **bkw)[:, :int(fr.tile_start[-1])]),
        "reduce (segment kernel)": twice(lambda: route.reduce(
            grads, fr.bins, nch)),
        "reduce (JAX's prefix formula)": twice(prefix),
        "autograd projection+SH": twice(project_backward),
        "background einsum": twice(lambda: torch.einsum(
            "hwc,hw->c", g_img, t_px)),
        "render forward+backward": twice(lambda: CS.render_forward_backward(
            route, params, cam, icap, geometry, loss_fn, **bkw)),
    }
    log(f"{label} stages run twice (largest difference, 0 bitwise): "
        + "; ".join(f"{k} {v:.3e}" for k, v in diffs.items()))


def off_path(params, cam, icap: int, device) -> None:
    densest, tcap = RT.tile_capacity_for(params, cam, icap)
    tiles = twice(lambda: CS.render_forward_backward(
        CS.GAUSS, params, cam, icap, loss_fn=CS.sum_loss, backend="tiles",
        tile_capacity=tcap, chunk=RT.CHUNK))
    vals = torch.randn((1 << 20,), generator=torch.Generator(
        device=device).manual_seed(0), device=device)
    (ca, ia), (cb, ib) = KM.kmeans_1d(vals), KM.kmeans_1d(vals)
    log(f"off the main path, each run twice: the \"tiles\" route's render "
        f"forward + backward of sum_loss (tile_capacity {tcap}) "
        f"{tiles:.3e}; k-means of 2^20 values: centres "
        f"{CR.max_diff(ca, cb):.3e} (of a largest "
        f"{float(ca.abs().max()):.3f}), {int((ia != ib).sum())} ids differ")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cells", default="train,train2d")
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    device = torch.device(args.device)
    scale = CS.TINY if args.tiny else CS.FULL
    if device.type == "cuda":
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip()
        log(f"card {smi}; torch {torch.__version__}")
    for cell in args.cells.split(","):
        model_type = {"train": 0, "train2d": 1}[cell]
        cfg, ds, params = CS._bench_setup(device, scale, model_type)
        _, m = make_train_step(cfg, ds, {"instance_capacity": 1 << 19})(
            TrainState.init(params, seed=0), 0)
        icap = CS.auto_icap(int(m["num_instances"]))
        state = steps(cfg, ds, params, icap, cell, device)
        route = CS.SURFEL if model_type else CS.GAUSS
        bkw = {} if model_type else {"with_absgrad": False}
        stages(cfg, ds, state, icap, route, cell, **bkw)
        if cell == "train":
            off_path(state.params, ds.cameras[0], icap, device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
