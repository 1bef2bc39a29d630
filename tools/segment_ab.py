#!/usr/bin/env python3
"""The per-splat reduce of two checkouts on the same backward rows, in
turns, on one card: the sums' bits and the reduce stage's time.

    python3 tools/segment_ab.py --roots PARENT,CHANGE [--order 0110]
                                [--cells random,model,model2d]

Each turn is a process of its own, started from that checkout's root: it
builds the checkout's kernels, makes each cell's frame as
``chip_smoke.py`` makes it at ``chip_smoke.FULL`` (``random``: phase
5(c)'s random 1M splats at 1920x1080; ``model`` / ``model2d``: view 0 of
``runs/tpu_bricks_mcmc`` / ``runs/tpu_bricks_2dgs2`` at 1920x1080 on the
3DGS / surfel route, as 5(e) and 6(c)), runs the backward kernel on the
cotangent of ``chip_smoke.sum_loss``, and sums its rows with the
checkout's ``bin.segment_rows_sorted``: the whole reduce stage as a
backward runs it, timed with CUDA events over 20 calls after one. Prints
one ``AB`` line of JSON a turn and cell: the root, the cell, the stage's
ms, and SHA-256 digests of the backward's rows (the same in every turn
when the inputs are) and of the sums. Then one ``SAME`` line a cell: true
when every turn's sums have the same bits.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

TURN = r"""
import hashlib, json, sys
import numpy as np
import torch
sys.path.insert(0, ".")
import chip_smoke as CS
from divshot_tpu_torch import _build
from divshot_tpu_torch.gsio.synthetic import orbit_cameras, random_scene
from divshot_tpu_torch.raster import bin as B
from divshot_tpu_torch.raster.render import render_fast
from divshot_tpu_torch.apps.render import orbit_for_model

def digest(t):
    return hashlib.sha256(t.contiguous().cpu().numpy().tobytes()).hexdigest()

_build.library()
dev = torch.device("cuda")
scale = CS.FULL
w, h = scale.width, scale.height
for cell in sys.argv[2].split(","):
    if cell == "random":
        route, bkw = CS.GAUSS, dict(with_absgrad=False)
        params = random_scene(np.random.default_rng(0), scale.random_splats,
                              sh_degree=3, scale_range=(0.004, 0.025),
                              device=dev)
        cam = orbit_cameras(1, width=w, height_px=h, device=dev)[0]
        demand = int(render_fast(params, cam,
                                 instance_capacity=scale.probe_capacity
                                 )[2].num_instances)
    else:
        route, bkw = ((CS.GAUSS, dict(with_absgrad=False))
                      if cell == "model" else (CS.SURFEL, {}))
        name = "tpu_bricks_mcmc" if cell == "model" else "tpu_bricks_2dgs2"
        params = CS._load(CS.REPO / "runs" / name / "point_cloud.ply", dev,
                          scale)
        cam = orbit_for_model(params, 1, radius=4.0, width=w, height=h,
                              fov=50.0)[0]
        with torch.no_grad():
            demand = int(route.render(params, cam, scale.probe_capacity,
                                      True, **bkw).num_instances)
    fr = CS.make_frame(params, cam, CS.auto_icap(demand), grad=True,
                       route=route)
    cot = CS.loss_cotangent(fr, CS.sum_loss)
    kw = dict(width=w, height=h, nch=fr.nch)
    fwd = route.fwd(fr.table, fr.tile_start, **kw)
    grads = route.bwd(fr.table, fr.tile_start, cot, fwd, **kw, **bkw)
    rows = range(route.grad_rows + fr.nch)
    sums = B.segment_rows_sorted(grads, fr.bins, rows)
    ms = CS.time_ms(lambda: B.segment_rows_sorted(grads, fr.bins, rows),
                    dev, 20)
    print("AB " + json.dumps(dict(
        root=sys.argv[1], cell=cell, rows=len(rows), icap=fr.cap,
        kept=int(fr.tile_start[-1]), reduce_ms=ms, grads=digest(grads),
        sums=digest(sums))), flush=True)
    del fr, cot, fwd, grads, sums
    torch.cuda.empty_cache()
"""


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--roots", required=True)
    ap.add_argument("--order", default="0110")
    ap.add_argument("--cells", default="random,model,model2d")
    args = ap.parse_args()
    roots = [Path(r).resolve() for r in args.roots.split(",")]
    seen: dict[str, set] = {}
    for i in args.order:
        root = roots[int(i)]
        res = subprocess.run([sys.executable, "-c", TURN, str(root),
                              args.cells], cwd=root, capture_output=True,
                             text=True)
        for line in res.stdout.splitlines():
            if line.startswith("AB "):
                print(line, flush=True)
                rec = json.loads(line[3:])
                seen.setdefault(rec["cell"], set()).add(
                    (rec["grads"], rec["sums"]))
        if res.returncode != 0:
            print(res.stderr[-3000:], file=sys.stderr)
            return res.returncode
    for cell, digests in seen.items():
        print("SAME " + json.dumps(dict(
            cell=cell, grads=len({g for g, _ in digests}) == 1,
            sums=len(digests) == 1)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
