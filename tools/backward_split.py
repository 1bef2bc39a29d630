#!/usr/bin/env python3
"""Split the two backward compositing kernels' time into walk, gradient
arithmetic and reduction, on one NVIDIA card.

    python3 tools/backward_split.py [--root CHECKOUT] [--out FILE]
                                    [--units 1024,2048]

For each backward kernel (``csrc/backward.cu``, ``csrc/surfel_backward.cu``)
of the checkout at ``--root`` (default: this one) it builds three variants
from a copy of its ``csrc/`` in a temporary directory, never from switches
in the committed sources:

- ``a``: the kernel as it is;
- ``b``: without the per-instance reduction across lanes (the warp
  shuffles; a thread's own terms are summed in their place), so its output
  is wrong and only its time counts;
- ``c``: the forward recompute alone: the walk with its culls, T, the
  running ``w cdot`` and the stops, no gradient terms and no reduction.

Each variant is timed with CUDA events through the checkout's own wrapper
on the cells' inputs: ``train`` and ``train2d`` (``chip_smoke``'s training
configuration, a fresh 100K-splat model at 800x800, view 0, the cotangent of
the train loss), ``model`` and ``model2d`` (the repo's trained 3DGS and 2DGS
models, view 0 at 1920x1080, the cotangent of ``sum_loss``). Then
``a - b`` is the reduction, ``b - c`` the gradient arithmetic and ``c``
the walk. With ``--units`` the kernels as they are (a) are also timed at
each of those unit lengths, each built from a copy whose ``units::kUnit``
is replaced. One JSON line of the times (ms) goes to stdout and to
``--out``.

The variant rules are tied to the kernels' sources. "units" matches the
kernels with the unit split (``csrc/units.cuh``): the call of
``units::warp_transpose_sum`` and the span between the markers ``//
gradient terms`` and ``// end of the gradient terms``. "ported" matches
the kernels as first ported, one block per tile (the revision before the
unit split), to time that revision with ``--root`` on its checkout; it
matches nothing in later sources. A change to the kernels that moves these
lines must update the rules: a rule that does not match exactly once
stops the tool.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

# Variant rules per kernel design, "ported" (one block per tile)
# or "units" (the unit split, csrc/units.cuh): (file, regex, replacement),
# each regex matching exactly once.
_PORTED_B = (r"      if \(__any_sync\(kFull, applied\)\) \{\n.*?\n      \}\n"
             r"(      if \(lane == 0\))", r"\1")
_UNITS_B = (r"units::warp_transpose_sum<kRows>\(acc, lane\)",
            "[&] { float s_ = 0.0f; for (int k_ = 0; k_ < kRows; ++k_) "
            "s_ += acc[k_]; return s_; }()")
_UNITS_C = (r"// gradient terms[^\n]*\n.*?// end of the gradient terms\n",
            "acc[0] += p.c_dot;\n")
_UNIT_CONSTANT = r"constexpr int32_t kUnit = \d+;"
_C_3DGS = r"""applied = true;
            const float w = __fmul_rn(alpha, T);
            float cdot = 0.0f;
#pragma unroll
            for (int ch = 0; ch < kMaxCh; ++ch)
              if (ch < nch) cdot += g[ch] * chunk[(6 + ch) * kChunk + j];
            c_dot += w * cdot;
            val[0] = c_dot;
            T = q;"""
_C_SURFEL = r"""applied = true;
          const float* col = chunk + j;
          const float w = __fmul_rn(s.alpha, T);
          float cdot = 0.0f;
#pragma unroll
          for (int ch = 0; ch < kMaxCh; ++ch)
            if (ch < nch)
              cdot += g[ch] * col[(surfel::kRowCh + ch) * kChunk];
          c_dot += w * cdot;
          val[0] = c_dot;
          T = q;"""
RULES = {
    "ported": {
        "b": [("backward.cu", *_PORTED_B),
              ("surfel_backward.cu", *_PORTED_B)],
        "c": [("backward.cu", *_PORTED_B),
              ("surfel_backward.cu", *_PORTED_B),
              ("backward.cu", r"applied = true;.*?T = q;",
               _C_3DGS.replace("\\", "\\\\")),
              ("surfel_backward.cu", r"applied = true;.*?T = q;",
               _C_SURFEL.replace("\\", "\\\\"))],
    },
    "units": {
        "b": [("backward.cu", *_UNITS_B), ("surfel_backward.cu", *_UNITS_B)],
        "c": [("backward.cu", *_UNITS_B), ("surfel_backward.cu", *_UNITS_B),
              ("backward.cu", *_UNITS_C), ("surfel_backward.cu", *_UNITS_C)],
    },
}
BACKWARD_SOURCES = ("backward.cu", "surfel_backward.cu")


def patch(csrc: Path, dst: Path, variant: str) -> str:
    """Copy ``csrc`` to ``dst`` with the variant's rules applied -> the
    kernels' design ('' for variant a). Variant ``a_U<n>`` is the kernels
    as they are with ``units::kUnit`` = n."""
    shutil.copytree(csrc, dst)
    if variant == "a":
        return ""
    design = "units" if (csrc / "units.cuh").exists() else "ported"
    rules = RULES[design].get(variant, [])
    if variant.startswith("a_U") and design == "units":
        rules = [("units.cuh", _UNIT_CONSTANT,
                  f"constexpr int32_t kUnit = {int(variant[3:])};")]
    if not rules:
        raise RuntimeError(f"variant {variant}: no rules for {design}")
    for fname, pat, rep in rules:
        src = (dst / fname).read_text()
        if len(re.findall(pat, src, re.S)) != 1:
            raise RuntimeError(f"variant {variant}: {pat!r} does not match "
                               f"{fname} once")
        (dst / fname).write_text(re.sub(pat, rep, src, count=1, flags=re.S))
    return design


def cell_frame(cs, cell: str, device, scale):
    """The inputs of one cell, through the checkout's ``chip_smoke`` module
    ``cs`` -> (route, frame, the cotangent of the cell's loss): ``train`` and
    ``train2d`` a fresh 100K-splat model at 800x800, view 0, the train loss;
    ``model`` and ``model2d`` the repo's trained 3DGS and 2DGS models, view 0
    of the app's orbit at the frame size, ``sum_loss``; ``random`` the
    1M-splat random scene of ``chip_smoke`` phase 4 at the frame size;
    ``bar_<name>`` (``bar_adc+``, ``bar_mcmc``, ``bar_2dgs``) the loss bar
    of that name in ``chip_smoke`` phases 5(a) and 6(a), trained for its
    steps, view 0, the train loss; ``demo`` and ``demo2d`` view 0 of
    ``apps.train --demo`` (with ``--model_type 1``) after its steps, the
    train loss."""
    import contextlib
    import io

    import numpy as np

    from divshot_tpu_torch.apps.render import orbit_for_model
    from divshot_tpu_torch.gsio.synthetic import orbit_cameras, random_scene
    if cell.startswith("bar_"):
        cases = {c[0]: (c, 0) for c in cs.BARS_3DGS}
        cases.update({c[0]: (c, 1) for c in cs.BARS_2DGS})
        (_, strategy, _, setup_kw, cfg_kw, densify_kw), model_type = \
            cases[cell[4:]]
        cfg, ds, params = cs.small_setup(np.random.default_rng(0), strategy,
                                         device, **setup_kw)
        cfg = cfg.replace(**cfg_kw)
        for k, v in densify_kw.items():
            setattr(cfg.densify, k, v)
        tr = cs.Trainer(cfg, ds, params,
                        render_kwargs={"instance_capacity": 1 << 15})
        tr.run(scale.bars2d_iters if model_type else scale.bars_iters,
               log_every=0)
        route = cs.SURFEL if model_type else cs.GAUSS
        fr = cs.make_frame(tr.state.params, ds.cameras[0],
                           tr.instance_capacity, route=route)
        return route, fr, cs.loss_cotangent(
            fr, cs.train_loss(tr.cfg, ds.images[0], fr.cam, tr.state.step))
    if cell in ("demo", "demo2d"):
        argv = ["--demo", "--iterations", str(scale.demo_iters), "--device",
                device.type] + (["--model_type", "1"] if cell == "demo2d"
                                else [])
        with tempfile.TemporaryDirectory() as out, \
                contextlib.redirect_stdout(io.StringIO()):
            tr = cs.train_app.run(argv + ["--model_path", out])
        route = cs.SURFEL if cell == "demo2d" else cs.GAUSS
        fr = cs.make_frame(tr.state.params, tr.dataset.cameras[0],
                           tr.instance_capacity, route=route)
        return route, fr, cs.loss_cotangent(fr, cs.train_loss(
            tr.cfg, tr.dataset.images[0], fr.cam, tr.state.step))
    if cell == "random":
        params = random_scene(np.random.default_rng(0), scale.random_splats,
                              sh_degree=3, scale_range=(0.004, 0.025),
                              device=device)
        cam = orbit_cameras(1, width=scale.width, height_px=scale.height,
                            device=device)[0]
        probe = cs.make_frame(params, cam, scale.probe_capacity)
        fr = cs.make_frame(params, cam, cs.auto_icap(int(probe.pp.total)))
        return cs.GAUSS, fr, cs.loss_cotangent(fr, cs.sum_loss)
    if cell in ("train", "train2d"):
        model_type = int(cell == "train2d")
        cfg, ds, params = cs._bench_setup(device, scale, model_type)
        route = cs.SURFEL if model_type else cs.GAUSS
        cam = ds.cameras[0]
        probe = cs.make_frame(params, cam, 1 << 22, route=route)
        fr = cs.make_frame(params, cam, cs.auto_icap(int(probe.pp.total)),
                           route=route)
        return route, fr, cs.loss_cotangent(
            fr, cs.train_loss(cfg, ds.images[0], cam, 0))
    route = cs.SURFEL if cell == "model2d" else cs.GAUSS
    params = cs._load(cs.MODEL_2DGS if cell == "model2d" else cs.MODEL,
                      device, scale)
    cam = orbit_for_model(params, 1, radius=4.0, width=scale.width,
                          height=scale.height, fov=50.0)[0]
    probe = cs.make_frame(params, cam, scale.probe_capacity, route=route)
    fr = cs.make_frame(params, cam, cs.auto_icap(int(probe.pp.total)),
                       route=route)
    return route, fr, cs.loss_cotangent(fr, cs.sum_loss)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--out", default="")
    ap.add_argument("--cells", default="train,train2d,model,model2d")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--units", default="")
    args = ap.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))

    import torch

    import chip_smoke as cs
    from divshot_tpu_torch import _build

    device = torch.device("cuda")
    if not torch.cuda.is_available():
        raise RuntimeError("needs an NVIDIA card")
    real = _build.library()

    # build the variants in parallel, each a library of the two backward
    # sources alone
    tmp = Path(tempfile.mkdtemp(prefix="backward_split_"))
    procs, libs, designs = {}, {}, {}
    t0 = time.perf_counter()
    variants = ["a", "b", "c"] + [f"a_U{int(u)}" for u in
                                  args.units.split(",") if u]
    for v in variants:
        d = tmp / v
        designs[v] = patch(_build.CSRC, d, v)
        so = tmp / f"lib_{v}.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so),
               *[str(d / f) for f in BACKWARD_SOURCES]]
        procs[v] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                         stderr=subprocess.STDOUT, text=True))
    for v, (so, p) in procs.items():
        out, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"variant {v}: nvcc failed\n{out}")
        lib = ctypes.CDLL(str(so))
        for name in ("divshot_backward", "divshot_surfel_backward"):
            fn = getattr(lib, name)
            fn.argtypes = _build._SIGNATURES[name]
            fn.restype = ctypes.c_int
        libs[v] = lib
    print(f"built variants {designs} in {time.perf_counter() - t0:.1f} s",
          flush=True)

    class Proxy:
        """The checkout's library with the backward entry points of one
        variant."""
        def __init__(self, lib):
            self.lib = lib

        def __getattr__(self, name):
            if name in ("divshot_backward", "divshot_surfel_backward"):
                return getattr(self.lib, name)
            return getattr(real, name)

    scale = cs.FULL
    cells = {}
    for cell in args.cells.split(","):
        route, fr, cot = cell_frame(cs, cell, device, scale)
        w, h = fr.cam.width, fr.cam.height
        kw = dict(width=w, height=h, nch=fr.nch)
        if route is cs.GAUSS:
            kw["with_absgrad"] = False
        fwd = route.fwd(fr.table, fr.tile_start, width=w, height=h,
                        nch=fr.nch)
        n_t = (fr.tile_start[1:] - fr.tile_start[:-1]).long()
        times = {}
        for v in variants:
            _build.library = (lambda lib=Proxy(libs[v]): lib)
            times[v] = cs.time_ms(
                lambda: route.bwd(fr.table, fr.tile_start, cot, fwd, **kw),
                device, args.iters)
        _build.library = lambda: real
        a, b, c = times["a"], times["b"], times["c"]
        cells[cell] = dict(
            times, kept=int(fr.tile_start[-1]),
            longest_tile=int(n_t.max()), tiles=int(n_t.numel()),
            nch=fr.nch, walk=c, arithmetic=b - c, reduction=a - b)
        print(f"{cell}: " + json.dumps(cells[cell]), flush=True)
        del fr, cot, fwd
        torch.cuda.empty_cache()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "-i", "0"],
                         capture_output=True, text=True).stdout.strip()
    rec = {"root": str(root), "designs": designs, "card": smi,
           "cells": cells}
    line = json.dumps(rec)
    print(line)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "a") as f:
            f.write(line + "\n")
    shutil.rmtree(tmp, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
