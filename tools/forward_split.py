#!/usr/bin/env python3
"""Split the two forward compositing kernels' time on one NVIDIA card, and
count the survivors of the cull in each cell's longest tile.

    python3 tools/forward_split.py [--root CHECKOUT] [--out FILE]
                                   [--units 256,4096] [--cells ...]
    python3 tools/forward_split.py --binning [--root CHECKOUT] [--cells ...]

For the forward kernels (``csrc/forward.cu``, ``csrc/surfel_forward.cu``)
of the checkout at ``--root`` (default: this one) it builds variants from
a copy of its ``csrc/`` in a temporary directory, never from switches in
the committed sources, and times each with CUDA events on the cells'
inputs (``train``, ``train2d``, ``model``, ``model2d``, and on request
``random`` and the loss bars ``bar_adc+``, ``bar_mcmc``, ``bar_2dgs``: the
frames of ``tools/backward_split.py``), calling the C entry points
directly; a ``torch.profiler`` trace of the same calls gives each
launch's device time and the host's time to issue a call (``profiler``),
which tell a call bound by the host from one bound by the card:

- design "twopass" (a launch that walks the tiles in one pass and marks
  the culled long ones, then one that culls those and walks their
  survivors): ``a`` the kernels as they are; ``first`` the first launch
  alone; ``nowalk`` both launches without the culled tiles' walks. Then
  ``first`` is the one-pass walk, ``nowalk - first`` the cull and ``a -
  nowalk`` the survivors' walk (the variants leave the culled tiles'
  output rows wrong). With ``--units`` also ``a_U<n>``, a copy whose
  ``units::kFwdUnit`` is n (the workspace sized to match);
- design "ported" (one block per tile, every pair evaluated in order):
  ``a`` as it is; ``b`` the chain removed, each pair's cull counted
  instead (no pixel stops, so every pair of every tile is evaluated);
  ``c`` the evaluation removed too, one table row summed a pair (the
  staging and the loop). Then ``b - c`` is the evaluation and ``c`` the
  walk; at a cell whose long tile never stops ``a - b`` is the chain.

For each cell it also counts, with the checkout's plain pair terms, the
pairs of the longest tile that pass the cull (regardless of the pixels'
stops): per pixel the largest and the median, and per 4096 columns the
largest and the median per pixel; the pairs each pixel walks up to its
stop (a float64 running log-transmittance, for counting): the tile's
total, a pixel's largest and median, and the pixels that stop; and the
eight longest tiles' lengths with the instances their pixels reach (the
plain forward's ``reach``). One JSON line goes to stdout and to
``--out``. A rule that does not match the sources exactly once stops the
tool.

With ``--binning`` it builds no variant and times, with the checkout's
own code, the stages around the forward at each cell (also ``demo`` and
``demo2d``, the frames of ``apps.train --demo``): the expand kernel
through its wrapper (``expand``, as ``chip_smoke`` times it) and through
its C entry alone (``expand_entry``), the sort and the tile ranges
(``sort+ranges``, ``sort_instances``) and the full frame (``frame``:
``render_fast`` on the 3DGS route, a ``render_surfels`` forward on the
surfel route), each with CUDA events; all but the frame also under
``torch.profiler`` (each launch's device time, and the host's time to
issue a call). With ``--items 4,8`` it also builds copies of the expand
kernel whose threads walk that many items (``kItems``, a piece of 256
times as many) and times each through its C entry (``expand_items<k>``).
Run it on a parent (an unpacked ``git archive`` as ``--root``) and on the
change in one call to compare them.
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

# Variant rules of the "ported" design: (file, regex, replacement).
_B_3DGS = (r"const float alpha = expf\(fminf\(s, kLogAlphaMax\)\);.*?T = q;",
           "acc[0] += 1.0f;")
_C_3DGS = (r"const float dx = __fsub_rn\(px, chunk\[j\]\);.*?T = q;",
           "acc[0] += chunk[5 * npx + j];")
_B_SURFEL = (r"const float q = __fmul_rn\(T, __fsub_rn\(1\.0f, s\.alpha\)\);"
             r".*?T = q;", "acc[0] += 1.0f;")
_C_SURFEL = (r"surfel::Pair s;\s*if \(!surfel::eval_pair\(chunk, npx, j, px, "
             r"py, s\)\) continue;.*?T = q;",
             "acc[0] += chunk[surfel::kRowOp * npx + j];")
RULES = {
    "b": [("forward.cu", *_B_3DGS), ("surfel_forward.cu", *_B_SURFEL)],
    "c": [("forward.cu", *_C_3DGS), ("surfel_forward.cu", *_C_SURFEL)],
}
_FWD_UNIT = r"constexpr int32_t kFwdUnit = \d+;"
LONG_REGIONS = 4   # units::kFwdLongRegions
SOURCES = ("forward.cu", "surfel_forward.cu")
# Variant rules of the "twopass" design (its launches are units.cuh's).
TWOPASS = {
    "first": [("units.cuh",
               r"  if \(regions > 0\) \{\n    const int64_t blocks",
               "  if (false) {\n    const int64_t blocks")],
    "nowalk": [("units.cuh", r"  auto walk = \[&\]\(int32_t t\) \{",
                "  auto walk = [&](int32_t t) {\n    return;")],
}


def patch(csrc: Path, dst: Path, variant: str, design: str) -> None:
    """Copy ``csrc`` to ``dst`` with the variant's rules applied."""
    shutil.copytree(csrc, dst)
    if variant == "a":
        return
    if variant.startswith("a_U") and design == "twopass":
        rules = [("units.cuh", _FWD_UNIT,
                  f"constexpr int32_t kFwdUnit = {int(variant[3:])};")]
    elif design == "twopass":
        rules = TWOPASS[variant]
    elif design == "ported":
        rules = RULES[variant]
    else:
        raise RuntimeError(f"variant {variant}: no rules for {design}")
    for fname, pat, rep in rules:
        src = (dst / fname).read_text()
        if len(re.findall(pat, src, re.S)) != 1:
            raise RuntimeError(f"variant {variant}: {pat!r} does not match "
                               f"{fname} once")
        (dst / fname).write_text(re.sub(pat, rep, src, count=1, flags=re.S))


def work_words(num_instances: int, unit: int, npx: int) -> int:
    """``units::work_words`` at ``unit`` (for a workspace of any unit)."""
    if num_instances <= LONG_REGIONS * unit:
        return 0
    m = -(-num_instances // unit)
    words = (m - 1) * (unit // 32 + 1) + -(-(num_instances - (m - 1) * unit)
                                           // 32)
    return words * npx + 3 * m


def device_split(fn, iters: int, torch) -> dict:
    """Per call of ``fn``, from a ``torch.profiler`` trace of ``iters``
    calls: each kernel's device time (ms, by its name's ``*_kernel`` part),
    their sum (``device``), and the host's time to issue the calls
    (``host``, ms, the calls not waited for)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        host = (time.perf_counter() - t0) * 1e3 / iters
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0.0))
        m = re.search(r"(\w+_kernel)\b", e.key)
        key = m.group(1) if m else e.key[:40]
        out[key] = out.get(key, 0.0) + us / 1e3 / iters
    out["device"] = sum(out.values())
    out["host"] = host
    return out


def survivor_stats(route, fr, cs, torch) -> dict:
    """Pairs of the frame's longest tile that pass the cull, from the plain
    pair terms of ``route``."""
    from divshot_tpu_torch.raster import raster as R
    from divshot_tpu_torch.raster import surfel_raster as SR
    ts = fr.tile_start.long()
    n_t = ts[1:] - ts[:-1]
    t = int(torch.argmax(n_t))
    s, n = int(ts[t]), int(n_t[t])
    w = fr.cam.width
    tiles_x = -(-w // 16)
    dev = fr.table.device
    per_unit = []
    total = None
    walked = torch.zeros((256,), dtype=torch.int64, device=dev)
    log_t = torch.zeros((256,), dtype=torch.float64, device=dev)
    for k0 in range(0, n, 4096):
        chunk = min(4096, n - k0)
        args = (fr.table, torch.tensor([t], device=dev),
                torch.tensor([s], device=dev), torch.tensor([n], device=dev),
                k0, chunk, 1, tiles_x, 16)
        if route is cs.GAUSS:
            terms = R._chunk_terms(*args)
            ok, alpha = terms[5][0] >= R._LOG_AMIN_F32, terms[6][0]
        else:
            terms = SR._chunk_terms(*args)
            ok, alpha = terms["ok"][0], terms["alpha"][0]
        # a pixel walks a pair while its transmittance before it is >= 1e-4
        a = torch.where(ok, alpha, torch.zeros_like(alpha)).double()
        before = log_t[:, None] + torch.cumsum(torch.log1p(-a), 1) - \
            torch.log1p(-a)
        walked += (ok & (before >= torch.log(torch.tensor(
            1e-4, dtype=torch.float64, device=dev)))).sum(1)
        log_t += torch.log1p(-a).sum(1)
        cnt = ok.sum(-1)                                   # (px,)
        per_unit.append((int(cnt.max()), float(cnt.float().median())))
        total = cnt if total is None else total + cnt
    kw = dict(width=w, height=fr.cam.height, nch=fr.nch)
    _, _, reach = route.fwd_plain(fr.table, fr.tile_start, count_pairs=True,
                                  **kw)
    longest = torch.argsort(n_t, descending=True)[:8].tolist()
    return dict(tile=t, length=n, survivors=int(total.sum()),
                pixel_max=int(total.max()),
                pixel_median=float(total.float().median()),
                unit_max=[u[0] for u in per_unit],
                unit_median=[u[1] for u in per_unit],
                walked=int(walked.sum()), walked_max=int(walked.max()),
                walked_median=float(walked.float().median()),
                stopped=int((log_t < torch.log(torch.tensor(
                    1e-4, dtype=torch.float64, device=dev))).sum()),
                longest_reach=[(int(n_t[k]), int(reach[k]))
                               for k in longest])


_ITEMS = r"constexpr int kItems = \d+;"
_PIECE = r"constexpr int32_t kPiece = \d+;"


def expand_variants(csrc: Path, items: list[int], tmp: Path) -> dict:
    """Copies of the expand kernel whose threads walk ``k`` items each (a
    piece of 256 k), each built alone -> {k: library}."""
    from divshot_tpu_torch import _build
    src = (csrc / "expand.cu").read_text()
    if len(re.findall(_ITEMS, src)) != 1 or len(re.findall(_PIECE, src)) != 1:
        raise RuntimeError("--items: expand.cu has no kItems / kPiece")
    procs = {}
    for k in items:
        d = tmp / f"items{k}"
        shutil.copytree(csrc, d)
        (d / "expand.cu").write_text(re.sub(_PIECE, (
            f"constexpr int32_t kPiece = {256 * k};"), re.sub(
                _ITEMS, f"constexpr int kItems = {k};", src)))
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(d / "lib.so"),
               str(d / "expand.cu")]
        procs[k] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
    libs = {}
    for k, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"items {k}: nvcc failed\n{out}")
        lib = ctypes.CDLL(str(tmp / f"items{k}" / "lib.so"))
        lib.divshot_expand.argtypes = _build._SIGNATURES["divshot_expand"]
        libs[k] = lib
    return libs


def binning_cell(cs, route, fr, device, iters: int,
                 variants: dict | None = None) -> dict:
    """The binning stages of one cell's frame (``--binning``), ms; with
    ``variants`` ({k: library} of ``expand_variants``) also each copy's
    expand through its C entry (``expand_items<k>``), its keys and owners
    held equal to the plain version's first."""
    import torch

    from divshot_tpu_torch import _build
    from divshot_tpu_torch.raster import bin as B
    from divshot_tpu_torch.raster.render import render_fast
    w, h = fr.cam.width, fr.cam.height
    num_tiles, depth_bits = B.key_bits(w, h, 16)
    pp, cap = fr.pp, fr.cap
    n = pp.u.shape[0]
    keys, owners = B.expand_instances(pp, cap, width=w, height=h)
    lib = _build.library()
    cargs = [getattr(pp, f).data_ptr() for f in (
        "offsets", "counts", "tmin_x", "tmin_y", "nx", "depth_key", "u", "v",
        "rad2")] + [n, cap, -(-w // 16), 16, depth_bits, keys.data_ptr(),
                    owners.data_ptr(),
                    torch.cuda.current_stream(device).cuda_stream]

    def entry(lib=lib):
        if lib.divshot_expand(*cargs):
            raise RuntimeError("expand: launch failed")

    bg = torch.zeros((3,), device=device)

    def frame():
        with torch.no_grad():
            if route is cs.GAUSS:
                render_fast(fr.params, fr.cam, background=bg,
                            instance_capacity=cap)
            else:
                route.render(fr.params, fr.cam, cap, fr.nch == cs.SR.MAX_CH)

    fns = {
        "expand": lambda: B.expand_instances(pp, cap, width=w, height=h),
        "expand_entry": entry,
        "sort+ranges": lambda: B.sort_instances(
            fr.keys, fr.owners, num_tiles=num_tiles, depth_bits=depth_bits),
        "frame": frame,
    }
    if variants:
        want = B.expand_instances_plain(pp, cap, width=w, height=h)
        for k, vlib in variants.items():
            entry(vlib)
            if not (torch.equal(keys, want[0])
                    and torch.equal(owners, want[1])):
                raise AssertionError(f"items {k}: differs from plain")
            fns[f"expand_items{k}"] = lambda vlib=vlib: entry(vlib)
    times = {k: cs.time_ms(fn, device, iters) for k, fn in fns.items()}
    owning = int((pp.counts > 0).sum())
    return dict(
        times, profiler={k: device_split(fns[k], iters, torch)
                         for k in fns if k != "frame"},
        splats=n, owning=owning, demand=int(pp.total), capacity=cap,
        kept=int(fr.tile_start[-1]),
        # 9 words of each gaussian that owns instances, 8 bytes a slot
        expand_bound_ms=(owning * 36 + cap * 8) / cs.PEAK_BYTES_S * 1e3)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--out", default="")
    ap.add_argument("--cells", default="train,train2d,model,model2d")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--units", default="")
    ap.add_argument("--binning", action="store_true")
    ap.add_argument("--items", default="")
    args = ap.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    sys.path.insert(1, str(Path(__file__).resolve().parent))

    import numpy as np
    import torch

    import chip_smoke as cs
    from backward_split import cell_frame
    from divshot_tpu_torch import _build

    device = torch.device("cuda")
    if not torch.cuda.is_available():
        raise RuntimeError("needs an NVIDIA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "-i", "0"],
                         capture_output=True, text=True).stdout.strip()
    if args.binning:
        tmp = Path(tempfile.mkdtemp(prefix="binning_split_"))
        items = [int(k) for k in args.items.split(",") if k]
        variants = expand_variants(_build.CSRC, items, tmp) if items else {}
        cells = {}
        for cell in args.cells.split(","):
            route, fr, _ = cell_frame(cs, cell, device, cs.FULL)
            cells[cell] = binning_cell(cs, route, fr, device, args.iters,
                                       variants)
            print(f"{cell}: " + json.dumps(cells[cell]), flush=True)
            del fr
            torch.cuda.empty_cache()
        shutil.rmtree(tmp, ignore_errors=True)
        return _emit({"root": str(root), "binning": True, "card": smi,
                      "cells": cells}, args.out)
    design = ("twopass" if any(
        "cull_walk_kernel" in (_build.CSRC / f).read_text()
        for f in ("forward.cu", "units.cuh")) else "ported")
    variants = (["a", "first", "nowalk"]
                + [f"a_U{int(u)}" for u in args.units.split(",") if u]
                if design == "twopass" else ["a", "b", "c"])

    # build the variants in parallel, each a library of the two forward
    # sources alone
    tmp = Path(tempfile.mkdtemp(prefix="forward_split_"))
    procs, libs = {}, {}
    t0 = time.perf_counter()
    for v in variants:
        d = tmp / v
        patch(_build.CSRC, d, v, design)
        so = tmp / f"lib_{v}.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so),
               *[str(d / f) for f in SOURCES]]
        procs[v] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                         stderr=subprocess.STDOUT, text=True))
    P, I32, I64, F = (ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64,
                      ctypes.c_float)
    fwd_args = [P, I64, P, I32, I32, I32, I32, F, P] + (
        [P, P] if design == "twopass" else [P])
    for v, (so, p) in procs.items():
        out, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"variant {v}: nvcc failed\n{out}")
        # each kernel's registers, from ptxas -v
        kernel = None
        for ln in out.splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", ln)
            kernel = m.group(1) if m else kernel
            m = re.search(r"Used (\d+) registers", ln)
            if m and kernel:
                what = re.search(r"[a-z_]+_kernel", kernel).group(0)
                where = "surfel" if "surfel" in kernel else "3dgs"
                print(f"{v}: {where} {what} {m.group(1)} registers",
                      flush=True)
        lib = ctypes.CDLL(str(so))
        for name in ("divshot_forward", "divshot_surfel_forward"):
            getattr(lib, name).argtypes = fwd_args
        libs[v] = lib
    print(f"built {design} variants {variants} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    scale = cs.FULL
    cells = {}
    for cell in args.cells.split(","):
        route, fr, _ = cell_frame(cs, cell, device, scale)
        w, h = fr.cam.width, fr.cam.height
        tiles_x, tiles_y = -(-w // 16), -(-h // 16)
        num_tiles = tiles_x * tiles_y
        table, ts = fr.table, fr.tile_start
        inst = table.shape[1]
        out = torch.empty((num_tiles, 8, 256), device=device)
        stream = torch.cuda.current_stream(device).cuda_stream
        name = ("divshot_forward" if route is cs.GAUSS
                else "divshot_surfel_forward")
        times, split = {}, {}
        for v in variants:
            unit = int(v[3:]) if v.startswith("a_U") else None
            if design == "twopass" and unit is None:
                unit = int(re.search(r"kFwdUnit = (\d+);", (
                    _build.CSRC / "units.cuh").read_text()).group(1))
            lib = libs[v]
            work = None
            if design == "twopass":
                nw = work_words(inst, unit, 256)
                work = (torch.empty((nw,), dtype=torch.int32, device=device)
                        if nw else None)
            wptr = None if work is None else work.data_ptr()
            fargs = [table.data_ptr(), inst, ts.data_ptr(), num_tiles,
                     tiles_x, 16, fr.nch, float(np.float32(1e-4)),
                     out.data_ptr()] + ([wptr] if design == "twopass"
                                        else []) + [stream]

            def whole():
                if getattr(lib, name)(*fargs):
                    raise RuntimeError(f"{v}: launch failed")
            times[v] = cs.time_ms(whole, device, args.iters)
            split[v] = device_split(whole, args.iters, torch)
        rec = dict(times, profiler=split, kept=int(ts[-1]), capacity=inst,
                   nch=fr.nch, longest=int((ts[1:] - ts[:-1]).max()),
                   survivors=survivor_stats(route, fr, cs, torch))
        if design == "ported":
            rec.update(walk=times["c"], evaluation=times["b"] - times["c"],
                       chain=times["a"] - times["b"])
        else:
            rec.update(one_pass=times["first"],
                       cull=times["nowalk"] - times["first"],
                       survivor_walk=times["a"] - times["nowalk"])
        cells[cell] = rec
        print(f"{cell}: " + json.dumps(rec), flush=True)
        del fr, out
        torch.cuda.empty_cache()
    shutil.rmtree(tmp, ignore_errors=True)
    return _emit({"root": str(root), "design": design, "card": smi,
                  "cells": cells}, args.out)


def _emit(rec: dict, out: str) -> int:
    """Print ``rec`` as one JSON line, and append it to ``out`` if given."""
    line = json.dumps(rec)
    print(line)
    if out:
        Path(out).parent.mkdir(parents=True, exist_ok=True)
        with open(out, "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
