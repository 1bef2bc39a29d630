#!/usr/bin/env python3
"""Smoke check of the PyTorch + CUDA port (``divshot_tpu_torch``) on one
NVIDIA card.

    python3 chip_smoke.py

Phases, each a function of ``(device, scale)``:

1. card identity (fails without a CUDA device);
2. build the kernel library from ``divshot_tpu_torch/csrc`` (one ``nvcc``);
3. each kernel against its plain PyTorch version at a bounded size;
4. the viewer path (``divshot_tpu_torch.apps.render``) at 1920x1080 on the
   repo's trained model ``runs/tpu_bricks_mcmc/point_cloud.ply`` and on a
   1M-splat random scene, with the launch counts that prove it went through
   the kernels, per-frame timings, output checks, the stale-bins guard, and
   each kernel against its plain version at the shapes of that path.

It prints one line per phase, then a JSON line of numbers per kernel and
scene, the
card's ``nvidia-smi`` name and power limit, and last the result line
``{"ok": true, "device": {...}}``. Any failure raises: the exit code is then
non-zero and no result line is printed.
"""

from __future__ import annotations

import json
import math
import shutil
import subprocess
import sys
import tempfile
import time
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from divshot_tpu_torch import _build
from divshot_tpu_torch.apps.render import orbit_for_model, render_orbit
from divshot_tpu_torch.gsio.io import load_model
from divshot_tpu_torch.gsio.synthetic import orbit_cameras, random_scene
from divshot_tpu_torch.raster import bin as B
from divshot_tpu_torch.raster import raster as R
from divshot_tpu_torch.raster.render import frame_inputs, render_fast
from divshot_tpu_torch.splat.gaussians import GaussianParams

REPO = Path(__file__).resolve().parent
MODEL = REPO / "runs" / "tpu_bricks_mcmc" / "point_cloud.ply"

FORWARD_ATOL = 3e-5
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, float32 FLOP/s outside
# the tensor cores
PEAK_BYTES_S = 3.35e12
PEAK_F32_S = 67e12
# float32 operations per (pixel, instance) pair the forward kernel must
# evaluate: dx, dy, the quadratic form (7 mul, 2 add), s (mul, sub), cull
FORWARD_OPS_PER_PAIR = 14

KERNELS = {
    "expand": dict(source="divshot_tpu_torch/csrc/expand.cu",
                   replaces="divshot_tpu/raster/pallas_bin.py:71"),
    "forward": dict(source="divshot_tpu_torch/csrc/forward.cu",
                    replaces="divshot_tpu/raster/pallas_raster.py:267"),
}


@dataclass(frozen=True)
class Scale:
    width: int            # main-path frame size
    height: int
    model_views: int      # orbit views of the trained model
    model_stride: int     # keep every n-th splat of the trained model
    random_splats: int    # splats of the random scene
    probe_capacity: int   # instance capacity of the demand probe
    check_splats: int     # phase-3 kernel check size
    check_res: int
    timing_iters: int


FULL = Scale(1920, 1080, 4, 1, 1_000_000, 1 << 24, 50_000, 512, 10)
TINY = Scale(64, 48, 1, 512, 1_500, 1 << 16, 400, 64, 1)


def log(msg: str) -> None:
    print(msg, flush=True)


def auto_icap(demand: int) -> int:
    """Instance capacity from a probed demand: demand * 1.3 rounded up to a
    power of two, at least 2^16 (the JAX trainer's and bench's policy)."""
    return 1 << max(16, math.ceil(math.log2(max(demand, 1) * 1.3)))


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def time_ms(fn, device: torch.device, iters: int, warmup: int = 1) -> float:
    """Mean milliseconds of ``fn()``: CUDA events on a card, the host clock
    on the CPU (a rehearsal number, never a device metric)."""
    for _ in range(warmup):
        fn()
    sync(device)
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) * 1e3 / iters


# --------------------------------------------------------------------------
# phase 1 and 2


def phase_identity(device: torch.device, scale: Scale) -> dict:
    if device.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke.py needs an NVIDIA "
                           "card")
    name = torch.cuda.get_device_name(0)
    smi = None
    if shutil.which("nvidia-smi"):
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", "-i", "0"],
            capture_output=True, text=True, timeout=60)
        smi = res.stdout.strip() or None
    log(f"  device {name}; count {torch.cuda.device_count()}; "
        f"nvidia-smi: {smi}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}")
    return {"kind": name, "count": torch.cuda.device_count(), "smi": smi}


def phase_build(device: torch.device, scale: Scale) -> float:
    so, seconds = _build.build()
    _build.library()
    log(f"  built {so.name} in {seconds:.2f} s (0 = already built)")
    return seconds


# --------------------------------------------------------------------------
# kernel against plain version


def _bins_inputs(params: GaussianParams, cam):
    """The expand kernel's inputs for one frame, as render_fast makes them."""
    proj, colors, opac = frame_inputs(params, cam)
    p = B.prep(proj.means2d, proj.depths, proj.radii, proj.radii_xy,
               proj.rad2, cam.width, cam.height, 16, 64)
    return p, (proj, colors, opac)


def check_expand(p: B.Prep, cap: int, width: int, height: int) -> dict:
    """Expand kernel vs plain version: every key and owner equal as
    multisets per tile, and tile_start equal."""
    num_tiles, depth_bits = B.key_bits(width, height, 16)
    kk, ko = B.expand_instances(p, cap, width=width, height=height)
    pk, po = B.expand_instances_plain(p, cap, width=width, height=height)
    sorted_k = B.sort_instances(kk, ko, num_tiles=num_tiles,
                                depth_bits=depth_bits)
    sorted_p = B.sort_instances(pk, po, num_tiles=num_tiles,
                                depth_bits=depth_bits)
    if not torch.equal(sorted_k[2], sorted_p[2]):
        raise AssertionError("expand: tile_start differs from plain")

    def pairs(s_key, s_owner):
        return torch.sort((s_key << 32) | s_owner.to(torch.int64))[0]

    if not torch.equal(pairs(*sorted_k[:2]), pairs(*sorted_p[:2])):
        raise AssertionError("expand: (key, owner) multisets differ")
    demand = int(p.total)
    return {"demand": demand, "kept": int(sorted_k[2][-1]),
            "max_abs_err": 0.0}


def check_forward(table, tile_start, width: int, height: int):
    """Forward kernel vs plain version -> (max abs err, pairs evaluated,
    instances the data needs read: per tile, up to its last pixel's
    stop)."""
    out_k = R.rasterize_forward(table, tile_start, width=width,
                                height=height)
    out_p, pairs, reach = R.rasterize_forward_plain(
        table, tile_start, width=width, height=height, count_pairs=True)
    err = float((out_k - out_p).abs().max())
    if not err <= FORWARD_ATOL:
        raise AssertionError(f"forward: max abs err {err} > {FORWARD_ATOL}")
    return err, int(pairs), int(reach.sum())


def phase_kernels_vs_plain(device: torch.device, scale: Scale) -> dict:
    params = random_scene(np.random.default_rng(1), scale.check_splats,
                          sh_degree=3, scale_range=(0.004, 0.025),
                          device=device)
    cam = orbit_cameras(1, width=scale.check_res, device=device)[0]
    p, (proj, colors, opac) = _bins_inputs(params, cam)
    cap = min(auto_icap(int(p.total)), 1 << 20)
    ex = check_expand(p, cap, cam.width, cam.height)
    sb = B.expand_sorted(proj.means2d, proj.conics, proj.depths, proj.radii,
                         proj.radii_xy, proj.rad2, colors, opac,
                         width=cam.width, height=cam.height,
                         instance_capacity=cap)
    fw_err, _, _ = check_forward(sb.table, sb.tile_start, cam.width,
                                 cam.height)
    log(f"  {scale.check_splats} splats at {cam.width}x{cam.height}, "
        f"capacity {cap}, demand {ex['demand']}: expand exact "
        f"(max abs err {ex['max_abs_err']}), forward max abs err {fw_err:.3e}"
        f" (tolerance {FORWARD_ATOL})")
    return {"expand_err": ex["max_abs_err"], "forward_err": fw_err}


# --------------------------------------------------------------------------
# main path


def _scenes(device: torch.device, scale: Scale):
    params, _ = load_model(str(MODEL), device=device)
    if scale.model_stride > 1:
        keep = torch.arange(0, params.capacity, scale.model_stride,
                            device=device)
        params = GaussianParams(**{f: getattr(params, f)[keep] for f in (
            "means", "scales", "quats", "opacity", "sh0", "shN", "alive")})
    model_cams = orbit_for_model(params, scale.model_views, radius=4.0,
                                 width=scale.width, height=scale.height,
                                 fov=50.0)
    rnd = random_scene(np.random.default_rng(0), scale.random_splats,
                       sh_degree=3, scale_range=(0.004, 0.025),
                       device=device)
    rnd_cams = orbit_cameras(1, width=scale.width, height_px=scale.height,
                             device=device)
    return [("tpu_bricks_mcmc", params, model_cams),
            (f"random_{scale.random_splats}", rnd, rnd_cams)]


def _check_frame(img: torch.Tensor, alpha: torch.Tensor, what: str) -> None:
    if not bool(torch.isfinite(img).all()):
        raise AssertionError(f"{what}: image not finite")
    if not (bool(torch.isfinite(alpha).all()) and float(alpha.min()) >= 0.0
            and float(alpha.max()) <= 1.0):
        raise AssertionError(f"{what}: alpha not finite in [0, 1]")
    if float(img.max()) <= 0.0 or float(alpha.max()) < 0.05:
        raise AssertionError(f"{what}: image is all background")


def phase_main_path(device: torch.device, scale: Scale) -> list[dict]:
    scenes = _scenes(device, scale)
    bg = torch.zeros((3,), device=device)

    # probe each scene's demand, then size the capacity from it
    caps = {}
    for name, params, cams in scenes:
        demand = max(int(render_fast(params, c, background=bg,
                                     instance_capacity=scale.probe_capacity
                                     )[2].num_instances) for c in cams)
        caps[name] = auto_icap(demand)

    with tempfile.TemporaryDirectory() as out_dir:
        sync(device)
        _build.reset_launches()
        runs = {name: render_orbit(params, cams, background=bg,
                                   instance_capacity=caps[name],
                                   out_dir=out_dir)
                for name, params, cams in scenes}
        sync(device)
        launches = dict(_build.LAUNCHES)
        n_png = len(list(Path(out_dir).glob("*.png")))
    log(f"  main path launches: {launches}; {n_png} PNGs written")
    if device.type == "cuda":
        for k in KERNELS:
            if launches[k] <= 0:
                raise AssertionError(f"kernel {k} was not launched on the "
                                     f"main path")

    records = []
    for name, params, cams in scenes:
        cap = caps[name]
        for i, ((img, alpha, bins), cam) in enumerate(zip(runs[name], cams)):
            _check_frame(img, alpha, f"{name} view {i}")
            full = time_ms(lambda: render_fast(
                params, cam, background=bg, instance_capacity=cap),
                device, scale.timing_iters)
            cached = time_ms(lambda: render_fast(
                params, cam, background=bg, instance_capacity=cap,
                bins=bins), device, scale.timing_iters)
            log(f"  {name} view {i} {cam.width}x{cam.height}: demand "
                f"{int(bins.num_instances)}, capacity {cap}, full frame "
                f"{full:.3f} ms, cached-bins frame {cached:.3f} ms")
        # stale-bins guard: bins built under token None, reused under 1
        try:
            render_fast(params, cams[0], background=bg, bins=runs[name][0][2],
                        instance_capacity=cap, params_token=1)
        except ValueError as e:
            if "stale FastBins" not in str(e):
                raise
        else:
            raise AssertionError("stale FastBins were not rejected")
        records += kernel_records(name, params, cams[0], cap, device, scale,
                                  launches)
        stages = stage_times(params, cams[0], cap, device, scale)
        log(f"  {name} view 0 stages (ms, each timed alone): "
            + ", ".join(f"{k} {v:.3f}" for k, v in stages.items()))
    log("  stale-bins guard raised as expected")
    return records


def kernel_records(scene: str, params, cam, cap: int, device: torch.device,
                   scale: Scale, launches: dict) -> list[dict]:
    """Each kernel against its plain version at this frame's shapes, with
    its time, the plain version's time and its bound; one record per
    kernel, tagged with the scene."""
    p, (proj, colors, opac) = _bins_inputs(params, cam)
    w, h = cam.width, cam.height
    ex = check_expand(p, cap, w, h)
    ex_ms = time_ms(lambda: B.expand_instances(p, cap, width=w, height=h),
                    device, scale.timing_iters * 5)
    ex_plain = time_ms(lambda: B.expand_instances_plain(
        p, cap, width=w, height=h), device, 1, warmup=0)
    n = p.u.shape[0]
    ex_bytes = n * 9 * 4 + cap * 8
    sb = B.expand_sorted(proj.means2d, proj.conics, proj.depths, proj.radii,
                         proj.radii_xy, proj.rad2, colors, opac, width=w,
                         height=h, instance_capacity=cap)
    fw_err, pairs, reads = check_forward(sb.table, sb.tile_start, w, h)
    fw_ms = time_ms(lambda: R.rasterize_forward(
        sb.table, sb.tile_start, width=w, height=h), device,
        scale.timing_iters * 5)
    fw_plain = time_ms(lambda: R.rasterize_forward_plain(
        sb.table, sb.tile_start, width=w, height=h), device, 1, warmup=0)
    # the instance rows this data needs read (each tile up to its last
    # pixel's stop), the tile ranges, and the (T, 8, 256) output
    num_tiles = sb.tile_start.shape[0] - 1
    fw_bytes = (reads * sb.table.shape[0] * 4 + (num_tiles + 1) * 4
                + num_tiles * 8 * 256 * 4)
    fw_ops = pairs * FORWARD_OPS_PER_PAIR
    recs = []
    for name, err, ms, plain, nbytes, ops in (
            ("expand", ex["max_abs_err"], ex_ms, ex_plain, ex_bytes, 0),
            ("forward", fw_err, fw_ms, fw_plain, fw_bytes, fw_ops)):
        t_bytes = nbytes / PEAK_BYTES_S * 1e3
        t_ops = ops / PEAK_F32_S * 1e3
        recs.append(dict(
            name=name, scene=scene, route="cuda", **KERNELS[name],
            launches=launches[name], max_abs_err=err, ms=ms, plain_ms=plain,
            bound_ms=max(t_bytes, t_ops),
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            library_ms=None))
    log(f"  {scene} kernels at {w}x{h}, {n} splats, capacity {cap}, "
        f"demand {ex['demand']}, {int(sb.tile_start[-1])} instances kept, "
        f"{reads} read, {pairs} pairs evaluated: "
        + "; ".join(f"{r['name']} {r['ms']:.4f} ms (plain {r['plain_ms']:.3f}"
                    f" ms, bound {r['bound_ms']:.4f} ms by {r['bound_by']}, "
                    f"err {r['max_abs_err']:.3e})" for r in recs))
    return recs


def stage_times(params, cam, cap: int, device: torch.device,
                scale: Scale) -> dict:
    """Mean ms of each stage of one full render_fast frame, each timed
    alone on its own inputs."""
    w, h = cam.width, cam.height
    num_tiles, depth_bits = B.key_bits(w, h, 16)
    p, (proj, colors, opac) = _bins_inputs(params, cam)
    keys, owners = B.expand_instances(p, cap, width=w, height=h)
    s_key, s_owner, tile_start = B.sort_instances(
        keys, owners, num_tiles=num_tiles, depth_bits=depth_bits)
    inst = torch.where(s_key == B.CULLED_KEY, -1, s_owner)
    table = R.build_feature_table(proj.means2d, proj.conics, colors, opac,
                                  inst)
    stages = {
        "project+sh": lambda: frame_inputs(params, cam),
        "prep": lambda: B.prep(proj.means2d, proj.depths, proj.radii,
                               proj.radii_xy, proj.rad2, w, h, 16, 64),
        "expand": lambda: B.expand_instances(p, cap, width=w, height=h),
        "sort+ranges": lambda: B.sort_instances(
            keys, owners, num_tiles=num_tiles, depth_bits=depth_bits),
        "feature table": lambda: R.build_feature_table(
            proj.means2d, proj.conics, colors, opac, inst),
        "forward": lambda: R.rasterize_forward(table, tile_start, width=w,
                                               height=h),
    }
    return {k: time_ms(fn, device, scale.timing_iters)
            for k, fn in stages.items()}


# --------------------------------------------------------------------------


def main() -> int:
    device = torch.device("cuda")
    scale = FULL
    t_all = time.perf_counter()

    def run(label, fn):
        t0 = time.perf_counter()
        log(f"phase {label} ...")
        out = fn(device, scale)
        log(f"phase {label} ok in {time.perf_counter() - t0:.2f} s")
        return out

    ident = run("1 card identity", phase_identity)
    run("2 build kernels", phase_build)
    run("3 kernels vs plain versions", phase_kernels_vs_plain)
    records = run("4 main path", phase_main_path)
    log(f"all phases ok in {time.perf_counter() - t_all:.2f} s")
    print(json.dumps({"kernels": records}))
    print(ident["smi"] or f"{ident['kind']}, power limit not readable")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": ident["kind"], "count": ident["count"]}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
