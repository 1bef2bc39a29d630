"""Phase 12 of ``chip_smoke.py``: the routes of ``render()`` other than
the kernel route, on the card. ``python3 chip_smoke.py`` runs it after
phase 11 (``chip_smoke.phase_routes``); it shares that script's harness
(``Frame``, ``kernel_records``, ``count_launches``) and is no script of
its own.

(a) One render forward + backward of ``sum_loss`` on phase 5(b)'s train
cell (100K splats, SH 3, 800x800, view 0) through the kernel route,
``backend="pallas", binning="xla"`` and ``"tiles"`` (its
``tile_capacity`` the next multiple of ``chunk`` at or above the densest
tile, so that nothing is dropped), each image and alpha held against the
kernel route's at atol 3e-5 outside the pixels of the pairs the two
binnings' depth keys may order differently (``tie_pixels``; none at
800x800) and the pixels whose early stop the two float orders put at
different instances (``stop_flips``), together counted and bounded at 2 %
of the frame, each gradient within 3e-3 of its largest value;
``"dense"`` on phase 11's 20K-splat dense entity at 400x400 against the
kernel route there at the bounds JAX holds dense against tiles (image and
alpha 5e-3, outside the pixels that a splat's tail past the tiled
routes' 3-sigma cap reaches, ``tail_pixels``, counted; gradients 2e-2 of
the largest). ``binning="xla"`` launches
the forward and backward kernels once each and expand never; both
kernels are held against their plain versions at its shapes
(``xla_*`` records). (b) ``render_fast(binning="xla")`` on phase 4's
random 1M at 1920x1080 beside the kernel-binned frame: its launches (the
forward once, expand never) and the forward against its plain version.
(c) The loss bars of ``tests/test_train.py`` through JAX's CPU routes,
each over the fewest steps at which it held on the card
(``chip_smoke.BAR_STEPS``: ADC+ 120, MCMC 60, 2DGS 20, where the
reference's tests run 150, 150 and 60): ADC+ and MCMC through
``"tiles"``, MCMC with the normal-consistency loss through ``"tiles"``
for 20 steps (its second-pass geometry renders;
finite, the loss falling), 2DGS through ``"surfel"``. (d) ``render(backend="surfel")``'s
compositor with the geometry planes, forward + backward, on phase 6(b)'s
train2d cell (its alive surfels) against the surfel kernel route: image
and alpha atol 5e-5 (outside the stop flips, bounded at 2 %), the planes
2e-4 at 99 % of the pixels (grazing intersections' depths are
ill-conditioned in float32), the pixel counts within 2, the gradients
of ``sum_loss`` without the depth planes within 3e-3 of their largest
value, and with them every field but the scales within 3e-3 and the
scales within ``SCALES_PLANES_BAR`` (their gradient through the planes is
a float32 cancellation, in JAX's kernel route too).
The loss bars of (c) composite each tile's 1024 instance positions in
one step (``BAR_CHUNK``), which changes only float rounding. (e) ``apps.render --backend tiles --orbit 2`` at
1280x720 on phase 11(c)'s edited model: the PNGs, the densest tile and
the tiles past JAX's ``tile_capacity`` of 1024, whose farthest instances
both packages drop.
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
import time

import numpy as np
import torch

import chip_smoke as CS
from divshot_tpu_torch import _build
from divshot_tpu_torch.apps import render as render_app
from divshot_tpu_torch.gsio.io import save_model
from divshot_tpu_torch.gsio.png import read_png
from divshot_tpu_torch.gsio.synthetic import orbit_cameras, random_scene
from divshot_tpu_torch.raster import bin as B
from divshot_tpu_torch.raster import raster as R
from divshot_tpu_torch.raster import surfel as SF
from divshot_tpu_torch.raster import surfel_raster as SR
from divshot_tpu_torch.raster import tiles as TL
from divshot_tpu_torch.raster.render import frame_inputs, render_fast
from divshot_tpu_torch.train.trainer import Trainer

CHUNK = 32
TIMED_CALLS = 1           # a route's forward + backward takes up to ~1 s
# the loss bars' chunk (instance positions a compositor step takes): the
# whole tile_capacity (1024), one step a render. JAX's compositors give
# the same result at any chunk that divides tile_capacity, but for float
# rounding; at 64 px one step launches an eighth of 128's kernels
BAR_CHUNK = 1024
XLA = dict(backend="pallas", binning="xla")
# the near-tie pixels allowed, a share of the frame (their bounding
# squares are a superset of the discs tests/test_torch_scene.py bounds at
# the same share)
TIE_SHARE = 0.02
# (d) the scale gradient through the depth planes, a float32 cancellation
# of per-instance rows: the kernel route may be as far from the XLA route
# as JAX's own kernel route is from a float64 run of the XLA compositor
# on the CPU at TINY (0.670 of the largest value, where the port's kernel
# route is 0.125 and was 0.850 with JAX's prefix-sum reduce:
# tests/test_torch_segment.py)
SCALES_PLANES_BAR = 0.670
# the surfel planes' pixels allowed past 2e-4: a grazing intersection's
# depth is ill-conditioned in float32 (ROADMAP.md, "Properties of the
# reference"), so two float orders of it differ there
PLANES_SHARE = 0.01


def card_label(device: torch.device) -> str:
    """The card's ``nvidia-smi`` name and power limit (phase 1's
    reading), for each line."""
    if device.type != "cuda":
        return "CPU rehearsal"
    return CS.CARD.get("smi") or (f"{torch.cuda.get_device_name(0)}, power "
                                 f"limit not readable")


def tile_capacity_for(params, cam, icap: int) -> tuple[int, int]:
    """-> (the densest tile's instances on the tiles binning, the next
    multiple of ``CHUNK`` at or above it)."""
    with torch.no_grad():
        proj, _, _ = frame_inputs(params, cam)
        tb = TL.bin_gaussians(proj.means2d, proj.depths, proj.radii,
                              cam.width, cam.height, instance_capacity=icap,
                              build_ids_mat=False, radii_xy=proj.radii_xy,
                              rad2=proj.rad2)
    densest = int(tb.tile_counts.max())
    return densest, max(CHUNK, -(-densest // CHUNK) * CHUNK)


def xla_frame(params, cam, cap: int) -> CS.Frame:
    """The frame of ``params`` seen by ``cam`` binned as ``render(...,
    binning="xla")`` bins it (``tiles.bin_gaussians``), for
    ``kernel_records``; its ``pp`` is the kernel binning's prep (the same
    counts and demand) and it has no expand keys."""
    w, h = cam.width, cam.height
    proj, colors, opac = frame_inputs(params, cam)
    pargs = tuple(None if x is None else x.detach() for x in (
        proj.means2d, proj.depths, proj.radii, proj.radii_xy, proj.rad2))
    tb = TL.bin_gaussians(*pargs[:3], w, h, instance_capacity=cap,
                          build_ids_mat=False, radii_xy=pargs[3],
                          rad2=pargs[4])
    table = R.build_feature_table(proj.means2d.detach(),
                                  proj.conics.detach(), colors.detach(),
                                  opac.detach(), tb.inst_gauss)
    bins = B.SortedBins(table=table, tile_start=tb.tile_start,
                        s_owner=tb.inst_gauss, perm=tb.perm,
                        g_offsets=tb.g_offsets, g_counts=tb.g_counts,
                        num_instances=tb.num_instances,
                        tile_counts=tb.tile_counts)
    return CS.Frame(CS.GAUSS, params, {}, cam, cap, 3, proj, colors, opac,
                    pargs, B.prep(*pargs, w, h, 16, 64), None, None,
                    tb.inst_gauss, bins)


def tie_pixels(params, cam) -> tuple[torch.Tensor, int]:
    """(H, W) pixels inside the overlap of the two splats' bounding
    squares of every pair that the kernel binning's depth key
    (``bin.prep``) and the tiles binning's (``tiles.bin_gaussians``) may
    order differently: splats adjacent in depth that one key ties (the
    stable sorts then keep their expansion order) and the other does not
    -> (the mask, the number of such pairs). None at 64 tiles or more,
    where both keys keep the same bits of the depth."""
    w, h = cam.width, cam.height
    with torch.no_grad():
        proj, _, _ = frame_inputs(params, cam)
    _, depth_bits = B.key_bits(w, h, 16)
    tile_bits = 32 - depth_bits
    lo = max(tile_bits, (64).bit_length())
    inf = torch.full((), float("inf"), device=proj.depths.device)
    dbits = torch.where(proj.depths > 0, proj.depths, inf).contiguous() \
        .view(torch.int32).long()
    key_t = (dbits >> lo) << (lo - tile_bits)
    key_k = B.prep(proj.means2d, proj.depths, proj.radii, proj.radii_xy,
                   proj.rad2, w, h, 16, 64).depth_key
    idx = torch.nonzero(params.alive & (proj.radii > 0))[:, 0]
    o = idx[torch.argsort(proj.depths[idx], stable=True)]
    k = torch.nonzero((key_t[o[1:]] == key_t[o[:-1]])
                      != (key_k[o[1:]] == key_k[o[:-1]]))[:, 0]
    a, b = o[k], o[k + 1]
    m, r = proj.means2d, proj.radii

    def span(axis, hi):
        lo_ = torch.maximum(m[a, axis] - r[a], m[b, axis] - r[b])
        up = torch.minimum(m[a, axis] + r[a], m[b, axis] + r[b])
        return (torch.clamp(torch.floor(lo_), 0, hi).long(),
                torch.clamp(torch.ceil(up), 0, hi).long())
    x0, x1 = span(0, w)
    y0, y1 = span(1, h)
    ok = (x1 > x0) & (y1 > y0)
    diff = torch.zeros((h + 1, w + 1), dtype=torch.int32, device=m.device)
    ones = torch.ones_like(x0[ok], dtype=torch.int32)
    for ys, xs, sign in ((y0, x0, 1), (y0, x1, -1), (y1, x0, -1),
                         (y1, x1, 1)):
        diff.index_put_((ys[ok], xs[ok]), sign * ones, accumulate=True)
    cover = diff.cumsum(0).cumsum(1)[:h, :w] > 0
    return cover, int(k.numel())


def tail_pixels(params, cam, chunk: int = 256) -> torch.Tensor:
    """(H, W) pixels that a splat reaches with alpha >= 1/255 outside its
    3-sigma ellipse. The tiled routes composite a splat only inside its
    3-sigma rectangle and radius (the CUDA reference's truncation, JAX's
    ``project_gaussians`` radius cap); ``"dense"`` composites it wherever
    alpha >= 1/255, so only these pixels see other splats on the two."""
    with torch.no_grad():
        proj, _, opac = frame_inputs(params, cam)
        keep = proj.radii > 0
        m, con, op = proj.means2d[keep], proj.conics[keep], opac[keep]
        w, h = cam.width, cam.height
        gy, gx = torch.meshgrid(
            torch.arange(h, device=m.device) + 0.5,
            torch.arange(w, device=m.device) + 0.5, indexing="ij")
        gx, gy = gx.reshape(-1), gy.reshape(-1)
        mask = torch.zeros_like(gx, dtype=torch.bool)
        for lo in range(0, m.shape[0], chunk):
            dx = gx[None, :] - m[lo:lo + chunk, 0:1]
            dy = gy[None, :] - m[lo:lo + chunk, 1:2]
            c = con[lo:lo + chunk]
            power = (-0.5 * (c[:, 0:1] * dx * dx + c[:, 2:3] * dy * dy)
                     - c[:, 1:2] * dx * dy)
            alpha = op[lo:lo + chunk, None] * torch.exp(power)
            mask |= ((alpha >= 1.0 / 255.0) & (power < -4.5)).any(0)
    return mask.reshape(h, w)


def stop_flips(alpha, ref_alpha) -> torch.Tensor:
    """(H, W) pixels where two routes' float32 orders took the early stop
    (T (1 - alpha) < t_eps) at different instances: there the final
    transmittances differ by the skipped instance's factor (1 - a), a
    relative change of a >= 1/255, where rounding alone moves it by far
    less than 1e-3."""
    t, t_ref = 1.0 - alpha.detach(), 1.0 - ref_alpha.detach()
    return (t - t_ref).abs() > 1e-3 * t_ref.abs()


def _grad_rel(got, want) -> float:
    """Largest |got - want| over the largest |want|, over the fields."""
    return max(float((g - w).abs().max()) / max(float(w.abs().max()), 1e-30)
               for g, w in zip(got, want) if w is not None)


def run_route(params, cam, icap: int, device, scale, loss_fn=CS.sum_loss,
              **kw):
    """One render forward + backward on the route ``kw`` names -> (its
    output, its gradients, its launches, its ms over ``timing_iters``)."""
    CS.sync(device)
    _build.reset_launches()
    (out, grads), ms = CS.timed(lambda: CS.render_forward_backward(
        CS.GAUSS, params, cam, icap, loss_fn=loss_fn, **kw), device)
    launches = dict(_build.LAUNCHES)
    return out, grads, launches, warm_ms(lambda: CS.render_forward_backward(
        CS.GAUSS, params, cam, icap, loss_fn=loss_fn, **kw), device, scale,
        ms)


def warm_ms(fn, device, scale, first_ms: float) -> float:
    """Mean ms of ``fn()`` after the call just made: CUDA events over
    ``TIMED_CALLS`` calls on a card; on the CPU (a rehearsal) the first
    call's host time."""
    if device.type != "cuda":
        return first_ms
    return CS.time_ms(fn, device, TIMED_CALLS, warmup=0)


def routes_train_cell(device, scale, label: str) -> list[dict]:
    """(a) The kernel, ``binning="xla"`` and ``"tiles"`` routes on the
    train cell; ``"dense"`` on the dense entity; the ``xla_*`` records."""
    secs, t0 = {}, time.perf_counter()

    def lap(key):
        nonlocal t0
        secs[key] = time.perf_counter() - t0
        t0 = time.perf_counter()

    cfg, ds, params = CS._bench_setup(device, scale)
    cam = ds.cameras[0]
    with torch.no_grad():
        demand = int(render_fast(params, cam,
                                 instance_capacity=scale.probe_capacity
                                 )[2].num_instances)
    icap = CS.auto_icap(demand)
    lap("setup")
    densest, tcap = tile_capacity_for(params, cam, icap)
    ties, n_pairs = tie_pixels(params, cam)
    n_tie = int(ties.sum())
    CS.log(f"  (a) {label}: train cell {params.num_alive} splats at "
           f"{cam.width}x{cam.height}, demand {demand}, capacity {icap}; "
           f"densest tile {densest} instances, tiles route tile_capacity "
           f"{tcap}; {n_pairs} pairs the two binnings' depth keys may "
           f"order differently, covering {n_tie} pixels")
    if n_tie > TIE_SHARE * cam.width * cam.height:
        raise AssertionError(f"(a) {n_tie} near-tie pixels")
    keep = ~ties
    runs = {name: run_route(params, cam, icap, device, scale, **kw)
            for name, kw in (("kernel", {}), ("xla", XLA),
                             ("tiles", dict(backend="tiles",
                                            tile_capacity=tcap,
                                            chunk=CHUNK)))}
    lap("routes")
    # expand, forward, backward and segment_rows
    want = {"kernel": (1, 1, 1, 1), "xla": (0, 1, 1, 1),
            "tiles": (0, 0, 0, 0)}
    ref_out, ref_g = runs["kernel"][:2]
    errs = {}
    for name, (out, grads, launches, ms) in runs.items():
        CS._check_frame(out.image.detach(), out.alpha.detach(),
                        f"(a) {name}")
        got = tuple(launches[k] for k in CS.TRAIN_KERNELS)
        if device.type == "cuda" and got != want[name]:
            raise AssertionError(f"(a) {name}: launches {launches}")
        flips = stop_flips(out.alpha, ref_out.alpha)
        ok = keep & ~flips
        img_err = float((out.image - ref_out.image).detach().abs()[ok]
                        .max())
        alpha_err = float((out.alpha - ref_out.alpha).detach().abs()[ok]
                          .max())
        g_err = _grad_rel(grads, ref_g)
        errs[name] = dict(
            ms=ms, image=img_err, alpha=alpha_err, grad=g_err,
            launches=got, stop_flips=int(flips.sum()),
            image_all=float((out.image - ref_out.image).detach().abs()
                            .max()))
        if not (img_err <= 3e-5 and alpha_err <= 3e-5 and g_err <= 3e-3
                and n_tie + int(flips.sum())
                <= TIE_SHARE * cam.width * cam.height):
            raise AssertionError(f"(a) {name} against the kernel route: "
                                 f"{errs[name]}")
    # "dense": O(N pixels), on the dense entity at a small frame
    res = scale.routes[0]
    small = random_scene(np.random.default_rng(12), scale.editor[2],
                         sh_degree=3, device=device)
    dcam = orbit_cameras(1, width=res, device=device)[0]
    with torch.no_grad():
        dcap = CS.auto_icap(int(render_fast(
            small, dcam, instance_capacity=scale.probe_capacity
        )[2].num_instances))
    dk = run_route(small, dcam, dcap, device, scale)
    dd = run_route(small, dcam, dcap, device, scale, backend="dense")
    tails = tail_pixels(small, dcam)
    d_img = (dd[0].image - dk[0].image).detach().abs()
    d_err = dict(ms=dd[3], kernel_ms=dk[3],
                 image=float(d_img[~tails].max()),
                 alpha=float((dd[0].alpha - dk[0].alpha).detach().abs()
                             [~tails].max()),
                 grad=_grad_rel(dd[1], dk[1]), launches=tuple(
                     dd[2][k] for k in CS.TRAIN_KERNELS),
                 tail_pixels=int(tails.sum()), image_all=float(d_img.max()))
    errs["dense"] = d_err
    lap("dense")
    if not (d_err["image"] <= 5e-3 and d_err["alpha"] <= 5e-3
            and d_err["grad"] <= 2e-2):
        raise AssertionError(f"(a) dense against the kernel route: {d_err}")
    CS.log(f"  (a) {label}: render forward + backward of sum_loss (ms; "
           f"image, alpha and gradient errors against the kernel route, "
           f"the image's outside the pixels whose early stop the two "
           f"float orders put at different instances, their count and the "
           f"image's error there too; launches of expand, forward, "
           f"backward): " + "; ".join(
               f"{k} {v['ms']:.3f} ms, {v['image']:.3e} / {v['alpha']:.3e}"
               f" / {v['grad']:.3e}, {v.get('stop_flips', '-')} pixels, "
               f"{v.get('image_all', v['image']):.3e}, {v['launches']}"
               for k, v in errs.items())
           + f" (dense: {small.num_alive} splats at {res}x{res}, its "
           f"image and alpha outside the {d_err['tail_pixels']} pixels "
           f"that a splat's tail past its 3-sigma cap reaches, the "
           f"image's error there {d_err['image_all']:.3e}; the kernel "
           f"route there {d_err['kernel_ms']:.3f} ms)")
    fr = xla_frame(params, cam, icap)
    cot = CS.loss_cotangent(fr, CS.sum_loss)
    recs = CS.kernel_records(
        f"xla_train_{scale.train_splats}_{scale.train_res}", fr, device,
        scale, runs["xla"][2], cot=cot, expand=False, with_absgrad=True)
    lap("records")
    CS.log(f"  (a) {label}: seconds " + ", ".join(
        f"{k} {v:.2f}" for k, v in secs.items()))
    for r in recs:
        r.update(routes=errs, densest_tile=densest, tie_pixels=n_tie,
                 seconds=secs)
    return recs


def routes_fast(device, scale, label: str) -> list[dict]:
    """(b) ``render_fast(binning="xla")`` on the random 1M at the frame
    size, beside the kernel-binned frame."""
    rnd = random_scene(np.random.default_rng(0), scale.random_splats,
                       sh_degree=3, scale_range=(0.004, 0.025),
                       device=device)
    cam = orbit_cameras(1, width=scale.width, height_px=scale.height,
                        device=device)[0]
    with torch.no_grad():
        demand = int(render_fast(rnd, cam,
                                 instance_capacity=scale.probe_capacity
                                 )[2].num_instances)
        icap = CS.auto_icap(demand)
        (img, alpha, bins), launches = CS.count_launches(
            lambda: render_fast(rnd, cam, instance_capacity=icap,
                                binning="xla"),
            device, None, "(b) render_fast(binning=\"xla\")",
            only_steps=False, kernels=("forward",))
        if device.type == "cuda" and (launches["expand"], launches[
                "forward"]) != (0, 1):
            raise AssertionError(f"(b) launches {launches}")
        CS._check_frame(img, alpha, "(b) render_fast xla")
        ref, _, _ = render_fast(rnd, cam, instance_capacity=icap)
        diff = float((img - ref).abs().max())
        xla_ms = CS.time_ms(lambda: render_fast(
            rnd, cam, instance_capacity=icap, binning="xla"), device,
            scale.timing_iters)
        kern_ms = CS.time_ms(lambda: render_fast(
            rnd, cam, instance_capacity=icap), device, scale.timing_iters)
    CS.log(f"  (b) {label}: render_fast at {cam.width}x{cam.height}, "
           f"{rnd.num_alive} splats, demand {demand}, capacity {icap}: "
           f"binning=\"xla\" {xla_ms:.3f} ms a frame, the kernel binning "
           f"{kern_ms:.3f} ms; largest difference of the two images "
           f"{diff:.3e}")
    with torch.no_grad():
        fr = xla_frame(rnd, cam, icap)
    recs = CS.kernel_records(f"xla_random_{scale.random_splats}", fr,
                             device, scale, launches, expand=False)
    for r in recs:
        r.update(frame_ms=xla_ms, kernel_binned_frame_ms=kern_ms,
                 image_diff=diff)
    return recs


def routes_bars(device, scale, label: str) -> dict:
    """(c) The loss bars through JAX's CPU routes, each run for at most
    its ``chip_smoke.BAR_STEPS`` and checked when it runs them; these
    routes launch no kernel."""
    mcmc = CS.BARS_3DGS[1]
    normal = ("mcmc_normal", mcmc[1], None, mcmc[3],
              {"normal_consistency_loss": True, "normal_start_iter": 0},
              mcmc[5])
    steps_normal = scale.routes[6]
    out = {}
    setups = {}       # the strategy sets the config alone: one scene each
    for cases, rk, most in (
            (CS.BARS_3DGS + (normal,), {"backend": "tiles"}, scale.routes[4]),
            (CS.BARS_2DGS, {"backend": "surfel"}, scale.routes[5])):
        for name, strategy, bar, setup_kw, cfg_kw, densify_kw in cases:
            key = tuple(sorted(setup_kw.items()))
            if key not in setups:
                setups[key] = CS.small_setup(np.random.default_rng(0),
                                             strategy, device, **setup_kw)
            cfg, ds, params = setups[key]
            cfg = dataclasses.replace(cfg, densify=dataclasses.replace(
                cfg.densify, strategy=strategy), **cfg_kw)
            params = dataclasses.replace(params, **{
                f: getattr(params, f).clone() for f in CS.PARAM_FIELDS})
            for k, v in densify_kw.items():
                setattr(cfg.densify, k, v)
            tr = Trainer(cfg, ds, params, render_kwargs={
                "instance_capacity": 1 << 15, **rk, "chunk": BAR_CHUNK})
            n_steps = steps_normal if bar is None else min(
                most, CS.BAR_STEPS[name])
            losses = []
            t0 = time.perf_counter()
            _, launches = CS.count_launches(
                lambda: tr.run(n_steps, log_every=0,
                               callback=lambda i, st, m: losses.append(
                                   m["loss"])),
                device, n_steps, f"(c) {name} on {rk['backend']}",
                only_steps=False, kernels=())
            dt = time.perf_counter() - t0
            if any(launches.values()):
                raise AssertionError(f"(c) {name}: launches {launches}")
            losses = torch.stack(losses).cpu().numpy()
            first, last = (float(np.mean(losses[:10])),
                           float(np.mean(losses[-10:])))
            out[name] = dict(route=rk["backend"], ratio=last / first,
                             bar=bar, s=dt)
            CS.log(f"  (c) {label}: {name} through {rk['backend']!r}, "
                   f"{n_steps} steps in {dt:.2f} s, loss first-10 "
                   f"{first:.5f} last-10 {last:.5f} (ratio "
                   f"{last / first:.4f}, bar {bar})")
            if not np.isfinite(losses).all():
                raise AssertionError(f"(c) {name}: non-finite loss")
            if n_steps >= CS.BAR_STEPS.get(name, steps_normal) and \
                    device.type == "cuda" and not last < (bar or 1.0) * first:
                raise AssertionError(f"(c) {name}: loss ratio "
                                     f"{last / first:.4f}, bar {bar}")
    return out


def routes_surfel(device, scale, label: str) -> dict:
    """(d) The XLA surfel compositor against the surfel kernel route on
    the train2d cell, with the planes, forward + backward."""
    cfg, ds, params = CS._bench_setup(device, scale, model_type=1)
    cam = ds.cameras[0]
    # the alive surfels alone: the XLA route bins every row with a radius,
    # as JAX's does, and the capacity's dead rows, all at the origin, would
    # fill one tile with ~31K instances that no pixel composites
    alive = torch.nonzero(params.alive)[:, 0]
    params = CS.GaussianParams(**{f: getattr(params, f)[alive]
                                  for f in CS.PARAM_FIELDS})
    with torch.no_grad():
        demand = int(SR.render_surfels(
            params, cam, instance_capacity=scale.probe_capacity
        ).num_instances)
        pr = SF.project_surfels(params.means, params.scales, params.quats,
                                cam)
        tb = TL.bin_gaussians(pr["center2d"], pr["depths"], pr["radii"],
                              cam.width, cam.height,
                              instance_capacity=CS.auto_icap(demand),
                              build_ids_mat=False)
    icap = CS.auto_icap(max(demand, int(tb.num_instances)))
    densest = int(tb.tile_counts.max())
    tcap = max(CHUNK, -(-densest // CHUNK) * CHUNK)

    def loss_fn(out):
        # without the depth planes: their scale gradient is a float32
        # cancellation (z at the intersection does not depend on the
        # scales), held apart below
        return CS.sum_loss(out.image, out.alpha, out.extra[..., 2:])

    def run(xla: bool):
        """-> (output, the gradients of ``loss_fn``, the pixel counts, the
        leaves; the graph kept for the loss with the planes)."""
        p, leaves = CS._grad_leaves(params)
        sink = torch.zeros((p.capacity,), device=device, requires_grad=True)
        if xla:
            out, npix = SF.render_surfels(p, cam, instance_capacity=icap,
                                          tile_capacity=tcap, chunk=CHUNK,
                                          with_geometry=True)
        else:
            out, npix = SR.render_surfels(p, cam, instance_capacity=icap,
                                          with_geometry=True,
                                          npix_sink=sink), None
        g = torch.autograd.grad(loss_fn(out), [*leaves.values(), sink],
                                allow_unused=True, retain_graph=True)
        return out, list(g[:-1]), g[-1] if npix is None else npix, leaves

    def with_planes(out, leaves):
        return list(torch.autograd.grad(
            CS.sum_loss(out.image, out.alpha, out.extra),
            list(leaves.values()), allow_unused=True))

    # one timed call of each (the XLA route's takes seconds)
    (ko, kg, kn, kl), k_ms = CS.timed(lambda: run(False), device)
    (xo, xg, xn, xl), x_ms = CS.timed(lambda: run(True), device)
    kp, xp = with_planes(ko, kl), with_planes(xo, xl)
    i_sc = list(kl).index("scales")
    ms = {"kernel": k_ms, "surfel": x_ms}
    flips = stop_flips(xo.alpha, ko.alpha)
    d_planes = (xo.extra - ko.extra).detach().abs().amax(-1)[~flips]
    errs = dict(
        image=float((xo.image - ko.image).detach().abs()[~flips].max()),
        alpha=float((xo.alpha - ko.alpha).detach().abs()[~flips].max()),
        planes=float(d_planes.max()),
        planes_over=float((d_planes > 2e-4).float().mean()),
        stop_flips=int(flips.sum()),
        npix=float((xn - kn).abs().max()), grad=_grad_rel(xg, kg),
        grad_planes=_grad_rel([g for i, g in enumerate(xp) if i != i_sc],
                               [g for i, g in enumerate(kp) if i != i_sc]),
        scales_planes=_grad_rel(xp[i_sc:i_sc + 1], kp[i_sc:i_sc + 1]),
        ms=ms, densest_tile=densest)
    CS.log(f"  (d) {label}: train2d cell {params.num_alive} surfels at "
           f"{cam.width}x{cam.height}, densest tile {densest} "
           f"(tile_capacity {tcap}): render(backend=\"surfel\") forward + "
           f"backward {ms['surfel']:.3f} ms, the surfel kernels "
           f"{ms['kernel']:.3f} ms; against them, outside the "
           f"{errs['stop_flips']} pixels whose early stop the two float "
           f"orders put at different instances, image {errs['image']:.3e},"
           f" alpha {errs['alpha']:.3e}, planes {errs['planes']:.3e} "
           f"(above 2e-4 at {errs['planes_over']:.2e} of the pixels), "
           f"pixel counts {errs['npix']:.0f}, gradients of sum_loss "
           f"without the depth planes {errs['grad']:.3e} of the largest; "
           f"with them, every field but the scales "
           f"{errs['grad_planes']:.3e}, the scales "
           f"{errs['scales_planes']:.3e} (bar {SCALES_PLANES_BAR})")
    if not (errs["image"] <= 5e-5 and errs["alpha"] <= 5e-5
            and errs["planes_over"] <= PLANES_SHARE and errs["npix"] <= 2
            and errs["grad"] <= 3e-3 and errs["grad_planes"] <= 3e-3
            and errs["scales_planes"] <= SCALES_PLANES_BAR
            and errs["stop_flips"] <= TIE_SHARE * cam.width * cam.height):
        raise AssertionError(f"(d) the XLA surfel route: {errs}")
    return errs


def routes_app(device, scale, label: str) -> dict:
    """(e) ``apps.render --backend tiles`` on the edited model."""
    _, aw, ah, orbit = scale.routes[:4]
    params = CS.EDITED.get("params")
    source = "phase 11's edited model"
    if params is None:
        params, source = CS._load(CS.MODEL, device, scale), CS.MODEL.name
    cams = render_app.orbit_for_model(params, orbit, radius=4.0, width=aw,
                                      height=ah, fov=50.0)
    cap, demand = render_app.orbit_capacity(params, cams)
    counts = []
    with torch.no_grad():
        for c in cams:
            proj, _, _ = frame_inputs(params, c)
            counts.append(TL.bin_gaussians(
                proj.means2d, proj.depths, proj.radii, aw, ah,
                instance_capacity=cap, build_ids_mat=False,
                radii_xy=proj.radii_xy, rad2=proj.rad2).tile_counts)
    counts = torch.stack(counts)
    out = dict(densest_tile=int(counts.max()),
               tiles_over_1024=int((counts > 1024).sum()),
               demand=demand, capacity=cap)
    with tempfile.TemporaryDirectory() as tmp:
        ply = f"{tmp}/edited.ply"
        save_model(ply, params)
        argv = ["--model", ply, "--orbit", str(orbit), "--width", str(aw),
                "--height", str(ah), "--backend", "tiles", "--out",
                f"{tmp}/tiles", "--device", device.type]
        t0 = time.perf_counter()
        _, launches = CS.count_launches(
            lambda: CS._run_app(render_app.main, argv,
                                "(e) apps.render --backend tiles"),
            device, None, "(e) apps.render --backend tiles",
            only_steps=False, kernels=())
        out["s"] = time.perf_counter() - t0
        pngs = sorted(os.listdir(f"{tmp}/tiles"))
        if len(pngs) != orbit or any(launches.values()):
            raise AssertionError(f"(e) {pngs}, launches {launches}")
        for name in pngs:
            img = read_png(f"{tmp}/tiles/{name}")
            if img.shape != (ah, aw, 3) or int(img.max()) == 0:
                raise AssertionError(f"(e) {name}: {img.shape}")
    CS.log(f"  (e) {label}: apps.render --backend tiles --orbit {orbit} at "
           f"{aw}x{ah} on {source} ({params.num_alive} splats): "
           f"{out['s']:.2f} s, {orbit} PNGs; densest tile "
           f"{out['densest_tile']} instances, {out['tiles_over_1024']} "
           f"tile views past the tile_capacity of 1024 (their farthest "
           f"instances dropped, as in JAX); demand {demand}, capacity "
           f"{cap}")
    return out


def phase_routes(device: torch.device, scale) -> list[dict]:
    """Phase 12: (a) the routes on the train cell and dense entity with
    the ``xla_*`` records, (b) ``render_fast(binning="xla")``, (c) the
    loss bars through ``"tiles"`` and ``"surfel"``, (d) the XLA surfel
    route against the surfel kernels, (e) ``apps.render --backend
    tiles``."""
    label = card_label(device)
    parts = {}

    def part(key, fn):
        t0 = time.perf_counter()
        res = fn(device, scale, label)
        parts[key] = time.perf_counter() - t0
        CS.log(f"  ({key}) done in {parts[key]:.2f} s")
        return res

    recs = part("a", routes_train_cell)
    recs += part("b", routes_fast)
    bars = part("c", routes_bars)
    surfel = part("d", routes_surfel)
    app = part("e", routes_app)
    CS.EDITED.clear()
    for r in recs:
        r.update(bars=bars, surfel=surfel, app=app, parts_s=parts)
    return recs
