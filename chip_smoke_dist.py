"""Phase 14 of ``chip_smoke.py``: training over several processes and
tile-sharded rendering (``divshot_tpu_torch/dist``), on the card.
``python3 chip_smoke.py`` runs it after phase 13
(``chip_smoke.phase_dist``); it shares that script's harness
(``_bench_setup``, ``count_launches``, ``make_frame``,
``kernel_records``). ``python3 chip_smoke_dist.py`` runs it alone
(``main``); ``--worker`` is the entry of the processes it spawns.

It trains phase 5(b)'s train cell at its full width (100K random splats
in a 2^17 capacity, SH 3, 4 orbit views at 800x800, MCMC) and renders the
repo's trained model ``runs/tpu_bricks_mcmc`` at 1920x1088 (1080 rows
cannot be cut into bands of whole 16-row tiles, as JAX's
``render_tiled`` asserts).

The steps of (a) and (b) run in PyTorch's default mode: every sum of the
train step is in an order its code fixes (the per-splat reduce is the
segment kernel, ``csrc/segment.cu``), so the serial step is bitwise
reproducible on the card, and (a) first checks that its first step run
twice is bitwise equal.

(a) A world of one on the card (NCCL, a 1x1 mesh, in this process):
``make_parallel_train_step`` and ``make_overlap_train_step`` each for
the scale's steps, each step's loss and the final parameters bitwise
equal to ``make_train_step`` on the same one-view lists; one launch of
each of the expand, forward and backward kernels a step, counted; the
three kernels against their plain versions at the cell's shapes on the
trained state; the it/s of the three.

(b) Two processes on the one card over gloo (NCCL refuses two ranks on
one card), spawned here; they import while (a) runs and touch the card
only when it is done. Each rank: on a 2x1 mesh (one view a rank) the
parallel and the overlap step, the first step against the serial
two-view step run
in that process alone (the loss rtol 1e-5 and the means atol 1e-5,
``tests/test_dist.py:80-84``'s bars), then more steps, after which the
ranks' parameters are bitwise equal (their digests compared here); on a
1x2 mesh, half the moment rows on each rank (the bytes printed) and the
first step against the serial one-view step at the same bars;
``MultiHostTrainer`` for 3 steps, the losses bitwise equal across
ranks. Each rank counts its launches (one of each kernel a step) and
holds its kernels against their plain versions, one rank at a time. A
worker's non-zero exit or its timeout fails the phase, and so does a
worker that loaded JAX or the reference package.

(c) ``render_tiled`` of the trained model at 1920x1088, over one band in
(a)'s world and over two in (b)'s, each against ``render`` of the whole
frame on the kernel route, with the largest difference printed. JAX's
bar, 2e-3 (``tests/test_dist.py:104-107``), is set on random splats
where two effects the bands have, in either package, do not show: the
pixels where the whole frame's sort key ties splats (a band's key keeps
one depth bit more; found as the pixels that change when the frame is
rendered with its splats reversed or shuffled, at most ``TIE_SHARE`` of
it) are left out, and outside them a pixel may pass 2e-3 only by one
alpha-cull flip (``FLIP``), at most ``FLIP_SHARE`` of the frame. One
launch of the expand and the forward kernel a band; both against their
plain versions at band 0 of 2 (the bands' shapes are equal), in this
process while (b)'s workers start.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import json
import os
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

import chip_smoke as CS
from chip_smoke_repro import steps_twice
from divshot_tpu_torch.apps.render import orbit_for_model
from divshot_tpu_torch.dist import (band_camera, make_mesh,
                                    make_parallel_train_step, render_tiled)
from divshot_tpu_torch.dist.mesh import shard_train_state
from divshot_tpu_torch.dist.multihost import (MultiHostTrainer,
                                              host_view_shard, init_multihost)
from divshot_tpu_torch.dist.overlap import make_overlap_train_step
from divshot_tpu_torch.raster.render import render, render_fast
from divshot_tpu_torch.train.trainer import (Dataset, TrainState,
                                             make_train_step,
                                             render_kwargs_from_config)

REPO = Path(__file__).resolve().parent
WORKERS = 2
STEPS = ("parallel", "overlap")
MAKERS = {"parallel": make_parallel_train_step,
          "overlap": make_overlap_train_step}
TILED_BAR = 2e-3          # tests/test_dist.py:104-107
TIE_SHARE = 0.02          # (c)'s tie pixels: at most this share
# (c) outside the tie pixels: a pixel past TILED_BAR is one where a splat's
# alpha sits within rounding of the 1/255 cull (a band's v is rounded
# apart from the frame's), so it differs by at most one such alpha; at
# most FLIP_SHARE of the frame may
FLIP = 1.0 / 255.0
FLIP_SHARE = 1e-5
LOSS_RTOL, MEANS_ATOL = 1e-5, 1e-5


def cell(device: torch.device, scale):
    """Phase 5(b)'s train cell -> (cfg, dataset, params, render kwargs),
    the instance capacity sized from the demand of one probe step by the
    trainer's policy."""
    cfg, ds, params = CS._bench_setup(device, scale)
    _, m = make_train_step(cfg, ds, {"instance_capacity": 1 << 19})(
        TrainState.init(params, seed=0), 0)
    return cfg, ds, params, {"instance_capacity": CS.auto_icap(
        int(m["num_instances"]))}


def warm_groups(mesh, device: torch.device) -> None:
    """One all-reduce in each of the mesh's groups: a group's communicator
    is made at its first collective, outside the steps' timings."""
    for g in (mesh.data_group, mesh.model_group):
        dist.all_reduce(torch.zeros(1, device=device), group=g)


def run_steps(step, state, views: list, device: torch.device):
    """``step`` over ``views`` -> (state, the losses, seconds: CUDA events on
    a card, the host clock on the CPU)."""
    losses = []
    CS.sync(device)
    t0 = time.perf_counter()
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
    for v in views:
        state, m = step(state, v)
        losses.append(m["loss"])
    if device.type == "cuda":
        end.record()
        end.synchronize()
        return state, torch.stack(losses), start.elapsed_time(end) / 1e3
    return state, torch.stack(losses), time.perf_counter() - t0


def same_params(a, b) -> bool:
    return all(torch.equal(getattr(a, f), getattr(b, f))
               for f in CS.PARAM_FIELDS)


def digest(params) -> str:
    h = hashlib.sha256()
    for f in CS.PARAM_FIELDS:
        h.update(getattr(params, f).detach().contiguous().cpu().numpy()
                 .tobytes())
    return h.hexdigest()


def check_launches(launches: dict, kernels, n: int, what: str,
                   device: torch.device) -> None:
    if device.type == "cuda" and any(launches[k] != n for k in kernels):
        raise AssertionError(f"{what}: launches {launches}, expected {n} "
                             f"of each of {kernels}")


def cell_records(scene: str, state, cfg, ds, rk, device, scale,
                 launches: dict, steps: int, **extra) -> list[dict]:
    """The three kernels against their plain versions on view 0 of the
    cell at the trained state, with the cotangent of its loss."""
    fr = CS.make_frame(state.params, ds.cameras[0], rk["instance_capacity"])
    cot = CS.loss_cotangent(fr, CS.train_loss(cfg, ds.images[0], fr.cam,
                                              state.step))
    recs = CS.kernel_records(scene, fr, device, scale, launches, cot=cot,
                             per_step=steps, with_absgrad=
                             render_kwargs_from_config(cfg)["with_absgrad"])
    for r in recs:
        r.update(extra)
    return recs


def first_step_bars(m, st, ref, what: str) -> dict:
    """The first step of a mesh against the serial step ``ref`` (state,
    metrics) at ``tests/test_dist.py:80-84``'s bars."""
    loss, want = float(m["loss"]), float(ref[1]["loss"])
    means = float((st.params.means - ref[0].params.means).abs().max())
    CS.log(f"    {what}: first step loss {loss:.9f} against the serial "
           f"step's {want:.9f}, means within {means:.3e}, bitwise "
           f"{same_params(st.params, ref[0].params)}")
    if not (abs(loss - want) <= LOSS_RTOL * abs(want)
            and means <= MEANS_ATOL):
        raise AssertionError(f"{what}: the first step is off the serial "
                             f"step (loss {loss} vs {want}, means {means})")
    return dict(loss=loss, serial_loss=want, means_diff=means)


# --------------------------------------------------------------------------
# (c) render_tiled


def tiled_scene(device: torch.device, scale):
    """(c)'s model, camera, demand and instance capacity, and ``render``
    of the whole frame."""
    params = CS._load(CS.MODEL, device, scale)
    W, H = scale.dist[3:5]
    cam = orbit_for_model(params, 1, radius=4.0, width=W, height=H,
                          fov=50.0)[0]
    with torch.no_grad():
        demand = int(render_fast(params, cam, instance_capacity=scale
                                 .probe_capacity)[2].num_instances)
        icap = CS.auto_icap(demand)
        ref = render(params, cam, instance_capacity=icap)
        # the splats reversed, and shuffled: the pairs the sort key ties
        # composite in other orders (the sort is stable), and a pixel where
        # the order of tied splats matters changes
        gen = torch.Generator().manual_seed(0)
        ties = torch.zeros_like(ref.alpha, dtype=torch.bool)
        for order in (torch.arange(params.capacity - 1, -1, -1),
                      torch.randperm(params.capacity, generator=gen)):
            o = order.to(device)
            other = render(dataclasses.replace(params, **{
                f: getattr(params, f)[o] for f in CS.PARAM_FIELDS}), cam,
                instance_capacity=icap)
            ties |= (other.image != ref.image).any(-1) | (
                other.alpha != ref.alpha)
    return params, cam, demand, icap, ref, ties


def tiled(device: torch.device, scale, mesh, what: str, scene
          ) -> tuple[dict, dict]:
    """(c) ``render_tiled`` of ``tiled_scene``'s model over the mesh's
    data axis against ``render`` of the whole frame -> (its launches, its
    numbers)."""
    params, cam, demand, icap, ref, ties = scene
    W, H = cam.width, cam.height
    kw = dict(instance_capacity=icap)
    with torch.no_grad():
        (img, alpha), launches = CS.count_launches(
            lambda: render_tiled(params, cam, mesh, **kw),
            device, None, what, only_steps=False,
            kernels=CS.VIEWER_KERNELS)
        check_launches(launches, CS.VIEWER_KERNELS, 1, what, device)
        CS._check_frame(img, alpha, what)
        err = torch.maximum((img - ref.image).abs().amax(-1),
                            (alpha - ref.alpha).abs())
        diff = float(err[~ties].max())
        diff_all = float(err.max())
        over_bar = {k: int((err[m] > TILED_BAR).sum()) for k, m in (
            ("ties", ties), ("rest", ~ties))}
        flips = over_bar["rest"]
        ms = CS.time_ms(lambda: render_tiled(params, cam, mesh, **kw),
                        device, scale.timing_iters)
        n = mesh.n_data
        band_h = H // n
    CS.log(f"  {what}: {params.num_alive} splats at {W}x{H} in {n} "
           f"band(s) of {band_h} rows, demand {demand}, capacity {icap}: "
           f"{ms:.3f} ms a frame; largest difference from render() of the "
           f"whole frame {diff:.3e} outside the {int(ties.sum())} pixels "
           f"where the whole frame's key ties splats (the frame with its "
           f"splats reversed or shuffled differs there), {diff_all:.3e} "
           f"over all; pixels past {TILED_BAR} {over_bar} (outside the tie "
           f"pixels at most {FLIP_SHARE * W * H:.0f}, each within one alpha "
           f"cull flip, {FLIP:.3e})")
    share = float(ties.float().mean())
    if not (diff <= FLIP and flips <= FLIP_SHARE * W * H
            and share <= TIE_SHARE):
        raise AssertionError(f"{what}: {diff} from render() outside "
                             f"{share:.4f} of the frame, {flips} pixels "
                             f"past {TILED_BAR}")
    return launches, dict(bands=n, diff=diff, frame_ms=ms, demand=demand,
                          tie_pixels=int(ties.sum()), diff_all=diff_all,
                          over_bar=over_bar)


def band_records(device: torch.device, scale, scene, n: int) -> list[dict]:
    """The expand and forward kernels against their plain versions at band
    0 of ``n`` (every band has its shapes); the launches, 0 here, are
    rank 0's in (b), set by ``two_processes``."""
    params, cam, _, icap, _, _ = scene
    with torch.no_grad():
        fr = CS.make_frame(params, band_camera(cam, 0, cam.height // n),
                           icap)
    return CS.kernel_records(
        f"tiled_{n}band_{cam.width}x{cam.height}_rank0_tpu_bricks_mcmc", fr,
        device, scale, {k: 0 for k in CS.VIEWER_KERNELS})


# --------------------------------------------------------------------------
# (a) a world of one, in this process


def world_of_one(device: torch.device, scale, warmed=lambda: None
                 ) -> list[dict]:
    """(a) and (c) over one band: the 1x1 mesh on NCCL (gloo on the CPU);
    ``warmed()`` once the process's first steps have loaded its kernels
    (slow while other processes start on the host)."""
    backend = "nccl" if device.type == "cuda" else "gloo"
    t0 = time.perf_counter()

    def mark(what):
        CS.log(f"    (a) {what} at {time.perf_counter() - t0:.2f} s")
    with contextlib.ExitStack() as stack:
        cfg, ds, params, rk = cell(device, scale)
        mark("the cell made")
        n = scale.dist[0]
        views = [[i % ds.num_views] for i in range(n)]
        # the serial step's first step twice, in the default mode
        diffs = steps_twice(make_train_step(cfg, ds, rk),
                            TrainState.init(params, seed=0), views[:1],
                            "(a) the serial step")
        mark("the serial first step twice done")
        CS.log("  (a) the serial step's first step twice in PyTorch's "
               "default mode: the loss and the whole state bitwise equal")
        warmed()
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
        stack.callback(dist.destroy_process_group)
        dist.all_reduce(torch.zeros(1, device=device))  # the communicator
        mark("the process group up")
        mesh = make_mesh(1, 1, devices=[device])
        warm_groups(mesh, device)
        st_s, loss_s, secs = run_steps(make_train_step(cfg, ds, rk),
                                       TrainState.init(params, seed=0),
                                       views, device)
        its = {"serial": n / secs}
        total = {k: 0 for k in CS.TRAIN_KERNELS}
        for name in STEPS:
            st = shard_train_state(TrainState.init(params, seed=0), mesh)
            step = MAKERS[name](cfg, ds, mesh, rk)(st)
            (st, losses, secs), launches = CS.count_launches(
                lambda: run_steps(step, st, views, device), device, n,
                f"(a) 1x1 {name} step ({backend})")
            check_launches(launches, CS.TRAIN_KERNELS, n, f"(a) {name}",
                           device)
            for k in total:
                total[k] += launches[k]
            its[name] = n / secs
            if not (torch.equal(losses, loss_s)
                    and same_params(st.params, st_s.params)):
                diffs = {f: float((getattr(st.params, f).float() - getattr(
                    st_s.params, f).float()).abs().max())
                    for f in CS.PARAM_FIELDS}
                raise AssertionError(
                    f"(a) the 1x1 {name} step is not bitwise the serial "
                    f"step: losses equal {torch.equal(losses, loss_s)}, "
                    f"largest parameter differences {diffs}")
        CS.log(f"  (a) 1x1 world ({backend}): {n} steps each, the parallel "
               f"and overlap steps bitwise the serial step (every loss and "
               f"the final parameters); it/s serial {its['serial']:.3f}, "
               f"parallel {its['parallel']:.3f}, overlap "
               f"{its['overlap']:.3f}")
        mark("the steps done")
        recs = cell_records(
            f"dist_1x1_train_{scale.train_splats}_{scale.train_res}", st,
            cfg, ds, rk, device, scale, total, 2 * n,
            dist=dict(its=its, steps=n, backend=backend))
        recs[-1]["it_per_s"] = its["parallel"]
        mark("the kernel records done")
        scene = tiled_scene(device, scale)
        mark("the tiled scene loaded")
        # one band is the whole frame, whose kernels phase 4 holds
        _, info = tiled(device, scale, mesh,
                        "(c) render_tiled in (a)'s world", scene)
        recs[0]["dist"]["tiled_one_band"] = info
        # (b)'s bands, held here while its workers start
        recs += band_records(device, scale, scene, WORKERS)
    recs[0]["dist"]["default_mode_first_step_diff"] = diffs
    return recs


# --------------------------------------------------------------------------
# (b) two processes on the card over gloo


def worker(rank: int, port: int, out: str, scale, device: torch.device
           ) -> None:
    """One rank of (b) and of (c) over two bands; its results to
    ``out/rank{rank}.json``."""
    spawned = float(os.environ["DIVSHOT_SPAWNED"])
    CS.log(f"    (b) rank {rank}: imported {time.time() - spawned:.2f} s "
           f"after the spawn")
    init_multihost(f"localhost:{port}", WORKERS, rank, backend="gloo")
    CS.log(f"    (b) rank {rank}: in the world {time.time() - spawned:.2f} "
           f"s after the spawn")
    # the card is (a)'s until the go: processes that share a card run
    # time-sliced, and (a) measures its steps
    go = Path(out) / "go"
    t0 = time.perf_counter()
    while not go.exists():
        if time.perf_counter() - t0 > 600:
            raise TimeoutError("no go from the phase")
        time.sleep(0.02)
    t_go = time.perf_counter()
    CS.log(f"    (b) rank {rank}: the go seen {time.time() - spawned:.2f} s "
           f"after the spawn")

    def mark(what):
        CS.log(f"    (b) rank {rank}: {what} at "
               f"{time.perf_counter() - t_go:.2f} s after the go")
    cfg, ds, params, rk = cell(device, scale)
    # the serial references, in this process alone
    two = make_train_step(cfg, ds, rk)(TrainState.init(params, seed=0),
                                       [0, 1])
    one = make_train_step(cfg, ds, rk)(TrainState.init(params, seed=0), [0])
    scene = tiled_scene(device, scale)
    mark("set up")
    res = {"rank": rank}
    mesh21 = make_mesh(WORKERS, 1, devices=[device] * WORKERS)
    mesh12 = make_mesh(1, WORKERS, devices=[device] * WORKERS)
    for m in (mesh21, mesh12):
        warm_groups(m, device)
    n, V = scale.dist[1], ds.num_views
    views = [[(2 * i) % V, (2 * i + 1) % V] for i in range(n)]
    total = {k: 0 for k in CS.KERNELS}
    for name in STEPS:
        st = shard_train_state(TrainState.init(params, seed=0), mesh21)
        step = MAKERS[name](cfg, ds, mesh21, rk)(st)

        def train():
            s, m = step(st, views[0])
            bars = first_step_bars(m, s, two, f"(b) rank {rank} 2x1 {name}")
            s, losses, secs = run_steps(step, s, views[1:], device)
            return s, bars, secs
        (st2, bars, secs), launches = CS.count_launches(
            train, device, n, f"(b) rank {rank} 2x1 {name} step (gloo)")
        check_launches(launches, CS.TRAIN_KERNELS, n, f"(b) {name}", device)
        for k in total:
            total[k] += launches[k]
        res[name] = dict(bars, digest=digest(st2.params),
                         its=(n - 1) / secs if n > 1 else None)
    trained = st2
    mark("2x1 steps done")
    # 1x2: each rank holds half the moment rows
    st = shard_train_state(TrainState.init(params, seed=0), mesh12)
    held = sum(v.numel() * v.element_size() for d in (st.opt.mu, st.opt.nu)
               for v in d.values())
    whole = sum(v.numel() * v.element_size() for d in (two[0].opt.mu,
                                                       two[0].opt.nu)
                for v in d.values())
    st2, m = make_parallel_train_step(cfg, ds, mesh12, rk)(st)(st, [0])
    res["1x2"] = dict(first_step_bars(m, st2, one, f"(b) rank {rank} 1x2"),
                      rows=st2.opt.mu["means"].shape[0], moment_bytes=held,
                      whole_bytes=whole, digest=digest(st2.params))
    CS.log(f"    (b) rank {rank} 1x2: moment rows {res['1x2']['rows']} of "
           f"{params.capacity}, {held} of {whole} moment bytes held")
    mark("1x2 step done")
    # MultiHostTrainer on the streamed step, each rank its shard's images
    images = ds.images.cpu().numpy()
    mine = host_view_shard(V)
    tr = MultiHostTrainer(cfg, Dataset.from_views(ds.cameras, images,
                                                  stream=True), params,
                          mine, [images[v] for v in mine], render_kwargs=rk)
    k = scale.dist[2]
    losses, launches = CS.count_launches(
        lambda: [float(tr.step_once()["loss"]).hex() for _ in range(k)],
        device, k, f"(b) rank {rank} MultiHostTrainer (gloo)")
    check_launches(launches, CS.TRAIN_KERNELS, k, "(b) MultiHostTrainer",
                   device)
    res["multihost"] = dict(views=[int(v) for v in mine], losses=losses,
                            digest=digest(tr.state.params))
    mark("MultiHostTrainer done")
    t_launches, info = tiled(device, scale, mesh21,
                             f"(c) render_tiled in (b)'s world, rank {rank}",
                             scene)
    mark("render_tiled done")
    records = []
    # the kernel records one rank at a time: the card is shared
    for r in range(WORKERS):
        if r == rank:
            records = cell_records(
                f"dist_2x1_rank{rank}_train_{scale.train_splats}_"
                f"{scale.train_res}", trained, cfg, ds, rk, device, scale,
                total, 2 * n, dist=dict(backend="gloo", steps=n))
        dist.barrier()
    mark("kernel records done")
    res["records"] = records
    res["tiled"] = dict(info, launches={k: t_launches[k]
                                        for k in CS.VIEWER_KERNELS})
    res["loaded"] = [m for m in CS_BLOCKED if sys.modules.get(m)]
    with open(Path(out) / f"rank{rank}.json", "w") as f:
        json.dump(res, f, default=lambda o: o.item())
    dist.barrier()
    dist.destroy_process_group()


CS_BLOCKED = ("jax", "jaxlib", "flax", "divshot_tpu")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def spawn(tmp: str, scale, device: torch.device) -> list:
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=str(REPO),
               DIVSHOT_SPAWNED=repr(time.time()))
    name = "full" if scale is CS.FULL else "tiny"
    procs = []
    for r in range(WORKERS):
        log = open(Path(tmp) / f"rank{r}.log", "w")
        procs.append(subprocess.Popen(
            [sys.executable, str(REPO / "chip_smoke_dist.py"), "--worker",
             str(r), str(port), tmp, name, device.type], cwd=REPO, env=env,
            stdout=log, stderr=subprocess.STDOUT))
        log.close()
    return procs


def join(procs, tmp: str, timeout: float) -> list[dict]:
    """Wait for the workers; a non-zero exit or the timeout fails."""
    deadline = time.perf_counter() + timeout
    for p in procs:
        try:
            p.wait(timeout=max(1.0, deadline - time.perf_counter()))
        except subprocess.TimeoutExpired:
            pass
    failed = [r for r, p in enumerate(procs) if p.returncode != 0]
    for r in range(WORKERS):
        text = (Path(tmp) / f"rank{r}.log").read_text()
        lines = [ln for ln in text.splitlines() if "socket.cpp" not in ln]
        if r in failed:
            lines = lines[-60:]
        for ln in lines:
            CS.log(f"  [rank {r}] {ln}")
    if failed:
        raise AssertionError(f"(b) worker(s) {failed} failed or timed out "
                             f"(exit codes {[p.returncode for p in procs]})")
    out = []
    for r in range(WORKERS):
        with open(Path(tmp) / f"rank{r}.json") as f:
            out.append(json.load(f))
    return out


def two_processes(results: list[dict], band_recs: list[dict]
                  ) -> list[dict]:
    """(b) and (c)'s checks across the ranks -> their records, and
    ``band_records``' with rank 0's launches and numbers of (c)."""
    r0, r1 = results
    info = dict(r0["tiled"])
    launches = info.pop("launches")
    for rec in band_recs:
        rec.update(launches=launches[rec["name"]], tiled=info)
    CS.log(f"  (c) rank 0's band: launches {launches}")
    for what in (*STEPS, "1x2", "multihost"):
        if r0[what]["digest"] != r1[what]["digest"]:
            raise AssertionError(f"(b) {what}: the ranks' parameters differ")
    if r0["multihost"]["losses"] != r1["multihost"]["losses"]:
        raise AssertionError("(b) MultiHostTrainer: the ranks' losses "
                             "differ")
    loaded = r0["loaded"] + r1["loaded"]
    if loaded:
        raise AssertionError(f"(b) a worker loaded {loaded}")
    CS.log("  (b) 2 processes over gloo on the one card: the 2x1 parallel "
           "and overlap steps and the 1x2 step with both ranks' parameters "
           "bitwise equal, MultiHostTrainer's losses bitwise equal across "
           f"ranks ({[float.fromhex(x) for x in r0['multihost']['losses']]}"
           f"), views {r0['multihost']['views']} / "
           f"{r1['multihost']['views']}; it/s a rank: " + ", ".join(
               f"{w} {r0[w]['its']:.3f} / {r1[w]['its']:.3f}" for w in STEPS
               if r0[w]["its"]) + f"; moment bytes a rank on the 1x2 mesh "
           f"{r0['1x2']['moment_bytes']} and {r1['1x2']['moment_bytes']} of "
           f"{r0['1x2']['whole_bytes']}")
    recs = []
    for r in results:
        for rec in r["records"]:
            rec.setdefault("dist", {}).update(
                {w: {k: v for k, v in r[w].items() if k != "digest"}
                 for w in (*STEPS, "1x2")})
            recs.append(rec)
    return recs


def phase_dist(device: torch.device, scale) -> list[dict]:
    """Phase 14: (a) and (c) over one band here while (b)'s two workers
    start, then (b) and (c) over two bands in them."""
    with tempfile.TemporaryDirectory() as tmp:
        procs = []
        try:
            t0 = time.perf_counter()
            records = world_of_one(device, scale, lambda: procs.extend(
                spawn(tmp, scale, device)))
            CS.log(f"  (a), (c) one band: done in "
                   f"{time.perf_counter() - t0:.2f} s")
            t0 = time.perf_counter()
            (Path(tmp) / "go").touch()
            results = join(procs, tmp, 900 if scale is CS.FULL else 280)
            records += two_processes(results, [
                r for r in records if r["scene"].startswith("tiled_")])
            CS.log(f"  (b), (c) two bands: done in "
                   f"{time.perf_counter() - t0:.2f} s after the go")
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    return records


def main() -> int:
    """Phase 14 alone on the card: the card's identity, the kernels'
    build, then phase 14 at ``chip_smoke.FULL``."""
    device = torch.device("cuda")
    t_all = time.perf_counter()
    for label, fn in (("1 card identity", CS.phase_identity),
                      ("2 build kernels", CS.phase_build),
                      ("14 multi-process training and tile-sharded "
                       "rendering", phase_dist)):
        t0 = time.perf_counter()
        CS.log(f"phase {label} ...")
        fn(device, CS.FULL)
        CS.log(f"phase {label} ok in {time.perf_counter() - t0:.2f} s")
    CS.log(f"all phases ok in {time.perf_counter() - t_all:.2f} s")
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--worker"]:
        rank, port, out, name, dev = sys.argv[2:7]
        device = torch.device(dev)
        # two processes share the host's cores
        torch.set_num_threads(1 if device.type == "cpu" else 2)
        worker(int(rank), int(port), out,
               CS.FULL if name == "full" else CS.TINY, device)
        sys.exit(0)
    sys.exit(main())
