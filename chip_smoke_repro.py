"""The segment kernel's check and the train step's reproducibility check,
for ``chip_smoke.py`` (phases 5, 6, 12 and 14, through its
``kernel_records`` and ``train_bench``) and ``tools/repro_probe.py``.

``check_segment`` holds the segment reduce (``raster.segment_rows``,
``csrc/segment.cu``: a stage launch and a reduce launch) against its plain
versions run in float64, within the worst-case bound of the kernel's order
of additions, and a second call bitwise. ``steps_twice`` runs a train step twice from copies of one state
in PyTorch's default mode and compares the losses and every tensor the
state carries; ``reproducible`` requires them bitwise equal.
"""

from __future__ import annotations

import dataclasses

import torch

from divshot_tpu_torch.raster import bin as B
from divshot_tpu_torch.raster import raster as R
from divshot_tpu_torch.train.trainer import TrainState

PARAM_FIELDS = ("means", "scales", "quats", "opacity", "sh0", "shN",
                "alive")


def _cs():
    """``chip_smoke`` (its timer and log), imported at call time: that
    script imports this module while it loads."""
    import chip_smoke
    return chip_smoke


# float32's unit roundoff: the segment kernel's sums are held against the
# float64 sum within the worst-case bound of their order of additions
EPS32 = 2.0 ** -24


def segment_bound_terms(lens: torch.Tensor) -> torch.Tensor:
    """Per gaussian, at least the most roundings any of its terms goes
    through in the segment reduce (csrc/segment.cu): a team of w lanes
    (8, 32, or the block's 256) adds ceil(len / w) - 1 in a lane, log2(min(w,
    32)) in the butterfly, and a block 7 more adding its 8 warp sums; each
    is at most ceil(len / 8) + 11. The bound on a sum's error is that count
    times EPS32 times the sum of its terms' magnitudes."""
    return torch.div(lens + 7, 8, rounding_mode="floor") + 12


def check_segment(grads: torch.Tensor, bins: B.SortedBins, nrows: int,
                  device: torch.device, iters: int) -> tuple:
    """The segment reduce (``raster.segment_rows``: the stage and the
    reduce launch) on a backward's rows: a second call bitwise equal, and
    each sum within ``segment_bound_terms(len) * EPS32 * sum|terms|`` of
    the plain versions run in float64 -> a ``_records`` row with the
    pair's time and each launch's alone, the float32 plain versions', the
    times of two PyTorch calls computing the same sums (``index_add_`` of
    the rows already in expansion order, and ``index_add_`` straight from
    the sorted rows by each kept position's owner), and the bytes the
    function must move: each live instance's rows, every slot index of the
    segments, the offsets and counts, and the sums."""
    icap = grads.shape[1]
    rows = range(nrows)
    args = (bins.tile_start, bins.perm, bins.g_offsets, bins.g_counts, rows)
    seg = (bins.g_offsets, bins.g_counts)
    got = R.segment_rows(grads, *args)
    if not torch.equal(got, R.segment_rows(grads, *args)):
        raise AssertionError("segment_rows: two calls differ")

    def plain(g):
        return R.segment_reduce_plain(R.segment_stage_plain(g, *args), *seg,
                                      nrows)

    want = plain(grads.double())
    mags = plain(grads.abs().double())
    slot, owner = R.segment_owners(*seg, icap)
    lens = torch.bincount(owner, minlength=bins.g_counts.shape[0])
    # on the CPU the wrapper runs the plain versions, which add a
    # segment's L terms one after another: L - 1 roundings at most
    terms = (segment_bound_terms(lens) if grads.device.type == "cuda"
             else torch.clamp_min(lens - 1, 0))
    bound = terms.double() * EPS32 * mags
    err = (got.double() - want).abs()
    if not torch.equal(torch.isnan(got), torch.isnan(want)):
        raise AssertionError("segment_rows: NaN sums differ from plain")
    err = torch.nan_to_num(err, nan=0.0)
    ratio = float((err / bound.clamp_min(1e-300)).max()) if err.numel() \
        else 0.0
    if not ratio <= 1.0:
        raise AssertionError(f"segment_rows: a sum {ratio:.3f} times its "
                             f"bound from the float64 sum")
    kept = int(bins.tile_start[-1])
    # the kept positions whose slots lie in a segment (every one, on both
    # binnings)
    live_pos = bins.perm[:kept] < slot.numel()
    live = int(live_pos.sum())
    records = R.segment_stage(grads, *args)
    vals = records[slot, :nrows].T.contiguous()
    acc = grads.new_zeros((nrows, lens.numel()))
    time_ms = _cs().time_ms
    library_ms = time_ms(lambda: acc.index_add_(1, owner, vals), device,
                         iters)
    # each kept position's owner, n (a column no one reads) where its slot
    # lies in no segment
    n = lens.numel()
    s_owner = torch.where(live_pos, bins.s_owner[:kept].long(), n)
    acc_sorted = grads.new_zeros((nrows, n + 1))
    sorted_ms = time_ms(lambda: acc_sorted.index_add_(
        1, s_owner, grads[:nrows, :kept]), device, iters)
    ms = time_ms(lambda: R.segment_rows(grads, *args), device, iters)
    stage_ms = time_ms(lambda: R.segment_stage(grads, *args), device, iters)
    reduce_ms = time_ms(lambda: R.segment_reduce(records, *seg, nrows),
                        device, iters)
    plain_ms = time_ms(lambda: R.segment_reduce_plain(
        R.segment_stage_plain(grads, *args), *seg, nrows), device, 1,
        warmup=0)
    nbytes = live * nrows * 4 + slot.numel() * 4 + n * 8 + nrows * n * 4
    return ("segment_rows", float(err.max()) if err.numel() else 0.0, ms,
            plain_ms, nbytes, live * nrows,
            {"library_ms": library_ms,
             "library": "index_add_ of the rows in expansion order",
             "library_sorted": "index_add_ of the sorted rows by owner",
             "library_sorted_ms": sorted_ms, "stage_ms": stage_ms,
             "reduce_ms": reduce_ms, "bound_ratio": ratio, "rows": nrows,
             "live_instances": live,
             "longest_segment": int(lens.max()) if n else 0})


def clone_state(state: TrainState) -> TrainState:
    """A copy of ``state`` that shares no tensor and no generator with it
    (a step may update its input in place, and its draws advance the
    generator)."""
    gen = torch.Generator(device=state.gen.device)
    gen.set_state(state.gen.get_state())
    return TrainState(
        params=dataclasses.replace(state.params, **{
            f: getattr(state.params, f).clone() for f in PARAM_FIELDS}),
        opt=dataclasses.replace(state.opt, **{
            k: {f: t.clone() for f, t in getattr(state.opt, k).items()}
            for k in ("mu", "nu")}),
        dstate=dataclasses.replace(state.dstate, **{
            f.name: getattr(state.dstate, f.name).clone()
            for f in dataclasses.fields(state.dstate)}),
        gen=gen, bg=None if state.bg is None else {
            k: t.clone() for k, t in state.bg.items()})


def state_tensors(state: TrainState) -> dict[str, torch.Tensor]:
    """Every tensor a train step carries to the next: the parameters, the
    Adam moments, the densify statistics, the envmap and the generator's
    state."""
    out = {f"params.{f}": getattr(state.params, f) for f in PARAM_FIELDS}
    for k in ("mu", "nu"):
        out.update({f"{k}.{f}": t for f, t in getattr(state.opt, k).items()})
    out.update({f"dstate.{f.name}": getattr(state.dstate, f.name)
                for f in dataclasses.fields(state.dstate)})
    out.update({f"bg.{k}": t for k, t in (state.bg or {}).items()})
    out["gen"] = state.gen.get_state()
    return out


def max_diff(a: torch.Tensor, b: torch.Tensor) -> float:
    if a.dtype == torch.bool or not a.is_floating_point():
        return float((a.long() - b.long()).abs().max()) if a.numel() else 0.0
    return float((a.float() - b.float()).abs().nan_to_num(
        nan=float("inf")).max()) if a.numel() else 0.0


def steps_twice(step_fn, state: TrainState, views: list, what: str,
                check: bool = True) -> dict:
    """``step_fn`` over ``views`` twice from copies of ``state``, as the
    trainer runs (PyTorch's default mode) -> the largest difference of each
    loss and state tensor between the two runs, all 0 when bitwise equal;
    with ``check``, raises on any difference."""
    runs = []
    for _ in range(2):
        st, losses = clone_state(state), []
        for v in views:
            st, m = step_fn(st, v)
            losses.append(m["loss"])
        runs.append((torch.stack(losses), state_tensors(st)))
    (la, ta), (lb, tb) = runs
    diffs = {"loss": max_diff(la, lb)}
    diffs.update({k: max_diff(ta[k], tb[k]) for k in ta})
    differ = {k: v for k, v in diffs.items()
              if k != "loss" and not torch.equal(ta[k], tb[k])}
    if not torch.equal(la, lb):
        differ["loss"] = diffs["loss"]
    if differ and check:
        raise AssertionError(f"{what}: two runs of {len(views)} steps from "
                             f"one state differ: {differ}")
    return diffs


def reproducible(step_fn, fresh: TrainState, trained: TrainState, ds,
                 what: str) -> None:
    """The train step run twice in PyTorch's default mode, bitwise equal:
    one step from the fresh state (Adam's first step moves each parameter
    by a whole learning rate times the sign of its gradient, so a
    difference in the last bit of a gradient shows there as a whole
    learning rate) and two steps from the trained one."""
    steps_twice(step_fn, fresh, [0], f"{what} first step")
    steps_twice(step_fn, trained, [i % ds.num_views for i in range(2)],
                f"{what} at step {trained.step}")
    _cs().log(
        f"  {what}: the first step from the fresh state and 2 steps from "
        f"step {trained.step}, each run twice in PyTorch's default mode: "
        f"the losses, parameters, Adam moments, densify statistics and "
        f"the generator bitwise equal")
