"""The segment reduce's two launches (``csrc/segment.cu``) through their
plain versions on the CPU: ``raster.segment_stage_plain`` (each sorted
position's rows written instance-major to its expansion slot) then
``raster.segment_reduce_plain`` (each gaussian's contiguous run of
records summed), composed, against ``raster.segment_rows_plain`` (the same
function gathered through the inverse permutation), **bitwise**: both add
each gaussian's live terms one after another in slot order, a culled term
as +0.0 to a sum that is never -0.0. ``segment_rows_plain`` itself is held
against JAX's reduces in ``tests/test_torch_segment.py``.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from divshot_tpu_torch.gsio.synthetic import orbit_cameras, random_scene
from divshot_tpu_torch.raster import bin as B
from divshot_tpu_torch.raster import raster as R
from divshot_tpu_torch.raster import render as RD
from divshot_tpu_torch.raster import surfel_raster as SR
from divshot_tpu_torch.raster import tiles as TL
from divshot_tpu_torch.raster.render import frame_inputs

CPU = "cpu"


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().view(torch.int32)


def _inverse(perm: torch.Tensor) -> torch.Tensor:
    """Each expansion slot's sorted position (``exp2sorted``)."""
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(perm.numel())
    return inv.int()


def _both(grads, tile_start, perm, g_offsets, g_counts, rows):
    """-> (the two launches' plain versions composed, the records,
    ``segment_rows_plain`` through the inverse permutation), after checking
    that the wrapper on the CPU gives the composition's bits."""
    nrows = len(rows)
    records = R.segment_stage_plain(grads, tile_start, perm, g_offsets,
                                    g_counts, rows)
    got = R.segment_reduce_plain(records, g_offsets, g_counts, nrows)
    want = R.segment_rows_plain(grads, tile_start, _inverse(perm), g_offsets,
                                g_counts, rows)
    wrapped = R.segment_rows(grads, tile_start, perm, g_offsets, g_counts,
                             rows)
    assert torch.equal(_bits(wrapped), _bits(got))
    return got, records, want


def _scene(n: int, res: int, seed: int, big: bool = False):
    """``n`` random splats at ``res`` x ``res``, the first 10 culled (radius
    0); with ``big`` the last one's screen radius covers the whole frame."""
    params = random_scene(np.random.default_rng(seed), n, sh_degree=0,
                          device=CPU)
    cam = orbit_cameras(1, width=res, device=CPU)[0]
    proj, colors, opac = frame_inputs(params, cam)
    radii = torch.cat([torch.zeros(10), proj.radii[10:]])
    proj = proj._replace(radii=radii)
    if big:
        r = torch.full((1,), float(res))
        proj = proj._replace(
            means2d=torch.cat([proj.means2d[:-1],
                               torch.tensor([[res / 2.0, res / 2.0]])]),
            depths=torch.cat([proj.depths[:-1], torch.ones(1)]),
            radii=torch.cat([radii[:-1], r]),
            radii_xy=torch.cat([proj.radii_xy[:-1], r.expand(1, 2)]),
            rad2=torch.cat([proj.rad2[:-1],
                            torch.full((1,), 4.0 * res * res)]))
    return proj, colors, opac


def _kernel_bins(cap: int, n: int = 300, res: int = 320, seed: int = 3):
    proj, colors, opac = _scene(n, res, seed, big=True)
    return B.expand_sorted(proj.means2d, proj.conics, proj.depths,
                           proj.radii, proj.radii_xy, proj.rad2, colors,
                           opac, width=res, height=res, instance_capacity=cap,
                           mt=256, guard_lanes=1024)


def _rows(nrows: int, cap: int, seed: int) -> torch.Tensor:
    return torch.tensor(np.random.default_rng(seed).standard_normal(
        (nrows, cap)).astype(np.float32))


@pytest.mark.parametrize("nrows,stride", [(12, 16), (25, 32)])
def test_stage_then_reduce_on_kernel_bins(nrows, stride):
    """The kernel binning's bins (culled instances, the guard band's cut,
    gaussians without instances, one splat at the cap of 256 tiles) with
    the 3DGS backward's 12 rows and the surfel backward's 25: the records'
    layout, and the composition bitwise ``segment_rows_plain``."""
    cap = 1 << 12
    sb = _kernel_bins(cap)
    kept = int(sb.tile_start[-1])
    assert int(sb.g_counts[-1]) == 256 and bool((sb.g_counts == 0).any())
    assert 0 < kept < int(sb.num_instances) <= cap
    # the kernel's precondition: the first ``demand`` positions hold the
    # first ``demand`` slots
    demand = int(sb.num_instances)
    assert bool((sb.perm[:demand] < demand).all())
    grads = _rows(nrows, cap, nrows)
    got, records, want = _both(grads, sb.tile_start, sb.perm, sb.g_offsets,
                               sb.g_counts, range(nrows))
    assert torch.equal(_bits(got), _bits(want))
    assert records.shape == (cap, stride) == (cap, R.segment_stride(nrows))
    # a live position's rows at its slot, zeros past them; a culled one's
    # record all zeros
    j = torch.arange(cap)
    slot = sb.perm
    live = j < kept
    assert torch.equal(records[slot[live], :nrows], grads[:, live].T)
    assert not records[:, nrows:].any()
    culled = (~live) & (slot < int(sb.num_instances))
    assert bool(culled.any()) and not records[slot[culled]].any()


def test_stage_then_reduce_on_xla_bins_with_a_long_segment():
    """The XLA binning's bins (``tiles.bin_gaussians``, no cap of 256):
    one splat covers all 1024 tiles of a 512x512 frame, past the block's
    limit of 512 slots; its ``perm`` is the sort's own."""
    proj, _, _ = _scene(400, 512, 7, big=True)
    cap = 1 << 13
    tb = TL.bin_gaussians(proj.means2d, proj.depths, proj.radii, 512, 512,
                          instance_capacity=cap,
                          max_tiles_per_gaussian=1024, build_ids_mat=False,
                          radii_xy=proj.radii_xy, rad2=proj.rad2)
    assert int(tb.g_counts[-1]) == 1024
    assert torch.equal(_inverse(tb.perm), tb.exp2sorted)
    demand = int(tb.num_instances)
    assert demand < cap and bool((tb.perm[:demand] < demand).all())
    grads = _rows(12, cap, 8)
    got, _, want = _both(grads, tb.tile_start, tb.perm, tb.g_offsets,
                         tb.g_counts, range(12))
    assert torch.equal(_bits(got), _bits(want))
    assert float(got[:, -1].abs().max()) > 0


def test_culled_nan_rows_do_not_leak_and_a_live_nan_does():
    """NaN in every culled position's rows (and the capacity tail): every
    sum stays finite; a NaN in one live position's row gives NaN in that
    row of its gaussian only; both bitwise ``segment_rows_plain``."""
    cap = 1 << 12
    sb = _kernel_bins(cap)
    kept = int(sb.tile_start[-1])
    grads = _rows(12, cap, 5)
    grads[:, kept:] = float("nan")
    args = (sb.tile_start, sb.perm, sb.g_offsets, sb.g_counts, range(12))
    got, _, want = _both(grads, *args)
    assert torch.isfinite(got).all()
    assert torch.equal(_bits(got), _bits(want))
    grads[4, 7] = float("nan")
    owner = int(sb.s_owner[7])
    got, _, want = _both(grads, *args)
    assert torch.equal(_bits(got), _bits(want))
    assert torch.isnan(got).nonzero().tolist() == [[4, owner]]


def test_counts_cut_at_the_capacity_and_splats_without_instances():
    """A demand past the capacity: the straddling splat's segment cut at
    the capacity, the splats past it and those without instances 0."""
    cap = 1 << 11
    sb = _kernel_bins(cap, n=600)
    off, cnt = sb.g_offsets.long(), sb.g_counts.long()
    assert int(sb.num_instances) > cap
    cut = (off < cap) & (off + cnt > cap)
    past = off >= cap
    empty = cnt == 0
    assert bool(cut.any()) and bool(past.any()) and bool(empty.any())
    got, _, want = _both(_rows(12, cap, 9), sb.tile_start, sb.perm,
                         sb.g_offsets, sb.g_counts, range(12))
    assert torch.equal(_bits(got), _bits(want))
    assert not got[:, past | empty].any()


@pytest.mark.parametrize("rows", [range(1, 12, 2), range(11, -1, -3),
                                  [4, 0, 5, 11]])
def test_rows_with_a_step(rows):
    """A ``range`` of rows with a step, a descending one, and a list: the
    records hold those rows in that order."""
    cap = 1 << 12
    sb = _kernel_bins(cap, seed=4)
    grads = _rows(12, cap, 6)
    got, records, want = _both(grads, sb.tile_start, sb.perm, sb.g_offsets,
                               sb.g_counts, rows)
    assert got.shape == (len(rows), sb.g_counts.shape[0])
    assert records.shape[1] == R.segment_stride(len(rows))
    assert torch.equal(_bits(got), _bits(want))


@pytest.mark.parametrize("route", ["kernel", "xla", "surfel"])
def test_routes_hand_the_sort_permutation_to_the_reduce(monkeypatch, route):
    """Each backward route passes its binning's own ``perm`` to the stage,
    not a tensor built from it, and the reduce's sums reach the splats'
    gradients."""
    binned, staged = [], []
    if route == "xla":
        bin_fn, mod, name = TL.bin_gaussians, TL, "bin_gaussians"
    else:
        mod = RD if route == "kernel" else SR
        bin_fn, name = mod.expand_sorted, "expand_sorted"
    stage = R.segment_stage

    def bin_spy(*a, **k):
        binned.append(bin_fn(*a, **k))
        return binned[-1]

    def stage_spy(grads, tile_start, perm, *a):
        staged.append(perm)
        return stage(grads, tile_start, perm, *a)

    monkeypatch.setattr(mod, name, bin_spy)
    monkeypatch.setattr(R, "segment_stage", stage_spy)
    params = random_scene(np.random.default_rng(2), 200, sh_degree=0,
                          device=CPU)
    cam = orbit_cameras(1, width=64, device=CPU)[0]
    means = params.means.detach().requires_grad_(True)
    params = type(params)(**{**vars(params), "means": means})
    if route == "surfel":
        out = SR.render_surfels(params, cam, instance_capacity=1 << 12)
    else:
        out = RD.render(params, cam, instance_capacity=1 << 12,
                        binning="pallas" if route == "kernel" else "xla")
    out = out if hasattr(out, "image") else out[0]
    out.image.sum().backward()
    assert len(binned) == 1 and len(staged) == 1
    assert staged[0] is binned[0].perm and staged[0].dtype == torch.int64
    assert float(means.grad.abs().max()) > 0
