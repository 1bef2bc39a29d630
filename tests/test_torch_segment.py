"""The per-splat gradient reduce (``raster.segment_rows``, whose kernel is
``csrc/segment.cu``) on the CPU, where it runs its plain version
``raster.segment_rows_plain``, against JAX's reduces and float64.

Tolerances, each with its reason:

- against JAX's ``pallas_bin.segment_rows_sorted`` /
  ``reduce_grads_sorted`` and ``pallas_raster.reduce_instance_grads`` (XLA
  on the CPU): 2e-5 of the largest segment sum, the bar of the existing
  parity tests; JAX sums by differences of one float32 cumsum over the
  capacity, the port each gaussian's own terms;
- against float64: any order of adding L float32 terms is within (L - 1)
  x 2^-24 x the sum of their magnitudes of the exact sum (Higham's bound
  for recursive summation), so the plain version is held to that;
- the surfel route's scale gradient through the depth planes: measured
  against a float64 run of the XLA surfel compositor, the port's kernel
  route no further from it than JAX's own kernel route (interpret mode).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from divshot_tpu.raster import pallas_bin as jax_bin
from divshot_tpu.raster import pallas_raster as jax_raster
from divshot_tpu.raster import pallas_surfel as jax_ps
from divshot_tpu.raster.surfel import render_surfels as jax_render_surfels
from divshot_tpu.splat.camera import Camera as JCamera
from divshot_tpu.splat.gaussians import GaussianParams as JParams

import jax

from divshot_tpu_torch.gsio.synthetic import orbit_cameras, random_scene
from divshot_tpu_torch.raster import bin as B
from divshot_tpu_torch.raster import raster as R
from divshot_tpu_torch.raster import surfel as SF
from divshot_tpu_torch.raster import surfel_raster as SR
from divshot_tpu_torch.raster import tiles as TL
from divshot_tpu_torch.raster.render import frame_inputs

CPU = "cpu"
EPS32 = 2.0 ** -24
FIELDS = ("means", "scales", "quats", "opacity", "sh0", "shN")


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / (np.abs(b).max() + 1e-12)


def _big_splat_scene(n: int, res: int, seed: int):
    """``n`` random splats, the first 10 culled (radius 0) and, last, one
    whose screen radius covers the whole ``res`` x ``res`` frame: its
    segment is every tile."""
    params = random_scene(np.random.default_rng(seed), n, sh_degree=0,
                          device=CPU)
    cam = orbit_cameras(1, width=res, device=CPU)[0]
    proj, colors, opac = frame_inputs(params, cam)
    big = torch.full((1,), float(res), dtype=proj.radii.dtype)
    centre = torch.tensor([[res / 2.0, res / 2.0]])
    proj = proj._replace(
        means2d=torch.cat([proj.means2d[:-1], centre]),
        depths=torch.cat([proj.depths[:-1], torch.ones(1)]),
        radii=torch.cat([torch.zeros(10), proj.radii[10:-1], big]),
        radii_xy=torch.cat([proj.radii_xy[:-1], big.expand(1, 2).float()]),
        rad2=torch.cat([proj.rad2[:-1], torch.full((1,), 4.0 * res * res)]))
    return proj, colors, opac


@pytest.mark.parametrize("nch", [3, 5])
def test_plain_reduce_matches_jax_on_kernel_bins(nch):
    """The kernel binning's bins (culled instances, the capacity tail cut
    by the guard clamp, gaussians without instances, one splat at the
    binning's cap of 256 tiles): the plain reduce against JAX's
    ``segment_rows_sorted`` and ``reduce_grads_sorted``."""
    proj, colors, opac = _big_splat_scene(300, 320, nch)
    cols = colors if nch == 3 else torch.cat([colors, colors[:, :2]], 1)
    cap = 1 << 12
    sb = B.expand_sorted(proj.means2d, proj.conics, proj.depths, proj.radii,
                         proj.radii_xy, proj.rad2, cols, opac, width=320,
                         height=320, instance_capacity=cap, mt=256,
                         guard_lanes=1024)
    counts = sb.g_counts
    kept = int(sb.tile_start[-1])
    assert int(counts[-1]) == 256 and bool((counts == 0).any())
    assert 0 < kept < cap and int(sb.num_instances) > kept
    ngrad = 9 + nch
    rows = np.random.default_rng(nch).standard_normal(
        (ngrad, cap)).astype(np.float32)
    got = B.segment_rows_sorted(torch.tensor(rows), sb, range(ngrad))
    args = [jnp.asarray(x.numpy()) for x in (sb.tile_start, sb.s_owner,
                                              sb.g_offsets, sb.g_counts)]
    num_tiles = sb.tile_start.shape[0] - 1
    want = jax_bin.segment_rows_sorted(
        jnp.asarray(rows), jnp.zeros((num_tiles, ngrad, 256)), *args,
        rows=list(range(ngrad)))
    assert _rel(got.numpy(), want) < 2e-5
    red = B.reduce_grads_sorted(torch.tensor(rows), sb, nch=nch)
    padded = np.zeros((jax_raster._ngrad_rows(nch), cap), np.float32)
    padded[:ngrad] = rows
    jred = jax_bin.reduce_grads_sorted(
        jnp.asarray(padded), jnp.zeros((num_tiles, padded.shape[0], 256)),
        *args, nch=nch)
    for k in ("means2d", "conics", "colors", "opacity", "absgrad", "npix"):
        assert _rel(red[k].numpy(), jred[k]) < 2e-5, k


def test_plain_reduce_matches_jax_on_xla_bins_with_a_long_segment():
    """The XLA binning's bins (``tiles.bin_gaussians``, no cap of 256):
    one splat covers all 1024 tiles of a 512x512 frame, a segment longer
    than the kernel's one-warp limit; against JAX's
    ``pallas_raster.reduce_instance_grads``."""
    proj, _, _ = _big_splat_scene(400, 512, 7)
    cap = 1 << 13
    tb = TL.bin_gaussians(proj.means2d, proj.depths, proj.radii, 512, 512,
                          instance_capacity=cap,
                          max_tiles_per_gaussian=1024, build_ids_mat=False,
                          radii_xy=proj.radii_xy, rad2=proj.rad2)
    assert int(tb.g_counts[-1]) == 1024 and bool((tb.g_counts == 0).any())
    assert int(tb.tile_start[-1]) < cap
    rows = np.random.default_rng(8).standard_normal((12, cap)).astype(
        np.float32)
    got = R.reduce_instance_grads(torch.tensor(rows), tb.tile_start,
                                  tb.perm, tb.g_offsets, tb.g_counts)
    num_tiles = tb.tile_start.shape[0] - 1
    want = jax_raster.reduce_instance_grads(
        jnp.asarray(rows), jnp.zeros((num_tiles, 12, 256)),
        *[jnp.asarray(x.numpy()) for x in (tb.tile_start, tb.exp2sorted,
                                            tb.g_offsets, tb.g_counts)])
    for k in ("means2d", "conics", "colors", "opacity", "absgrad", "npix"):
        assert _rel(got[k].numpy(), want[k]) < 2e-5, k


@pytest.mark.parametrize("case", ["overflow", "empty", "one", "rows"])
def test_plain_reduce_against_a_loop(case):
    """Each gaussian's sum as a Python loop over its slots, in float64:
    a demand past the capacity (the segments cut there, the gaussians
    past it 0), no instance at all, one gaussian, and rows in no
    arithmetic order."""
    rng = np.random.default_rng(3)
    icap = 64
    counts = {"overflow": [5, 0, 30, 0, 40, 7], "empty": [0, 0, 0],
              "one": [17], "rows": [3, 9, 0, 12]}[case]
    counts = np.asarray(counts, np.int32)
    offsets = np.cumsum(counts) - counts
    grads = rng.standard_normal((6, icap)).astype(np.float32)
    perm = rng.permutation(icap)
    kept = 50
    rows = [4, 0, 5] if case == "rows" else range(6)
    # the wrapper takes each sorted position's slot: perm's inverse
    args = (torch.tensor([0, kept], dtype=torch.int32),
            torch.tensor(np.argsort(perm)), torch.tensor(offsets),
            torch.tensor(counts), rows)
    got = R.segment_rows(torch.tensor(grads), *args)
    want = np.zeros((len(rows), counts.size))
    for g, (o, c) in enumerate(zip(offsets, counts)):
        for slot in range(o, min(o + c, icap)):
            if perm[slot] < kept:
                want[:, g] += grads[list(rows), perm[slot]]
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_plain_reduce_bounded_where_the_prefix_formula_is_not():
    """Segments whose terms (~1e3) cancel to ~1e-1, after a gaussian of
    2^20 large instances: each plain sum is within (L - 1) eps sum|terms|
    of float64, the bound of any order of adding its L terms. JAX's
    formula (``pallas_bin.segment_rows_sorted``: differences of one
    float32 cumsum over the capacity) carries the prefix's rounding, about
    eps x 1e9, into those sums, far past the same bound."""
    rng = np.random.default_rng(11)
    prefix, seg_len, n_seg = 1 << 20, 32, 64
    icap = prefix + seg_len * n_seg
    vals = np.empty((2, icap), np.float32)
    vals[:, :prefix] = rng.uniform(500.0, 1500.0, (2, prefix))
    half = rng.uniform(500.0, 1500.0, (2, n_seg, seg_len // 2))
    tail = rng.uniform(-0.1, 0.1, (2, n_seg, seg_len // 2))
    # +t, -t + a small remainder: the segment sums to ~1e-1
    seg = np.concatenate([half, -half + tail], 2).astype(np.float32)
    seg = np.take_along_axis(seg, np.argsort(rng.random(seg.shape), 2), 2)
    vals[:, prefix:] = seg.reshape(2, -1)
    counts = np.array([prefix] + [seg_len] * n_seg, np.int32)
    offsets = (np.cumsum(counts) - counts).astype(np.int32)
    tile_start = torch.tensor([0, icap], dtype=torch.int32)
    ident = torch.arange(icap, dtype=torch.int32)
    got = R.segment_rows(torch.tensor(vals), tile_start, ident,
                         torch.tensor(offsets), torch.tensor(counts),
                         range(2)).numpy()[:, 1:]
    exact = seg.astype(np.float64).sum(2)
    bound = (seg_len - 1) * EPS32 * np.abs(seg.astype(np.float64)).sum(2)
    assert (np.abs(got - exact) <= bound).all()
    # a cancellation: each sum far below the magnitudes of its terms
    assert (np.abs(exact) < 1e-4 * np.abs(seg).sum(2)).all()
    want = np.asarray(jax_bin.segment_rows_sorted(
        jnp.asarray(vals), jnp.zeros((1, 2, 256)), jnp.asarray(tile_start),
        jnp.asarray(np.repeat(np.arange(1 + n_seg, dtype=np.int32), counts)),
        jnp.asarray(offsets), jnp.asarray(counts), rows=[0, 1]))[:, 1:]
    assert (np.abs(want - exact) > bound).any()
    assert np.abs(want - exact).max() > 10 * np.abs(got - exact).max()


def _prefix_formula(grads, tile_start, perm, g_offsets, g_counts, rows):
    """JAX's formula (``pallas_bin.segment_rows_sorted``) in PyTorch: each
    sum the difference of two entries of one float32 cumsum over the
    capacity, gathered through the inverse of the sort's permutation."""
    icap = grads.shape[1]
    exp2sorted = torch.empty_like(perm)
    exp2sorted[perm] = torch.arange(icap)
    zero = torch.zeros(())
    live = torch.arange(icap) < tile_start[-1]
    g = torch.where(live[None, :], grads[list(rows)], zero)
    cs = torch.cumsum(torch.index_select(g, 1, exp2sorted.long()), 1)
    hi = (g_offsets + g_counts - 1).long()
    e = torch.where(hi[None, :] >= 0, cs[:, torch.clamp(hi, 0, icap - 1)],
                    zero)
    e_prev = torch.cat([e.new_zeros((len(g), 1)), e[:, :-1]], 1)
    return torch.where((g_counts > 0)[None, :], e - e_prev, zero)


def test_surfel_depth_plane_scale_gradient_classified(monkeypatch):
    """The surfel kernel route's scale gradient of sum(image) + 0.01
    sum(planes), on the train2d cell cut to 500 surfels at 64x64, against
    a float64 run of the port's XLA surfel compositor (its binning in
    float32: JAX's binning and compositor take float32 only). JAX's own
    kernel route (interpret mode) is far from it: the scale gradient
    through the depth planes is a float32 cancellation of per-instance
    rows. The port's kernel route with JAX's prefix formula was further
    still; with the per-segment reduce it is within JAX's kernel route's
    error, and every other field within 1e-4 of its largest value."""
    # chip_smoke._bench_setup's draws at its TINY scale: the 300
    # ground-truth splats first, then the 500 trained ones
    rng = np.random.default_rng(0)
    sr = (0.004, 0.025)
    random_scene(rng, 300, sh_degree=3, scale_range=sr, device=CPU)
    cam = orbit_cameras(2, width=64, device=CPU)[0]
    params = random_scene(rng, 500, sh_degree=3, scale_range=sr, device=CPU)
    icap = 1 << 16

    def loss(out):
        return out.image.sum() + 0.01 * out.extra.sum()

    def port(route, p, **kw):
        p = dataclasses.replace(p, **{f: getattr(p, f).detach()
                                      .requires_grad_(True) for f in FIELDS})
        out = route(p, cam, instance_capacity=icap, with_geometry=True,
                    **kw)
        out = out if hasattr(out, "image") else out[0]
        return [g.numpy() for g in torch.autograd.grad(
            loss(out), [getattr(p, f) for f in FIELDS])]

    bin32 = TL.bin_gaussians
    monkeypatch.setattr(TL, "bin_gaussians", lambda *a, **k: bin32(
        *[x.float() if torch.is_tensor(x) and x.is_floating_point() else x
          for x in a], **{n: x.float() if torch.is_tensor(x)
                          and x.is_floating_point() else x
                          for n, x in k.items()}))
    ref = port(SF.render_surfels, dataclasses.replace(params, **{
        f: getattr(params, f).double() for f in FIELDS}),
        tile_capacity=1024)
    monkeypatch.setattr(TL, "bin_gaussians", bin32)
    new = port(SR.render_surfels, params)
    with monkeypatch.context() as m:
        m.setattr(B, "segment_rows", _prefix_formula)
        old = port(SR.render_surfels, params)
    jp = JParams(**{f: jnp.asarray(getattr(params, f).numpy())
                    for f in (*FIELDS, "alive")})
    jc = JCamera(viewmat=jnp.asarray(np.asarray(cam.viewmat)),
                 fx=jnp.float32(cam.fx), fy=jnp.float32(cam.fy),
                 cx=jnp.float32(cam.cx), cy=jnp.float32(cam.cy),
                 width=cam.width, height=cam.height)

    def jax_scales(render, **kw):
        def f(scales):
            out, _ = render(jp.replace(scales=scales), jc,
                            instance_capacity=icap, with_geometry=True, **kw)
            return loss(out)
        return np.asarray(jax.grad(f)(jp.scales))

    gaps = {"jax_kernel": _rel(jax_scales(jax_ps.render_surfels_pallas,
                                          interpret=True), ref[1]),
            "jax_xla": _rel(jax_scales(jax_render_surfels,
                                       tile_capacity=1024), ref[1]),
            "port_prefix": _rel(old[1], ref[1]),
            "port": _rel(new[1], ref[1])}
    print(f"scale-gradient gaps from float64, of the largest "
          f"{np.abs(ref[1]).max():.4e}: {gaps}")
    assert gaps["jax_xla"] < 0.1 < gaps["jax_kernel"]
    assert gaps["port"] < gaps["jax_kernel"] < gaps["port_prefix"]
    for f, g, r in zip(FIELDS, new, ref):
        if f != "scales":
            assert _rel(g, r) < 1e-4, f
