#!/usr/bin/env python3
"""Smoke check of the PyTorch + CUDA port (``divshot_tpu_torch``) on one
NVIDIA card.

    python3 chip_smoke.py

Phases, each a function of ``(device, scale)``:

1. card identity (fails without a CUDA device);
2. build the kernel library from ``divshot_tpu_torch/csrc`` (one ``nvcc``
   a source, all started together, then one link) and print each
   kernel's registers, shared memory and spills;
3. each kernel against its plain PyTorch version at a bounded size, with
   NaN instances in the inputs, and the backward at nch 3 and 7 with the
   AbsGS rows on and off; each forward and backward kernel on a synthetic
   frame whose long tile is cut into five backward units and the
   forward's cull segments (``unit_split_frame``: NaN, clamping and edge-on
   columns on unit boundaries, pixels that stop inside an earlier unit, a
   unit after every pixel's stop, a tile shorter than a unit), with the
   forward's survivor mask written on the card held against its plain
   cull pass; the expand kernel also on adversarial inputs at 1920x1080
   (zero-count runs longer than several blocks' pieces, every count at mt
   64 and 256, overflow, one gaussian and none, NaN instances). Every
   check launches the kernel twice and requires bitwise equal results;
   the expand kernel's keys and owners and the forwards equal their plain
   versions bitwise, and on every frame whose expansion is checked
   ``sort_instances`` gives the int64 sort's tile ranges, owners and
   permutation (``check_expand``);
4. the viewer path (``divshot_tpu_torch.apps.render``) at 1920x1080 on the
   repo's trained model ``runs/tpu_bricks_mcmc/point_cloud.ply`` and on a
   1M-splat random scene, with the launch counts that prove it went through
   the kernels, per-frame timings, output checks, the stale-bins guard, and
   each kernel against its plain version at the shapes of that path;
5. the training path (``divshot_tpu_torch.train``): (a) the loss bars of
   ``tests/test_train.py`` on its small setup, ADC+ and MCMC, each over
   the fewest steps at which it held on the card (``BAR_STEPS``: 120 and
   60 where the reference's tests run 150); (b) the JAX
   bench's primary training configuration (100K splats, SH 3, 800x800,
   4 views, MCMC), warm-up then 30 steps timed with CUDA events; (c) one
   ``render`` forward + backward of a random 1M-splat scene at 1920x1080
   with a stage breakdown; (d) a few steps of
   ``python -m divshot_tpu_torch.apps.train --demo``; (e) one ``render``
   forward + backward of ``sum_loss`` on the repo's trained model at
   1920x1080, whose longest tile never stops, with its stage breakdown.
   Each of (a)-(e) counts its own kernel launches, and each holds the
   three kernels against their plain versions at its own shapes (the
   backward with the cotangent of its loss and its AbsGS setting), and the
   segment reduce (``csrc/segment.cu``, the per-splat sums of the
   backward's rows: a stage and a reduce launch, counted once a backward)
   against its plain versions run in float64, within the worst-case bound
   of its order of additions, a second call bitwise (``check_segment``); (b) also runs the step twice
   from one state in PyTorch's default mode, the first step from the fresh
   state and 2 steps from the trained one, and requires the losses,
   parameters, Adam moments, densify statistics and generator bitwise
   equal (``reproducible``);
6. the exact-2DGS training path (``model_type=1``): (a) the 2DGS loss bar
   of ``tests/test_train.py:103-113`` met through the surfel kernels
   over 20 steps (``BAR_STEPS``; the reference's test runs 60); (b)
   the train2d cell, phase 5(b)'s scene and views trained as exact
   surfels with the normal-consistency loss from step 0, warm-up then 30
   steps timed with CUDA events, with its stage breakdown; (c) one
   ``render_surfels`` forward + backward of the repo's trained 2DGS model
   ``runs/tpu_bricks_2dgs2/point_cloud.ply`` at 1920x1080; (d) a few steps
   of ``apps.train --demo --model_type 1``. Each counts its own launches
   of the expand and the two surfel kernels and holds them against their
   plain versions at its own shapes (the backward with the cotangent of
   its loss), the segment kernel as in 5, and (b) the step twice from one
   state, bitwise, as in 5(b). Phase 3 also holds the surfel kernels
   against their plain versions at nch 3 and 5, with NaN, edge-on and
   clamping surfels;
7. the dataset path: (a) the procedural ``tpu_bricks`` scene traced on
   the card at its full 800x800 (24 train and 8 test views, cut from 100 +
   25 for the time limit) into a temporary directory and loaded; (b)
   ``apps.train --source_path`` on it with ``--white_background 1`` and
   ``--cap_max 262144``, evals, a periodic checkpoint and the final one,
   stopped half-way through its 100 steps (an eval every 25, a
   checkpoint every 30, an alpha reset every 25); (c) resumed with ``--load_itr -2`` to
   the end. It checks the files, the checkpoint against the state saved
   (bitwise), the eval curve kept up to the resume step, the final PLY
   rendered against the final params (bitwise) and the eval PSNR rising;
   it counts the launches of the resumed run and holds the three kernels
   against their plain versions on its trained state;
8. the trainer's options: (a) phase 5(b)'s train cell, warm-up then 6
   steps timed with CUDA events, with batches of 4 views (4 launches of
   each kernel a step, views/s), the envmap with masks made at run time
   (the left half out), 1/4, 1/2 and full resolution (200x200, 400x400,
   800x800, partial edge tiles at 200), bf16 ``shN`` (``pack_level=1``),
   and the views streamed from pinned host memory through the ``Trainer``
   (each step's ground truth on the card bitwise the device-resident one,
   in the same view order; the copy ms of one view); (b) the train2d cell
   as exact 2DGS with batches of 2, the envmap and masks; (c) ``apps.train
   --source_path`` on phase 7's scene with ``--use_mask 1`` (masks from
   the PNGs' alpha) ``--enable_bg 1 --progressive_train 1
   --resolution_schedule 25 --pack_level 1``, 40 of 100 steps with a
   checkpoint mid-way, then resumed to the end (the checkpoint bitwise,
   the envmap and bf16 ``shN`` included, the resumed scale, the eval PSNR
   rising, the PLY float32 and equal to the bf16 ``shN``); (d) ``--debug_nan
   1``: a clean run finishes, and a NaN written into one mean raises
   ``FloatingPointError`` at the projection stage. Each of (a)-(c) counts
   its launches and holds its kernels against their plain versions at its
   own shapes, with the cotangent of its own loss (the envmap composited,
   the mask applied, a batch's 1/B);
9. the live-training session (``train/session.py``, ``viewer/live.py``,
   ``apps/viewer.py``): (a) ``apps.viewer``'s demo session (20K
   ground-truth splats, 32 orbit views at 400 px, 100K random splats in
   the default 2M capacity, the session's fixed instance capacity of
   2^20) trained 150 steps on its thread with a snapshot every 50, while
   this thread polls ``/status`` and ``/splats`` over HTTP from a
   ``LiveViewerServer`` on port 0: the generation advances at least
   twice, each payload is ``splat_bytes`` of the snapshot of its
   generation with one 32-byte record per alive splat, ``?max=`` bounds
   it, the run ends in ``Training_Done`` at 150 with no error; the
   session's it/s against the same config stepped by ``Trainer.step_once``
   in a plain loop before and after, the ms of one snapshot against a
   whole-capacity copy, the instance demand against 2^20; then
   ``apps.viewer.main --demo`` for 20 steps in this process (rc 0); (b)
   the controls on the demo's views (100K random splats in a 262,144
   capacity), as 3DGS, as exact 2DGS (the surfel kernels) and streamed: a pause holds the iteration for 0.5 s, a queued
   ``pos_lr_init`` keeps the step functions, a queued ``ssim_weight`` 0
   rebuilds them, a queued ``num_iters`` ends the run there; (c)
   ``load_train_data`` on phase 7's ``tpu_bricks``, 50 steps through the
   session, ``save_model`` to a PLY read back and rendered bitwise as the
   snapshot's params, and a folder of bare PNGs with no COLMAP ending in
   ``Loading_Failed``; (d) LPIPS with random weights at 800x800, on the
   card against the CPU (1e-4 relative), its ms, and ``evaluate`` with
   ``DIVSHOT_LPIPS_WEIGHTS`` set. (a) and the 2DGS run of (b) count their
   launches and hold their kernels against their plain versions at their
   own shapes. Any ``session.error`` fails the phase;
10. the dynamic models, every model format and the export app: (a)
   ``tests/test_dynamic.py:40-73``'s bars through the kernels on its 48-px
   moving scene: a ``DeformationMLP(width=64, depth=3)`` over 75 steps
   (the reference's 150 cut where the bar held on the card) below 0.75x, a ``HexPlaneField(32, 16, 8)`` over 300 below 0.85x, the
   deformation time-dependent (mean |dxyz(0) - dxyz(1)| above 1e-4), one
   launch of each kernel a step; (b) a D-NeRF-layout blender scene
   written at run time (20K ground-truth splats moving along +x, 4 orbit
   cameras x 8 times at 800x800, 8 test views at times between, rendered
   through the kernels, ``time`` in every frame), then ``apps.train
   --model_type 2 --cap_max 262144`` with an eval and a checkpoint
   mid-way, and ``--model_type 3`` for fewer steps: the files, the final
   checkpoint bitwise the state saved, the eval PSNR rising, one launch
   of each kernel a step (the evals' renders add expand and forward),
   the three kernels against their plain versions on the trained state
   deformed to view 0's time, and each model type's it/s beside the
   static train cell's (5(b)); (c) the repo's trained model, every
   splat (262,144), through
   ``apps.export`` to ``.compressed.ply``, ``.reduced.ply``, ``.splat``,
   ``.spz`` and ``.dvsplat`` and back, each reload rendered finite
   through ``render_fast`` with its PSNR against the float model's frame;
   the reduced export's k-means on the card against the CPU (centres
   within 1e-5 of each job's range, ids equal but at distance ties,
   counted); ``apps.export --output mesh.obj`` (12 views at 512,
   resolution 128: vertices and faces, indices in range, one launch of
   expand and forward a view) and those two kernels against their plain
   versions at the depth render's shapes. Each save, load and
   extraction's ms is printed;
11. the editor side at the size of a trained scene that users edit: (a)
   ``EditSession`` on 1M random splats at SH 3 with a 250K-splat model
   merged in (the capacity grows): every selection tool (sphere, box,
   rect, a 64-point brush, polygon), ``pick``, hide, paint, a transform
   with a rotation (the SH rotated), the transform and paint palettes and
   their bakes, crop, delete and ``compact``, each op timed and the
   selected, hidden and deleted counts printed; three undos and three
   redos, each bitwise the params and state it restores; (b) a scene of
   the edited model (graded, cropped, world-transformed) and the merged
   model over a SUN_SKY plate through ``render_scene`` in SPLAT, DEPTH and
   NORMAL, then ``render_with_selection`` and ``selection_outline`` at
   1920x1080: the launches of expand and forward counted (one each an
   entity and a frame), the two kernels against their plain versions on
   the tint frame (``editor_tint_*`` records); the dense debug modes
   (RINGS, ELLIPSOIDS, CENTERS, POINT) on a 20K-splat entity at half the
   frame (960x540), timed, with their ns a splat-pixel pair; (c) the
   edited model written as a PLY, ``apps.render``
   with ``--orbit 12 --width 1280 --height 720 --video`` and with
   ``--fast --video``: the PNGs, each AVI read back through its ``idx1``
   (12 ``00dc`` frames, each a JPEG from SOI to EOI), the launches (one
   each a view), the port's JPEG encoder's ms a frame; ``render_taa`` of 8
   frames and ``post_process`` on one view; (d) ``apps.edit`` with
   ``--op``s, ``--merge``, ``--html`` and ``--output`` on that PLY, the
   output's splat count against an ``EditSession`` given the same ops;
12. the routes of ``render()`` other than the kernel route
   (``chip_smoke_routes.py``): (a) one render forward + backward on the
   train cell of 5(b) through the kernel route, ``binning="xla"`` (the
   forward and backward kernels once each, expand never, both held
   against their plain versions: ``xla_*`` records) and ``"tiles"``, and
   ``"dense"`` on 11(b)'s dense entity at 400x400, each against the
   kernel route; (b) ``render_fast(binning="xla")`` on 4's random 1M at
   1920x1080 beside the kernel-binned frame; (c) the loss bars of (5(a),
   6(a)) through ``"tiles"`` and ``"surfel"``, and MCMC with the
   normal-consistency loss through ``"tiles"``; (d) the XLA surfel route
   against the surfel kernels on 6(b)'s train2d cell, with the planes, and
   the gradients of a loss with the depth planes (the scales' through
   them a float32 cancellation, held at JAX's own kernel route's gap);
   (e) ``apps.render --backend tiles --orbit 2`` at 1280x720 on 11(c)'s
   edited model, with the densest tile and the tiles past JAX's
   ``tile_capacity`` of 1024;
13. real captures and the mesh renderers (``chip_smoke_capture.py``): (a)
   phase 7's ``tpu_bricks`` written as a COLMAP capture with JPEG images
   (the port's encoder, quality 90), loaded through the host library's
   parsers and the port's JPEG decoder (the load timed beside the PNG
   load), the cameras equal to the source's, every view's quantised
   coefficients bitwise the encoder's blocks, trained through ``apps.train
   --source_path`` as phase 7 trains the PNGs (the loss falling, the eval
   PSNR rising and within 0.5 dB of phase 7's at each eval step, the three
   kernels against their plain versions on the trained state); (b) the
   host library built by ``g++``, its
   PLY packing on a 1M-splat model and its COLMAP parsers on (a)'s
   binaries timed against the numpy / Python paths, bitwise equal; (c)
   phase 10(c)'s mesh over ``runs/tpu_bricks_mcmc`` at 1920x1080:
   ``rasterize_mesh``, ``shade_gbuffer_lights``, ``path_trace_mesh``,
   the hybrid frame (the splats through ``render`` and ``render_depth``
   on the kernel route: expand and forward launched, both held against
   their plain versions), ``restir_direct``, ``ssgi`` and
   ``deferred_shade_gi``, each timed (the median of 3 calls after a warm
   one) and finite, and the G-buffer on the card against the CPU at
   160x90;
14. training over several processes and tile-sharded rendering
   (``divshot_tpu_torch/dist``, ``chip_smoke_dist.py``): (a) phase 5(b)'s
   train cell through ``make_parallel_train_step`` and
   ``make_overlap_train_step`` on a 1x1 mesh over NCCL, bitwise the serial
   step in PyTorch's default mode (the serial step's first step run
   twice bitwise first), one launch of each kernel a step; (b) two
   processes spawned on
   the one card over gloo: the 2x1 parallel and overlap steps and a 1x2
   mesh (half the moment rows a rank), each first step against the
   serial step, the ranks' parameters bitwise equal, ``MultiHostTrainer``'s
   losses bitwise equal across ranks, each rank's launches counted and
   its kernels against their plain versions; (c) ``render_tiled`` of
   ``runs/tpu_bricks_mcmc`` at 1920x1088 over one band and over two,
   against ``render`` of the whole frame.

Both compositing routes, 3DGS and surfels, go through one harness
(``Route``, ``Frame``, ``kernel_records``, ``stage_times``). It prints
one line per phase, then a JSON line of numbers per kernel and scene, the
card's ``nvidia-smi`` name and power limit, and last the result line
``{"ok": true, "device": {...}}``. Any failure raises: the exit code is then
non-zero and no result line is printed.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
import urllib.request
from collections.abc import Callable
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from chip_smoke_repro import check_segment, reproducible
from divshot_tpu_torch import _build
from divshot_tpu_torch import scene as SC
from divshot_tpu_torch.apps import edit as edit_app
from divshot_tpu_torch.apps import export as export_app
from divshot_tpu_torch.apps import render as render_app
from divshot_tpu_torch.apps import train as train_app
from divshot_tpu_torch.apps import viewer as viewer_app
from divshot_tpu_torch.apps.render import orbit_for_model, render_orbit
from divshot_tpu_torch.core.config import DensifyStrategy, TrainConfig
from divshot_tpu_torch.core.metrics import TrainingStatus
from divshot_tpu_torch.core.profiling import StepTimer, profile_scope
from divshot_tpu_torch.edit import ops as ED
from divshot_tpu_torch.gsio.datasets import load_dataset
from divshot_tpu_torch.gsio import kmeans as KM
from divshot_tpu_torch.gsio.io import load_model, save_model
from divshot_tpu_torch.gsio.loader import HostImageStore
from divshot_tpu_torch.gsio.ply import load_ply, read_ply_arrays
from divshot_tpu_torch.gsio.png import read_png, write_png
from divshot_tpu_torch.gsio.procedural import generate_dataset
from divshot_tpu_torch.gsio.synthetic import (orbit_cameras, random_scene,
                                              render_gt_images)
from divshot_tpu_torch.models import dynamic as DYN
from divshot_tpu_torch.models.background import (init_envmap,
                                                 render_background)
from divshot_tpu_torch.raster import bin as B
from divshot_tpu_torch.raster import raster as R
from divshot_tpu_torch.raster import surfel_raster as SR
from divshot_tpu_torch.raster.render import (frame_inputs, render,
                                             render_fast)
from divshot_tpu_torch.raster.units import (UNIT, backward_schedule,
                                            backward_schedule_plain,
                                            forward_cull_plain, is_long)
from divshot_tpu_torch.splat.gaussians import GaussianParams, init_from_points
from divshot_tpu_torch.train import checkpoint as CK
from divshot_tpu_torch.train.evaluate import evaluate
from divshot_tpu_torch.train.losses import photometric_loss
from divshot_tpu_torch.train.lpips import (load_weights, lpips_fn,
                                           random_weights)
from divshot_tpu_torch.train.session import TrainerSession
from divshot_tpu_torch.train.trainer import (Dataset, Trainer, TrainState,
                                             geometry_loss,
                                             hypers_from_config,
                                             make_train_step,
                                             render_kwargs_from_config,
                                             scaled_camera)
from divshot_tpu_torch.viewer.html_export import splat_bytes
from divshot_tpu_torch.viewer import post as POST
from divshot_tpu_torch.viewer import scene_render as SR_SCENE
from divshot_tpu_torch.viewer import video as VID
from divshot_tpu_torch.viewer.live import LiveViewerServer

REPO = Path(__file__).resolve().parent
MODEL = REPO / "runs" / "tpu_bricks_mcmc" / "point_cloud.ply"
MODEL_2DGS = REPO / "runs" / "tpu_bricks_2dgs2" / "point_cloud.ply"

# backward kernel vs plain version: npix exactly; every other entry within
# this fraction of its row's largest magnitude, and within this fraction of
# its own scale (``check_backward``), which an outlier column elsewhere in
# the row, such as an edge-on surfel's, cannot inflate
BACKWARD_RTOL = 1e-4
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, float32 FLOP/s outside
# the tensor cores
PEAK_BYTES_S = 3.35e12
PEAK_F32_S = 67e12


def forward_ops(c: R.PairCounts, nch: int) -> int:
    """float32 operations the forward must do on this data: per evaluated
    pair dx, dy, the quadratic form (7 mul, 2 add), s (mul, sub) and the
    cull (14); per pair past the cull alpha's clamp and exp, 1 - alpha, q
    and the stop test (5); per applied pair w and a multiply-add per
    channel (1 + 2 nch)."""
    return 14 * c.evaluated + 5 * c.passed + (1 + 2 * nch) * c.applied


def backward_ops(c: R.PairCounts, nch: int, with_absgrad: bool) -> int:
    """float32 operations the backward must do on this data: the forward's
    per evaluated pair (14) and per pair past the cull (5); per applied
    pair w, cdot (2 nch), the channel gradients g w (nch) and their
    block-reduction adds (nch), the running sum of w cdot (2) and the
    clamp test (1); per live pair (applied, alpha not clamped) rear (1),
    dalpha (4), ds (1), du and dv (8), da, db and dc (9) and the reduction
    adds of du dv da db dc dlog_op npix (7); with AbsGS |du|, |dv| and
    their adds (4)."""
    return (14 * c.evaluated + 5 * c.passed + (4 + 4 * nch) * c.applied
            + (30 + 4 * bool(with_absgrad)) * c.live)


def surfel_forward_ops(c: SR.SurfelPairCounts, nch: int) -> int:
    """float32 operations the surfel forward must do on this data: per
    evaluated pair hu and hv (12), p (9), the p2 cull (2), u and v (2
    divisions), rho3d (3), dx, dy and rho2d (6), the branch (2), G (2), a
    (1) and the alpha cull (1): 40; per pair past the p2 and alpha culls
    the depth z (4) and its cull (1); per pair past the z cull too alpha's
    clamp, 1 - alpha, q and the stop test (4); per applied pair w, the z
    and z^2 sums (5) and a multiply-add per channel (2 nch)."""
    return (40 * c.evaluated + 5 * c.shaded + 4 * c.passed
            + (5 + 2 * nch) * c.applied)


def surfel_backward_ops(c: SR.SurfelPairCounts, nch: int) -> int:
    """float32 operations the surfel backward must do on this data: the
    forward's per evaluated pair (40), per pair past the p2 and alpha culls
    (5) and per pair past the z cull (4); per applied pair w, cdot, the
    running w cdot, d_z, the clamp test, d_alpha, g_rho, d_u, d_v, d_dx,
    d_dy, g_p (3 divisions), d_hu and d_hv (18), the 20 + nch rows (dT 15,
    dzp 2, dc2d 2, dop 1, ds 14, |ds| 2, npix 1, dch nch) and their
    block-reduction adds (20 + nch): 110 + 4 nch."""
    return (40 * c.evaluated + 5 * c.shaded + 4 * c.passed
            + (110 + 4 * nch) * c.applied)


KERNELS = {
    "expand": dict(source="divshot_tpu_torch/csrc/expand.cu",
                   replaces="divshot_tpu/raster/pallas_bin.py:71"),
    "forward": dict(source="divshot_tpu_torch/csrc/forward.cu",
                    replaces="divshot_tpu/raster/pallas_raster.py:267"),
    "backward": dict(source="divshot_tpu_torch/csrc/backward.cu",
                     replaces="divshot_tpu/raster/pallas_raster.py:437"),
    "surfel_forward": dict(source="divshot_tpu_torch/csrc/surfel_forward.cu",
                           replaces="divshot_tpu/raster/pallas_surfel.py:126"),
    "surfel_backward": dict(
        source="divshot_tpu_torch/csrc/surfel_backward.cu",
        replaces="divshot_tpu/raster/pallas_surfel.py:202"),
    # no Pallas kernel: JAX's XLA cumsum formula (pallas_bin.py:366-398,
    # segment_rows_sorted), which the port's kernel replaces
    "segment_rows": dict(source="divshot_tpu_torch/csrc/segment.cu",
                         replaces="divshot_tpu/raster/pallas_bin.py:366"),
}
VIEWER_KERNELS = ("expand", "forward")
# each backward's rows go through one call of the segment reduce
TRAIN_KERNELS = ("expand", "forward", "backward", "segment_rows")
SURFEL_KERNELS = ("expand", "surfel_forward", "surfel_backward",
                  "segment_rows")


@dataclass(frozen=True)
class Route:
    """One compositing route as this script drives it: its two kernels
    (names, wrappers, plain versions, operation counts), the rows of an
    instance's table column and of its backward output besides its nch
    channel rows, the tile rows the backward reads besides 2 nch, and how
    a frame's inputs, binning radii, table and gradient reduce are made.
    Both routes share the tile layout (channels from row 0, the
    transmittance in row 7, and its cotangent there)."""
    forward: str
    backward: str
    fwd: Callable
    fwd_plain: Callable
    bwd: Callable
    bwd_plain: Callable
    fwd_ops: Callable
    bwd_ops: Callable
    inst_rows: int
    grad_rows: int
    tile_rows: int
    inputs: Callable          # (params, cam, geometry) -> proj, colors, opac
    prep_args: Callable       # (proj, opac) -> binning inputs
    table_inputs: Callable    # (proj, colors, opac) -> what the table holds
    build_table: Callable     # (*table_inputs, inst) -> table
    reduce: Callable          # (grads, bins, nch) -> grads of table_inputs
    render: Callable          # (params, cam, icap, geometry, **bkw) -> out
    cull_entry: str           # the forward's C entry (R.kernel_mask)
    cull_passes: Callable     # (table, tiles_x, tile_size) -> plain cull


def _gauss_reduce(grads, bins, nch):
    red = B.reduce_grads_sorted(grads, bins, nch=nch)
    return [red["means2d"], red["conics"], red["colors"], red["opacity"]]


def _surfel_reduce(grads, bins, nch):
    seg = B.segment_rows_sorted(grads, bins, range(SR.ngrad_rows(nch)))
    return [seg[0:9].T.reshape(-1, 3, 3), seg[SR.ROW_ZP:SR.ROW_ZP + 3].T,
            seg[SR.ROW_C2D:SR.ROW_C2D + 2].T, seg[SR.ROW_OP],
            seg[SR.ROW_CH:SR.ROW_CH + nch].T]


GAUSS = Route(
    "forward", "backward", R.rasterize_forward, R.rasterize_forward_plain,
    R.rasterize_backward, R.rasterize_backward_plain,
    forward_ops, backward_ops, 6, 9, 2,
    inputs=lambda params, cam, geometry: frame_inputs(params, cam),
    prep_args=lambda pr, opac: (pr.means2d, pr.depths, pr.radii,
                                pr.radii_xy, pr.rad2),
    table_inputs=lambda pr, colors, opac: [pr.means2d, pr.conics, colors,
                                           opac],
    build_table=R.build_feature_table, reduce=_gauss_reduce,
    render=lambda params, cam, icap, geometry, **bkw: render(
        params, cam, instance_capacity=icap, **bkw),
    cull_entry="divshot_forward", cull_passes=R.cull_passes)
SURFEL = Route(
    "surfel_forward", "surfel_backward", SR.surfel_forward,
    SR.surfel_forward_plain, SR.surfel_backward, SR.surfel_backward_plain,
    surfel_forward_ops, surfel_backward_ops, 15, 20, 4,
    inputs=lambda params, cam, geometry: SR.surfel_inputs(
        params, cam, with_geometry=geometry),
    prep_args=lambda pr, opac: (pr["center2d"], pr["depths"],
                                SR.bin_radii(pr["radii"], opac), None, None),
    table_inputs=lambda pr, colors, opac: [pr["Tmat"], pr["zplane"],
                                           pr["center2d"], opac, colors],
    build_table=SR.build_surfel_table, reduce=_surfel_reduce,
    render=lambda params, cam, icap, geometry, **bkw: SR.render_surfels(
        params, cam, instance_capacity=icap, with_geometry=geometry),
    cull_entry="divshot_surfel_forward", cull_passes=SR.cull_passes)


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
    bars_iters: int       # the most steps of the small-setup loss bars
    #                       (each bar runs at most its BAR_STEPS)
    train_gt: int         # training bench: GT splats, model splats,
    train_splats: int     # capacity, resolution, views, timed steps
    train_capacity: int
    train_res: int
    train_views: int
    train_iters: int
    demo_iters: int       # steps of apps.train --demo (0: not run)
    bars2d_iters: int     # the most steps of the 2DGS loss bar
    data_res: int         # phase 7: tpu_bricks' width and height, its
    data_views: tuple     # train and test views, the app's capacity, its
    data_capacity: int    # num_iters, the steps of the first run, and
    data_iters: int       # eval_every, checkpoint_every and
    data_first: int       # reset_alpha_every
    data_every: tuple
    opt_iters: int        # phase 8: timed steps of each option, steps of
    opt2d_iters: int      # the 2DGS options run, the options app run's
    opt_app: tuple        # (iterations, first run's steps,
    nan_iters: int        # resolution_schedule, eval_every,
    #                       checkpoint_every, reset_alpha_every), steps of
    #                       the debug_nan runs
    session_demo: tuple   # phase 9: the demo's (GT splats, views, width,
    #                       cap_max, 0 for the default), and (the live
    session_iters: tuple  # session's steps, snapshot_every, the plain
    #                       loop's steps, the steps between two controls,
    #                       the viewer app's steps, the dataset session's)
    dyn_bars: tuple       # phase 10: (a)'s (resolution, times, MLP steps,
    #                       HexPlane steps); (b)'s scene (ground-truth
    dyn_scene: tuple      # splats, resolution, cameras, times, test
    #                       views) and its runs (model_type 2 steps,
    dyn_runs: tuple       # model_type 3 steps, cap_max); (c)'s (frame
    export: tuple         # size, mesh views, mesh resolution, the CPU
    #                       k-means check's values a job)
    editor: tuple         # phase 11: (the model's splats, the merged
    #                       model's, the dense debug entity's, apps.render's
    #                       width, height and orbit views, render_taa's
    #                       frames)
    routes: tuple         # phase 12: (the dense route's frame size,
    #                       apps.render --backend tiles' width, height and
    #                       orbit views, the most steps of the 3DGS and the
    #                       2DGS loss bars and the steps of the normal-loss
    #                       run)
    capture: tuple        # phase 13: (the mesh frame's width and height,
    #                       the path tracer's samples, the card-against-CPU
    #                       G-buffer's width and height, the splats of the
    #                       PLY-packing model, the largest eval PSNR gap in
    #                       dB between the JPEG capture and phase 7's
    #                       PNGs); the JPEG capture trains as phase 7
    #                       (data_*)
    dist: tuple           # phase 14: (the steps of each step function in
    #                       the world of one and of each on the
    #                       two-process 2x1 mesh, MultiHostTrainer's
    #                       steps, render_tiled's width and height)


FULL = Scale(1920, 1080, 4, 1, 1_000_000, 1 << 24, 50_000, 512, 2,
             150, 50_000, 100_000, 1 << 17, 800, 4, 30, 12, 60,
             800, (24, 8), 262_144, 100, 50, (25, 30, 25),
             6, 4, (100, 40, 25, 50, 20, 10), 5,
             (20_000, 32, 400, 0), (100, 33, 15, 3, 20, 50),
             (48, 5, 75, 300), (20_000, 800, 4, 8, 8), (60, 30, 262_144),
             (800, 12, 128, 1 << 13),
             (1_000_000, 250_000, 20_000, 1280, 720, 8, 8),
             (400, 1280, 720, 2, 150, 60, 20),
             (1920, 1080, 2, 160, 90, 1_000_000, 0.5),
             (20, 10, 3, 1920, 1088))
TINY = Scale(64, 48, 1, 512, 1_500, 1 << 16, 400, 64, 1,
             3, 300, 500, 1 << 10, 64, 2, 2, 0, 3,
             32, (3, 2), 1024, 12, 8, (4, 4, 3),
             2, 2, (12, 6, 3, 4, 3, 2), 3,
             (300, 2, 32, 1024), (9, 3, 2, 1, 2, 3),
             (32, 2, 3, 3), (300, 32, 2, 2, 2), (4, 2, 1024),
             (32, 2, 12, 1 << 10),
             (2_000, 500, 300, 64, 48, 3, 2),
             (32, 64, 48, 2, 1, 1, 1),
             (64, 48, 1, 32, 24, 2_000, 1.0),
             (3, 2, 3, 64, 64))


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


# the card's identity, as phase 1 reads it (phase 12 prints it per line)
CARD: dict = {}


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
    CARD.update(kind=name, count=torch.cuda.device_count(), smi=smi)
    return dict(CARD)


def phase_build(device: torch.device, scale: Scale) -> float:
    so, seconds = _build.build()
    _build.library()
    log(f"  built {so.name} in {seconds:.2f} s (0 = already built)")
    for line in _build.ptxas_report(so):
        log(f"  ptxas: {line}")
    return seconds


# --------------------------------------------------------------------------
# kernel against plain version


def check_expand(p: B.Prep, cap: int, width: int, height: int) -> dict:
    """Expand kernel vs plain version: keys and owners bitwise equal slot
    for slot, a second launch bitwise equal to the first, and the split of
    the kernel's work as its blocks find it (``B.expand_partition``) equal
    to its plain version. On the kernel's keys ``sort_instances`` must give
    the int64 path's ``tile_start``, owners and permutation."""
    num_tiles, depth_bits = B.key_bits(width, height, 16)
    kk, ko = B.expand_instances(p, cap, width=width, height=height)
    again = B.expand_instances(p, cap, width=width, height=height)
    pk, po = B.expand_instances_plain(p, cap, width=width, height=height)
    for what, got, want in (("keys", kk, pk), ("owners", ko, po)):
        if not torch.equal(got, want):
            bad = (got != want).nonzero()[:4, 0].tolist()
            raise AssertionError(f"expand: {what} differ from plain at "
                                 f"slots {bad}")
    if not (torch.equal(kk, again[0]) and torch.equal(ko, again[1])):
        raise AssertionError("expand: two launches differ")
    split = B.expand_partition(p.offsets, p.counts, cap)
    if not torch.equal(split.cpu(),
                       B.expand_partition_plain(p.offsets.cpu(), cap)):
        raise AssertionError("expand: the blocks' split differs from plain")
    kw = dict(num_tiles=num_tiles, depth_bits=depth_bits)
    got = B.sort_instances(kk, ko, **kw)
    ref = B.sort_instances_int64(kk, ko, **kw)
    for what, a, b in zip(("owners", "tile_start", "perm"), got[1:],
                          ref[1:]):
        if not torch.equal(a, b):
            raise AssertionError(f"sort_instances: {what} differ from the "
                                 f"int64 path")
    return {"demand": int(p.total), "kept": int(got[2][-1]),
            "pieces": split.numel() - 1, "max_abs_err": 0.0}


def check_forward(route: Route, table, tile_start, width: int, height: int,
                  nch: int):
    """Forward kernel vs plain version: bitwise equal, and a second launch
    bitwise equal to the first -> (max abs err, the data's pair counts,
    instances the data needs read: per tile, up to its last pixel's
    stop, the ms of the plain version's call, its pair counting
    included)."""
    kw = dict(width=width, height=height, nch=nch)
    out_k = route.fwd(table, tile_start, **kw)
    again = route.fwd(table, tile_start, **kw)
    (out_p, counts, reach), plain_ms = timed(lambda: route.fwd_plain(
        table, tile_start, count_pairs=True, **kw), table.device)
    err = float((out_k - out_p).abs().max())
    if not (bool(torch.isfinite(out_k).all())
            and torch.equal(out_k, out_p)):
        raise AssertionError(f"{route.forward}: differs from plain, max abs "
                             f"err {err}")
    if not torch.equal(out_k, again):
        raise AssertionError(f"{route.forward}: two launches differ")
    return err, counts, int(reach.sum()), plain_ms


def check_survivors(route: Route, table, tile_start, width: int,
                    height: int, what: str) -> dict:
    """The forward's survivor mask as its cull pass writes it on the card
    (``R.kernel_mask``) must equal its plain version (``forward_cull_plain``)
    on every word of a long tile's segment -> the words and segments
    compared. A CPU rehearsal has no kernel: the plain mask stands in."""
    want, written, culled = forward_cull_plain(
        tile_start, table.shape[1],
        route.cull_passes(table, -(-width // 16), 16), 256)
    got = (R.kernel_mask(route.cull_entry, table, tile_start, width=width,
                         height=height)
           if table.device.type == "cuda" else want)
    if got.shape != want.shape or not torch.equal(got[written],
                                                  want[written]):
        bad = ((got != want).any(1) & written).nonzero()[:4, 0].tolist() \
            if got.shape == want.shape else got.shape
        raise AssertionError(f"{what}: the survivor mask differs from "
                             f"plain at words {bad}")
    return {"cull_words": int(written.sum()),
            "long_tiles": int(is_long(tile_start[1:]
                                      - tile_start[:-1]).sum()),
            "culled_tiles": int(culled.sum())}


def row_floor(grads: torch.Tensor) -> torch.Tensor:
    """Per row, the 99th-percentile nonzero magnitude, which the top 1 % of
    the row's columns (where edge-on surfels sit) cannot inflate."""
    q = []
    for row in grads.abs():
        nz = torch.sort(row[row > 0]).values
        q.append(nz[int(0.99 * (nz.numel() - 1))] if nz.numel()
                 else row.new_zeros(()))
    return torch.stack(q)


def check_backward(route: Route, table, tile_start, fwd, cot, width: int,
                   height: int, nch: int, **bkw) -> dict:
    """Backward kernel vs plain version on the columns the kernel writes;
    a second launch must give bitwise the same gradients. npix must agree
    exactly; every other entry within BACKWARD_RTOL of its row's largest
    magnitude and within BACKWARD_RTOL of its own scale: the
    larger of the sum of the magnitudes of its per-pixel terms (the plain
    version's ``abs_sums``; an outlier column's own rounding scale) and its
    row's ``row_floor`` (which covers entries whose terms cancel inside a
    pixel, as d_alpha's rear sum does); all finite. -> max abs err, max
    row-relative err (``row_rel``), per column the largest err relative to
    the entries' scales (``scale_rel``), and the number of columns with an
    entry above 1e3 times its row's floor (``outlier_cols``; the floors
    stand while it is below 1 % of the columns)."""
    kw = dict(width=width, height=height, nch=nch, **bkw)
    n = int(tile_start[-1])
    gk = route.bwd(table, tile_start, cot, fwd, **kw)[:, :n]
    again = route.bwd(table, tile_start, cot, fwd, **kw)[:, :n]
    (gp, sums), plain_ms = timed(lambda: route.bwd_plain(
        table, tile_start, cot, fwd, abs_sums=True, **kw), table.device)
    gp, sums = gp[:, :n], sums[:, :n]
    what = route.backward
    if not (bool(torch.isfinite(gk).all())
            and bool(torch.isfinite(gp).all())):
        raise AssertionError(f"{what}: non-finite gradient rows")
    if not torch.equal(gk, again):
        raise AssertionError(f"{what}: two launches differ (not "
                             f"deterministic)")
    if not torch.equal(gk[-1], gp[-1]):
        raise AssertionError(f"{what}: npix differs from plain")
    diff = (gk - gp).abs()
    row_rel = float((diff.amax(1) / gp.abs().amax(1).clamp_min(1e-30)).max())
    floor = row_floor(gp)
    scale = torch.maximum(sums, floor[:, None])
    rel = torch.where(diff > 0, diff / scale, 0.0)
    scale_rel = rel.amax(0)
    worst = float(scale_rel.max()) if n else 0.0
    if not row_rel <= BACKWARD_RTOL:
        raise AssertionError(f"{what}: row err {row_rel:.3e} of the row's "
                             f"largest value > {BACKWARD_RTOL}")
    if not worst <= BACKWARD_RTOL:
        r, c = divmod(int(torch.argmax(rel)), n)
        raise AssertionError(
            f"{what}: err {worst:.3e} of the entry's scale > "
            f"{BACKWARD_RTOL} (row {r}, column {c}: kernel "
            f"{float(gk[r, c])}, plain {float(gp[r, c])}, terms "
            f"{float(sums[r, c])}, scale {float(scale[r, c])})")
    if bkw.get("with_absgrad") is False and float(gk[-3:-1].abs().max()):
        raise AssertionError(f"{what}: absgrad rows not zero")
    big = (gp.abs() > 1e3 * floor[:, None]) & (floor[:, None] > 0)
    return dict(max_abs_err=float(diff.max()) if n else 0.0,
                row_rel=row_rel, scale_rel=scale_rel,
                outlier_cols=int(big.any(0).sum()), npix=gp[-1],
                plain_ms=plain_ms)


def _nan_prep(p: B.Prep) -> B.Prep:
    """The expand inputs with a NaN u, v and rad2 on three gaussians that
    have instances."""
    idx = torch.nonzero(p.counts > 0)[:3, 0].tolist()
    u, v, rad2 = p.u.clone(), p.v.clone(), p.rad2.clone()
    u[idx[0]], v[idx[1]], rad2[idx[2]] = (float("nan"),) * 3
    return p._replace(u=u, v=v, rad2=rad2)


def expand_case(rng, counts, device, width: int = 1920, height: int = 1080,
                nan: bool = True) -> B.Prep:
    """Expand inputs with the given instance counts: each gaussian's
    rectangle holds its count inside the tile grid, its centre lies near
    it (some tiles culled), and with ``nan`` three gaussians that own
    instances have a NaN u, v and rad2."""
    tw, th = -(-width // 16), -(-height // 16)
    counts = np.asarray(counts, np.int32)
    n = counts.size
    nx = np.maximum(rng.integers(1, 33, n), -(-counts // th)).astype(np.int32)
    ny = np.maximum(-(-counts // nx), 1)
    tmin_x = rng.integers(0, tw - nx + 1).astype(np.int32)
    tmin_y = rng.integers(0, th - ny + 1).astype(np.int32)
    f = {"u": ((tmin_x + nx * rng.random(n)) * 16).astype(np.float32),
         "v": ((tmin_y + ny * rng.random(n)) * 16).astype(np.float32),
         "rad2": ((rng.random(n) * 64 * (nx + ny)) ** 2).astype(np.float32)}
    owning = np.flatnonzero(counts > 0)
    if nan and owning.size >= 3:
        for k, name in enumerate(("u", "v", "rad2")):
            f[name][owning[k * owning.size // 3]] = np.nan
    _, depth_bits = B.key_bits(width, height, 16)
    arrays = dict(offsets=(np.cumsum(counts) - counts).astype(np.int32),
                  counts=counts, tmin_x=tmin_x, tmin_y=tmin_y, nx=nx,
                  depth_key=rng.integers(0, 1 << depth_bits,
                                         n).astype(np.int32), **f)
    return B.Prep(**{k: torch.from_numpy(np.ascontiguousarray(a)).to(device)
                     for k, a in arrays.items()},
                  total=torch.tensor(int(counts.sum()), dtype=torch.int32,
                                     device=device))


def adversarial_expand(device, scale: Scale) -> dict:
    """The expand kernel and the sort on inputs that stress the kernel's
    split, at 1920x1080 (tiles whose key word has its top bit set), each
    with NaN instances: zero-count runs longer than several blocks'
    pieces, every count at mt 64 and at 256, overflow (demand past the
    capacity), one gaussian and none; capacities not multiples of a
    piece."""
    rng = np.random.default_rng(11)
    m = max(scale.check_splats // 10, 100)

    def r(lo, hi, k):
        return list(rng.integers(lo, hi, k))

    cases = {
        "zero_run": r(1, 65, m) + [0] * (5 * B.PIECE + 3) + r(0, 65, m)
        + [0] * (B.PIECE + 1),
        "all_mt64": [64] * m,
        "all_mt256": [256] * (m // 4),
        "overflow": r(0, 65, 4 * m),
        "one": [37],
        "none": [],
    }
    out = {}
    for name, counts in cases.items():
        total = int(sum(counts))
        cap = (total // 2 + 7 if name == "overflow"
               else max(total + B.PIECE // 3, 100))
        chk = check_expand(expand_case(rng, counts, device), cap, 1920, 1080)
        out[name] = (len(counts), total, cap, chk["pieces"])
    log("  expand on adversarial inputs at 1920x1080, (gaussians, demand, "
        "capacity, pieces): " + ", ".join(f"{k} {v}" for k, v in out.items())
        + ": keys and owners bitwise equal to plain, the split equal, the "
        "sort equal to the int64 path")
    return out


def _nan_table(table: torch.Tensor, tile_start: torch.Tensor
               ) -> torch.Tensor:
    """The instance table with NaN rows: one instance all NaN, one with a
    NaN u, one with a NaN log-opacity."""
    t = table.clone()
    cols = torch.linspace(0, int(tile_start[-1]) - 1, 3).long().tolist()
    t[:, cols[0]] = float("nan")
    t[0, cols[1]] = float("nan")
    t[R.ROW_LOGOP, cols[2]] = float("nan")
    return t


def _cotangent(num_tiles: int, nch: int, device, seed: int,
               planes: bool = False):
    """Random cotangent tiles for the channel rows and row 7 (T), and with
    ``planes`` rows 5 and 6 (z, z^2) at a tenth of the scale."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    cot = torch.randn((num_tiles, 8, 256), generator=g, device=device)
    cot[:, nch:SR.ROW_Z if planes else 7] = 0.0
    if planes:
        cot[:, SR.ROW_Z:SR.ROW_Z2 + 1] *= 0.1
    return cot


def phase_kernels_vs_plain(device: torch.device, scale: Scale) -> dict:
    params = random_scene(np.random.default_rng(1), scale.check_splats,
                          sh_degree=3, scale_range=(0.004, 0.025),
                          device=device)
    cam = orbit_cameras(1, width=scale.check_res, device=device)[0]
    w, h = cam.width, cam.height
    proj, colors, opac = frame_inputs(params, cam)
    p = B.prep(proj.means2d, proj.depths, proj.radii, proj.radii_xy,
               proj.rad2, w, h, 16, 64)
    cap = min(auto_icap(int(p.total)), 1 << 20)
    ex = check_expand(p, cap, w, h)
    ex_nan = check_expand(_nan_prep(p), cap, w, h)
    out = {"expand_err": max(ex["max_abs_err"], ex_nan["max_abs_err"])}
    adversarial_expand(device, scale)
    g = torch.Generator(device=device)
    g.manual_seed(2)
    extra = torch.rand((colors.shape[0], 4), generator=g, device=device)
    for nch in (3, 7):
        cols = colors if nch == 3 else torch.cat([colors, extra], 1)
        sb = B.expand_sorted(proj.means2d, proj.conics, proj.depths,
                             proj.radii, proj.radii_xy, proj.rad2, cols,
                             opac, width=w, height=h, instance_capacity=cap)
        table = _nan_table(sb.table, sb.tile_start)
        fw_err, _, _, _ = check_forward(GAUSS, table, sb.tile_start, w, h,
                                        nch)
        out["forward_err"] = max(out.get("forward_err", 0.0), fw_err)
        fwd = R.rasterize_forward(table, sb.tile_start, width=w, height=h,
                                  nch=nch)
        cot = _cotangent(fwd.shape[0], nch, device, nch)
        for absgrad in (True, False):
            chk = check_backward(GAUSS, table, sb.tile_start, fwd, cot, w, h,
                                 nch, with_absgrad=absgrad)
            out[f"backward_err_nch{nch}_absgrad{int(absgrad)}"] = \
                chk["max_abs_err"]
            log(f"  backward nch {nch}, absgrad {absgrad}: max abs err "
                f"{chk['max_abs_err']:.3e}, max row-relative err "
                f"{chk['row_rel']:.3e}, max err relative to the entries' "
                f"scales {float(chk['scale_rel'].max()):.3e} (tolerance "
                f"{BACKWARD_RTOL} each; npix exact)")
    log(f"  {scale.check_splats} splats at {w}x{h}, capacity {cap}, demand "
        f"{ex['demand']}, NaN instances in every input: expand exact "
        f"(max abs err {out['expand_err']}), forward bitwise equal (max abs "
        f"err {out['forward_err']:.3e}) and deterministic")
    out.update(surfel_kernels_vs_plain(params, cam, device))
    for route, nch in ((GAUSS, 3), (SURFEL, SR.MAX_CH)):
        out.update(unit_split_check(route, nch, device))
    return out


# --------------------------------------------------------------------------
# the backward kernels' unit split


def _splat_cols(route: Route, x0, y0, sigma, op, chans) -> np.ndarray:
    """Table columns on ``route`` of isotropic splats centred at (x0, y0)
    with a standard deviation of ``sigma`` px and opacity ``op`` (arrays
    or scalars), channels ``chans`` (nch, n): a 3DGS conic (1/sigma^2, 0,
    1/sigma^2) with its log-opacity, or a fronto-parallel surfel at depth
    2 (T rows (sigma, 0, x0), (0, sigma, y0), (0, 0, 1))."""
    n = chans.shape[1]
    if route is GAUSS:
        inv = 1.0 / np.asarray(sigma) ** 2
        rows = [x0, y0, inv, 0.0, inv, np.log(op)]
    else:
        rows = [sigma, 0.0, x0, 0.0, sigma, y0, 0.0, 0.0, 1.0, 0.0, 0.0,
                2.0, x0, y0, op]
    return np.concatenate([np.stack([np.broadcast_to(
        np.asarray(r, np.float64), (n,)) for r in rows]), chans])


def unit_split_frame(route: Route, nch: int, device, seed: int = 0):
    """A 32x32 frame (2x2 tiles of 16 px) for the backward's unit split
    -> (table, tile_start, planted columns, tile 1's hitter columns, its
    unit starts). Tile 0 holds random splats, fewer than a unit (``UNIT``
    columns); tile 1 holds 4.5 units, so five units the first of which is
    short: from column ``UNIT`` on, every sixth column (at ``UNIT`` 4096)
    a broad splat (sigma 20 px, opacity 0.006-0.009) at the tile's centre,
    whose alpha falls with the distance from it, so that the pixels stop at
    different columns in units 1-3, and fillers far away that every pixel
    culls; NaN, clamping and (surfels) edge-on columns sit on the first and
    last column of its units; tile 2 is empty; tile 3 holds exactly one
    unit of random splats."""
    rng = np.random.default_rng(seed)
    u = UNIT
    n0, n1, n3 = u // 3 + 1, 4 * u + u // 2, u

    def random_cols(n, cx, cy):
        return _splat_cols(route, cx + rng.uniform(0, 16, n),
                           cy + rng.uniform(0, 16, n),
                           rng.uniform(0.4, 4.0, n),
                           rng.uniform(0.05, 0.6, n),
                           rng.uniform(0, 1, (nch, n)))

    # hitters every `every` columns at opacity ~0.0075 `boost`, so that
    # the pixels stop ~1.4-2.2 units after the first
    every, boost = max(3, round(3 * u / 2048)), max(1.0, 2048 / u)
    col = n0 + np.arange(n1)                     # tile 1's columns
    hit = (col >= u) & ((col - u) % every == 0)
    tile1 = _splat_cols(route, np.where(hit, 24 + rng.uniform(-1, 1, n1),
                                        1e4),
                        np.where(hit, 8 + rng.uniform(-1, 1, n1), 1e4), 20.0,
                        boost * rng.uniform(0.006, 0.009, n1),
                        rng.uniform(0, 1, (nch, n1)))
    t = np.concatenate([random_cols(n0, 0, 0), tile1,
                        random_cols(n3, 16, 16)], 1)
    op_row = R.ROW_LOGOP if route is GAUSS else SR.ROW_OP

    def clamp(c, x, y):        # opacity 1 centred on the pixel centre (x, y)
        t[:, c] = _splat_cols(route, x, y, 0.25, 1.0, t[-nch:, c:c + 1])[:, 0]

    def edge_on(c, eps):       # T rows (12, 1, 24), (24, 2 + 2 eps, 48)
        if route is GAUSS:
            t[0, c] = np.nan
            return
        t[:SR.ROW_CH, c] = [12.0, 1.0, 24.0, 24.0, 2.0 + 2.0 * eps, 48.0,
                            0.0, 0.0, 1.0, 0.0, 0.0, 2.0, 24.0, 8.0, 0.9]

    t[:, n0] = np.nan
    clamp(u - 1, 20.5, 4.5)
    if route is GAUSS:
        clamp(u, 27.5, 11.5)
    else:
        edge_on(u, 1e-3)
    t[op_row, 2 * u - 1] = np.nan
    edge_on(2 * u, 0.0)
    if route is GAUSS:
        clamp(3 * u - 1, 27.5, 3.5)
    else:
        edge_on(3 * u - 1, 1e-6)
    t[:, 3 * u] = np.nan
    t[op_row, 4 * u - 1] = np.nan
    edge_on(4 * u, 1e-3)
    planted = [n0, u - 1, u, 2 * u - 1, 2 * u, 3 * u - 1, 3 * u, 4 * u - 1,
               4 * u]
    rows = (R.ROW_CH if route is GAUSS else SR.feat_rows(nch) - nch) + nch
    table = np.zeros((rows, t.shape[1]), np.float32)
    table[:t.shape[0]] = t
    tile_start = torch.tensor([0, n0, n0 + n1, n0 + n1, n0 + n1 + n3],
                              dtype=torch.int32, device=device)
    hitters = [c for c in col[hit].tolist() if c not in planted]
    return (torch.from_numpy(table).to(device), tile_start, planted, hitters,
            [n0, u, 2 * u, 3 * u, 4 * u])


def check_schedule(tile_start: torch.Tensor, num_instances: int,
                   what: str) -> torch.Tensor:
    """The backward kernels' schedule over these tiles as they find it on
    the card (``units::find``, written out by ``backward_schedule``) must
    equal its plain version, block for block -> the schedule."""
    got = backward_schedule(tile_start, num_instances).cpu()
    want = backward_schedule_plain(tile_start, num_instances)
    if not torch.equal(got, want):
        bad = (got != want).any(1).nonzero()[:4, 0].tolist()
        raise AssertionError(f"{what}: the backward schedule differs from "
                             f"plain at blocks {bad}: {got[bad].tolist()} "
                             f"against {want[bad].tolist()}")
    return want


def unit_split_check(route: Route, nch: int, device) -> dict:
    """Phase 3's check of the unit split: on ``unit_split_frame``, the
    forward kernel against its plain version (bitwise, twice) and its
    survivor mask against the plain cull pass; the backward's schedule on
    the card against its plain version and against the units the frame
    plants, then the backward kernel against its plain version under
    ``check_backward``'s bars and its determinism check; the frame's
    pixels' stops (from the plain version's npix on the hitter columns,
    where every pixel not yet stopped applies a live pair) are checked to
    be what the frame promises."""
    w = h = 32
    table, tile_start, planted, hitters, starts = unit_split_frame(
        route, nch, device)
    fw_err, _, _, _ = check_forward(route, table, tile_start, w, h, nch)
    cull = check_survivors(route, table, tile_start, w, h, route.forward)
    log(f"  {route.forward} unit split: bitwise equal to plain and "
        f"deterministic; survivor mask equal to plain on its "
        f"{cull['cull_words']} words ({cull['long_tiles']} long tiles, "
        f"{cull['culled_tiles']} culled)")
    units = check_schedule(tile_start, table.shape[1], route.backward)
    tile1 = sorted(units[units[:, 0] == 1][:, 2].tolist())
    if tile1 != starts or int((units[:, 0] == 3).sum()) != 1:
        raise AssertionError(f"{route.backward}: unit schedule {tile1}")
    fwd = route.fwd(table, tile_start, width=w, height=h, nch=nch)
    cot = _cotangent(4, nch, device, 5, planes=route is SURFEL)
    bkw = {"with_absgrad": True} if route is GAUSS else {}
    chk = check_backward(route, table, tile_start, fwd, cot, w, h, nch,
                         **bkw)
    out = {f"{route.forward}_units_err": fw_err,
           f"{route.backward}_units_err": chk["max_abs_err"]}
    log(f"  {route.backward} unit split: schedule equal to plain; max abs "
        f"err {chk['max_abs_err']:.3e}, row-relative {chk['row_rel']:.3e}, "
        f"relative to the entries' scales "
        f"{float(chk['scale_rel'].max()):.3e}; deterministic")
    npix = chk["npix"][hitters].long().tolist()
    live = {s: max(n for c, n in zip(hitters, npix) if s <= c < e)
            for s, e in zip(starts[1:], starts[2:] + [starts[-1] + UNIT])}
    first_stop = next(c for c, n in zip(hitters, npix) if n < 256)
    if not (first_stop < starts[2] and live[starts[3]] > 0
            and live[starts[4]] == 0 and len(set(npix)) >= 8):
        raise AssertionError(f"{route.backward}: the frame's stops miss "
                             f"their units (first stop {first_stop}, "
                             f"live per unit {live})")
    log(f"  {route.backward} unit split frame: tile 1 units at {starts}, "
        f"first stop at column {first_stop}, most live pixels per unit "
        f"{live}, {len(set(npix))} distinct counts, planted {planted}")
    return out


# --------------------------------------------------------------------------
# main path


PARAM_FIELDS = ("means", "scales", "quats", "opacity", "sh0", "shN",
                "alive")


def _load(path: Path, device: torch.device, scale: Scale) -> GaussianParams:
    """A model of the repo, every ``scale.model_stride``-th splat kept."""
    params, _ = load_model(str(path), device=device)
    if scale.model_stride > 1:
        keep = torch.arange(0, params.capacity, scale.model_stride,
                            device=device)
        params = GaussianParams(**{f: getattr(params, f)[keep]
                                   for f in PARAM_FIELDS})
    return params


def _scenes(device: torch.device, scale: Scale):
    params = _load(MODEL, device, scale)
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
        for k in VIEWER_KERNELS:
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
        fr = make_frame(params, cams[0], cap)
        recs = kernel_records(name, fr, device, scale, launches)
        stages = stage_times(fr, device, scale, recs)
        records += recs
        log(f"  {name} view 0 stages (ms, each timed alone): "
            + ", ".join(f"{k} {v:.3f}" for k, v in stages.items()))
    log("  stale-bins guard raised as expected")
    return records


def _records(scene: str, rows: list[tuple], launches: dict,
             per_step: int | None = None) -> list[dict]:
    """Kernel records: rows of (name, max_abs_err, ms, plain_ms, bytes,
    ops[, extra keys])."""
    recs = []
    for name, err, ms, plain, nbytes, ops, *extra in rows:
        t_bytes = nbytes / PEAK_BYTES_S * 1e3
        t_ops = ops / PEAK_F32_S * 1e3
        rec = dict(
            name=name, scene=scene, route="cuda", **KERNELS[name],
            launches=launches[name], max_abs_err=err, ms=ms, plain_ms=plain,
            bound_ms=max(t_bytes, t_ops),
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            library_ms=None)
        if per_step:
            rec["launches_per_step"] = launches[name] / per_step
        for e in extra:
            rec.update(e)
        recs.append(rec)
    return recs


@dataclass
class Frame:
    """One view's binning and instance table on one route, built stage by
    stage as ``render`` or ``render_surfels`` builds them; ``params``
    carries the leaves for autograd when the frame was made with
    ``grad``."""
    route: Route
    params: GaussianParams
    leaves: dict
    cam: object
    cap: int
    nch: int
    proj: object
    colors: torch.Tensor
    opac: torch.Tensor
    prep_args: tuple
    pp: B.Prep
    keys: torch.Tensor
    owners: torch.Tensor
    inst: torch.Tensor
    bins: B.SortedBins

    @property
    def table(self) -> torch.Tensor:
        return self.bins.table

    @property
    def tile_start(self) -> torch.Tensor:
        return self.bins.tile_start


def _grad_leaves(params: GaussianParams):
    """-> (params with fresh leaves that require grad, the leaves)."""
    leaves = {f: getattr(params, f).detach().requires_grad_(True)
              for f in ("means", "scales", "quats", "opacity", "sh0", "shN")}
    return dataclasses.replace(params, **leaves), leaves


def make_frame(params: GaussianParams, cam, cap: int, grad: bool = False,
               route: Route = GAUSS, geometry: bool = True) -> Frame:
    """The frame of ``params`` seen by ``cam`` on ``route``; the surfel
    route's colours carry the normal's (nx, ny) with ``geometry``."""
    leaves = {}
    if grad:
        params, leaves = _grad_leaves(params)
    w, h = cam.width, cam.height
    num_tiles, depth_bits = B.key_bits(w, h, 16)
    proj, colors, opac = route.inputs(params, cam, geometry)
    pargs = tuple(None if x is None else x.detach()
                  for x in route.prep_args(proj, opac))
    pp = B.prep(*pargs, w, h, 16, 64)
    keys, owners = B.expand_instances(pp, cap, width=w, height=h)
    s_key, s_owner, tile_start, perm = B.sort_instances(
        keys, owners, num_tiles=num_tiles, depth_bits=depth_bits)
    inst = torch.where(s_key == B.CULLED_KEY, -1, s_owner)
    table = route.build_table(*[x.detach() for x in route.table_inputs(
        proj, colors, opac)], inst)
    bins = B.SortedBins(table=table, tile_start=tile_start, s_owner=s_owner,
                        perm=perm, g_offsets=pp.offsets, g_counts=pp.counts,
                        num_instances=pp.total,
                        tile_counts=tile_start[1:] - tile_start[:-1])
    return Frame(route, params, leaves, cam, cap, colors.shape[1], proj,
                 colors, opac, pargs, pp, keys, owners, inst, bins)


def train_loss(cfg: TrainConfig, gt_img, cam, step: int):
    """The train step's loss of a frame's (rgb, alpha, planes): the
    photometric loss against ``gt_img`` (uint8), and the geometry terms
    when the frame has the planes."""
    hyp = hypers_from_config(cfg)

    def loss(rgb, alpha, planes):
        out = photometric_loss(rgb, gt_img.float() / 255.0,
                               hyp["ssim_weight"])
        if planes is not None:
            out = out + geometry_loss(cfg, planes, alpha, cam, step, hyp)
        return out
    return loss


def sum_loss(rgb, alpha, planes):
    """sum(image), plus a hundredth of the planes' sum when there are
    planes."""
    return rgb.sum() + (0.0 if planes is None else 0.01 * planes.sum())


def loss_cotangent(fr: Frame, loss_fn) -> torch.Tensor:
    """The cotangent tiles that ``loss_fn(rgb, alpha, planes)`` sends back
    to this frame's forward (black background); ``planes`` is the surfel
    route's [z, z^2, nx, ny] at nch 5, else None."""
    w, h = fr.cam.width, fr.cam.height
    out = fr.route.fwd(fr.table, fr.tile_start, width=w, height=h,
                       nch=fr.nch)
    bg = torch.zeros((3,), device=out.device)
    rgb, t_px, extra = SR.split_surfel_tiles(out, bg, w, h, 16, fr.nch)
    leaves = [x.detach().requires_grad_(True) for x in (rgb, 1.0 - t_px,
                                                        extra)]
    with_planes = fr.route is SURFEL and fr.nch == SR.MAX_CH
    loss = loss_fn(*leaves[:2], leaves[2] if with_planes else None)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    g_rgb, g_alpha, g_extra = (torch.zeros_like(x) if g is None else g
                               for x, g in zip(leaves, grads))
    return SR.surfel_cotangent(g_rgb, g_alpha, g_extra, bg, fr.nch)


def kernel_records(scene: str, fr: Frame, device: torch.device,
                   scale: Scale, launches: dict, *, cot=None,
                   per_step: int | None = None, backward_only: bool = False,
                   expand: bool = True, **bkw) -> list[dict]:
    """Expand and the route's kernels against their plain versions at this
    frame's shapes, with their times, the plain versions' times (the
    checks' own calls: the forward's with its pair counting, the
    backward's with the magnitudes of its terms) and their bounds: expand (unless ``expand`` is False: a frame binned by
    ``tiles.bin_gaussians``) and forward unless ``backward_only``, and the
    backward
    (with ``bkw``) on the cotangent tiles ``cot`` when given, after its
    schedule on the card is held against its plain version. One record per
    kernel, tagged with the scene."""
    route, nch = fr.route, fr.nch
    w, h = fr.cam.width, fr.cam.height
    cap, table, tile_start = fr.cap, fr.table, fr.tile_start
    kw = dict(width=w, height=h, nch=nch)
    it = scale.timing_iters * 5
    # the forward's check also counts the pairs that the bounds charge
    fw_err, counts, reads, fw_plain = check_forward(route, table,
                                                    tile_start, w, h, nch)
    cull = {} if backward_only else check_survivors(route, table,
                                                    tile_start, w, h, scene)
    n = fr.pp.u.shape[0]
    owning = int((fr.pp.counts > 0).sum())    # gaussians with instances
    kept = int(tile_start[-1])
    num_tiles = tile_start.shape[0] - 1
    tile_bytes = num_tiles * 256 * 4          # one row of a (T, 8, 256)
    # the instance rows this data needs read (each tile up to its last
    # pixel's stop) and the tile ranges
    read_bytes = reads * (route.inst_rows + nch) * 4 + (num_tiles + 1) * 4
    rows = [] if backward_only or not expand else [
        ("expand", check_expand(fr.pp, cap, w, h)["max_abs_err"],
         time_ms(lambda: B.expand_instances(fr.pp, cap, width=w, height=h),
                 device, it),
         time_ms(lambda: B.expand_instances_plain(
             fr.pp, cap, width=w, height=h), device, 1, warmup=0),
         # the 9 fields of each gaussian that owns instances, and every
         # slot's key and owner
         owning * 9 * 4 + cap * 8, 0)]
    rows += [] if backward_only else [
        (route.forward, fw_err,
         time_ms(lambda: route.fwd(table, tile_start, **kw), device, it),
         fw_plain,
         read_bytes + 8 * tile_bytes, route.fwd_ops(counts, nch),
         {"longest_tile": int((tile_start[1:] - tile_start[:-1]).max()),
          **cull}),
    ]
    if cot is not None:
        units = check_schedule(tile_start, table.shape[1], scene)
        fwd = route.fwd(table, tile_start, **kw)
        chk = check_backward(route, table, tile_start, fwd, cot, w, h, nch,
                             **bkw)
        # it reads nch + tile_rows / 2 rows of the cotangent and forward
        # tiles each, and writes the rows of every kept instance
        rows.append((
            route.backward, chk["max_abs_err"],
            time_ms(lambda: route.bwd(table, tile_start, cot, fwd, **kw,
                                      **bkw), device, it),
            chk["plain_ms"],
            read_bytes + (2 * nch + route.tile_rows) * tile_bytes
            + kept * (route.grad_rows + nch) * 4,
            route.bwd_ops(counts, nch, **bkw),
            {"max_rel_err": chk["row_rel"],
             "max_scale_rel_err": float(chk["scale_rel"].max()),
             "outlier_cols": chk["outlier_cols"], "nch": nch,
             "units": int((units[:, 0] >= 0).sum()),
             "longest_tile": int((tile_start[1:] - tile_start[:-1]).max()),
             **bkw}))
        rows.append(check_segment(
            route.bwd(table, tile_start, cot, fwd, **kw, **bkw), fr.bins,
            route.grad_rows + nch, device, it))
    recs = _records(scene, rows, launches, per_step)
    log(f"  {scene} kernels at {w}x{h}, nch {nch}, {n} splats ({owning} "
        f"with instances), capacity {cap}, demand {int(fr.pp.total)}, "
        f"{kept} instances kept, {reads} read, pairs {counts._asdict()}: "
        + "; ".join(
            f"{r['name']} {r['ms']:.4f} ms (plain {r['plain_ms']:.3f} ms, "
            f"bound {r['bound_ms']:.4f} ms by {r['bound_by']}, err "
            f"{r['max_abs_err']:.3e}, launches {r['launches']})"
            + (f", err relative to row max {r['max_rel_err']:.3e} and to "
               f"the entries' scales {r['max_scale_rel_err']:.3e} "
               f"({r['outlier_cols']} of {kept} columns above 1e3 times "
               f"their row's floor)" if "max_rel_err" in r else "")
            + (f", {r['rows']} rows of {r['live_instances']} live "
               f"instances, longest segment {r['longest_segment']}, err "
               f"{r['bound_ratio']:.3e} of its order's bound from float64, "
               f"a second call bitwise, stage {r['stage_ms']:.4f} ms + "
               f"reduce {r['reduce_ms']:.4f} ms, index_add_ "
               f"{r['library_ms']:.4f} ms, from the sorted rows "
               f"{r['library_sorted_ms']:.4f} ms"
               if r["name"] == "segment_rows"
               else "")
            for r in recs))
    return recs


def stage_times(fr: Frame, device: torch.device, scale: Scale,
                recs: list[dict], cot=None, loss_fn=sum_loss,
                **bkw) -> dict:
    """Mean ms of each stage of one full frame, each timed alone on its own
    inputs; the kernels' times are those of ``recs``, or timed here for a
    kernel that ``recs`` lacks. With ``cot``, also
    the stages of the backward: the backward kernel, the reduce, autograd
    through projection and SH, and one whole render forward + backward of
    ``loss_fn`` (``fr`` must then be made with ``grad``)."""
    route = fr.route
    w, h = fr.cam.width, fr.cam.height
    num_tiles, depth_bits = B.key_bits(w, h, 16)
    geometry = fr.nch == SR.MAX_CH
    tins = [x.detach() for x in route.table_inputs(fr.proj, fr.colors,
                                                   fr.opac)]
    kernel_ms = {r["name"]: r["ms"] for r in recs}
    stages = {
        "project+sh": lambda: route.inputs(fr.params, fr.cam, geometry),
        "prep": lambda: B.prep(*fr.prep_args, w, h, 16, 64),
        "expand": kernel_ms.get("expand", lambda: B.expand_instances(
            fr.pp, fr.cap, width=w, height=h)),
        "sort+ranges": lambda: B.sort_instances(
            fr.keys, fr.owners, num_tiles=num_tiles, depth_bits=depth_bits),
        "table": lambda: route.build_table(*tins, fr.inst),
        route.forward: kernel_ms.get(route.forward, lambda: route.fwd(
            fr.table, fr.tile_start, width=w, height=h, nch=fr.nch)),
    }
    if cot is not None:
        fwd = route.fwd(fr.table, fr.tile_start, width=w, height=h,
                        nch=fr.nch)
        grads = route.bwd(fr.table, fr.tile_start, cot, fwd, width=w,
                          height=h, nch=fr.nch, **bkw)
        gouts = route.reduce(grads, fr.bins, fr.nch)

        def project_backward():
            outs = route.table_inputs(*route.inputs(fr.params, fr.cam,
                                                    geometry))
            torch.autograd.grad(outs, list(fr.leaves.values()), gouts,
                                allow_unused=True)

        stages.update({
            route.backward: kernel_ms[route.backward],
            "reduce": lambda: route.reduce(grads, fr.bins, fr.nch),
            "autograd project+sh": project_backward,
            "whole render fwd+bwd": lambda: render_forward_backward(
                route, fr.params, fr.cam, fr.cap, geometry, loss_fn, **bkw),
        })
    return {k: v if isinstance(v, float) else time_ms(
        v, device, scale.timing_iters) for k, v in stages.items()}


def render_forward_backward(route: Route, params: GaussianParams, cam,
                            icap: int, geometry: bool = True,
                            loss_fn=sum_loss, **bkw):
    """One render on ``route`` and the gradient of ``loss_fn(image, alpha,
    planes)`` with respect to every parameter field."""
    params, leaves = _grad_leaves(params)
    out = route.render(params, cam, icap, geometry, **bkw)
    loss = loss_fn(out.image, out.alpha, out.extra)
    return out, torch.autograd.grad(loss, list(leaves.values()),
                                    allow_unused=True)


# --------------------------------------------------------------------------
# training path


def count_launches(fn, device: torch.device, steps: int | None, what: str,
                   only_steps: bool = True, kernels=TRAIN_KERNELS):
    """Run ``fn()`` with every launch count set to 0 just before and read
    just after -> (its result, the counts). On a card each of ``kernels``
    (those of the training path it drives) must have been launched. With
    ``only_steps`` (``fn`` launches nothing but its ``steps`` train steps)
    the launches per step are printed too; ``steps`` None: not known
    ahead."""
    sync(device)
    _build.reset_launches()
    out = fn()
    sync(device)
    launches = dict(_build.LAUNCHES)
    over = "" if steps is None else f" over {steps} steps"
    log(f"  {what}: launches{over} {launches}" + (
        ", per step " + ", ".join(f"{k} {launches[k] / steps:.3f}"
                                  for k in kernels)
        if only_steps else ""))
    if device.type == "cuda":
        for k in kernels:
            if launches[k] <= 0:
                raise AssertionError(f"kernel {k} was not launched on the "
                                     f"training path ({what})")
        if "segment_rows" in kernels and launches["segment_rows"] != (
                launches["backward"] + launches["surfel_backward"]):
            raise AssertionError(f"{what}: the segment kernel was not "
                                 f"launched once a backward: {launches}")
    return out, launches


def trainer_records(scene: str, tr: Trainer, device: torch.device,
                    scale: Scale, launches: dict, steps: int) -> list[dict]:
    """The kernels of a trainer's route against their plain versions on
    view 0 of its dataset, at its trained state and instance capacity,
    with the cotangent of its loss (and its AbsGS setting)."""
    ds = tr.dataset
    rk = render_kwargs_from_config(tr.cfg)
    surfel = rk["backend"] == "surfel_pallas"
    fr = make_frame(tr.state.params, ds.cameras[0], tr.instance_capacity,
                    route=SURFEL if surfel else GAUSS)
    cot = loss_cotangent(fr, train_loss(tr.cfg, ds.images[0], fr.cam,
                                        tr.state.step))
    bkw = {} if surfel else {"with_absgrad": rk["with_absgrad"]}
    return kernel_records(scene, fr, device, scale, launches, cot=cot,
                          per_step=steps, **bkw)


def small_setup(rng, strategy, device, n_gt=400, capacity=1200, res=64,
                n_views=10):
    """``tests/test_train.py``'s small setup, through the port."""
    gt = random_scene(rng, n_gt, sh_degree=0, device=device)
    cams = orbit_cameras(n_views, width=res, device=device)
    ds = Dataset.from_views(cams, render_gt_images(
        gt, cams, instance_capacity=1 << 15))
    pts = gt.means.cpu().numpy()[:200] + 0.05 * rng.standard_normal((200, 3))
    cols = rng.uniform(0.2, 0.8, (200, 3))
    params = init_from_points(pts, cols, sh_degree=0, capacity=capacity,
                              device=device)
    cfg = TrainConfig(sh_degree=0, ssim_weight=0.2)
    cfg.densify.strategy = strategy
    cfg.densify.warmup_length = 30
    cfg.densify.refine_every = 40
    cfg.densify.reset_alpha_every = 10_000
    cfg.densify.refine_stop_iter = 10_000
    cfg.densify.cap_max = capacity
    return cfg, ds, params


# the loss bars, as (name, strategy, bar, small-setup arguments, config
# fields, densify fields): tests/test_train.py:48-68 (3DGS) and :103-113
# (2DGS surfels with the normal-consistency loss from step 0)
BARS_3DGS = (("adc+", DensifyStrategy.ADC_PLUS, 0.6, {}, {},
              {"revised_opacity": True}),
             ("mcmc", DensifyStrategy.MCMC, 0.7, {}, {}, {"cap_max": 800}))
BARS_2DGS = (("2dgs", DensifyStrategy.ADC_PLUS, 1.0,
              {"res": 48, "n_views": 6},
              {"model_type": 1, "normal_consistency_loss": True,
               "normal_start_iter": 0}, {}),)
# each bar's steps: the fewest at which it held on the card, read from
# 150-step runs (60 for 2DGS) whose loss ratio over their first n steps
# was 0.4946 at 120 (ADC+; 0.6001 at 100), 0.6424 at 60 (MCMC) and 0.8256
# / 0.8380 at 20 (2DGS through the surfel kernels / the XLA surfel
# route), the kernel and tiles routes' 3DGS ratios equal to 4 digits
# (``tools/dist_probe.py --bars`` on an H100 80GB HBM3 at 700.00 W); the
# reference's tests run 150, 150 and 60
BAR_STEPS = {"adc+": 120, "mcmc": 60, "2dgs": 20}


def train_bars(device: torch.device, scale: Scale, cases=BARS_3DGS,
               iters: int | None = None,
               kernels=TRAIN_KERNELS) -> list[dict]:
    """(a) Loss bars: the mean loss of the last 10 steps below ``bar``
    times the first 10, each bar run for at most its ``BAR_STEPS`` and
    checked when it runs them; each run's launch counts, and its kernels
    against their plain versions on its view 0."""
    most = scale.bars_iters if iters is None else iters
    records = []
    for name, strategy, bar, setup_kw, cfg_kw, densify_kw in cases:
        iters = min(most, BAR_STEPS[name])
        cfg, ds, params = small_setup(np.random.default_rng(0), strategy,
                                      device, **setup_kw)
        cfg = cfg.replace(**cfg_kw)
        for k, v in densify_kw.items():
            setattr(cfg.densify, k, v)
        tr = Trainer(cfg, ds, params,
                     render_kwargs={"instance_capacity": 1 << 15})
        losses = []
        t0 = time.perf_counter()
        _, launches = count_launches(
            lambda: tr.run(iters, log_every=0,
                           callback=lambda i, st, m: losses.append(
                               m["loss"])),
            device, iters, f"(a) {name}", kernels=kernels)
        losses = torch.stack(losses).cpu().numpy()
        dt = time.perf_counter() - t0
        first, last = float(np.mean(losses[:10])), float(np.mean(losses[-10:]))
        alive = int(tr.state.params.alive.sum())
        log(f"  (a) {name}: {iters} steps in {dt:.2f} s, loss "
            f"first-10 {first:.5f} last-10 {last:.5f} (ratio "
            f"{last / first:.4f}, bar {bar}), alive {alive}")
        if not np.isfinite(losses).all():
            raise AssertionError(f"{name}: non-finite loss")
        if iters >= BAR_STEPS[name] and not last < bar * first:
            raise AssertionError(f"{name}: loss ratio {last / first:.4f} "
                                 f"misses the bar {bar}")
        recs = trainer_records(f"bars_{name}_{ds.cameras[0].width}", tr,
                               device, scale, launches, iters)
        for r in recs:
            r.update(loss_ratio=last / first, bar=bar)
        records += recs
    return records


def _bench_setup(device: torch.device, scale: Scale, model_type: int = 0):
    """The JAX bench's primary training configuration (bench.py:81-143):
    GT from a 50K-splat random scene, a fresh 100K-splat random model at
    capacity 2^17, SH 3, orbit views, the default (MCMC) strategy; with
    ``model_type=1`` the same scene trained as exact 2DGS surfels with the
    normal-consistency loss from step 0."""
    rng = np.random.default_rng(0)
    sr = (0.004, 0.025)
    gt = random_scene(rng, min(scale.train_splats, scale.train_gt),
                      sh_degree=3, scale_range=sr, device=device)
    cams = orbit_cameras(scale.train_views, width=scale.train_res,
                         device=device)
    ds = Dataset.from_views(cams, render_gt_images(
        gt, cams, instance_capacity=1 << 20))
    params = random_scene(rng, scale.train_splats, sh_degree=3,
                          capacity=scale.train_capacity, scale_range=sr,
                          device=device)
    cfg = TrainConfig(sh_degree=3, model_type=model_type)
    if model_type == 1:
        cfg.normal_start_iter = 0
    cfg.densify.cap_max = scale.train_capacity
    cfg.densify.refine_every = 100
    cfg.densify.warmup_length = 500
    return cfg, ds, params


def train_bench(device: torch.device, scale: Scale,
                model_type: int = 0) -> dict:
    """(b) Warm-up, then ``train_iters`` steps timed with CUDA events; the
    instance capacity is sized from the demand the first step measures,
    by the trainer's policy. The kernel launch counts are those of the
    warm-up and the timed steps."""
    cfg, ds, params = _bench_setup(device, scale, model_type)
    kernels, what = ((SURFEL_KERNELS, "(b) train2d bench") if model_type
                     else (TRAIN_KERNELS, "(b) bench"))

    def fresh(icap):
        step = make_train_step(cfg, ds, {"instance_capacity": icap})
        return step, TrainState.init(params, seed=0)

    step_fn, state = fresh(1 << 19)
    _, m = step_fn(state, 0)
    demand = int(m["num_instances"])
    icap = auto_icap(demand)
    step_fn, state = fresh(icap)
    warm_steps = min(4, ds.num_views)
    steps = warm_steps + scale.train_iters

    def run():
        nonlocal state
        for i in range(warm_steps):
            state, _ = step_fn(state, i % ds.num_views)
        losses = []
        sync(device)
        t0 = time.perf_counter()
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
        for i in range(scale.train_iters):
            state, m = step_fn(state, i % ds.num_views)
            losses.append(m["loss"])
        if device.type == "cuda":
            end.record()
            end.synchronize()
            return losses, start.elapsed_time(end) / 1e3
        return losses, time.perf_counter() - t0

    (losses, secs), launches = count_launches(run, device, steps, what,
                                              kernels=kernels)
    reproducible(step_fn, TrainState.init(params, seed=0), state, ds, what)
    losses = torch.stack(losses).cpu().numpy()
    its = scale.train_iters / secs
    busy = device_busy(lambda: step_fn(state, 0), device, ds.num_views)
    log(f"  {what}: {scale.train_splats} splats (capacity "
        f"{scale.train_capacity}), SH 3, {ds.num_views} views at "
        f"{scale.train_res}x{scale.train_res}, MCMC, model_type "
        f"{model_type}: demand {demand}, "
        f"instance capacity {icap}; {scale.train_iters} timed steps in "
        f"{secs:.4f} s = {its:.3f} it/s; loss first {losses[0]:.6f} last "
        f"{losses[-1]:.6f}")
    if not np.isfinite(losses).all():
        raise AssertionError("bench: non-finite loss")
    if device.type == "cuda":
        # one pass over the views at the start against one at the end
        v = ds.num_views
        first, last = float(losses[:v].mean()), float(losses[-v:].mean())
        if not last < first:
            raise AssertionError(f"bench: the loss did not fall (mean over "
                                 f"the views {first:.6f} -> {last:.6f})")
    return dict(params=state.params, cams=ds.cameras, images=ds.images,
                cfg=cfg, step=state.step,
                icap=icap, demand=demand, its=its, launches=launches,
                steps=steps, loss_first=float(losses[0]),
                loss_last=float(losses[-1]), device_busy=busy)


def device_busy(fn, device: torch.device, iters: int) -> float | None:
    """Share of the wall time of ``iters`` calls of ``fn`` during which the
    card ran a kernel: the device time of every kernel in a
    ``torch.profiler`` trace over the window's host time; the largest
    kernels by device time are printed. None when the trace holds no
    device time (or there is no card)."""
    if device.type != "cuda":
        return None
    from torch.profiler import ProfilerActivity, profile
    fn()
    sync(device)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        sync(device)
        wall_us = (time.perf_counter() - t0) * 1e6

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    # device-side events only: an operator's own row repeats the device
    # time of the kernels it launched
    events = sorted((e for e in prof.key_averages()
                     if e.device_type == torch.autograd.DeviceType.CUDA),
                    key=dev_us, reverse=True)
    total = sum(dev_us(e) for e in events)
    if total <= 0:
        log("  profiler: no device time in the trace; busy share not "
            "measured")
        return None
    log(f"  profiler over {iters} steps: wall {wall_us / 1e3:.3f} ms, "
        f"kernels {total / 1e3:.3f} ms ({total / 1e3 / iters:.3f} ms a "
        f"step), device busy "
        f"{total / wall_us:.4f}; largest: " + "; ".join(
            f"{e.key[:48]} {dev_us(e) / 1e3 / iters:.3f} ms/step "
            f"x{e.count // iters}" for e in events[:8]))
    return total / wall_us


def train_demo(device: torch.device, scale: Scale, flags=(),
               label: str = "demo", kernels=TRAIN_KERNELS) -> list[dict]:
    """(d) A few steps of ``python -m divshot_tpu_torch.apps.train
    --demo`` with ``flags``, in this process, its output echoed; then the
    kernels of its route against their plain versions on the demo's view
    0. The launch counts are those of the whole app run, ground-truth
    renders included; the launches per step are counted over the steps
    after the first."""
    buf = io.StringIO()
    after_first = {}

    def step_done(i, state, m):
        if i == 0:
            after_first.update(_build.LAUNCHES)

    def run():
        with tempfile.TemporaryDirectory() as out, \
                contextlib.redirect_stdout(buf):
            return train_app.run(
                ["--demo", "--iterations", str(scale.demo_iters),
                 "--device", device.type, "--model_path", out, *flags],
                callback=step_done)

    tr, launches = count_launches(run, device, scale.demo_iters,
                                  f"(d) {label} app run", only_steps=False,
                                  kernels=kernels)
    for line in buf.getvalue().splitlines():
        log(f"  (d) {line}")
    if tr is None:
        raise AssertionError("apps.train --demo did not train")
    last = progress_lines(buf.getvalue())[-1]
    loss = float(last.split("loss=")[1].split()[0])
    if not math.isfinite(loss):
        raise AssertionError("apps.train --demo: non-finite loss")
    steps = scale.demo_iters - 1
    per_step = {k: (launches[k] - after_first[k]) / max(steps, 1)
                for k in kernels}
    log(f"  (d) {label}: launches per step over steps 2.."
        f"{scale.demo_iters}: "
        + ", ".join(f"{k} {v:.3f}" for k, v in per_step.items()))
    recs = trainer_records(f"{label}_{tr.dataset.cameras[0].width}", tr,
                           device, scale, launches, scale.demo_iters)
    for r in recs:
        r["launches_per_step"] = per_step[r["name"]]
    return recs


def progress_lines(out: str) -> list[str]:
    """The train app's per-step progress lines (``[step/total] loss=...``)
    in its output."""
    return [ln for ln in out.splitlines()
            if ln.startswith("[") and "loss=" in ln]


def bench_records(scene: str, bench: dict, route: Route,
                  device: torch.device, scale: Scale, **bkw) -> list[dict]:
    """(b) The kernels of a bench run's route against their plain versions
    on its view 0 at its trained state, with the cotangent of its loss,
    and the stage breakdown of one render forward + backward there."""
    fr = make_frame(bench["params"], bench["cams"][0], bench["icap"],
                    grad=True, route=route)
    loss_fn = train_loss(bench["cfg"], bench["images"][0], fr.cam,
                         bench["step"])
    cot = loss_cotangent(fr, loss_fn)
    recs = kernel_records(scene, fr, device, scale, bench["launches"],
                          cot=cot, per_step=bench["steps"], **bkw)
    stages = stage_times(fr, device, scale, recs, cot, loss_fn, **bkw)
    log(f"  (b) {fr.cam.width}x{fr.cam.height} {scene} render forward + "
        f"backward stages (ms, each timed alone): "
        + ", ".join(f"{k} {v:.3f}" for k, v in stages.items()))
    for r in recs:
        r.update(it_per_s=bench["its"], loss_first=bench["loss_first"],
                 loss_last=bench["loss_last"], demand=bench["demand"],
                 icap=bench["icap"], device_busy=bench["device_busy"])
    return recs


def phase_training(device: torch.device, scale: Scale) -> list[dict]:
    records = train_bars(device, scale)
    records += bench_records(f"train_{scale.train_splats}_{scale.train_res}",
                             train_bench(device, scale), GAUSS, device,
                             scale, with_absgrad=False)

    # (c) one render forward + backward at random 1M, 1920x1080
    rnd = random_scene(np.random.default_rng(0), scale.random_splats,
                       sh_degree=3, scale_range=(0.004, 0.025),
                       device=device)
    cam = orbit_cameras(1, width=scale.width, height_px=scale.height,
                        device=device)[0]
    demand = int(render_fast(rnd, cam, instance_capacity=scale.probe_capacity
                             )[2].num_instances)
    icap = auto_icap(demand)
    sync(device)
    _build.reset_launches()
    out, grads = render_forward_backward(GAUSS, rnd, cam, icap)
    sync(device)
    launches = dict(_build.LAUNCHES)
    if not all(bool(torch.isfinite(g).all()) for g in grads if g is not None):
        raise AssertionError("1M render: non-finite gradients")
    if device.type == "cuda" and launches["backward"] != 1:
        raise AssertionError(f"1M render: launches {launches}")
    fr = make_frame(rnd, cam, icap, grad=True)
    cot = loss_cotangent(fr, sum_loss)
    recs = kernel_records(f"random_{scale.random_splats}", fr, device,
                          scale, launches, cot=cot, with_absgrad=False)
    stages = stage_times(fr, device, scale, recs, cot, with_absgrad=False)
    log(f"  {scale.width}x{scale.height} render forward + backward stages "
        f"(ms, each timed alone): "
        + ", ".join(f"{k} {v:.3f}" for k, v in stages.items()))
    records += [r for r in recs if r["name"] in ("backward",
                                                 "segment_rows")]

    if scale.demo_iters:
        records += train_demo(device, scale)
    # (e) the trained 3DGS model, whose longest tile never stops
    records += model_record(device, scale, GAUSS, MODEL, "(e)",
                            backward_only=True, with_absgrad=False)
    return records


# --------------------------------------------------------------------------
# the exact-2DGS (surfel) kernels and training path


def _degenerate_surfels(table, tile_start, width: int):
    """The surfel table with NaN columns (all rows; a T entry; a zplane
    entry; the opacity), surfels seen edge-on (p2 = 0 exactly, and two
    nearly so with a constant depth plane, whose u overflows rho3d) and
    three fronto-parallel surfels of opacity 1 centred on a pixel centre
    of their tile, whose alpha clamps -> (table, the changed columns)."""
    t = table.clone()
    n = int(tile_start[-1])
    cols = torch.linspace(0, n - 1, 7).long().tolist()
    t[:, cols[0]] = float("nan")
    t[4, cols[1]] = float("nan")
    t[SR.ROW_ZP + 2, cols[2]] = float("nan")
    t[SR.ROW_OP, cols[3]] = float("nan")
    for c, eps in zip(cols[4:], (0.0, 1e-3, 1e-6)):
        t[3:6, c] = 2.0 * t[0:3, c]
        t[4, c] = t[4, c] * (1.0 + eps)
        t[6:8, c] = 0.0
        t[SR.ROW_ZP:SR.ROW_ZP + 2, c] = 0.0
        t[SR.ROW_OP, c] = 0.9
    starts = tile_start.tolist()
    tiles_x = -(-width // 16)
    full = [k for k in range(len(starts) - 1)
            if starts[k + 1] > starts[k] and starts[k] not in cols]
    for k in full[:: max(1, len(full) // 3)][:3]:
        x0 = (k % tiles_x) * 16 + 3.5
        y0 = (k // tiles_x) * 16 + 5.5
        t[:SR.ROW_OP + 1, starts[k]] = torch.tensor(
            [4.0, 0.0, 2.0 * x0, 0.0, 4.0, 2.0 * y0, 0.0, 0.0, 2.0,
             0.0, 0.0, 2.0, x0, y0, 1.0], device=t.device)
        cols.append(starts[k])
    return t, cols


def surfel_kernels_vs_plain(params, cam, device: torch.device) -> dict:
    """Phase 3's surfel part: the surfel forward (exactly) and backward
    against their plain versions at nch 3 and 5, on a table with NaN,
    edge-on and clamping surfels; the backward's error relative to its
    entries' scales is reported for those columns and the others
    apart."""
    w, h = cam.width, cam.height
    pr, _, opac = SR.surfel_inputs(params, cam)
    demand = int(B.prep(*SURFEL.prep_args(pr, opac), w, h, 16, 64).total)
    cap = min(auto_icap(demand), 1 << 21)
    out = {}
    for nch in (3, 5):
        fr = make_frame(params, cam, cap, route=SURFEL, geometry=nch == 5)
        table, planted = _degenerate_surfels(fr.table, fr.tile_start, w)
        err, counts, _, _ = check_forward(SURFEL, table, fr.tile_start, w,
                                          h, nch)
        out["surfel_forward_err"] = max(out.get("surfel_forward_err", 0.0),
                                        err)
        fwd = SR.surfel_forward(table, fr.tile_start, width=w, height=h,
                                nch=nch)
        cot = _cotangent(fwd.shape[0], nch, device, nch, planes=True)
        chk = check_backward(SURFEL, table, fr.tile_start, fwd, cot, w, h,
                             nch)
        out[f"surfel_backward_err_nch{nch}"] = chk["max_abs_err"]
        mask = torch.zeros_like(chk["scale_rel"], dtype=torch.bool)
        mask[planted] = True
        log(f"  surfel nch {nch}: {params.capacity} splats at {w}x{h}, "
            f"capacity {cap}, demand {demand}, pairs {counts._asdict()}, "
            f"NaN, edge-on and clamping surfels: forward exact, backward "
            f"max abs err {chk['max_abs_err']:.3e}, max row-relative err "
            f"{chk['row_rel']:.3e}, max err relative to the entries' "
            f"scales {float(chk['scale_rel'][~mask].max()):.3e} on the "
            f"scene's columns and {float(chk['scale_rel'][mask].max()):.3e} "
            f"on the {len(planted)} planted ones (tolerance "
            f"{BACKWARD_RTOL} each; npix exact; {chk['outlier_cols']} "
            f"columns above 1e3 times their row's floor)")
    return out


def model_record(device: torch.device, scale: Scale, route: Route,
                 path: Path, label: str, backward_only: bool = False,
                 **bkw) -> list[dict]:
    """A trained model of the repo on ``route`` at the frame size, view 0
    of the app's orbit: one render forward and backward of ``sum_loss``
    with its launch counts (each kernel of the route once), its kernels
    against their plain versions with that loss's cotangent (the backward
    alone with ``backward_only``), and the stage breakdown; ``bkw`` goes
    to the render and the backward."""
    params = _load(path, device, scale)
    name = path.parent.name
    kernels = SURFEL_KERNELS if route is SURFEL else TRAIN_KERNELS
    cam = orbit_for_model(params, 1, radius=4.0, width=scale.width,
                          height=scale.height, fov=50.0)[0]
    with torch.no_grad():
        demand = int(route.render(params, cam, scale.probe_capacity, True,
                                  **bkw).num_instances)
    icap = auto_icap(demand)
    sync(device)
    _build.reset_launches()
    out, grads = render_forward_backward(route, params, cam, icap, **bkw)
    sync(device)
    launches = dict(_build.LAUNCHES)
    log(f"  {label} {name} render forward + backward at "
        f"{cam.width}x{cam.height}: launches {launches}")
    _check_frame(out.image.detach(), out.alpha.detach(), name)
    if not all(bool(torch.isfinite(g).all()) for g in grads if g is not None):
        raise AssertionError(f"{name}: non-finite gradients")
    if device.type == "cuda" and any(launches[k] != 1 for k in kernels):
        raise AssertionError(f"{name}: launches {launches}")
    fr = make_frame(params, cam, icap, grad=True, route=route)
    cot = loss_cotangent(fr, sum_loss)
    recs = kernel_records(name, fr, device, scale, launches, cot=cot,
                          backward_only=backward_only, **bkw)
    stages = stage_times(fr, device, scale, recs, cot, **bkw)
    log(f"  {label} {cam.width}x{cam.height} {name} render forward + "
        f"backward stages (ms, each timed alone): "
        + ", ".join(f"{k} {v:.3f}" for k, v in stages.items()))
    for r in recs:
        r.update(demand=demand, icap=icap)
    return recs


def phase_training_2dgs(device: torch.device, scale: Scale) -> list[dict]:
    """The exact-2DGS training path: (a) the 2DGS loss bar, (b) the
    train2d cell timed with its stage breakdown, (c) the trained 2DGS
    model at the frame size, (d) ``apps.train --demo --model_type 1``."""
    records = train_bars(device, scale, BARS_2DGS, scale.bars2d_iters,
                         SURFEL_KERNELS)
    records += bench_records(
        f"train2d_{scale.train_splats}_{scale.train_res}",
        train_bench(device, scale, model_type=1), SURFEL, device, scale)
    records += model_record(device, scale, SURFEL, MODEL_2DGS, "(c)")
    if scale.demo_iters:
        records += train_demo(device, scale, ("--model_type", "1"),
                              "demo2d", SURFEL_KERNELS)
    return records


# --------------------------------------------------------------------------
# the dataset path: a scene on disk to checkpoints, an eval curve and a PLY

_BRICKS: dict = {}
# phase 7's eval PSNR by step, keyed as ``_BRICKS``: phase 13(a) holds the
# JPEG capture's curve against it
PNG_CURVE: dict = {}


def bricks(device: torch.device, scale: Scale) -> tuple[str, float]:
    """``tpu_bricks`` traced on ``device`` at ``data_res`` with
    ``data_views`` into a temporary directory, once for phases 7 and 8 ->
    (its directory, the seconds it took)."""
    key = (device.type, scale.data_res, scale.data_views)
    if key not in _BRICKS:
        tmp = tempfile.TemporaryDirectory()
        data = f"{tmp.name}/tpu_bricks"
        t0 = time.perf_counter()
        generate_dataset(data, n_train=scale.data_views[0],
                         n_test=scale.data_views[1], width=scale.data_res,
                         height=scale.data_res, device=device)
        _BRICKS[key] = (tmp, data, time.perf_counter() - t0)
    return _BRICKS[key][1:]


def drop_bricks() -> None:
    """Remove the scenes ``bricks`` made."""
    for tmp, _, _ in _BRICKS.values():
        tmp.cleanup()
    _BRICKS.clear()


def _app_run(argv: list[str], device: torch.device, what: str,
             steps: int, max_steps: int | None = None):
    """``apps.train.run(argv)`` with its launch counts, its output echoed
    -> (the trainer, the counts, the output)."""
    buf = io.StringIO()

    def run():
        with contextlib.redirect_stdout(buf):
            return train_app.run(argv, max_steps=max_steps)

    tr, launches = count_launches(run, device, steps, what,
                                  only_steps=False)
    for line in buf.getvalue().splitlines():
        log(f"  {line}")
    if tr is None:
        raise AssertionError(f"{what}: the app did not train")
    return tr, launches, buf.getvalue()


def _same_state(a: dict, b: dict, what: str) -> None:
    """Two ``checkpoint.state_dict``s bitwise equal."""
    for k in ("params", "mu", "nu", "dstate"):
        for f, t in a[k].items():
            if t.dtype != b[k][f].dtype or not torch.equal(t, b[k][f]):
                raise AssertionError(f"{what}: {k}.{f} differs")
    for k, t in a.get("bg", {}).items():
        if not torch.equal(t, b["bg"][k]):
            raise AssertionError(f"{what}: bg.{k} differs")
    if set(a.get("bg", {})) != set(b.get("bg", {})):
        raise AssertionError(f"{what}: the envmap state differs")
    for k in ("step", "sampler", "instance_capacity", "pending_views"):
        if a.get(k) != b.get(k):
            raise AssertionError(f"{what}: {k} differs")
    if not torch.equal(a["gen"], b["gen"]):
        raise AssertionError(f"{what}: the generator's state differs")


def phase_dataset(device: torch.device, scale: Scale) -> list[dict]:
    """(a) ``tpu_bricks`` generated by the port's tracer at its full
    800x800 into a temporary directory (24 train and 8 test views, cut from
    100 + 25 for the time limit) and loaded; (b) ``apps.train
    --source_path`` on it for ``data_first`` of ``data_iters`` steps, with
    evals, a periodic checkpoint and the final one; (c) resumed with
    ``--load_itr -2`` to the end. Checks: the files; the checkpoint read
    back bitwise equal to the state saved; the resumed eval curve keeping
    the entries up to the resume step; the final ``point_cloud.ply`` read
    back and rendered bitwise equal to the final params rendered; the eval
    PSNR finite and higher at the last eval than at the first. Then the
    three kernels against their plain versions on the trained state."""
    res, (n_train, n_test) = scale.data_res, scale.data_views
    eval_every, ckpt_every, reset_every = scale.data_every
    data, gen_s = bricks(device, scale)
    with tempfile.TemporaryDirectory() as tmp:
        model = f"{tmp}/model"
        t0 = time.perf_counter()
        train_ds, eval_ds = load_dataset(data, device=device,
                                         white_background=True)
        sync(device)
        load_s = time.perf_counter() - t0
        if (train_ds.images.shape != (n_train, res, res, 3)
                or eval_ds is None or eval_ds.num_views != n_test):
            raise AssertionError("tpu_bricks: the loaded dataset's shape")
        log(f"  (a) tpu_bricks at {res}x{res}, {n_train} train and {n_test} "
            f"test views (cut from 100 + 25 for the time limit): generated "
            f"in {gen_s:.2f} s, loaded in {load_s:.2f} s")
        del train_ds, eval_ds
        argv = ["--source_path", data, "--model_path", model, "--device",
                device.type, "--white_background", "1", "--cap_max",
                str(scale.data_capacity), "--iterations",
                str(scale.data_iters), "--eval_every", str(eval_every),
                "--checkpoint_every", str(ckpt_every), "--reset_alpha_every",
                str(reset_every)]
        first = scale.data_first
        tr, _, out1 = _app_run(argv, device, "(b) apps.train --source_path",
                               first, max_steps=first)
        for name in ("metrics.csv", "eval_curve.json", "point_cloud.ply",
                     f"iteration_{ckpt_every}/state.pt",
                     f"iteration_{first}/state.pt",
                     f"iteration_{first}/point_cloud.ply"):
            if not Path(model, name).exists():
                raise AssertionError(f"(b) {name} was not written")
        _same_state(CK.load_state_dict(model, first), CK.state_dict(
            tr.state, tr._np_rng, tr.instance_capacity),
            f"(b) iteration_{first}")
        curve1 = json.loads(Path(model, "eval_curve.json").read_text())
        tr, launches, out2 = _app_run(argv + ["--load_itr", "-2"], device,
                                      "(c) resumed with --load_itr -2",
                                      scale.data_iters - first)
        if f"resumed from iteration_{first}" not in out2:
            raise AssertionError("(c) did not resume from the checkpoint")
        curve = json.loads(Path(model, "eval_curve.json").read_text())
        if curve[:len(curve1)] != curve1 or curve[len(curve1)]["step"] <= \
                first:
            raise AssertionError("(c) the resumed eval curve lost entries")
        psnrs = [e["psnr"] for e in curve]
        if not (all(math.isfinite(x) for x in psnrs)
                and psnrs[-1] > psnrs[0]):
            raise AssertionError(f"eval PSNR {psnrs}")
        PNG_CURVE[(device.type, res, scale.data_views)] = {
            e["step"]: e["psnr"] for e in curve}
        # the PLY read back renders as the params it was written from
        ply, _ = load_ply(f"{model}/point_cloud.ply", device=device)
        cam = tr.dataset.cameras[0]
        bg = torch.ones((3,), device=device)
        with torch.no_grad():
            a = render(tr.state.params, cam, background=bg,
                       instance_capacity=tr.instance_capacity)
            b = render(ply, cam, background=bg,
                       instance_capacity=tr.instance_capacity)
        if not (torch.equal(a.image, b.image)
                and torch.equal(a.alpha, b.alpha)):
            raise AssertionError("point_cloud.ply renders otherwise than "
                                 "the params it was written from")
    its = [float(ln.split("(")[1].split()[0]) for ln in
           (out1 + out2).splitlines() if ln.startswith("trained ")]
    vps = [float(ln.rsplit(", ", 1)[1].split()[0]) for ln in
           (out1 + out2).splitlines() if ln.startswith("[eval @")]
    log(f"  eval PSNR over the run: "
        + ", ".join(f"{e['step']}: {e['psnr']:.3f}" for e in curve))
    log(f"  dataset path: generation {gen_s:.2f} s, load {load_s:.2f} s, "
        f"train {its[0]:.2f} / {its[1]:.2f} it/s (first run / resumed; "
        f"evals and checkpoints excluded), eval "
        f"{min(vps):.1f}-{max(vps):.1f} views/s; checkpoint bitwise equal "
        f"to the state saved, PLY render bitwise equal to the params'")
    recs = trainer_records(f"tpu_bricks_data_{res}", tr, device, scale,
                           launches, scale.data_iters - first)
    for r in recs:
        r.update(it_per_s=its[1], eval_views_per_s=max(vps),
                 gen_s=gen_s, load_s=load_s, eval_psnr=psnrs[-1])
    return recs


# --------------------------------------------------------------------------
# the trainer's options: batches, the envmap and masks, progressive
# resolution, bf16 shN, streamed views, debug_nan


def option_loss(cfg: TrainConfig, gt: torch.Tensor, cam, step: int,
                env=None, mask=None, weight: float = 1.0):
    """The train step's loss of one view with its options, as a function
    of the frame's (rgb, alpha, planes): the envmap composited behind the
    splats, the mask on the image and the (float) ground truth, the
    geometry terms unmasked, times ``weight`` (1/B of a batch's mean)."""
    hyp = hypers_from_config(cfg)
    bg_px = None if env is None else render_background(env, cam)

    def loss(rgb, alpha, planes):
        img, g = rgb, gt
        if bg_px is not None:
            img = img + (1.0 - alpha)[..., None] * bg_px
        if mask is not None:
            img, g = img * mask[..., None], g * mask[..., None]
        out = photometric_loss(img, g, hyp["ssim_weight"])
        if planes is not None:
            out = out + geometry_loss(cfg, planes, alpha, cam, step, hyp)
        return weight * out
    return loss


def pooled(img: torch.Tensor, s: int) -> torch.Tensor:
    """(h, w, C) float -> averaged over s x s blocks, as the step pools its
    ground truth at 1/s resolution."""
    if s == 1:
        return img
    h, w = img.shape[0] // s, img.shape[1] // s
    return img[:h * s, :w * s].reshape(h, s, w, s, -1).mean((1, 3))


def option_records(scene: str, cfg: TrainConfig, params, ds: Dataset,
                   icap: int, launches: dict, steps: int, device, scale,
                   route: Route = GAUSS, env=None, res_scale: int = 1,
                   weight: float = 1.0) -> list[dict]:
    """The kernels of a run with options against their plain versions on
    view 0 at its shapes (1/``res_scale`` resolution), with the cotangent
    of its own loss (envmap, mask, batch weight)."""
    cam = ds.cameras[0] if res_scale == 1 else scaled_camera(
        ds.cameras[0], res_scale)
    img = ds.images[0]
    img = torch.as_tensor(img, device=device)
    gt = pooled(img.float() / 255.0, res_scale)
    mask = None
    if ds.masks is not None:
        m = torch.as_tensor(ds.masks[0], device=device)
        mask = pooled((m.float() / 255.0)[..., None], res_scale)[..., 0]
    fr = make_frame(params, cam, icap, route=route)
    cot = loss_cotangent(fr, option_loss(cfg, gt, cam, steps, env, mask,
                                         weight))
    bkw = {} if route is SURFEL else {"with_absgrad": False}
    return kernel_records(scene, fr, device, scale, launches, cot=cot,
                          per_step=steps, **bkw)


def timed_steps(step, warm: int, iters: int, device: torch.device):
    """``step(i)`` for ``warm`` steps, then ``iters`` steps timed with CUDA
    events (the host clock on the CPU) -> (their losses, seconds)."""
    for i in range(warm):
        step(i)
    losses = []
    sync(device)
    t0 = time.perf_counter()
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
    for i in range(warm, warm + iters):
        losses.append(step(i)["loss"])
    if device.type == "cuda":
        end.record()
        end.synchronize()
        secs = start.elapsed_time(end) / 1e3
    else:
        secs = time.perf_counter() - t0
    losses = torch.stack(losses).cpu().numpy()
    if not np.isfinite(losses).all():
        raise AssertionError("non-finite loss")
    return losses, secs


def _check_launches(launches: dict, kernels, per_step: int, steps: int,
                    what: str, device: torch.device) -> None:
    """On a card each kernel of the path ran ``per_step`` times a step."""
    if device.type == "cuda" and any(launches[k] != per_step * steps
                                     for k in kernels):
        raise AssertionError(f"{what}: launches {launches}, expected "
                             f"{per_step} a step over {steps} steps")


def _masks(n: int, h: int, w: int) -> np.ndarray:
    """Masks made at run time: the left half of every view left out."""
    m = np.full((n, h, w), 255, np.uint8)
    m[:, :, : w // 2] = 0
    return m


def _with_bg(cfg: TrainConfig, params, seed: int = 0) -> TrainState:
    env = init_envmap(init_color=(1, 1, 1) if cfg.white_background
                      else (0, 0, 0), device=params.device)
    return TrainState.init(params, seed, bg={
        "params": env, "mu": torch.zeros_like(env),
        "nu": torch.zeros_like(env)})


def options_cells(device: torch.device, scale: Scale) -> list[dict]:
    """(a) Phase 5(b)'s train cell with each option: warm-up, then
    ``opt_iters`` steps timed with CUDA events, its launches counted and
    its kernels held against their plain versions at its own shapes."""
    cfg, ds, params = _bench_setup(device, scale)
    res, V = scale.train_res, ds.num_views
    probe = make_train_step(cfg, ds, {"instance_capacity": 1 << 19})
    _, m = probe(TrainState.init(params, 0), 0)
    icap = auto_icap(int(m["num_instances"]))
    rk = {"instance_capacity": icap}
    host = ds.images.cpu().numpy()
    ds_mask = Dataset.from_views(ds.cameras, host, masks=_masks(V, res, res))
    packed = dataclasses.replace(params, shN=params.shN.to(torch.bfloat16))
    warm = min(4, V)
    steps = warm + scale.opt_iters
    records, rates = [], {}

    # (label, config, dataset, res_scale, views of step i, first state,
    #  launches a step); the plain step first and again last, for the
    #  spread of the host's step time within the phase
    runs = [
        ("x1", cfg, ds, 1, lambda i: i % V, TrainState.init(params, 0), 1),
        ("batch4", cfg, ds, 1, lambda i: [(i + k) % V for k in range(4)],
         TrainState.init(params, 0), 4),
        ("bg_mask", cfg.replace(enable_bg=True), ds_mask, 1,
         lambda i: i % V, _with_bg(cfg, params), 1),
        ("x4", cfg, ds, 4, lambda i: i % V, TrainState.init(params, 0), 1),
        ("x2", cfg, ds, 2, lambda i: i % V, TrainState.init(params, 0), 1),
        ("pack1", cfg.replace(pack_level=1), ds, 1, lambda i: i % V,
         TrainState.init(packed, 0), 1),
        ("x1_again", cfg, ds, 1, lambda i: i % V, TrainState.init(params, 0),
         1),
    ]
    for label, rcfg, rds, rs, views, state0, per_step in runs:
        step_fn = make_train_step(rcfg, rds, rk, res_scale=rs)
        box = [state0]

        def step(i):
            box[0], out = step_fn(box[0], views(i))
            return out

        (losses, secs), launches = count_launches(
            lambda: timed_steps(step, warm, scale.opt_iters, device), device,
            steps, f"(a) {label}")
        _check_launches(launches, TRAIN_KERNELS, per_step, steps, label,
                        device)
        st = box[0]
        if label == "pack1" and st.params.shN.dtype != torch.bfloat16:
            raise AssertionError("pack1: shN left bf16")
        its = scale.opt_iters / secs
        rates[label] = its
        w = res // rs
        log(f"  (a) {label}: {scale.opt_iters} timed steps at {w}x{w} in "
            f"{secs:.4f} s = {its:.3f} it/s ({per_step * its:.3f} views/s), "
            f"loss first {losses[0]:.6f} last {losses[-1]:.6f}")
        if label == "x1_again":
            continue
        recs = option_records(
            f"opt_{label}_{w}", rcfg, st.params, rds, icap, launches, steps,
            device, scale, env=None if st.bg is None else st.bg["params"],
            res_scale=rs, weight=1.0 / per_step)
        for r in recs:
            r.update(it_per_s=its, views_per_s=per_step * its, res=w,
                     launches_per_step=launches[r["name"]] / steps)
        records += recs

    # streamed: the Trainer on host images, each step's ground truth on the
    # card held bitwise against the device-resident image of its view
    sds = Dataset.from_views(ds.cameras, host, stream=True)
    tr = Trainer(cfg, sds, params, render_kwargs=rk)
    full_step, seen = tr._steps[1], []

    def checked(state, view, gt, mask, hypers=None):
        seen.append((view, (gt == ds.images[view]).all()))
        return full_step(state, view, gt, mask, hypers=hypers)

    tr._steps[1] = checked
    (losses, secs), launches = count_launches(
        lambda: timed_steps(lambda i: tr.step_once(), warm, scale.opt_iters,
                            device), device, steps, "(a) stream")
    tr.close()
    _check_launches(launches, TRAIN_KERNELS, 1, steps, "stream", device)
    order = np.random.default_rng(cfg.seed).integers(V, size=steps)
    if [v for v, _ in seen] != [int(v) for v in order]:
        raise AssertionError("stream: views out of the device-resident "
                             "order")
    if not all(bool(ok) for _, ok in seen):
        raise AssertionError("stream: a streamed ground truth differs from "
                             "the device-resident one")
    its = scale.opt_iters / secs
    rates["stream"] = its
    store = HostImageStore(images=host, pin=device.type == "cuda")
    copy_ms = time_ms(lambda: store.get(0).to(device, non_blocking=True),
                      device, scale.timing_iters * 2)
    mb = host[0].nbytes / 1e6
    log(f"  (a) stream: {scale.opt_iters} timed steps in {secs:.4f} s = "
        f"{its:.3f} it/s; every step's ground truth bitwise the "
        f"device-resident one, in the same view order; the pinned copy of "
        f"one {mb:.2f} MB view {copy_ms:.4f} ms")
    recs = option_records(f"opt_stream_{res}", cfg, tr.state.params, ds,
                          icap, launches, steps, device, scale)
    for r in recs:
        r.update(it_per_s=its, copy_ms_per_view=copy_ms,
                 launches_per_step=launches[r["name"]] / steps)
    records += recs
    log("  (a) it/s: " + ", ".join(f"{k} {v:.3f}" for k, v in rates.items())
        + f"; views/s at batch 4 {4 * rates['batch4']:.3f} against "
        f"{rates['x1']:.3f} / {rates['x1_again']:.3f} at batch 1 (first / "
        f"last)")
    return records


def options_2dgs(device: torch.device, scale: Scale) -> list[dict]:
    """(b) The train2d cell as exact 2DGS with batches of 2 views, the
    envmap and masks: a few steps, the expand and surfel kernels' launches
    (2 a step) and the kernels against their plain versions."""
    cfg, ds, params = _bench_setup(device, scale, model_type=1)
    cfg = cfg.replace(enable_bg=True)
    res, V = scale.train_res, ds.num_views
    ds = Dataset.from_views(ds.cameras, ds.images.cpu().numpy(),
                            masks=_masks(V, res, res))
    probe = make_train_step(cfg, ds, {"instance_capacity": 1 << 19})
    _, m = probe(_with_bg(cfg, params), 0)
    icap = auto_icap(int(m["num_instances"]))
    step_fn = make_train_step(cfg, ds, {"instance_capacity": icap})
    box = [_with_bg(cfg, params)]

    def step(i):
        box[0], out = step_fn(box[0], [i % V, (i + 1) % V])
        return out

    steps = 1 + scale.opt2d_iters
    (losses, secs), launches = count_launches(
        lambda: timed_steps(step, 1, scale.opt2d_iters, device), device,
        steps, "(b) train2d batch 2, envmap, masks", kernels=SURFEL_KERNELS)
    _check_launches(launches, SURFEL_KERNELS, 2, steps, "(b)", device)
    its = scale.opt2d_iters / secs
    log(f"  (b) train2d, exact 2DGS, batch 2, envmap and masks: "
        f"{scale.opt2d_iters} timed steps in {secs:.4f} s = {its:.3f} it/s "
        f"({2 * its:.3f} views/s), loss first {losses[0]:.6f} last "
        f"{losses[-1]:.6f}")
    recs = option_records(f"opt2d_b2_bg_mask_{res}", cfg, box[0].params, ds,
                          icap, launches, steps, device, scale,
                          route=SURFEL, env=box[0].bg["params"], weight=0.5)
    for r in recs:
        r.update(it_per_s=its, launches_per_step=launches[r["name"]] / steps)
    return recs


def masked_psnr(params, ds: Dataset, icap: int, device) -> float:
    """Mean PSNR over ``ds``'s views of the pixels its masks keep whole
    (255), rendered over white, as the eval renders."""
    bg = torch.ones((3,), device=device)
    out = []
    with torch.no_grad():
        for v, cam in enumerate(ds.cameras):
            img = render(params, cam, background=bg,
                         instance_capacity=icap).image
            keep = ds.masks[v] == 255
            mse = ((img - ds.images[v].float() / 255.0) ** 2)[keep].mean()
            out.append(float(-10.0 * torch.log10(mse)))
    return float(np.mean(out))


def options_app(device: torch.device, scale: Scale) -> list[dict]:
    """(c) ``apps.train --source_path`` on phase 7's ``tpu_bricks`` with
    masks from the PNGs' alpha, the envmap, progressive resolution and
    bf16 shN: a first run with a checkpoint mid-way, then ``--load_itr -2``
    to the end. Checks: the files, the checkpoint read back bitwise (the
    envmap, its moments, bf16 shN and moments), the resumed run's scale,
    the eval PSNR finite, the PSNR of the eval views' masked-in pixels
    rising from the first run's end to the second's (the loss sees only
    those: the full-frame eval also scores the background, which no step
    trains), the PLY float32 and equal to the bf16 shN."""
    data, _ = bricks(device, scale)
    _, eval_ds = load_dataset(data, device=device, white_background=True,
                              use_mask=True)
    iters, first, sched, eval_every, ckpt_every, reset_every = scale.opt_app
    with tempfile.TemporaryDirectory() as tmp:
        model = f"{tmp}/model"
        argv = ["--source_path", data, "--model_path", model, "--device",
                device.type, "--white_background", "1", "--cap_max",
                str(scale.data_capacity), "--iterations", str(iters),
                "--eval_every", str(eval_every), "--checkpoint_every",
                str(ckpt_every), "--reset_alpha_every", str(reset_every),
                "--use_mask", "1", "--enable_bg", "1", "--progressive_train",
                "1", "--resolution_schedule", str(sched), "--pack_level", "1"]
        tr, _, out1 = _app_run(argv, device, "(c) apps.train with the "
                               "options", first, max_steps=first)
        masks = tr.dataset.masks
        if masks is None or not bool((masks < 255).any()):
            raise AssertionError("(c) the masks did not come from alpha")
        for name in ("eval_curve.json", "point_cloud.ply",
                     f"iteration_{ckpt_every}/state.pt",
                     f"iteration_{first}/state.pt"):
            if not Path(model, name).exists():
                raise AssertionError(f"(c) {name} was not written")
        saved = CK.load_state_dict(model, first)
        if saved["params"]["shN"].dtype != torch.bfloat16 or \
                saved["mu"]["shN"].dtype != torch.bfloat16 or "bg" not in saved:
            raise AssertionError("(c) the checkpoint lost bf16 shN or the "
                                 "envmap")
        _same_state(saved, CK.state_dict(tr.state, tr._np_rng,
                                         tr.instance_capacity),
                    f"(c) iteration_{first}")
        kept = [masked_psnr(tr.state.params, eval_ds, tr.instance_capacity,
                            device)]
        tr, launches, out2 = _app_run(argv + ["--load_itr", "-2"], device,
                                      "(c) resumed with --load_itr -2",
                                      iters - first)
        if f"resumed from iteration_{first}" not in out2:
            raise AssertionError("(c) did not resume from the checkpoint")
        scales = [tr.res_scale(s) for s in (first, iters - 1)]
        log(f"  (c) scales: step {first} x{scales[0]}, step {iters - 1} "
            f"x{scales[1]} (schedule {sched})")
        if scales != [4 if first < sched else 2 if first < 2 * sched else 1,
                      1]:
            raise AssertionError(f"(c) resumed at scales {scales}")
        curve = json.loads(Path(model, "eval_curve.json").read_text())
        psnrs = [e["psnr"] for e in curve]
        kept.append(masked_psnr(tr.state.params, eval_ds,
                                tr.instance_capacity, device))
        if not (len(psnrs) >= 2 and all(math.isfinite(x) for x in psnrs)
                and all(math.isfinite(x) for x in kept)
                and kept[1] > kept[0]):
            raise AssertionError(f"(c) eval PSNR {psnrs}, of the masked-in "
                                 f"pixels {kept}")
        arrays, _ = read_ply_arrays(f"{model}/point_cloud.ply")
        p = tr.state.params
        shn = p.shN[p.alive].float().cpu().numpy()
        if arrays["shN"].dtype != np.float32 or not np.array_equal(
                arrays["shN"], shn):
            raise AssertionError("(c) the PLY is not the float32 of bf16 "
                                 "shN")
    its = [float(ln.split("(")[1].split()[0]) for ln in
           (out1 + out2).splitlines() if ln.startswith("trained ")]
    log(f"  (c) eval PSNR: " + ", ".join(f"{e['step']}: {e['psnr']:.3f}"
                                         for e in curve)
        + f"; of the masked-in pixels {kept[0]:.3f} at step {first}, "
        f"{kept[1]:.3f} at {iters}; "
        f"{its[0]:.2f} / {its[1]:.2f} it/s (first run / resumed); "
        f"checkpoint bitwise, PLY float32 equal to the bf16 shN")
    res = tr.dataset.cameras[0].width
    recs = option_records(f"opt_app_bricks_{res}", tr.cfg, p, tr.dataset,
                          tr.instance_capacity, launches, iters - first,
                          device, scale, env=tr.state.bg["params"])
    for r in recs:
        r.update(it_per_s=its[1], eval_psnr=psnrs[-1],
                 masked_psnr=kept[1])
    return recs


def options_debug_nan(device: torch.device, scale: Scale) -> None:
    """(d) ``--debug_nan 1`` on ``tpu_bricks``: a clean run finishes; a
    NaN written into one mean after the first step raises
    ``FloatingPointError`` naming the projection stage."""
    data, _ = bricks(device, scale)
    n = scale.nan_iters

    def argv(model):
        return ["--source_path", data, "--model_path", model, "--device",
                device.type, "--white_background", "1", "--cap_max",
                str(scale.data_capacity), "--iterations", str(n),
                "--debug_nan", "1"]

    with tempfile.TemporaryDirectory() as tmp:
        tr, _, _ = _app_run(argv(f"{tmp}/clean"), device,
                            "(d) --debug_nan 1, clean", n)
        if tr.state.step != n:
            raise AssertionError("(d) the clean run stopped early")

        def poison(i, state, m):
            if i == 0:
                state.params.means[0, 0] = float("nan")

        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(io.StringIO()):
                train_app.run(argv(f"{tmp}/nan"), callback=poison)
        except FloatingPointError as e:
            if "projection" not in str(e):
                raise AssertionError(f"(d) raised at another stage: {e}")
            log(f"  (d) a NaN mean after step 1 raised, as expected, in "
                f"{time.perf_counter() - t0:.2f} s: FloatingPointError: {e}")
        else:
            raise AssertionError("(d) a NaN mean did not raise")


def phase_options(device: torch.device, scale: Scale) -> list[dict]:
    records = []
    for label, fn in (("(a)", options_cells), ("(b)", options_2dgs),
                      ("(c)", options_app), ("(d)", options_debug_nan)):
        t0 = time.perf_counter()
        records += fn(device, scale) or []
        log(f"  {label} done in {time.perf_counter() - t0:.2f} s")
    return records


# --------------------------------------------------------------------------
# the live-training session: TrainerSession, the live viewer server and
# apps.viewer, the dataset through the session, LPIPS


@contextlib.contextmanager
def demo_scale(scale: Scale):
    """``apps.train``'s demo scene (which ``apps.viewer --demo`` trains
    towards) at this scale's size, restored after; at FULL the demo's own
    20K splats and 32 views at 400 px."""
    names = ("DEMO_SPLATS", "DEMO_VIEWS", "DEMO_WIDTH")
    old = [getattr(train_app, n) for n in names]
    for n, v in zip(names, scale.session_demo[:3]):
        setattr(train_app, n, v)
    try:
        yield
    finally:
        for n, v in zip(names, old):
            setattr(train_app, n, v)


def _session_cfg(scale: Scale, **kw) -> TrainConfig:
    """The default config (``cap_max`` 2M at FULL) with ``kw``."""
    cfg = TrainConfig(**kw)
    if scale.session_demo[3]:
        cfg.densify.cap_max = scale.session_demo[3]
    return cfg


def _cap_flags(scale: Scale) -> list[str]:
    cap = scale.session_demo[3]
    return ["--cap_max", str(cap)] if cap else []


def _wait(sess: TrainerSession, pred, what: str,
          timeout: float = 300.0) -> None:
    """Wait for ``pred()``; raise on the session's error or at the
    deadline."""
    deadline = time.perf_counter() + timeout
    while not pred():
        if sess.error:
            raise AssertionError(f"{what}: the session failed:\n"
                                 f"{sess.error}")
        if time.perf_counter() > deadline:
            raise AssertionError(f"{what}: timed out")
        time.sleep(0.01)
    if sess.error:
        raise AssertionError(f"{what}: the session failed:\n{sess.error}")


def _finished(sess: TrainerSession, iters: int, what: str) -> None:
    _wait(sess, sess.is_terminated, what)
    sess.terminate()
    if (sess.error or sess.status != TrainingStatus.TRAINING_DONE
            or sess.current_iteration != iters):
        raise AssertionError(f"{what}: ended in {sess.status.value} at "
                             f"iteration {sess.current_iteration} of "
                             f"{iters}: {sess.error}")


def _http(port: int, path: str) -> tuple[dict, bytes]:
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=60) as r:
        return dict(r.headers), r.read()


def _poll_live(sess: TrainerSession, server: LiveViewerServer,
               max_splats: int) -> dict:
    """Poll ``/status`` while the session trains, as the page does, and
    fetch ``/splats`` whenever the generation moves; hold each payload
    against ``splat_bytes`` of the snapshot of its generation (when the
    snapshot has not moved on meanwhile) and its size against the alive
    splats, and one ``?max=`` payload against its bound."""
    gens, checked, seen, decimated = set(), 0, -1, False
    while not sess.is_terminated():
        st = json.loads(_http(server.port, "/status")[1])
        if st["phase"] == "Training":
            gens.add(st["generation"])
        if st["generation"] != seen:
            headers, body = _http(server.port, "/splats")
            seen = int(headers["X-Generation"])
            snap = sess.get_params_snapshot()
            if sess.snapshot_generation == seen:
                want = 32 * min(snap.capacity, server.max_splats)
                if len(body) != want or body != splat_bytes(snap):
                    raise AssertionError(
                        f"/splats at generation {seen}: {len(body)} bytes, "
                        f"not splat_bytes of the snapshot ({want})")
                checked += 1
                if not decimated and snap.capacity > max_splats:
                    part = _http(server.port, f"/splats?max={max_splats}")[1]
                    if len(part) != 32 * max_splats:
                        raise AssertionError("/splats?max= size")
                    decimated = True
        time.sleep(0.05)
    if sess.error:
        raise AssertionError(f"(a) the session failed:\n{sess.error}")
    if len(gens) < 3 or checked < 2 or not decimated:
        raise AssertionError(f"the live viewer saw generations {sorted(gens)}"
                             f" while training, checked {checked} payloads "
                             f"(decimated: {decimated})")
    return {"generations": sorted(gens), "payloads_checked": checked}


def _plain_its(sess: TrainerSession, steps: int, device) -> float:
    """it/s of ``steps`` calls of ``Trainer.step_once`` on the session's
    trainer, in a plain loop on this thread, after one step untimed; timed
    by ``core/profiling.StepTimer`` fenced on the card, in a named
    scope."""
    tr = sess.trainer
    tr.step_once()
    sync(device)
    timer = StepTimer(fence_every=1)
    with timer.scope("plain loop", fence_on=device), \
            profile_scope("plain loop"):
        for _ in range(steps):
            tr.step_once()
    return steps / (timer.summary()["plain loop"]["last_ms"] / 1e3)


def _snapshot_ms(sess: TrainerSession, device, reps: int = 2
                 ) -> tuple[float, float]:
    """ms of one session snapshot (the alive rows gathered on the card,
    one copy to the host) and of a whole-capacity copy of every field, as
    JAX's snapshot makes it; the host's clock, the card idle at the
    start."""
    p = sess.trainer.state.params
    out = []
    for fn in (sess._take_snapshot,
               lambda: [getattr(p, f).cpu().numpy() for f in (
                   "means", "scales", "quats", "opacity", "sh0", "shN",
                   "alive")]):
        fn()
        sync(device)
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        sync(device)
        out.append((time.perf_counter() - t0) * 1e3 / reps)
    return out[0], out[1]


def session_live(device: torch.device, scale: Scale):
    """(a) ``apps.viewer``'s demo session trained on its thread while this
    thread polls the live viewer over HTTP; the plain loop before and
    after; a snapshot's ms; the instance demand against the session's
    fixed capacity; then ``apps.viewer.main --demo`` in this process ->
    (the kernel records, the session)."""
    iters, snap_every, plain_iters, _, app_iters, _ = scale.session_iters
    cfg = _session_cfg(scale, num_iters=iters)
    t0 = time.perf_counter()
    with demo_scale(scale):
        sess = viewer_app.demo_session(cfg, device,
                                       snapshot_every=snap_every)
    setup_s = time.perf_counter() - t0
    alive = sess.trainer.state.params.num_alive
    plain = TrainerSession(cfg, device=device, snapshot_every=0)
    plain.load_synthetic(sess.trainer.dataset)
    plain.trainer.step_once()
    demand1 = int(plain.trainer.last_metrics["num_instances"])
    before = _plain_its(plain, plain_iters, device)
    server = LiveViewerServer(sess, port=0).start()
    try:
        def run():
            sess.start_train()
            return _poll_live(sess, server, max(1, alive // 2))
        live, launches = count_launches(run, device, iters, "(a) live session",
                                        only_steps=False)
        _finished(sess, iters, "(a) live session")
    finally:
        server.stop()
    after = _plain_its(plain, plain_iters, device)
    its = iters / sess.train_seconds
    snap_ms, full_ms = _snapshot_ms(sess, device)
    m = sess.trainer.last_metrics
    demand, icap = int(m["num_instances"]), sess.trainer.instance_capacity
    cam = sess.get_camera(0)
    log(f"  (a) demo session: {sess.num_cameras} views at {cam.width}x"
        f"{cam.height}, {alive} splats in capacity "
        f"{sess.trainer.state.params.capacity}, set up in {setup_s:.2f} s; "
        f"{iters} steps at {its:.2f} it/s (snapshots every {snap_every}, "
        f"the viewer polled), the plain loop {before:.2f} / {after:.2f} it/s"
        f" before / after; generations seen while training "
        f"{live['generations']}, {live['payloads_checked']} payloads equal "
        f"to splat_bytes of their snapshot; loss {sess.current_loss:.5f}")
    log(f"  (a) one snapshot ({alive} alive splats): {snap_ms:.3f} ms; a "
        f"whole-capacity copy of every field: {full_ms:.3f} ms; instance "
        f"demand {demand1} at step 1, {demand} at step {iters}, of the "
        f"fixed capacity {icap} (max tile count "
        f"{int(m['max_tile_count'])}"
        + ("; instances were dropped)" if max(demand, demand1) > icap
           else ")"))
    recs = trainer_records(f"session_{cam.width}", sess.trainer, device,
                           scale, launches, iters)
    for r in recs:
        r.update(it_per_s=its, plain_it_per_s=[before, after],
                 snapshot_ms=snap_ms, snapshot_full_ms=full_ms,
                 demand=demand, demand_step1=demand1,
                 instance_capacity=icap)
    buf = io.StringIO()
    with demo_scale(scale), contextlib.redirect_stdout(buf):
        rc = viewer_app.main(["--demo", "--port", "0", "--num_iters",
                              str(app_iters), "--device", device.type,
                              *_cap_flags(scale)])
    for line in buf.getvalue().splitlines():
        log(f"  (a) apps.viewer: {line}")
    if rc != 0:
        raise AssertionError(f"apps.viewer.main --demo returned {rc}")
    plain.close()
    return recs, sess


def session_control(label: str, ds: Dataset, device: torch.device,
                    scale: Scale, kernels=TRAIN_KERNELS, **cfg_kw):
    """(b) The session's controls on ``ds``: a pause holds the iteration
    for 0.5 s; a queued ``pos_lr_init`` keeps the step functions; a queued
    ``ssim_weight`` 0 rebuilds them; a queued ``num_iters`` ends the run
    there -> (the session, its launch counts)."""
    gap = scale.session_iters[3]
    cfg = _session_cfg(scale, num_iters=10_000, **cfg_kw)
    # the 100K random splats in phase 7's capacity, not the demo's 2M: the
    # controls do not need the capacity, and Adam over it is the step's
    cfg.densify.cap_max = min(cfg.densify.cap_max, scale.data_capacity)
    sess = TrainerSession(cfg, device=device, snapshot_every=0)
    sess.load_synthetic(ds)
    tr = sess.trainer
    step0 = tr._steps[1]

    def hold(n):
        _wait(sess, lambda: sess.current_iteration >= n, f"(b) {label}")
        sess.pause_train()
        _wait(sess, sess.is_paused, f"(b) {label}: the pause")
        return sess.current_iteration

    def run():
        sess.start_train()
        it = hold(gap)
        time.sleep(0.5)
        if sess.current_iteration != it or sess.is_training():
            raise AssertionError(f"(b) {label}: the pause did not hold")
        lr = cfg.optim.pos_lr_init * 0.5
        sess.update_config(lambda c: c.replace(
            optim=dataclasses.replace(c.optim, pos_lr_init=lr)))
        sess.resume()
        it = hold(it + gap)
        if tr._steps[1] is not step0 or tr._hypers["pos_lr_init"] != float(
                np.float32(lr)):
            raise AssertionError(f"(b) {label}: a hyper change rebuilt the "
                                 f"steps or did not reach them")
        sess.update_config(lambda c: c.replace(ssim_weight=0.0))
        sess.resume()
        it = hold(it + gap)
        if tr._steps[1] is step0 or tr._hypers["ssim_weight"] != 0.0:
            raise AssertionError(f"(b) {label}: ssim_weight 0 did not "
                                 f"rebuild the steps")
        sess.update_config(lambda c: c.replace(num_iters=it + gap))
        sess.resume()
        _finished(sess, it + gap, f"(b) {label}")
        return it + gap

    t0 = time.perf_counter()
    end, launches = count_launches(run, device, None,
                                   f"(b) {label} controls",
                                   only_steps=False, kernels=kernels)
    log(f"  (b) {label}: the pause held 0.5 s, pos_lr_init kept the steps, "
        f"ssim_weight 0 rebuilt them, num_iters ended the run at {end} "
        f"({time.perf_counter() - t0:.2f} s)")
    return sess, launches


def session_dataset(device: torch.device, scale: Scale):
    """(c) ``load_train_data`` on phase 7's ``tpu_bricks`` (white
    background), trained through the session; ``save_model`` to PLY read
    back bitwise as the snapshot's params and rendered bitwise as them; a
    folder of bare PNGs with no COLMAP ends in ``LOADING_FAILED`` ->
    (the session, its trained params on the card)."""
    steps = scale.session_iters[5]
    data, _ = bricks(device, scale)
    cfg = TrainConfig(num_iters=steps, white_background=True)
    cfg.densify.cap_max = scale.data_capacity
    sess = TrainerSession(cfg, device=device, snapshot_every=0)
    t0 = time.perf_counter()
    sess.load_train_data(data)
    load_s = time.perf_counter() - t0
    loaded = sess.status
    if loaded != TrainingStatus.PREPROCESS_DONE:
        raise AssertionError(f"(c) load_train_data: {sess.status.value}: "
                             f"{sess.error}")

    def run():
        sess.start_train()
        _finished(sess, steps, "(c) dataset session")

    _, launches = count_launches(run, device, steps, "(c) dataset session",
                                 only_steps=False)
    snap = sess.get_params_snapshot()
    with tempfile.TemporaryDirectory() as tmp:
        sess.save_model(f"{tmp}/model.ply")
        ply, _ = load_model(f"{tmp}/model.ply", device=device)
        bad = []
        for f in ("means", "scales", "quats", "opacity", "sh0", "shN",
                  "alive"):
            if not torch.equal(getattr(ply, f).cpu(), getattr(snap, f)):
                bad.append(f)
        params = GaussianParams.from_numpy(
            {f: getattr(snap, f).numpy() for f in (
                "means", "scales", "quats", "opacity", "sh0", "shN",
                "alive")}, device=device)
        cam = sess.get_camera(0)
        bg = torch.ones((3,), device=device)
        icap = sess.trainer.instance_capacity
        with torch.no_grad():
            a = render(params, cam, background=bg, instance_capacity=icap)
            b = render(ply, cam, background=bg, instance_capacity=icap)
        if bad or not (torch.equal(a.image, b.image)
                       and torch.equal(a.alpha, b.alpha)):
            raise AssertionError(f"(c) the saved PLY differs from the "
                                 f"snapshot ({bad}) or renders otherwise")
        bare = Path(tmp, "bare")
        bare.mkdir()
        for png in sorted(Path(data, "train").glob("*.png"))[:3]:
            shutil.copy(png, bare / png.name)
        env = {k: os.environ.pop(k, None) for k in ("DIVSHOT_COLMAP",)}
        path = os.environ.get("PATH", "")
        os.environ["PATH"] = ""
        try:
            fail = TrainerSession(cfg, device=device)
            fail.load_train_data(str(bare))
        finally:
            os.environ["PATH"] = path
            for k, v in env.items():
                if v is not None:
                    os.environ[k] = v
        if (fail.status != TrainingStatus.LOADING_FAILED
                or "COLMAP" not in (fail.error or "")):
            raise AssertionError(f"(c) bare PNGs: {fail.status.value}, "
                                 f"{fail.error}")
    demand = int(sess.trainer.last_metrics["num_instances"])
    log(f"  (c) tpu_bricks at {cam.width}x{cam.height}: loaded to "
        f"{loaded.value} in {load_s:.2f} s, {steps} steps at "
        f"{steps / sess.train_seconds:.2f} it/s, instance demand {demand} of "
        f"the fixed capacity {icap}; the saved PLY bitwise the "
        f"snapshot and rendered bitwise as it; bare PNGs without COLMAP "
        f"ended in {fail.status.value} ({fail.error.splitlines()[0][:60]})")
    return sess, params


def session_lpips(sess: TrainerSession, params: GaussianParams,
                  device: torch.device, scale: Scale) -> dict:
    """(d) LPIPS with random weights in the torchvision layout: on the card
    against the same function on the CPU at the dataset's resolution
    (within 1e-4 relative), its ms a view pair, and ``evaluate`` with
    ``DIVSHOT_LPIPS_WEIGHTS`` set against the same evaluation without."""
    ev = sess._eval_dataset
    bg = torch.ones((3,), device=device)
    rk = {"instance_capacity": sess.trainer.instance_capacity}
    with tempfile.TemporaryDirectory() as tmp:
        path = random_weights(f"{tmp}/lpips.npz")
        fn = lpips_fn(load_weights(path))
        with torch.no_grad():
            img = render(params, ev.cameras[0], background=bg, **rk).image
        gt = ev.images[0].float() / 255.0
        here = float(fn(img, gt))
        t0 = time.perf_counter()
        cpu = float(fn(img.cpu(), gt.cpu()))
        cpu_s = time.perf_counter() - t0
        rel = abs(here - cpu) / abs(cpu)
        if not (cpu > 0 and rel <= 1e-4):
            raise AssertionError(f"(d) LPIPS {here} against {cpu} on the CPU "
                                 f"(relative {rel:.3g})")
        ms = time_ms(lambda: fn(img, gt), device, 5)
        plain = evaluate(params, ev, background=bg, render_kwargs=rk)
        old = os.environ.get("DIVSHOT_LPIPS_WEIGHTS")
        os.environ["DIVSHOT_LPIPS_WEIGHTS"] = path
        try:
            out = evaluate(params, ev, background=bg, render_kwargs=rk)
        finally:
            if old is None:
                os.environ.pop("DIVSHOT_LPIPS_WEIGHTS")
            else:
                os.environ["DIVSHOT_LPIPS_WEIGHTS"] = old
    if "lpips" not in out or not math.isfinite(out["lpips"]):
        raise AssertionError(f"(d) evaluate reported no LPIPS: {out}")
    n = out["n_views"]
    extra = (n / out["views_per_s"] - n / plain["views_per_s"]) * 1e3 / n
    h, w = img.shape[:2]
    log(f"  (d) LPIPS at {w}x{h}: {here:.6f} on {device.type}, {cpu:.6f} on "
        f"the CPU (relative {rel:.3g}; the CPU took {cpu_s:.2f} s); "
        f"{ms:.3f} ms a view pair; evaluate over {n} views: lpips "
        f"{out['lpips']:.6f}, {out['views_per_s']:.1f} views/s against "
        f"{plain['views_per_s']:.1f} without (+{extra:.3f} ms a view)")
    return {"lpips_ms": ms, "lpips_rel_err": rel,
            "eval_lpips_ms_per_view": extra}


def phase_session(device: torch.device, scale: Scale) -> list[dict]:
    """Phase 9, the live-training session on the card: (a) the demo
    session with the live viewer polled over HTTP; (b) its controls, as
    3DGS, as exact 2DGS (``model_type`` 1) and streamed; (c) the dataset
    through the session; (d) LPIPS."""
    t0 = time.perf_counter()
    recs, live = session_live(device, scale)
    log(f"  (a) done in {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    ds = live.trainer.dataset
    live.close()
    s3, _ = session_control("3dgs", ds, device, scale)
    s3.close()
    s2, launches = session_control("2dgs", ds, device, scale,
                                   kernels=SURFEL_KERNELS, model_type=1)
    w = ds.cameras[0].width
    recs += trainer_records(f"session_2dgs_{w}", s2.trainer, device, scale,
                            launches, s2.current_iteration)
    s2.close()
    host = ds.images.cpu().numpy()
    streamed = Dataset.from_views(ds.cameras, host, stream=True)
    ss, _ = session_control("streamed", streamed, device, scale)
    ss.close()
    log(f"  (b) done in {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    data_sess, params = session_dataset(device, scale)
    log(f"  (c) done in {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    lp = session_lpips(data_sess, params, device, scale)
    data_sess.close()
    log(f"  (d) done in {time.perf_counter() - t0:.2f} s")
    for r in recs:
        r.update(lp)
    return recs


# --------------------------------------------------------------------------
# phase 10: the dynamic models, every model format and the export app with
# mesh extraction

DYN_KERNELS = TRAIN_KERNELS


def dyn_setup(device: torch.device, rng, res: int, n_times: int):
    """``tests/test_dynamic.py:19-40``'s moving scene through the port:
    300 ground-truth splats moved 0.6 along +x over the times, 4 orbit
    views at each, the model starting near the scene at t = 0."""
    gt = random_scene(rng, 300, sh_degree=0, device=device)
    base = orbit_cameras(4, width=res, device=device)
    cams, images, times = [], [], []
    for ti in range(n_times):
        t = ti / (n_times - 1)
        moved = dataclasses.replace(gt, means=gt.means + torch.tensor(
            [0.6 * t, 0.0, 0.0], device=device))
        imgs = render_gt_images(moved, base, instance_capacity=1 << 14)
        cams += base
        images += list(imgs)
        times += [t] * len(base)
    ds = Dataset.from_views(cams, np.stack(images))
    ds.times = np.asarray(times, np.float32)
    noise = torch.as_tensor(rng.standard_normal(tuple(gt.means.shape)),
                            dtype=torch.float32, device=device)
    return ds, dataclasses.replace(gt, means=gt.means + 0.03 * noise)


def dynamic_bars(device: torch.device, scale: Scale) -> list[dict]:
    """(a) ``tests/test_dynamic.py:40-73``'s bars through the kernels: the
    mean of the last 15 losses below 0.75x the first 15 for a
    ``DeformationMLP(width=64, depth=3)`` over 75 steps (the reference's
    test runs 150; over its first 75 the ratio read 0.5244 and over 60
    0.8086, ``tools/dist_probe.py --bars`` on an H100 80GB HBM3 at 700.00
    W), below 0.85x for a ``HexPlaneField(32, 16, 8)`` over 300; the mean |dxyz(t=0) -
    dxyz(t=1)| of 100 splats above 1e-4; one launch of each kernel a
    step. The bars are checked when a run has at least 30 steps."""
    res, n_times, mlp_iters, hex_iters = scale.dyn_bars
    cases = (("deform", lambda: DYN.DeformationMLP(width=64, depth=3,
                                                  device=device),
              mlp_iters, 0.75),
             ("hexplane", lambda: DYN.HexPlaneField(32, 16, 8,
                                                    device=device),
              hex_iters, 0.85))
    records = []
    for name, make, iters, bar in cases:
        ds, params = dyn_setup(device, np.random.default_rng(0), res,
                               n_times)
        cfg = TrainConfig(sh_degree=0)
        cfg.densify.warmup_length = 20      # the deformation from step 20
        cfg.densify.refine_every = 10_000   # no refine in a short run
        cfg.densify.cap_max = params.capacity
        net = make()
        init_fn, step_fn = DYN.make_dynamic_train_step(
            cfg, ds, net, render_kwargs={"instance_capacity": 1 << 14},
            net_lr=2e-3)
        state = init_fn(params, 0)
        views = np.random.default_rng(0).integers(ds.num_views, size=iters)
        losses = []

        def run():
            nonlocal state
            for v in views:
                state, m = step_fn(state, int(v))
                losses.append(m["loss"])

        t0 = time.perf_counter()
        _, launches = count_launches(run, device, iters, f"(a) {name}",
                                     kernels=DYN_KERNELS)
        dt = time.perf_counter() - t0
        losses = torch.stack(losses).cpu().numpy()
        with torch.no_grad():
            m100 = state.params.means[:100]
            diff = float((net(m100, 0.0)["dxyz"]
                          - net(m100, 1.0)["dxyz"]).abs().mean())
        first, last = float(losses[:15].mean()), float(losses[-15:].mean())
        log(f"  (a) {name}: {iters} steps at {res}x{res} in {dt:.2f} s "
            f"({iters / dt:.1f} it/s), loss first-15 {first:.5f} last-15 "
            f"{last:.5f} (ratio {last / first:.4f}, bar {bar}), "
            f"|dxyz(0) - dxyz(1)| {diff:.3e} (bar 1e-4)")
        if not np.isfinite(losses).all():
            raise AssertionError(f"(a) {name}: non-finite loss")
        if device.type == "cuda" and any(launches[k] != iters
                                         for k in DYN_KERNELS):
            raise AssertionError(f"(a) {name}: launches {launches}, not "
                                 f"one of each a step")
        if iters >= 30 and not (last < bar * first and diff > 1e-4):
            raise AssertionError(f"(a) {name}: ratio {last / first:.4f} "
                                 f"(bar {bar}), time dependence {diff}")
        with torch.no_grad():
            fr_params = DYN.apply_deformation(state.params, net(
                state.params.means, float(ds.times[0])))
        recs = dyn_records(f"dyn_bars_{name}_{res}", fr_params, ds, cfg,
                           state.step, 1 << 14, device, scale, launches,
                           iters)
        for r in recs:
            r.update(loss_ratio=last / first, bar=bar, time_dependence=diff,
                     it_per_s=iters / dt)
        records += recs
    return records


def dyn_records(scene: str, params: GaussianParams, ds: Dataset, cfg,
                step: int, icap: int, device: torch.device, scale: Scale,
                launches: dict, steps: int) -> list[dict]:
    """The three kernels against their plain versions on view 0 of a
    dynamic dataset, at the splats deformed to its time, with the
    cotangent of the step's loss and its AbsGS setting."""
    fr = make_frame(params, ds.cameras[0], icap)
    cot = loss_cotangent(fr, train_loss(cfg, ds.images[0], fr.cam, step))
    rk = render_kwargs_from_config(cfg)
    return kernel_records(scene, fr, device, scale, launches, cot=cot,
                          per_step=steps, with_absgrad=rk["with_absgrad"])


def dnerf_scene(device: torch.device, scale: Scale, root: str) -> float:
    """(b) A D-NeRF-layout blender scene written at run time into
    ``root``: ground-truth splats (SH 3) moving 0.5 along +x over the
    times, ``cameras`` orbit views at each of ``times`` times for training
    and ``test`` more orbit views at times between, rendered through the
    kernels and written with ``gsio/png.write_png``, a ``time`` in every
    frame -> the seconds it took."""
    n_gt, res, n_cams, n_times, n_test = scale.dyn_scene
    t0 = time.perf_counter()
    gt = random_scene(np.random.default_rng(0), n_gt, sh_degree=3,
                      scale_range=(0.004, 0.03), device=device)
    fov = 50.0
    train = [(c, ti / (n_times - 1)) for ti in range(n_times)
             for c in orbit_cameras(n_cams, width=res, fov_y_deg=fov,
                                    device=device)]
    test_cams = orbit_cameras(2 * n_test, width=res, fov_y_deg=fov,
                              device=device)[1::2]
    test = [(c, (k + 0.5) / n_test) for k, c in enumerate(test_cams)]
    for split, views in (("train", train), ("test", test)):
        os.makedirs(f"{root}/{split}")
        frames = []
        for k, (cam, t) in enumerate(views):
            moved = dataclasses.replace(gt, means=gt.means + torch.tensor(
                [0.5 * t, 0.0, 0.0], device=device))
            img = render_gt_images(moved, [cam],
                                   instance_capacity=1 << 21)[0]
            write_png(f"{root}/{split}/r_{k}.png", img)
            w2c = np.eye(4)
            w2c[:3, :4] = cam.viewmat[:3, :4]
            c2w = np.linalg.inv(w2c)
            c2w[:3, 1:3] *= -1.0            # COLMAP -> OpenGL axes
            frames.append({"file_path": f"./{split}/r_{k}", "time": t,
                           "transform_matrix": c2w.tolist()})
        with open(f"{root}/transforms_{split}.json", "w") as f:
            json.dump({"camera_angle_x": math.radians(fov),
                       "frames": frames}, f)
    return time.perf_counter() - t0


def _same_dynamic_state(a: dict, b: dict, what: str) -> None:
    """Two ``checkpoint.dynamic_state_dict``s bitwise equal."""
    _same_state(a, b, what)
    for k, t in a["net"].items():
        if not torch.equal(t, b["net"][k]):
            raise AssertionError(f"{what}: net.{k} differs")
    for m in ("mu", "nu"):
        for k, t in a["net_opt"][m].items():
            if not torch.equal(t, b["net_opt"][m][k]):
                raise AssertionError(f"{what}: net_opt.{m}.{k} differs")
    if a["net_opt"]["count"] != b["net_opt"]["count"]:
        raise AssertionError(f"{what}: the network's Adam count differs")


def dynamic_app(device: torch.device, scale: Scale) -> list[dict]:
    """(b) ``apps.train --source_path <the D-NeRF scene> --model_type 2
    --cap_max 262144`` with an eval and a checkpoint mid-way (the
    networks at their defaults), then ``--model_type 3`` for fewer steps.
    Checks: the files, the final checkpoint read back bitwise equal to the
    state saved, the eval PSNR rising, one launch of each kernel a step
    (the evals' renders add expand and forward only), the three kernels
    against their plain versions on the trained state."""
    n_gt, res, n_cams, n_times, n_test = scale.dyn_scene
    steps2, steps3, cap = scale.dyn_runs
    records, its = [], {}
    scene = tempfile.TemporaryDirectory()
    data = f"{scene.name}/dnerf"
    gen_s = dnerf_scene(device, scale, data)
    for model_type, steps, label in ((2, steps2, "deform"),
                                     (3, steps3, "hexplane")):
        half = max(1, steps // 2)
        with tempfile.TemporaryDirectory() as tmp:
            model = f"{tmp}/model"
            argv = ["--source_path", data, "--model_path", model,
                    "--device", device.type, "--model_type",
                    str(model_type), "--cap_max", str(cap), "--iterations",
                    str(steps), "--eval_every", str(half),
                    "--checkpoint_every", str(half)]
            tr, launches, out = _app_run(
                argv, device, f"(b) apps.train --model_type {model_type}",
                steps)
            for name in ("eval_curve.json", "point_cloud.ply",
                         f"iteration_{half}/state.pt",
                         f"iteration_{steps}/state.pt"):
                if not Path(model, name).exists():
                    raise AssertionError(f"(b) {label}: {name} was not "
                                         f"written")
            _same_dynamic_state(
                CK.load_state_dict(model, steps),
                CK.dynamic_state_dict(tr.state, tr._np_rng,
                                      tr.instance_capacity),
                f"(b) {label} iteration_{steps}")
            curve = json.loads(Path(model, "eval_curve.json").read_text())
        psnrs = [e["psnr"] for e in curve]
        renders = n_test * len(curve)
        if not all(math.isfinite(x) for x in psnrs):
            raise AssertionError(f"(b) {label}: eval PSNR {psnrs}")
        if steps >= 30 and not psnrs[-1] > psnrs[0]:
            raise AssertionError(f"(b) {label}: eval PSNR did not rise "
                                 f"{psnrs}")
        want = {"expand": steps + renders, "forward": steps + renders,
                "backward": steps}
        if device.type == "cuda" and any(launches[k] != n
                                         for k, n in want.items()):
            raise AssertionError(f"(b) {label}: launches {launches}, want "
                                 f"{want}")
        its[label] = [float(ln.split("(")[1].split()[0])
                      for ln in out.splitlines()
                      if ln.startswith("trained ")][0]
        log(f"  (b) {label}: {steps} steps on {n_cams * n_times} views at "
            f"{res}x{res} with {n_test} test views, capacity {cap}: "
            f"{its[label]:.2f} it/s; eval PSNR "
            + ", ".join(f"{e['step']}: {e['psnr']:.3f}" for e in curve)
            + f"; checkpoint bitwise equal to the state saved; launches "
            f"{launches} ({steps} steps, {renders} eval renders)")
        ds = tr.dataset
        params = tr.deformed_params(float(ds.times[0]))
        recs = dyn_records(f"dyn_{label}_{res}", params, ds, tr.cfg,
                           tr.state.step, tr.instance_capacity, device,
                           scale, launches, steps)
        for r in recs:
            r.update(it_per_s=its[label], eval_psnr=psnrs[-1],
                     gen_s=gen_s)
        records += recs
    scene.cleanup()
    log(f"  (b) dynamic it/s at {res}x{res}: deform {its['deform']:.2f}, "
        f"hexplane {its['hexplane']:.2f}; the scene written in "
        f"{gen_s:.2f} s")
    return records


FORMATS = (".compressed.ply", ".reduced.ply", ".splat", ".spz", ".dvsplat")


def _psnr(a: torch.Tensor, b: torch.Tensor) -> float:
    mse = float(((a.clamp(0, 1) - b.clamp(0, 1)) ** 2).mean())
    return -10.0 * math.log10(max(mse, 1e-10))


def kmeans_check(d: dict, device: torch.device, n_vals: int) -> dict:
    """The reduced export's codebooks: all 20 jobs of ``make_codebooks`` on
    the card, timed; then, on the first ``n_vals`` values of every job,
    the card's Lloyd iterations held step by step against the CPU's on the
    card's own state: the same quantile init (bitwise), each assignment
    equal but at exact distance ties (counted), each centre update within
    1e-5 of the job's range (the card's atomics add in another order).
    Also the two devices' independent runs end to end, whose discrete
    steps amplify that order: their centres' largest difference and the
    ids that differ, reported."""
    t0 = time.perf_counter()
    KM.make_codebooks(d, device=device)
    sync(device)
    card_ms = (time.perf_counter() - t0) * 1e3
    worst = ties = n_all = flips = 0
    end_to_end, cpu_s, dev_s = 0.0, 0.0, 0.0
    for name, vals in KM.codebook_jobs(d).items():
        v = torch.as_tensor(np.asarray(vals[:n_vals], np.float32))
        vd = v.to(device)
        rng = max(float(v.max() - v.min()), 1e-12)
        c = KM.kmeans_init(vd, 256)
        if not torch.equal(c.cpu(), KM.kmeans_init(v, 256)):
            raise AssertionError(f"k-means {name}: the initial centres")
        for it in range(11):
            ids = KM.kmeans_assign(vd, c).cpu()
            c_host = c.cpu()
            ref = KM.kmeans_assign(v, c_host)
            diff = ids != ref
            if bool(diff.any()):
                dc = (v[diff] - c_host[ref[diff]]).abs()
                dd = (v[diff] - c_host[ids[diff]]).abs()
                if not torch.equal(dc, dd):
                    raise AssertionError(f"k-means {name}: step {it}'s ids "
                                         f"differ away from a tie")
                ties += int(diff.sum())
            if it == 10:
                break
            c = KM.kmeans_update(vd, ids.to(device), c)
            up = KM.kmeans_update(v, ids, c_host)
            worst = max(worst, float((c.cpu() - up).abs().max()) / rng)
        t0 = time.perf_counter()
        cc, ic = KM.kmeans_1d(v)
        cpu_s += time.perf_counter() - t0
        t0 = time.perf_counter()
        cd, idv = KM.kmeans_1d(vd)
        sync(device)
        dev_s += time.perf_counter() - t0
        end_to_end = max(end_to_end, float((cd.cpu() - cc).abs().max())
                         / rng)
        flips += int((idv.cpu() != ic).sum())
        n_all += v.numel()
    if worst > 1e-5:
        raise AssertionError(f"k-means: a centre update differs by "
                             f"{worst:.3e} of the range")
    return dict(kmeans_card_ms=card_ms, kmeans_check_cpu_ms=cpu_s * 1e3,
                kmeans_check_card_ms=dev_s * 1e3, kmeans_update_rel=worst,
                kmeans_id_ties=ties, kmeans_values=n_all,
                kmeans_end_to_end_rel=end_to_end, kmeans_end_to_end_ids=flips)


def export_formats(device: torch.device, scale: Scale) -> tuple[list, dict]:
    """(c) The repo's trained model through ``apps.export`` to every
    format and back; each reload rendered through ``render_fast`` (finite,
    its PSNR against the float model's frame); the reduced export's
    k-means on the card against the CPU; then ``apps.export --output
    mesh.obj`` (its launches of expand and forward counted, one each a
    view) and its kernels against their plain versions at the depth
    render's shapes."""
    width, views, mesh_res, n_vals = scale.export
    params = _load(MODEL, device, scale)
    n = params.num_alive
    cam = orbit_for_model(params, 1, radius=4.0, width=width, height=width,
                          fov=50.0)[0]
    bg = torch.zeros((3,), device=device)
    icap = 1 << 23 if device.type == "cuda" else 1 << 16
    ref = render_fast(params, cam, background=bg, instance_capacity=icap)[0]
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        src = str(MODEL)
        if scale.model_stride > 1:
            src = f"{tmp}/model.ply"
            save_model(src, params)
        t0 = time.perf_counter()
        load_model(src, device=device)
        sync(device)
        out["ply_load_ms"] = (time.perf_counter() - t0) * 1e3
        parts = []
        for ext in FORMATS:
            dst = f"{tmp}/model{ext}"
            buf = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                rc = export_app.main(["--input", src, "--output", dst,
                                      "--device", device.type])
            sync(device)
            app_ms = (time.perf_counter() - t0) * 1e3
            if rc != 0 or f"loaded {n} splats" not in buf.getvalue():
                raise AssertionError(f"apps.export {ext}: {buf.getvalue()}")
            t0 = time.perf_counter()
            back, _ = load_model(dst, device=device)
            sync(device)
            load_ms = (time.perf_counter() - t0) * 1e3
            if back.num_alive != n:
                raise AssertionError(f"{ext}: {back.num_alive} of {n} splats")
            img, alpha, _ = render_fast(back, cam, background=bg,
                                        instance_capacity=icap)
            _check_frame(img, alpha, f"{ext} reload")
            p = _psnr(img, ref)
            size = os.path.getsize(dst)
            out[ext] = dict(app_ms=app_ms, load_ms=load_ms, psnr=p,
                            bytes=size)
            parts.append(f"{ext} app {app_ms:.1f} ms (the PLY's load "
                         f"included), load {load_ms:.1f} ms, "
                         f"{size / 1e6:.2f} MB, PSNR {p:.2f} dB")
        log(f"  (c) {n} splats of {MODEL.parent.name} exported and read "
            f"back, rendered at {width}x{width} against the float model "
            f"(its PLY read in {out['ply_load_ms']:.1f} ms): "
            + "; ".join(parts))
        km = kmeans_check(params.compact_numpy(), device, n_vals)
        log(f"  (c) reduced export's k-means: 20 codebooks on the "
            f"{device.type} in {km['kmeans_card_ms']:.1f} ms; on "
            f"{km['kmeans_values']} values (the first {n_vals} of each "
            f"job), step by step against the CPU: the init bitwise, the "
            f"ids equal but at {km['kmeans_id_ties']} exact ties, each "
            f"centre update within {km['kmeans_update_rel']:.2e} of its "
            f"job's range; end to end the {device.type} "
            f"{km['kmeans_check_card_ms']:.1f} ms and the CPU "
            f"{km['kmeans_check_cpu_ms']:.1f} ms, centres apart by up to "
            f"{km['kmeans_end_to_end_rel']:.2e} of the range, "
            f"{km['kmeans_end_to_end_ids']} ids differing")
        mesh = f"{tmp}/mesh.obj"
        buf = io.StringIO()

        def extract():
            with contextlib.redirect_stdout(buf):
                return export_app.main([
                    "--input", src, "--output", mesh, "--views", str(views),
                    "--mesh_resolution", str(mesh_res), "--device",
                    device.type])

        t0 = time.perf_counter()
        rc, launches = count_launches(extract, device, None,
                                      "(c) apps.export --output mesh.obj",
                                      only_steps=False,
                                      kernels=VIEWER_KERNELS)
        mesh_ms = (time.perf_counter() - t0) * 1e3
        verts, faces = read_obj_mesh(mesh)
    # the tiny rehearsal's sparse model (every 512th splat) leaves no
    # surface at two views: non-empty is required from 8 views up
    empty = not len(verts) or not len(faces)
    if rc != 0 or (empty and views >= 8) or (not empty and (
            faces.min() < 0 or faces.max() >= len(verts))):
        raise AssertionError(f"mesh.obj: {len(verts)} vertices, "
                             f"{len(faces)} faces")
    MESH.update(verts=verts, faces=faces)
    if device.type == "cuda" and any(launches[k] != views
                                     for k in VIEWER_KERNELS):
        raise AssertionError(f"mesh: launches {launches}, want {views} each")
    log(f"  (c) mesh: {views} views at 512, resolution {mesh_res}: "
        f"{len(verts)} vertices, {len(faces)} faces in {mesh_ms:.1f} ms; "
        f"{buf.getvalue().strip().splitlines()[-1]}")
    out.update(km, mesh_ms=mesh_ms, mesh_vertices=len(verts),
               mesh_faces=len(faces))
    # the depth render's frame: view 0 of the app's orbit, depth as colour
    d = params.compact_numpy()
    extent = float(np.abs(d["means"] - d["means"].mean(0)).max())
    mcam = orbit_cameras(views, radius=max(2.5 * extent, 1.0), width=512,
                         device=device)[0]
    fr = make_frame(params, mcam, 1 << 20, route=DEPTH)
    recs = kernel_records(f"mesh_depth_{MODEL.parent.name}", fr, device,
                          scale, launches)
    return recs, out


def read_obj_mesh(path: str) -> tuple[np.ndarray, np.ndarray]:
    """An OBJ's triangles -> (vertices (V, 3) float32, faces (F, 3) int32,
    0-based)."""
    verts, faces = [], []
    for line in open(path):
        if line.startswith("v "):
            verts.append([float(x) for x in line.split()[1:4]])
        elif line.startswith("f "):
            faces.append([int(x.split("/")[0]) - 1
                          for x in line.split()[1:4]])
    return (np.asarray(verts, np.float32).reshape(-1, 3),
            np.asarray(faces, np.int32).reshape(-1, 3))


def _depth_inputs(params, cam, geometry):
    """A frame's inputs with the camera-space depth as its colour, as
    ``viewer/mesh.render_depth`` composites it."""
    proj, _, opac = frame_inputs(params, cam)
    R, t = cam.rotation, cam.translation
    m = params.means
    z = R[2][0] * m[:, 0] + R[2][1] * m[:, 1] + R[2][2] * m[:, 2] + t[2]
    return proj, torch.stack([z, z, z], -1), opac


DEPTH = dataclasses.replace(GAUSS, inputs=_depth_inputs)


def phase_dynamic_export(device: torch.device, scale: Scale) -> list[dict]:
    """Phase 10: (a) the dynamic bars, (b) the dynamic models through the
    train app at full width, (c) every format and the mesh through the
    export app."""
    t0 = time.perf_counter()
    records = dynamic_bars(device, scale)
    log(f"  (a) done in {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    records += dynamic_app(device, scale)
    log(f"  (b) done in {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    recs, out = export_formats(device, scale)
    for r in recs:
        r.update(export=out)
    records += recs
    log(f"  (c) done in {time.perf_counter() - t0:.2f} s")
    return records


# --------------------------------------------------------------------------
# phase 11: the editor side


def timed(fn, device: torch.device):
    """-> (fn(), its milliseconds on the host clock with the card synced
    before and after)."""
    sync(device)
    t0 = time.perf_counter()
    out = fn()
    sync(device)
    return out, (time.perf_counter() - t0) * 1e3


def _bits(sess: ED.EditSession) -> tuple:
    """Copies of a session's params and state, for bitwise checks."""
    p = sess.params
    return tuple(getattr(p, f).clone() for f in PARAM_FIELDS) + (
        sess.state.clone(),)


def _same_bits(sess: ED.EditSession, snap: tuple, what: str) -> None:
    now = tuple(getattr(sess.params, f) for f in PARAM_FIELDS) + (
        sess.state,)
    if not all(a.shape == b.shape and torch.equal(a, b)
               for a, b in zip(now, snap)):
        raise AssertionError(f"{what}: params and state not bitwise "
                             f"restored")


def _rot_y(deg: float, t=(0.0, 0.0, 0.0), s: float = 1.0) -> np.ndarray:
    th = math.radians(deg)
    m = np.eye(4)
    m[:3, :3] = np.array([[math.cos(th), 0, math.sin(th)], [0, 1, 0],
                          [-math.sin(th), 0, math.cos(th)]]) * s
    m[:3, 3] = t
    return m


def editor_session(device: torch.device, scale: Scale):
    """(a) Every edit op on the editor's model (``scale.editor``'s splats,
    SH 3) with a second model merged in, each op timed; three undos and
    three redos, each held bitwise against the params and state it
    restores. -> (the session, the merged model, the camera, the ms of
    each op)."""
    n, n_merge = scale.editor[:2]
    rng = np.random.default_rng(11)
    params = random_scene(rng, n, sh_degree=3, scale_range=(0.004, 0.025),
                          device=device)
    other = random_scene(rng, n_merge, sh_degree=3,
                         scale_range=(0.004, 0.025), device=device)
    cam = orbit_cameras(1, width=scale.width, height_px=scale.height,
                        device=device)[0]
    w, h = cam.width, cam.height
    sess = ED.EditSession(params)
    t = np.linspace(0, 1, 64)
    stroke = np.stack([w * (0.2 + 0.6 * t),
                       h * (0.5 + 0.2 * np.sin(6 * t))], -1)
    poly = np.array([[0.3, 0.2], [0.7, 0.25], [0.8, 0.6], [0.5, 0.85],
                     [0.2, 0.6]]) * [w, h]
    ms, counts = {}, {}

    def count(label):
        counts[label] = dict(selected=int(sess.selected.sum()),
                             hidden=int(sess.hidden.sum()),
                             deleted=int(sess.deleted.sum()),
                             alive=sess.params.num_alive)

    script = [
        ("select_sphere", lambda: sess.select_sphere([0.2, 0.0, 0.1], 1.0)),
        ("select_box", lambda: sess.select_box([-1.5, -0.5, -1.5],
                                               [0.0, 0.5, 0.0], ED.OP_ADD)),
        ("select_rect", lambda: sess.select_rect(cam, 0.2 * w, 0.2 * h,
                                                 0.45 * w, 0.6 * h,
                                                 ED.OP_ADD)),
        ("select_brush", lambda: sess.select_brush(cam, stroke, 0.02 * w,
                                                   ED.OP_REMOVE)),
        ("select_polygon", lambda: sess.select_polygon(cam, poly,
                                                       ED.OP_ADD)),
        ("pick", lambda: sess.pick(cam, w / 2, h / 2)),
        ("hide_selected", sess.hide_selected),
        ("select_inverse", sess.select_inverse),
        ("paint_selected", lambda: sess.paint_selected([0.9, 0.2, 0.1])),
        ("transform_selected", lambda: sess.transform_selected(
            _rot_y(30.0, (0.1, 0.05, -0.1), 1.1))),
        ("palette_transform", lambda: ED.palette_transform_selected(
            sess, _rot_y(-15.0, (0.0, 0.2, 0.0)))),
        ("palette_paint", lambda: ED.palette_paint_selected(
            sess, (0.1, 0.4, 0.9))),
        ("effective_params", lambda: ED.effective_params(sess)),
        ("bake_palette", lambda: ED.bake_palette(sess)),
        ("bake_paint_palette", lambda: ED.bake_paint_palette(sess)),
        ("apply_crop", lambda: sess.apply_crop([
            {"type": "box", "lo": [-2.5] * 3, "hi": [2.5] * 3},
            {"type": "sphere", "center": [0.8, 0.8, 0.8], "radius": 0.4,
             "op": "remove"}])),
        ("unhide_all", sess.unhide_all),
        ("select_sphere_2", lambda: sess.select_sphere([-0.5, 0.3, 0.2],
                                                       0.6)),
        ("delete_selected", sess.delete_selected),
        ("compact", sess.compact),
        ("merge", lambda: sess.merge(other)),
    ]
    snaps = []
    picked = -1
    for label, fn in script:
        if label in ("delete_selected", "compact", "merge"):
            snaps.append(_bits(sess))
        out, ms[label] = timed(fn, device)
        if label == "pick":
            picked = out
        count(label)
    snaps.append(_bits(sess))
    if picked < 0:
        raise AssertionError("pick found no splat at the frame's centre")
    sel = counts["select_polygon"]["selected"]
    if not 0 < sel < n or counts["hide_selected"]["hidden"] != sel:
        raise AssertionError(f"selection counts {counts}")
    if counts["compact"]["alive"] != n - counts["delete_selected"][
            "deleted"] \
            or counts["merge"]["alive"] != counts["compact"]["alive"] \
            + n_merge or sess.params.capacity <= n:
        raise AssertionError(f"compact / merge counts {counts}")
    for i in range(3):
        _, ms[f"undo_{i}"] = timed(sess.undo, device)
        _same_bits(sess, snaps[-2 - i], f"undo {i}")
    for i in range(3):
        _, ms[f"redo_{i}"] = timed(sess.redo, device)
        _same_bits(sess, snaps[-3 + i], f"redo {i}")
    _, ms["select_sphere_3"] = timed(
        lambda: sess.select_sphere([0.3, 0.0, 0.0], 0.8), device)
    log(f"  (a) {n} splats SH 3 + {n_merge} merged (capacity "
        f"{sess.params.capacity}), picked splat {picked}; counts: "
        + "; ".join(f"{k} {v['selected']} sel / {v['hidden']} hidden / "
                    f"{v['deleted']} deleted / {v['alive']} alive"
                    for k, v in counts.items()
                    if k in ("select_polygon", "hide_selected", "apply_crop",
                             "delete_selected", "compact", "merge")))
    log("  (a) op ms: " + ", ".join(f"{k} {v:.2f}" for k, v in ms.items()))
    log("  (a) three undos and three redos, each bitwise the params and "
        "state it restores")
    return sess, other, cam, ms


def _tint_inputs(selected: torch.Tensor):
    """A frame's inputs with ``render_with_selection``'s tinted colours."""
    def inputs(params, cam, geometry):
        proj, colors, opac = frame_inputs(params, cam)
        return proj, SR_SCENE.selection_colors(colors, selected), opac
    return inputs


def editor_scene(device: torch.device, scale: Scale, sess, other, cam):
    """(b) A scene of the edited model (graded, cropped, world-transformed)
    and the merged model over a SUN_SKY plate, rendered in SPLAT, DEPTH
    and NORMAL, then the selection tint and outline; the launches of
    expand and forward counted (one each an entity and a frame); the two
    kernels against their plain versions on the tint frame; the dense
    debug modes on a small entity, timed."""
    scene = SC.Scene("editor")
    crop = SC.GaussianCrop()
    crop.add(SC.CropVolume(type=SC.CropType.BOX, pmin=(-2.0, -2.0, -2.0),
                           pmax=(2.0, 2.0, 2.0)))
    comp = SC.GaussianComponent(params=sess.visible_params(),
                                brightness=0.05, white_point=0.95,
                                transparency=0.9, crop=crop)
    scene.create_entity("edited", transform=_rot_y(20.0, (0.0, 0.1, 0.0))
                        .astype(np.float32)).add(comp)
    second = SC.GaussianComponent(params=other)
    scene.create_entity("second", transform=_rot_y(
        0.0, (1.2, 0.0, -0.6)).astype(np.float32)).add(second)
    sky = SC.Environment(mode=SC.EnvironmentMode.SUN_SKY, intensity=0.9)
    scene.create_entity("sky").add(sky)
    vis = sess.visible_params()
    selected = sess.selected & vis.alive
    frames, ms = {}, {}

    def main_path():
        for mode in ("SPLAT", "DEPTH", "NORMAL"):
            comp.render_type = SC.GaussianRenderType[mode]
            frames[mode], ms[mode] = timed(
                lambda: SR_SCENE.render_scene(scene, cam), device)
        comp.render_type = SC.GaussianRenderType.SPLAT
        frames["tint"], ms["tint"] = timed(
            lambda: SR_SCENE.render_with_selection(vis, cam, selected),
            device)
        frames["outline"], ms["outline"] = timed(
            lambda: SR_SCENE.selection_outline(vis, cam, selected), device)

    with torch.no_grad():
        _, launches = count_launches(main_path, device, None,
                                     "(b) the editor's frames",
                                     only_steps=False,
                                     kernels=VIEWER_KERNELS)
    if device.type == "cuda" and any(launches[k] != 8
                                     for k in VIEWER_KERNELS):
        raise AssertionError(f"(b) launches {launches}, want 8 each")
    for mode in ("SPLAT", "DEPTH", "NORMAL"):
        img = frames[mode]
        if img.shape != (cam.height, cam.width, 3) or not bool(
                torch.isfinite(img).all()):
            raise AssertionError(f"(b) {mode} frame")
    _check_frame(*frames["tint"], "(b) selection tint")
    outline = frames["outline"]
    n_edge = int(outline.sum())
    if not bool(((outline == 0) | (outline == 1)).all()) or n_edge == 0:
        raise AssertionError("(b) the outline is not a non-empty 0/1 mask")
    shown = SR_SCENE.composite_outline(frames["tint"][0], outline)
    if not bool(torch.isfinite(shown).all()):
        raise AssertionError("(b) the outline composited over the tint")
    log(f"  (b) {cam.width}x{cam.height}, entities of {vis.num_alive} and "
        f"{other.num_alive} splats, selection {int(selected.sum())}: "
        + ", ".join(f"{k} {v:.2f} ms" for k, v in ms.items())
        + f"; outline {n_edge} pixels")
    with torch.no_grad():
        parts = scene_parts(scene, comp, second, sky, cam, device)
    log("  (b) the SPLAT scene frame's parts, each timed alone: " + ", ".join(
        f"{k} {v:.2f} ms" for k, v in parts.items()))
    route = dataclasses.replace(GAUSS, inputs=_tint_inputs(selected))
    cap = max(1 << 16, 8 * vis.capacity)
    fr = make_frame(vis, cam, cap, route=route)
    recs = kernel_records(f"editor_tint_{vis.num_alive}", fr, device, scale,
                          launches)
    dense_ms = {}
    small = random_scene(np.random.default_rng(12), scale.editor[2],
                         sh_degree=3, device=device)
    # O(N pixels): at half the frame, timed per splat-pixel pair too
    dcam = scaled_camera(cam, 2)
    for mode in ("RINGS", "ELLIPSOIDS", "CENTERS", "POINT"):
        c = SC.GaussianComponent(params=small,
                                 render_type=SC.GaussianRenderType[mode])
        (img, alpha), dense_ms[mode] = timed(
            lambda: SR_SCENE.render_component(c, dcam), device)
        _check_frame(img, alpha, f"(b) {mode}")
    pairs = scale.editor[2] * dcam.width * dcam.height
    dense_ns = {k: v * 1e6 / pairs for k, v in dense_ms.items()}
    log(f"  (b) dense debug modes, {scale.editor[2]} splats at "
        f"{dcam.width}x{dcam.height}: " + ", ".join(
            f"{k} {dense_ms[k]:.1f} ms ({dense_ns[k]:.4f} ns a splat-pixel "
            f"pair)" for k in dense_ms))
    for r in recs:
        r.update(editor_ms=ms, dense_ms=dense_ms, dense_ns_per_pair=dense_ns,
                 scene_parts_ms=parts)
    return recs


def scene_parts(scene, comp, second, sky, cam, device) -> dict:
    """The parts of ``render_scene``'s SPLAT frame, each timed alone (ms):
    the edited entity's grading with its crop, the crop mask alone, its
    world transform baked in, its render; the second entity whole; the
    plate made and sent to the card; then the whole frame again."""
    comp.render_type = SC.GaussianRenderType.SPLAT
    world = scene.find("edited").world_transform(scene)
    graded, ms = {}, {}
    graded["p"], ms["grade+crop"] = timed(
        lambda: comp.graded_params(device), device)
    _, ms["crop mask"] = timed(
        lambda: comp.crop.keep_mask(comp.params.means), device)
    moved, ms["transform"] = timed(
        lambda: SR_SCENE.transform_params(graded["p"], world), device)
    _, ms["render"] = timed(lambda: render(moved, cam), device)
    _, ms["second entity"] = timed(lambda: SR_SCENE.render_component(
        second, cam, scene.find("second").world_transform(scene)), device)
    _, ms["plate"] = timed(lambda: torch.as_tensor(np.array(
        sky.sample_background(cam.width, cam.height), np.float32),
        device=device), device)
    _, ms["whole frame"] = timed(
        lambda: SR_SCENE.render_scene(scene, cam), device)
    return ms


def _check_avi(path: str, n: int, what: str) -> None:
    data = open(path, "rb").read()
    frames = VID.read_mjpeg_avi(path)
    if data[:4] != b"RIFF" or data[8:12] != b"AVI " or len(frames) != n \
            or data.count(b"00dc") < n:
        raise AssertionError(f"{what}: {len(frames)} frames of {n}")
    for i, f in enumerate(frames):
        if f[:2] != b"\xff\xd8" or f.rstrip(b"\x00")[-2:] != b"\xff\xd9":
            raise AssertionError(f"{what}: frame {i} lacks SOI / EOI")


def _run_app(main, argv, what):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    if rc != 0:
        raise AssertionError(f"{what}: rc {rc}: {buf.getvalue()}")
    return buf.getvalue()


def editor_apps(device: torch.device, scale: Scale, sess, cam) -> dict:
    """(c) The edited model as a PLY, then ``apps.render`` without
    ``--fast`` and with it, each with ``--video``: the PNGs and a valid
    MJPEG AVI of the port's own encoder (its ms a frame), each path's
    launches counted; ``post_process`` and ``render_taa`` on one view.
    (d) ``apps.edit`` with ``--op``s, ``--merge``, ``--html`` and
    ``--output`` on that PLY, the output's splat count against an
    ``EditSession`` given the same ops."""
    _, _, _, aw, ah, orbit, taa = scale.editor
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        ply = f"{tmp}/edited.ply"
        vis = sess.visible_params()
        _, out["ply_save_ms"] = timed(lambda: save_model(ply, vis), device)
        # the apps' fixed instance capacity (JAX's 2^20) against the
        # orbit's demand
        bg = torch.zeros((3,), device=device)
        out["orbit_demand"] = max(int(render_fast(
            vis, c, background=bg, instance_capacity=scale.probe_capacity
        )[2].num_instances) for c in orbit_for_model(
            vis, orbit, radius=4.0, width=aw, height=ah, fov=50.0))
        common = ["--model", ply, "--orbit", str(orbit), "--width", str(aw),
                  "--height", str(ah), "--device", device.type]
        for label, flags in (("views", []), ("fast", ["--fast"])):
            avi = f"{tmp}/{label}.avi"
            argv = common + ["--out", f"{tmp}/{label}", "--video", avi,
                             *flags]
            what = " ".join(["(c) apps.render", *flags, "--video"])
            t0 = time.perf_counter()
            text, launches = count_launches(
                lambda: _run_app(render_app.main, argv, what), device, None,
                what, only_steps=False, kernels=VIEWER_KERNELS)
            out[f"render_{label}_s"] = time.perf_counter() - t0
            # the app's capacity holds the orbit's demand: no view drops
            # instances
            grown = re.search(r"demand (\d+) .* capacity (\d+)", text)
            cap = int(grown[2]) if grown else render_app.APP_CAPACITY
            if cap < out["orbit_demand"] + render_app.GUARD_LANES or (
                    grown and int(grown[1]) != out["orbit_demand"]):
                raise AssertionError(f"(c) {label}: capacity {cap}, the "
                                     f"orbit's demand {out['orbit_demand']}"
                                     f": {text}")
            out["app_capacity"] = cap
            if device.type == "cuda" and any(launches[k] != orbit
                                             for k in VIEWER_KERNELS):
                raise AssertionError(f"(c) {label}: launches {launches}")
            _check_avi(avi, orbit, f"(c) {label}")
            pngs = sorted(os.listdir(f"{tmp}/{label}"))
            if len(pngs) != orbit:
                raise AssertionError(f"(c) {label}: {len(pngs)} PNGs")
            out[f"avi_{label}_bytes"] = os.path.getsize(avi)
        # the encoder alone on one of the frames, on the card
        frame = VID.to_uint8(torch.as_tensor(
            read_png(f"{tmp}/views/{pngs[0]}"), device=device))
        VID.encode_jpeg(frame)
        reps = 3
        _, enc = timed(lambda: [VID.encode_jpeg(frame) for _ in
                                range(reps)], device)
        out["jpeg_ms_per_frame"] = enc / reps
        log(f"  (c) {vis.num_alive} splats, PLY written in "
            f"{out['ply_save_ms']:.0f} ms; apps.render {orbit} views at "
            f"{aw}x{ah} with --video: {out['render_views_s']:.2f} s, "
            f"--fast --video {out['render_fast_s']:.2f} s; AVIs of "
            f"{orbit} 00dc frames, idx1 pointing at each, SOI / EOI "
            f"({out['avi_views_bytes']} / {out['avi_fast_bytes']} bytes); "
            f"JPEG encoder {out['jpeg_ms_per_frame']:.1f} ms a frame; the "
            f"orbit's largest instance demand {out['orbit_demand']} held "
            f"by the app's capacity {out['app_capacity']} (JAX's fixed "
            f"{render_app.APP_CAPACITY}, or more where the demand needs "
            f"it)")
        view_cam = orbit_cameras(1, width=scale.width, height_px=scale.height,
                                 device=device)[0]
        with torch.no_grad():
            img, out["taa_ms"] = timed(lambda: POST.render_taa(
                lambda c: render(vis, c).image, view_cam, taa), device)
            pp, out["post_ms"] = timed(lambda: POST.post_process(
                img, tonemap="aces", exposure=0.2, gamma=1.1,
                sharpen_amount=0.25), device)
        if not bool(torch.isfinite(pp).all()) or float(pp.max()) > 1.0:
            raise AssertionError("(c) post_process")
        log(f"  (c) render_taa of {taa} frames {out['taa_ms']:.1f} ms, "
            f"post_process {out['post_ms']:.2f} ms at "
            f"{view_cam.width}x{view_cam.height}")
        # (d) apps.edit on that PLY
        extra = f"{tmp}/extra.ply"
        save_model(extra, random_scene(np.random.default_rng(13),
                                       scale.editor[1] // 10, sh_degree=3,
                                       device=device))
        ops = ["select_sphere:0,0,0,1.0", "select_inverse", "delete",
               "crop_sphere:0,0,0,2.5", "transform_rotate_y:30",
               "select_box:-1,-1,-1,0,1,1", "paint:0.2,0.8,0.3", "compact"]
        argv = ["--input", ply, "--merge", extra, "--device", device.type]
        for o in ops:
            argv += ["--op", o]
        edited, html = f"{tmp}/out.ply", f"{tmp}/out.html"
        t0 = time.perf_counter()
        _run_app(edit_app.main, argv + ["--output", edited, "--html", html],
                 "apps.edit")
        out["edit_app_s"] = time.perf_counter() - t0
        back, _ = load_model(edited, device=device)
        ref = ED.EditSession(load_model(ply, device=device)[0])
        ref.merge(load_model(extra, device=device)[0])
        for o in ops:
            edit_app.apply_op(ref, o)
        want = ref.visible_params().num_alive
        if back.num_alive != want:
            raise AssertionError(f"(d) {back.num_alive} splats in the "
                                 f"output, the session {want}")
        log(f"  (d) apps.edit with {len(ops)} ops and a merge: "
            f"{out['edit_app_s']:.2f} s, {back.num_alive} splats out (the "
            f"session's {want}), HTML {os.path.getsize(html) / 1e6:.1f} MB")
    return out


# phase 11's edited model, which phase 12(e) renders on the tiles route
EDITED: dict = {}
# phase 10(c)'s mesh (vertices, faces), which phase 13(c) renders
MESH: dict = {}


def phase_editor(device: torch.device, scale: Scale) -> list[dict]:
    """Phase 11: (a) the edit session, (b) the scene's frames through
    expand and forward, (c) ``apps.render`` with video, post and TAA, (d)
    ``apps.edit``."""
    t0 = time.perf_counter()
    sess, other, cam, op_ms = editor_session(device, scale)
    EDITED["params"] = sess.visible_params()
    log(f"  (a) done in {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    recs = editor_scene(device, scale, sess, other, cam)
    log(f"  (b) done in {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    apps = editor_apps(device, scale, sess, cam)
    log(f"  (c, d) done in {time.perf_counter() - t0:.2f} s")
    for r in recs:
        r.update(op_ms=op_ms, apps=apps)
    return recs


def phase_routes(device: torch.device, scale: Scale) -> list[dict]:
    """Phase 12, the routes of ``render()`` other than the kernel route
    (``chip_smoke_routes.py``)."""
    import chip_smoke_routes
    return chip_smoke_routes.phase_routes(device, scale)


def phase_capture(device: torch.device, scale: Scale) -> list[dict]:
    """Phase 13, real captures and the mesh renderers
    (``chip_smoke_capture.py``)."""
    import chip_smoke_capture
    return chip_smoke_capture.phase_capture(device, scale)


def phase_dist(device: torch.device, scale: Scale) -> list[dict]:
    """Phase 14, training over several processes and tile-sharded
    rendering (``chip_smoke_dist.py``)."""
    import chip_smoke_dist
    return chip_smoke_dist.phase_dist(device, scale)


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
    records += run("5 training path", phase_training)
    records += run("6 2DGS training path", phase_training_2dgs)
    records += run("7 dataset path", phase_dataset)
    records += run("8 the trainer's options", phase_options)
    records += run("9 the live-training session", phase_session)
    dyn = run("10 dynamic models, formats and export", phase_dynamic_export)
    static = next(r["it_per_s"] for r in records
                  if r["scene"].startswith("train_") and "it_per_s" in r)
    log("phase 10(b) dynamic it/s against the static train cell (5(b), "
        f"100K splats at 800x800, {static:.2f} it/s): " + ", ".join(
            f"{r['scene']} {r['it_per_s']:.2f} ({r['it_per_s'] / static:.2f}"
            "x)" for r in dyn
            if r["name"] == "backward" and r["scene"].startswith("dyn_")
            and not r["scene"].startswith("dyn_bars")))
    records += dyn
    records += run("11 the editor side", phase_editor)
    records += run("12 the XLA routes", phase_routes)
    records += run("13 real captures and the mesh renderers", phase_capture)
    dist = run("14 multi-process training and tile-sharded rendering",
               phase_dist)
    one = next(r for r in dist if r["scene"].startswith("dist_1x1")
               and "it_per_s" in r)
    log("phase 14(a) it/s against the static train cell (5(b), "
        f"{static:.2f} it/s): " + ", ".join(
            f"{k} {v:.2f} ({v / static:.2f}x)"
            for k, v in one["dist"]["its"].items()))
    records += dist
    drop_bricks()
    log(f"all phases ok in {time.perf_counter() - t_all:.2f} s")
    print(json.dumps({"kernels": records}))
    print(ident["smi"] or f"{ident['kind']}, power limit not readable")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": ident["kind"], "count": ident["count"]}}),
        flush=True)
    return 0


if __name__ == "__main__":
    # phase 12's module imports this one by name: one module, not two
    sys.modules.setdefault("chip_smoke", sys.modules[__name__])
    sys.exit(main())
