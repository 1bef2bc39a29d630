"""Phase 13 of ``chip_smoke.py``: real captures and the mesh renderers, on
the card. ``python3 chip_smoke.py`` runs it after phase 12
(``chip_smoke.phase_capture``); it shares that script's harness
(``bricks``, ``_app_run``, ``trainer_records``, ``kernel_records``).
``python3 chip_smoke_capture.py`` runs it alone (``main``).

(a) A JPEG COLMAP capture, trained. Phase 7's ``tpu_bricks`` (800x800,
24 + 8 views) is loaded from its PNGs (timed: the PNG load) and written
as a COLMAP capture: ``cameras.bin`` (one PINHOLE camera), ``images.bin``
(each view's pose as a quaternion), ``points3D.bin`` (the train app's own
random init for a capture without points: the same seed, positions and
colours, the colours rounded to 8 bits), the images as JPEG from
``viewer/jpeg.encode_jpeg`` at quality 90 (the views are composited on
white), named so that the loader's holdout holds out phase 7's test views
and trains on its train views in their order (``capture_order``). It is
loaded through the host library's parsers and the port's JPEG decoder
(timed: the JPEG load). Every loaded camera must equal its source camera
(the viewmat within 1e-6 of its largest value, the intrinsics within a
relative 1e-6, the size equal). Every view's quantised coefficients
(``gsio/jpeg.decode_coefficients``) must equal ``quantized_blocks`` of its
source bitwise, and its PSNR against the source is printed. ``apps.train
--source_path`` trains it with phase 7's steps, evals and alpha resets
(phase 7 runs first if it has not); the loss must fall, the last eval's
PSNR be above the first, and each eval's PSNR within the scale's bar
(0.5 dB at full size) of phase 7's at the same step: the same views,
init and schedule, with the ground truth and the init's colours changed
only by quality-90 JPEG and 8-bit rounding (at the rehearsal's 32x32 a
view's JPEG is ~22 dB from its source, and the bar 1 dB); the three kernels are held against their
plain versions on the trained state.

(b) The host library: built by ``g++`` first (its seconds printed; phase
13 fails if it did not build), ``pack_ply_records`` on a 1M-splat random
model and ``parse_points3d_bin`` / ``parse_images_bin`` on (a)'s COLMAP
binaries, each timed with the library and on the numpy / pure-Python
path (``median_ms``), the results bitwise equal.

(c) The mesh passes over the trained model ``runs/tpu_bricks_mcmc``: phase
10(c)'s mesh (extracted here when phase 13 runs alone), at 1920x1080
from a camera that frames the mesh (``mesh_camera``):
``rasterize_mesh``, ``shade_gbuffer_lights`` (a point, a spot and a
directional light), ``path_trace_mesh`` with 2 samples,
``render_hybrid_pt`` with the model's splats rendered through the kernel
route (``render`` and ``render_depth``: expand and forward each launched;
their records hold both against their plain versions on that frame),
``restir_direct`` with its shadow rays, ``ssgi`` and
``deferred_shade_gi``, each timed (``median_ms``). Every
output must be finite, and the G-buffer on the card must equal the same
torch code on the CPU at 160x90 (triangle ids equal but at depth ties,
counted; floats within 1e-5 of the largest value).
"""

from __future__ import annotations

import json
import math
import os
import sys
import tempfile
import time

import numpy as np
import torch

import chip_smoke as CS
from divshot_tpu_torch import _build
from divshot_tpu_torch.apps import export as export_app
from divshot_tpu_torch.apps.render import orbit_for_model
from divshot_tpu_torch.core import native
from divshot_tpu_torch.gsio import colmap as COL
from divshot_tpu_torch.gsio.datasets import load_dataset
from divshot_tpu_torch.gsio.jpeg import decode_coefficients, read_jpeg
from divshot_tpu_torch.gsio.ply import pack_records_numpy
from divshot_tpu_torch.gsio.synthetic import random_scene
from divshot_tpu_torch.models.background import init_envmap
from divshot_tpu_torch.raster import gi as GI
from divshot_tpu_torch.raster import mesh_raster as MR
from divshot_tpu_torch.raster import path_trace as PT
from divshot_tpu_torch.raster.render import render, render_fast
from divshot_tpu_torch.scene.components import Light, LightType
from divshot_tpu_torch.splat.camera import Camera
from divshot_tpu_torch.viewer.jpeg import encode_jpeg, quantized_blocks
from divshot_tpu_torch.viewer.mesh import render_depth

QUALITY = 90
TIMED_CALLS = 3
_POINT = np.dtype([("id", "<u8"), ("xyz", "<f8", 3), ("rgb", "u1", 3),
                   ("err", "<f8"), ("track_len", "<u8")])


def _qvec(R: np.ndarray) -> np.ndarray:
    """COLMAP's ``rotmat2qvec``: the unit quaternion (w, x, y, z) of a
    rotation matrix, w >= 0."""
    Rxx, Ryx, Rzx, Rxy, Ryy, Rzy, Rxz, Ryz, Rzz = np.asarray(
        R, np.float64).flat
    K = np.array([[Rxx - Ryy - Rzz, 0, 0, 0],
                  [Ryx + Rxy, Ryy - Rxx - Rzz, 0, 0],
                  [Rzx + Rxz, Rzy + Ryz, Rzz - Rxx - Ryy, 0],
                  [Ryz - Rzy, Rzx - Rxz, Rxy - Ryx, Rxx + Ryy + Rzz]]) / 3.0
    vals, vecs = np.linalg.eigh(K)
    q = vecs[[3, 0, 1, 2], np.argmax(vals)]
    return -q if q[0] < 0 else q


def median_ms(fn, device):
    """-> (fn(), the median milliseconds of ``TIMED_CALLS`` calls after a
    warm one, each on the host clock with the card synced before and
    after)."""
    out, _ = CS.timed(fn, device)
    ms = []
    for _ in range(TIMED_CALLS):
        out, t = CS.timed(fn, device)
        ms.append(t)
    return out, float(np.median(ms))


def capture_order(n_train: int, n_test: int) -> tuple[list[int], int]:
    """-> (the source views, train views then test views, in the capture's
    name order; the eval holdout) such that the loader's holdout (every
    holdout-th name from the first) holds out exactly the test views and
    leaves the train views in their order."""
    n = n_train + n_test
    holdout = math.ceil(n / n_test)
    if len(range(0, n, holdout)) != n_test:
        raise ValueError(f"no holdout takes {n_test} of {n} views")
    test, train = iter(range(n_train, n)), iter(range(n_train))
    return [next(test) if p % holdout == 0 else next(train)
            for p in range(n)], holdout


def same_cameras(got, want, what: str) -> float:
    """Loaded cameras against their sources -> the largest viewmat
    difference over the largest value; raises past 1e-6."""
    if len(got) != len(want):
        raise AssertionError(f"(a) {what}: {len(got)} cameras, not "
                             f"{len(want)}")
    worst = 0.0
    for i, (a, b) in enumerate(zip(got, want)):
        d = float(np.abs(a.viewmat - b.viewmat).max()) / max(
            1.0, float(np.abs(b.viewmat).max()))
        worst = max(worst, d)
        if (d > 1e-6 or (a.width, a.height) != (b.width, b.height)
                or any(abs(x - y) > 1e-6 * abs(y) for x, y in (
                    (a.fx, b.fx), (a.fy, b.fy), (a.cx, b.cx),
                    (a.cy, b.cy)))):
            raise AssertionError(f"(a) {what} camera {i} differs from its "
                                 f"source: {a} against {b}")
    return worst


def write_capture(root: str, cams, imgs, n_points: int, seed: int = 0
                  ) -> float:
    """The views (cameras, (H, W, 3) uint8 images on the card) as a COLMAP
    capture with JPEG images, named in their order -> the seconds the JPEG
    encoding took. The points are ``apps.train``'s random init with
    ``--seed`` ``seed``."""
    sparse = os.path.join(root, "sparse", "0")
    os.makedirs(sparse)
    os.makedirs(os.path.join(root, "images"))
    c0 = cams[0]
    COL.write_cameras_bin(os.path.join(sparse, "cameras.bin"), {
        1: COL.ColmapCamera("PINHOLE", c0.width, c0.height, np.array(
            [c0.fx, c0.fy, c0.cx, c0.cy]))})
    images, enc_s = {}, 0.0
    for i, (cam, img) in enumerate(zip(cams, imgs)):
        name = f"view_{i:03d}.jpg"
        images[i + 1] = COL.ColmapImage(name, 1, _qvec(cam.viewmat[:3, :3]),
                                        cam.viewmat[:3, 3].astype(np.float64))
        t0 = time.perf_counter()
        data = encode_jpeg(img, QUALITY)
        enc_s += time.perf_counter() - t0
        with open(os.path.join(root, "images", name), "wb") as f:
            f.write(data)
    COL.write_images_bin(os.path.join(sparse, "images.bin"), images)
    # the train app's own random init, as the capture's SfM cloud
    rng = np.random.default_rng(seed)
    pts = np.zeros(n_points, _POINT)
    pts["id"] = np.arange(n_points)
    pts["xyz"] = rng.uniform(-1.3, 1.3, (n_points, 3)).astype(np.float32)
    pts["rgb"] = np.rint(rng.uniform(0, 1, (n_points, 3)) * 255)
    with open(os.path.join(sparse, "points3D.bin"), "wb") as f:
        f.write(np.uint64(n_points).tobytes() + pts.tobytes())
    return enc_s


def capture_train(device, scale, tmp: str) -> tuple[list[dict], str]:
    """(a) -> (kernel records, the capture's directory)."""
    key = (device.type, scale.data_res, scale.data_views)
    if key not in CS.PNG_CURVE:
        CS.log("  (a) phase 7 has not run: running it for its PNG curve")
        CS.phase_dataset(device, scale)
    png_curve = CS.PNG_CURVE[key]
    data, _ = CS.bricks(device, scale)
    t0 = time.perf_counter()
    train_ds, eval_ds = load_dataset(data, device=device,
                                     white_background=True)
    CS.sync(device)
    png_s = time.perf_counter() - t0
    order, holdout = capture_order(*scale.data_views)
    views = [(c, im) for ds in (train_ds, eval_ds)
             for c, im in zip(ds.cameras, ds.images)]
    cams = [views[i][0] for i in order]
    imgs = [views[i][1] for i in order]
    src = os.path.join(tmp, "capture")
    enc_s = write_capture(src, cams, imgs, min(100_000,
                                               scale.data_capacity))
    t0 = time.perf_counter()
    cap_train, cap_eval = load_dataset(src, device=device,
                                       white_background=True,
                                       eval_holdout=holdout)
    CS.sync(device)
    jpeg_s = time.perf_counter() - t0
    n = len(cams)
    res = cams[0].width
    if cap_train.num_views + cap_eval.num_views != n or \
            tuple(cap_train.images.shape[1:]) != (res, res, 3):
        raise AssertionError("(a) the JPEG capture's views")
    pose_err = max(same_cameras(cap_train.cameras, train_ds.cameras,
                                "train"),
                   same_cameras(cap_eval.cameras, eval_ds.cameras, "eval"))
    del train_ds, eval_ds, cap_train, cap_eval
    nblocks, psnrs = 0, []
    t0 = time.perf_counter()
    for i, img in enumerate(imgs):
        path = os.path.join(src, "images", f"view_{i:03d}.jpg")
        got = decode_coefficients(path)
        want = quantized_blocks(img, QUALITY)
        if got.shape != want.shape or not np.array_equal(got, want):
            raise AssertionError(f"(a) view {i}: the decoded coefficients "
                                 f"differ from the encoder's blocks")
        nblocks += len(got)
        psnrs.append(CS._psnr(torch.from_numpy(read_jpeg(path)).to(
            img.device) / 255.0, img / 255.0))
    check_s = time.perf_counter() - t0
    n_eval = len(range(0, n, holdout))
    CS.log(f"  (a) tpu_bricks at {res}x{res} as a COLMAP capture of {n} "
           f"JPEG views (quality {QUALITY}): encoded in {enc_s:.2f} s; PNG "
           f"load {png_s:.2f} s (phase 7's files), JPEG capture load "
           f"{jpeg_s:.2f} s (the host library's parsers and decoder, "
           f"{n - n_eval} train + {n_eval} held out, phase 7's split); "
           f"cameras equal to the source's (viewmat within {pose_err:.2e} "
           f"of its largest value); {nblocks} quantised blocks bitwise "
           f"equal to the encoder's, PSNR against the source "
           f"{min(psnrs):.2f}-{max(psnrs):.2f} dB (checked in "
           f"{check_s:.2f} s)")
    steps, bar = scale.data_iters, scale.capture[6]
    eval_every, _, reset_every = scale.data_every
    model = os.path.join(tmp, "model")
    argv = ["--source_path", src, "--model_path", model, "--device",
            device.type, "--white_background", "1", "--cap_max",
            str(scale.data_capacity), "--iterations", str(steps),
            "--eval_every", str(eval_every), "--reset_alpha_every",
            str(reset_every), "--eval_holdout", str(holdout),
            "--checkpoint_every", str(10 * steps)]
    tr, launches, out = CS._app_run(argv, device,
                                    "(a) apps.train on the JPEG capture",
                                    steps)
    losses = [float(ln.split("loss=")[1].split()[0])
              for ln in out.splitlines() if " loss=" in ln]
    with open(os.path.join(model, "eval_curve.json")) as f:
        curve = {e["step"]: e["psnr"] for e in json.load(f)}
    psnr = list(curve.values())
    if not (len(losses) >= 4 and np.mean(losses[-3:]) < losses[0]):
        raise AssertionError(f"(a) the loss did not fall: {losses}")
    if not (len(psnr) >= 2 and all(map(math.isfinite, psnr))
            and psnr[-1] > psnr[0]):
        raise AssertionError(f"(a) eval PSNR {curve}")
    if set(curve) != set(png_curve):
        raise AssertionError(f"(a) eval steps {sorted(curve)}, phase 7's "
                             f"{sorted(png_curve)}")
    gap = max(abs(curve[k] - png_curve[k]) for k in curve)
    CS.log(f"  (a) eval PSNR by step, JPEG capture / phase 7's PNGs: "
           + ", ".join(f"{k}: {curve[k]:.3f} / {png_curve[k]:.3f}"
                       for k in sorted(curve))
           + f"; largest gap {gap:.3f} dB (bar {bar})")
    if gap > bar:
        raise AssertionError(f"(a) the JPEG capture's eval PSNR is "
                             f"{gap:.3f} dB from phase 7's")
    its = [float(ln.split("(")[1].split()[0]) for ln in out.splitlines()
           if ln.startswith("trained ")][0]
    CS.log(f"  (a) trained {steps} steps at {its:.2f} it/s: loss "
           f"{losses[0]:.4f} -> {losses[-1]:.4f}")
    recs = CS.trainer_records(f"jpeg_capture_{res}", tr, device, scale,
                              launches, steps)
    for r in recs:
        r.update(it_per_s=its, eval_psnr=psnr[-1], png_eval_psnr=png_curve[
            max(png_curve)], psnr_gap=gap, png_load_s=png_s,
                 jpeg_load_s=jpeg_s, jpeg_psnr_min=min(psnrs),
                 pose_err=pose_err)
    return recs, src


def build_host_library() -> tuple[str, float]:
    """The host library built by ``g++`` before anything times its use ->
    (its file name, the seconds the build took, 0 when already built)."""
    so, build_s = _build.build_native()
    if native.get_lib() is None:
        raise AssertionError(f"the host library did not build: "
                             f"{native.BUILD_ERROR}")
    return so.name, build_s


def host_library(scale, src: str, so: str, build_s: float) -> dict:
    """(b) The host library's entries against the numpy and pure-Python
    paths (``median_ms``)."""
    n = scale.capture[5]
    cpu = torch.device("cpu")

    def _ms(fn):
        return median_ms(fn, cpu)

    params = random_scene(np.random.default_rng(0), n, sh_degree=3,
                          device="cpu")
    d = params.compact_numpy()
    lib_rec, lib_ms = _ms(lambda: native.pack_ply_records(
        d["means"], d["sh0"], d["shN"], d["opacity"], d["scales"],
        d["quats"]))
    np_rec, np_ms = _ms(lambda: pack_records_numpy(d))
    if lib_rec.tobytes() != np_rec.tobytes():
        raise AssertionError("(b) pack_ply_records differs from numpy")
    sparse = os.path.join(src, "sparse", "0")
    pts = os.path.join(sparse, "points3D.bin")
    (lp, lc), lib_pts_ms = _ms(lambda: COL.read_points3d_bin(pts))
    (pp, pc), py_pts_ms = _ms(lambda: COL.read_points3d_bin_py(pts))
    if lp.tobytes() != pp.tobytes() or lc.tobytes() != pc.tobytes():
        raise AssertionError("(b) parse_points3d_bin differs from Python")
    ims = os.path.join(sparse, "images.bin")
    li, lib_im_ms = _ms(lambda: COL.read_images_bin(ims))
    pi, py_im_ms = _ms(lambda: COL.read_images_bin_py(ims))
    if list(li) != list(pi) or any(
            li[k].name != pi[k].name or li[k].qvec.tobytes()
            != pi[k].qvec.tobytes() or li[k].tvec.tobytes()
            != pi[k].tvec.tobytes() for k in li):
        raise AssertionError("(b) parse_images_bin differs from Python")
    out = dict(native_build_s=build_s, pack_lib_ms=lib_ms,
               pack_numpy_ms=np_ms, points_lib_ms=lib_pts_ms,
               points_py_ms=py_pts_ms, images_lib_ms=lib_im_ms,
               images_py_ms=py_im_ms)
    CS.log(f"  (b) host library {so} built by g++ in {build_s:.2f} s "
           f"(0 = already built); pack_ply_records on {n} splats "
           f"{lib_ms:.1f} ms (numpy {np_ms:.1f} ms); parse_points3d_bin on "
           f"{len(lp)} points {lib_pts_ms:.1f} ms (Python "
           f"{py_pts_ms:.1f} ms); parse_images_bin on {len(li)} images "
           f"{lib_im_ms:.2f} ms (Python {py_im_ms:.2f} ms); all bitwise "
           f"equal")
    return out


def _mesh(device, scale, params) -> tuple[np.ndarray, np.ndarray, str]:
    """Phase 10(c)'s mesh, or the same extraction when phase 13 runs
    alone; the tiny rehearsal's sparse model may leave no surface, and a
    sphere around the model stands in there."""
    if "verts" not in CS.MESH:
        _, views, mesh_res, _ = scale.export
        with tempfile.TemporaryDirectory() as tmp:
            src = str(CS.MODEL)
            if scale.model_stride > 1:
                src = f"{tmp}/model.ply"
                CS.save_model(src, params)
            rc = export_app.main(["--input", src, "--output",
                                  f"{tmp}/mesh.obj", "--views", str(views),
                                  "--mesh_resolution", str(mesh_res),
                                  "--device", device.type])
            if rc != 0:
                raise AssertionError("(c) apps.export --output mesh.obj")
            verts, faces = CS.read_obj_mesh(f"{tmp}/mesh.obj")
        CS.MESH.update(verts=verts, faces=faces)
    verts, faces = CS.MESH["verts"], CS.MESH["faces"]
    if len(faces):
        return verts, faces, "phase 10(c)'s mesh"
    if device.type == "cuda":
        raise AssertionError("(c) the extracted mesh is empty")
    d = params.compact_numpy()
    c = d["means"].mean(0)
    r = float(np.abs(d["means"] - c).max()) * 0.5
    th, ph = np.meshgrid(np.linspace(0, np.pi, 9), np.linspace(
        0, 2 * np.pi, 17), indexing="ij")
    v = np.stack([np.sin(th) * np.cos(ph), np.cos(th),
                  np.sin(th) * np.sin(ph)], -1).reshape(-1, 3) * r + c
    i = np.arange(8)[:, None] * 17 + np.arange(16)[None, :]
    f = np.concatenate([np.stack([i, i + 17, i + 1], -1).reshape(-1, 3),
                        np.stack([i + 1, i + 17, i + 18], -1).reshape(-1, 3)])
    return v.astype(np.float32), f.astype(np.int32), "a stand-in sphere"


def _finite(x: torch.Tensor, what: str) -> None:
    if not torch.isfinite(x).all():
        raise AssertionError(f"(c) {what}: non-finite values")


def _lights(cam: Camera, centre: np.ndarray) -> list[Light]:
    eye = cam.campos.cpu().numpy()
    to_c = centre - eye
    return [Light(type=LightType.POINT, position=tuple(eye * 0.8 + centre
                                                       * 0.2),
                  intensity=3.0, range=20.0),
            Light(type=LightType.SPOT, position=tuple(eye),
                  direction=tuple(to_c), intensity=8.0, range=20.0,
                  inner_angle=0.15, outer_angle=0.3),
            Light(type=LightType.DIRECTIONAL, direction=(0.3, 1.0, 0.2),
                  intensity=0.8)]


def mesh_camera(params, verts: np.ndarray, width: int, height: int
                ) -> Camera:
    """The camera that frames the mesh: from the direction of the model's
    first orbit view (phase 10(c)'s), aimed at the mesh's box centre, at
    the distance where the box's half-diagonal fills 0.8 of the vertical
    field of 50 degrees."""
    orbit = orbit_for_model(params, 1, radius=4.0, width=width,
                            height=height, fov=50.0)[0]
    lo, hi = verts.min(0), verts.max(0)
    centre = 0.5 * (lo + hi)
    half = 0.5 * float(np.linalg.norm(hi - lo))
    away = orbit.campos.cpu().numpy() - centre
    dist = half / (0.8 * math.tan(math.radians(25.0)))
    eye = centre + away / max(float(np.linalg.norm(away)), 1e-9) * dist
    return Camera.look_at(eye, centre, [0, -1, 0], 50.0, width, height,
                          device=orbit.device)


def gbuffer_card_vs_cpu(verts, faces, cam: Camera, device) -> int:
    """The G-buffer on the card against the same code on the CPU: ids
    equal but at depth ties (returned), floats within 1e-5 of the
    largest value."""
    cpu = Camera(cam.viewmat, cam.fx, cam.fy, cam.cx, cam.cy, cam.width,
                 cam.height, device="cpu")
    a = MR.rasterize_mesh(verts, faces, cam)
    b = MR.rasterize_mesh(verts, faces, cpu)
    da, db = a.depth.cpu().numpy(), b.depth.numpy()
    hit = np.isfinite(db)
    if not np.array_equal(hit, np.isfinite(da)) or not hit.any():
        raise AssertionError("(c) G-buffer coverage differs on the card")
    scale = max(float(np.abs(db[hit]).max()), 1.0)
    ties = a.tri_id.cpu().numpy() != b.tri_id.numpy()
    dd = float(np.abs(da[hit] - db[hit]).max())
    if dd > 1e-5 * scale or ties.sum() > max(1, 1e-3 * hit.sum()):
        raise AssertionError(f"(c) G-buffer on the card: depth {dd}, "
                             f"{ties.sum()} ids differ")
    same = hit & ~ties
    for f in ("normal", "albedo"):
        x, y = getattr(a, f).cpu().numpy(), getattr(b, f).numpy()
        if np.abs(x - y)[same].max() > 1e-5 * max(float(np.abs(y).max()),
                                                  1.0):
            raise AssertionError(f"(c) G-buffer {f} on the card")
    return int(ties.sum())


def mesh_passes(device, scale) -> list[dict]:
    """(c) -> the hybrid frame's kernel records."""
    width, height, samples, sw, sh = scale.capture[:5]
    params = CS._load(CS.MODEL, device, scale)
    verts, faces, what = _mesh(device, scale, params)
    cam = mesh_camera(params, verts, width, height)
    centre = 0.5 * (verts.min(0) + verts.max(0))
    lights = _lights(cam, centre)
    gen = torch.Generator(device=device).manual_seed(0)
    env = init_envmap(16, 32, init_color=(0.8, 0.85, 0.95), device=device)
    bg = torch.zeros((3,), device=device)
    demand = int(render_fast(params, cam, background=bg,
                             instance_capacity=scale.probe_capacity
                             )[2].num_instances)
    cap = CS.auto_icap(demand)
    ms = {}
    gb, ms["rasterize_mesh"] = median_ms(
        lambda: MR.rasterize_mesh(verts, faces, cam), device)
    hit = int(torch.isfinite(gb.depth).sum())
    lit, ms["shade_gbuffer_lights"] = median_ms(
        lambda: MR.shade_gbuffer_lights(gb, cam, lights), device)
    pt, ms["path_trace_mesh"] = median_ms(
        lambda: PT.path_trace_mesh(verts, faces, cam, env, gen,
                                   n_samples=samples), device)

    def hybrid():
        out = render(params, cam, background=bg, instance_capacity=cap)
        depth, _ = render_depth(params, cam, background=bg,
                                instance_capacity=cap)
        return PT.render_hybrid_pt(out, verts, faces, cam, env, gen,
                                   splat_depth=depth, n_samples=samples)

    (img, hpt), launches = CS.count_launches(
        hybrid, device, None, "(c) hybrid frame", only_steps=False,
        kernels=CS.VIEWER_KERNELS)
    if device.type == "cuda" and launches["forward"] < 1:
        raise AssertionError("(c) the hybrid frame launched no forward")
    _, ms["hybrid_frame"] = median_ms(hybrid, device)
    soa = GI.lights_to_soa(lights, device)
    (direct, _), ms["restir_direct"] = median_ms(
        lambda: GI.restir_direct(gb, cam, soa, gen,
                                 occluders=(verts, faces)), device)
    (ao, ind), ms["ssgi"] = median_ms(lambda: GI.ssgi(gb, cam, lit, gen),
                                      device)
    (gi_img, _), ms["deferred_shade_gi"] = median_ms(
        lambda: GI.deferred_shade_gi(gb, cam, lights, gen,
                                     occluders=(verts, faces)), device)
    for x, name in ((gb.normal, "normal"), (gb.albedo, "albedo"),
                    (lit, "shade_gbuffer_lights"), (pt.image,
                                                    "path_trace_mesh"),
                    (img, "hybrid frame"), (direct, "restir_direct"),
                    (ao, "ssgi ao"), (ind, "ssgi indirect"),
                    (gi_img, "deferred_shade_gi")):
        _finite(x, name)
    if not hit or float(img.max()) <= 0:
        raise AssertionError("(c) the mesh frame is empty")
    small = mesh_camera(params, verts, sw, sh)
    ties = gbuffer_card_vs_cpu(verts, faces, small, device)
    CS.log(f"  (c) {what}: {len(verts)} vertices, {len(faces)} faces, at "
           f"{width}x{height} ({hit} pixels hit; {samples} path-traced "
           f"samples; splats {params.num_alive}, capacity {cap}); ms, the "
           f"median of {TIMED_CALLS} calls after a warm one: " + ", ".join(f"{k} {v:.1f}"
                                            for k, v in ms.items())
           + f"; the hybrid frame's launches {launches}; G-buffer at "
           f"{sw}x{sh} on the {device.type} against the CPU: ids equal but "
           f"{ties} depth ties, floats within 1e-5 of the largest")
    fr = CS.make_frame(params, cam, cap)
    recs = CS.kernel_records(f"hybrid_{CS.MODEL.parent.name}", fr, device,
                             scale, launches)
    for r in recs:
        r.update(mesh_ms=ms, mesh_faces=len(faces), gbuffer_ties=ties)
    return recs


def phase_capture(device: torch.device, scale) -> list[dict]:
    """Phase 13: (a) the JPEG COLMAP capture trained, (b) the host library,
    (c) the mesh passes."""
    so, build_s = build_host_library()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        records, src = capture_train(device, scale, tmp)
        CS.log(f"  (a) done in {time.perf_counter() - t0:.2f} s")
        t0 = time.perf_counter()
        lib = host_library(scale, src, so, build_s)
        CS.log(f"  (b) done in {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    records += mesh_passes(device, scale)
    CS.log(f"  (c) done in {time.perf_counter() - t0:.2f} s")
    for r in records:
        r.update(host_library=lib)
    return records


def main() -> int:
    """Phase 13 alone on the card: the card's identity, the kernels'
    build, then phase 13 at ``chip_smoke.FULL`` (phase 7, whose PNG curve
    (a) is held against, and phase 10(c)'s mesh extraction run within)."""
    device = torch.device("cuda")
    t_all = time.perf_counter()
    for label, fn in (("1 card identity", CS.phase_identity),
                      ("2 build kernels", CS.phase_build),
                      ("13 real captures and the mesh renderers",
                       phase_capture)):
        t0 = time.perf_counter()
        CS.log(f"phase {label} ...")
        fn(device, CS.FULL)
        CS.log(f"phase {label} ok in {time.perf_counter() - t0:.2f} s")
    CS.drop_bricks()
    CS.log(f"all phases ok in {time.perf_counter() - t_all:.2f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
