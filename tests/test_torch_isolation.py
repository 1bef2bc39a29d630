"""The port stands alone: with JAX, flax, PIL, imageio, OpenCV (``cv2``)
and ``divshot_tpu`` blocked, every module of ``divshot_tpu_torch`` imports
(``dist/`` with no process group started),
a JPEG, a Radiance file and a 32x32 mesh G-buffer are read and made, and
``chip_smoke.py``'s kernel (with the backward kernels' unit split),
viewer-path, training-path, 2DGS training-path, dataset-path,
trainer-options, live-session, dynamic-models-and-export and editor
phases and the XLA routes' phase run on the CPU at a tiny scale, with a
``kernels`` record for every kernel. Also checks on the port's
files: no JAX, flax, PIL, imageio, cv2 or ``divshot_tpu`` import outside
docstrings, no file over 200 KB, and the kernel build directory ignored by
git."""

import ast
import os
import re
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "divshot_tpu_torch"
BLOCKED = ("jax", "jaxlib", "flax", "PIL", "imageio", "cv2", "divshot_tpu")

_BLOCKED_RUN = r"""
import contextlib, importlib, io, pkgutil, sys
for m in %r:
    sys.modules[m] = None
import torch
torch.set_num_threads(1)
import divshot_tpu_torch
names = [m.name for m in pkgutil.walk_packages(divshot_tpu_torch.__path__,
                                               "divshot_tpu_torch.")]
for name in names:
    importlib.import_module(name)
# the dist modules are walked too, and importing them starts no process
# group
assert {"divshot_tpu_torch.dist." + m for m in (
    "mesh", "overlap", "tiles", "multihost")} <= set(names), names
assert not torch.distributed.is_initialized()
import os, tempfile
import numpy as np
from divshot_tpu_torch.gsio.hdr import read_hdr
from divshot_tpu_torch.gsio.image import read_image
from divshot_tpu_torch.raster.mesh_raster import rasterize_mesh
from divshot_tpu_torch.splat.camera import Camera
from divshot_tpu_torch.viewer.jpeg import encode_jpeg
with tempfile.TemporaryDirectory() as tmp:
    img = np.arange(40 * 24 * 3, dtype=np.uint8).reshape(24, 40, 3)
    with open(os.path.join(tmp, "a.jpg"), "wb") as f:
        f.write(encode_jpeg(img, 90))
    assert read_image(os.path.join(tmp, "a.jpg")).shape == (24, 40, 3)
    with open(os.path.join(tmp, "a.hdr"), "wb") as f:
        f.write(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n-Y 1 +X 2\n"
                + bytes([200, 100, 50, 126, 128, 64, 32, 136]))
    assert read_hdr(os.path.join(tmp, "a.hdr")).tolist() == [
        [[50, 25, 12], [255, 255, 255]]]
cam = Camera.look_at((0, 0, -3.0), (0, 0, 0), (0, -1, 0), 50.0, 32, 32,
                     device="cpu")
gb = rasterize_mesh(np.array([[-1, -1, 0], [1, -1, 0], [0, 1, 0]],
                             np.float32), np.array([[0, 1, 2]]), cam)
assert (gb.tri_id == 0).sum() > 50
import chip_smoke
buf = io.StringIO()
with contextlib.redirect_stdout(buf):
    dev = torch.device("cpu")
    checks = chip_smoke.phase_kernels_vs_plain(dev, chip_smoke.TINY)
    records = chip_smoke.phase_main_path(dev, chip_smoke.TINY)
    train = chip_smoke.phase_training(dev, chip_smoke.TINY)
    train2d = chip_smoke.phase_training_2dgs(dev, chip_smoke.TINY)
    data = chip_smoke.phase_dataset(dev, chip_smoke.TINY)
    opts = chip_smoke.phase_options(dev, chip_smoke.TINY)
    live = chip_smoke.phase_session(dev, chip_smoke.TINY)
    chip_smoke.drop_bricks()
    dyn = chip_smoke.phase_dynamic_export(dev, chip_smoke.TINY)
    ed = chip_smoke.phase_editor(dev, chip_smoke.TINY)
    routes = chip_smoke.phase_routes(dev, chip_smoke.TINY)
out = buf.getvalue()
assert '"ok"' not in out, out
assert all(v == 0.0 for v in checks.values()), checks
assert len(checks) == 13, checks
for route in ("forward", "surfel_forward"):
    assert f"{route} unit split: bitwise equal to plain" in out
assert "expand on adversarial inputs at 1920x1080" in out
assert ("unit split frame: tile 1 units at [1366, 4096, 8192, 12288, 16384]"
        in out)
assert [(r["scene"], r["name"]) for r in records] == [
    (s, k) for s in ("tpu_bricks_mcmc", "random_1500")
    for k in ("expand", "forward")]
TRAIN_K = ("expand", "forward", "backward", "segment_rows")
SURFEL_K = ("expand", "surfel_forward", "surfel_backward", "segment_rows")
assert [(r["scene"], r["name"]) for r in train] == [
    (s, k) for s in ("bars_adc+_64", "bars_mcmc_64", "train_500_64")
    for k in TRAIN_K] + [
    (s, k) for s in ("random_1500", "tpu_bricks_mcmc")
    for k in ("backward", "segment_rows")]
keys = {"name", "route", "source", "replaces", "launches", "max_abs_err",
        "ms", "plain_ms", "bound_ms", "bound_by", "library_ms"}
assert [(r["scene"], r["name"]) for r in train2d] == [
    (s, k) for s in ("bars_2dgs_48", "train2d_500_64", "tpu_bricks_2dgs2")
    for k in SURFEL_K]
for r, (name, line) in zip(train2d[1:3], (("forward", 126), ("backward",
                                                              202))):
    assert r["source"] == f"divshot_tpu_torch/csrc/surfel_{name}.cu"
    assert r["replaces"] == f"divshot_tpu/raster/pallas_surfel.py:{line}"
assert all(r["nch"] == 5 for r in train2d if r["name"] == "surfel_backward")
assert "it_per_s" in train2d[4] and "(b) train2d bench" in out
assert "surfel nch 3" in out and "surfel nch 5" in out
assert [(r["scene"], r["name"]) for r in data] == [
    ("tpu_bricks_data_32", k) for k in TRAIN_K]
assert "resumed from iteration_8" in out
assert "checkpoint bitwise equal to the state saved, PLY render bitwise" in out
assert all(r["it_per_s"] > 0 and r["eval_views_per_s"] > 0 for r in data)
assert [(r["scene"], r["name"]) for r in opts] == [
    (f"opt_{s}", k) for s in ("x1_64", "batch4_64", "bg_mask_64", "x4_16",
                              "x2_32", "pack1_64", "stream_64")
    for k in TRAIN_K] + [
    ("opt2d_b2_bg_mask_64", k) for k in SURFEL_K] + [
    ("opt_app_bricks_32", k) for k in TRAIN_K]
assert all(r["it_per_s"] > 0 for r in opts)
assert opts[4]["views_per_s"] == 4 * opts[4]["it_per_s"]
assert opts[24]["copy_ms_per_view"] > 0
assert "every step's ground truth bitwise the device-resident one" in out
assert "views/s at batch 4" in out
assert "(c) scales: step 6 x1, step 11 x1 (schedule 3)" in out
assert "resumed from iteration_6" in out
assert "checkpoint bitwise, PLY float32 equal to the bf16 shN" in out
assert ("(d) a NaN mean after step 1 raised, as expected" in out
        and "at the projection stage" in out)
assert [(r["scene"], r["name"]) for r in live] == [
    ("session_32", k) for k in TRAIN_K] + [
    ("session_2dgs_32", k) for k in SURFEL_K]
assert all(r["it_per_s"] > 0 and r["snapshot_ms"] > 0 and r["lpips_ms"] > 0
           and r["demand"] > 0 and r["instance_capacity"] == 1 << 20
           for r in live[:4])
for label in ("3dgs", "2dgs", "streamed"):
    assert (f"(b) {label}: the pause held 0.5 s, pos_lr_init kept the "
            f"steps, ssim_weight 0 rebuilt them") in out
assert "payloads equal to splat_bytes of their snapshot" in out
assert "apps.viewer: training done at iteration 2" in out
assert "the saved PLY bitwise the snapshot and rendered bitwise" in out
assert "bare PNGs without COLMAP ended in Loading_Failed" in out
assert "(d) LPIPS at 32x32" in out and "evaluate over 2 views: lpips" in out
assert [(r["scene"], r["name"]) for r in dyn] == [
    (s, k) for s in ("dyn_bars_deform_32", "dyn_bars_hexplane_32",
                     "dyn_deform_32", "dyn_hexplane_32")
    for k in TRAIN_K] + [
    ("mesh_depth_tpu_bricks_mcmc", k) for k in ("expand", "forward")]
assert all(r["it_per_s"] > 0 for r in dyn[:16])
assert "(a) deform: 3 steps at 32x32" in out and "(a) hexplane" in out
assert out.count("checkpoint bitwise equal to the state saved; launches") == 2
assert "(b) dynamic it/s at 32x32: deform" in out
exp = dyn[-1]["export"]
assert all(exp[e]["psnr"] > 30 and exp[e]["bytes"] > 0 for e in (
    ".compressed.ply", ".reduced.ply", ".splat", ".spz", ".dvsplat"))
assert exp["kmeans_update_rel"] == 0.0 and exp["kmeans_id_ties"] == 0
assert exp["kmeans_end_to_end_rel"] == 0.0
assert exp["kmeans_end_to_end_ids"] == 0
assert "(c) mesh: 2 views at 512, resolution 12" in out
assert [r["name"] for r in ed] == ["expand", "forward"]
assert all(r["scene"].startswith("editor_tint_") for r in ed)
assert all(r["op_ms"]["merge"] > 0 and r["apps"]["jpeg_ms_per_frame"] > 0
           and set(r["dense_ms"]) == {"RINGS", "ELLIPSOIDS", "CENTERS",
                                      "POINT"} for r in ed)
assert all(r["apps"]["app_capacity"] == 1 << 20 and set(r["scene_parts_ms"])
           == {"grade+crop", "crop mask", "transform", "render",
               "second entity", "plate", "whole frame"} for r in ed)
assert "(b) the SPLAT scene frame's parts, each timed alone" in out
assert ("three undos and three redos, each bitwise the params and state "
        "it restores") in out
assert "(c) apps.render --video: launches" in out
assert "(c) apps.render --fast --video: launches" in out
assert "AVIs of 3 00dc frames, idx1 pointing at each, SOI / EOI" in out
assert "(d) apps.edit with 8 ops and a merge" in out
assert [(r["scene"], r["name"]) for r in routes] == [
    ("xla_train_500_64", "forward"), ("xla_train_500_64", "backward"),
    ("xla_train_500_64", "segment_rows"), ("xla_random_1500", "forward")]
rt = routes[0]
assert set(rt["routes"]) == {"kernel", "xla", "tiles", "dense"}
assert rt["routes"]["xla"]["launches"] == (0, 0, 0, 0)
assert rt["routes"]["xla"]["image"] <= 3e-5
assert set(rt["bars"]) == {"adc+", "mcmc", "mcmc_normal", "2dgs"}
assert rt["bars"]["2dgs"]["route"] == "surfel"
assert rt["surfel"]["grad"] <= 3e-3 and rt["surfel"]["npix"] <= 2
assert rt["app"]["densest_tile"] > 0 and rt["app"]["s"] > 0
assert routes[3]["frame_ms"] > 0 and "kernel_binned_frame_ms" in routes[3]
assert "(a) CPU rehearsal: render forward + backward of sum_loss" in out
assert "(c) CPU rehearsal: mcmc_normal through 'tiles'" in out
assert "(e) CPU rehearsal: apps.render --backend tiles --orbit 2" in out
assert "ns a splat-pixel pair" in out
for r in records + train + train2d + data + opts + live + dyn + ed + routes:
    assert keys <= set(r), r
    assert r["route"] == "cuda" and r["bound_ms"] > 0
    if r["name"] == "segment_rows":
        # held against float64: within the bound of its order of adds
        assert r["library_ms"] > 0 and r["bound_ratio"] <= 1.0, r
        assert r["source"] == "divshot_tpu_torch/csrc/segment.cu"
    else:
        assert r["library_ms"] is None and r["max_abs_err"] == 0.0, r
bwd = train[10]
assert bwd["source"] == "divshot_tpu_torch/csrc/backward.cu"
assert bwd["replaces"] == "divshot_tpu/raster/pallas_raster.py:437"
assert "it_per_s" in bwd and "(a) adc+" in out and "(b) bench: 500 splats" in out
assert [r["with_absgrad"] for r in train if r["name"] == "backward"] == [
    True, False, False, False, False]
assert all(r["units"] >= 1 and r["longest_tile"] >= 1 for r in train + train2d
           if "backward" in r["name"])
assert all("launches_per_step" in r for r in train[:12])
for m in %r:
    assert sys.modules.get(m) is None, m
print("MODULES", len(names))
""" % (BLOCKED, BLOCKED)


def _run(args, **kw):
    env = dict(os.environ, PYTHONPATH=str(REPO))
    return subprocess.run([sys.executable, *args], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300, **kw)


def test_port_runs_with_jax_and_reference_blocked():
    res = _run(["-c", _BLOCKED_RUN])
    assert res.returncode == 0, res.stderr[-4000:]
    assert "MODULES" in res.stdout
    assert int(res.stdout.split("MODULES")[1]) >= 24


def test_chip_smoke_fails_without_a_card():
    res = _run(["chip_smoke.py"])
    assert res.returncode != 0
    assert "no CUDA device" in res.stderr
    assert '"ok"' not in res.stdout


def _port_files():
    files = sorted(p for p in PORT.rglob("*") if p.is_file()
                   and "__pycache__" not in p.parts)
    files += [REPO / "chip_smoke.py", REPO / "chip_smoke_routes.py",
              REPO / "chip_smoke_capture.py", REPO / "chip_smoke_dist.py",
              REPO / "chip_smoke_repro.py"]
    files += sorted((REPO / "tests").glob("test_torch_*.py"))
    return files


def _code_without_docstrings(path: Path) -> str:
    src = path.read_text()
    lines = src.splitlines()
    for node in ast.walk(ast.parse(src)):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                             ast.AsyncFunctionDef)) and node.body:
            first = node.body[0]
            if (isinstance(first, ast.Expr)
                    and isinstance(first.value, ast.Constant)
                    and isinstance(first.value.value, str)):
                for i in range(first.lineno - 1, first.end_lineno):
                    lines[i] = ""
    return "\n".join(lines)


def test_port_imports_no_jax_or_reference():
    pattern = re.compile(r"\bimport\s+(jax|flax|PIL|imageio|cv2)\b|\bfrom"
                         r"\s+(jax|flax|PIL|imageio|cv2)\b|\bdivshot_tpu\.")
    modules = [p for p in _port_files()
               if p.suffix == ".py" and not p.name.startswith("test_")]
    assert len(modules) >= 24
    for path in modules:
        code = _code_without_docstrings(path)
        assert not pattern.search(code), f"{path}: {pattern.search(code)}"


def test_port_files_are_small_text():
    for path in _port_files():
        assert path.stat().st_size <= 200_000, path
        path.read_text(encoding="utf-8")


def test_build_directory_is_ignored():
    lines = (REPO / ".gitignore").read_text().splitlines()
    assert "build/" in [ln.strip() for ln in lines]
