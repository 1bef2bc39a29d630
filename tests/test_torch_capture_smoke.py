"""A CPU rehearsal of ``chip_smoke.py``'s phase 13 (real captures and the
mesh renderers, ``chip_smoke_capture.py``) at its tiny scale, with JAX,
flax, PIL, imageio, OpenCV and ``divshot_tpu`` blocked: the JPEG COLMAP
capture written, decoded (every view's coefficients bitwise the
encoder's), its cameras equal to the source's, loaded and trained
through ``apps.train`` against phase 7's PNG curve; the host library
against its Python paths; the mesh passes and the hybrid frame, and the
kernel records of both paths."""

import os
import subprocess
import sys
from pathlib import Path

from tests.test_torch_isolation import BLOCKED

REPO = Path(__file__).resolve().parent.parent

_RUN = r"""
import contextlib, io, sys
for m in %r:
    sys.modules[m] = None
import torch
torch.set_num_threads(1)
import chip_smoke
buf = io.StringIO()
with contextlib.redirect_stdout(buf):
    recs = chip_smoke.phase_capture(torch.device("cpu"), chip_smoke.TINY)
out = buf.getvalue()
assert [(r["scene"], r["name"]) for r in recs] == [
    ("jpeg_capture_32", k) for k in ("expand", "forward", "backward",
                                     "segment_rows")] + [
    ("hybrid_tpu_bricks_mcmc", k) for k in ("expand", "forward")], recs
for r in recs:
    assert r["route"] == "cuda" and r["bound_ms"] > 0, r
    if r["name"] == "segment_rows":
        # held against float64: within the bound of its order of adds
        assert r["library_ms"] > 0 and r["bound_ratio"] <= 1.0, r
    else:
        assert r["max_abs_err"] == 0.0 and r["library_ms"] is None, r
assert "quantised blocks bitwise equal to the encoder's" in out
assert recs[0]["jpeg_load_s"] > 0 and recs[0]["png_load_s"] > 0
assert recs[0]["eval_psnr"] > 0 and recs[0]["it_per_s"] > 0
assert recs[0]["pose_err"] <= 1e-6 and recs[0]["psnr_gap"] <= 1.0
assert "cameras equal to the source's" in out
lib = recs[0]["host_library"]
assert lib["pack_lib_ms"] > 0 and lib["points_py_ms"] > 0
ms = recs[4]["mesh_ms"]
assert set(ms) == {"rasterize_mesh", "shade_gbuffer_lights",
                   "path_trace_mesh", "hybrid_frame", "restir_direct",
                   "ssgi", "deferred_shade_gi"}, ms
assert "all bitwise equal" in out and "hybrid frame" in out
for m in %r:
    assert sys.modules.get(m) is None, m
print("PHASE13 OK")
""" % (BLOCKED, BLOCKED)


def test_phase_13_rehearsal_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, "-c", _RUN], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-4000:]
    assert "PHASE13 OK" in res.stdout
