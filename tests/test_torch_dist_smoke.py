"""A CPU rehearsal of ``chip_smoke.py``'s phase 14 (training over several
processes and tile-sharded rendering, ``chip_smoke_dist.py``) at its tiny
scale, with JAX, flax, PIL, imageio, OpenCV and ``divshot_tpu`` blocked in
the phase's process: (a) the 1x1 world over gloo, the parallel and
overlap steps bitwise the serial step; (b) its two worker processes over
gloo on the CPU (2x1 and 1x2 meshes, ``MultiHostTrainer``), which must
not load JAX or the reference either; (c) ``render_tiled`` over one band
and over two; and the kernel records: the train cell's, every rank's,
and band 0's."""

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
import torch.distributed as dist
import chip_smoke
buf = io.StringIO()
with contextlib.redirect_stdout(buf):
    recs = chip_smoke.phase_dist(torch.device("cpu"), chip_smoke.TINY)
out = buf.getvalue()
assert not dist.is_initialized()
# the bands' kernel records: band 0's (the two bands' shapes are equal)
scenes = ["dist_1x1_train_500_64", "tiled_2band_64x64_rank0_tpu_bricks_mcmc",
          "dist_2x1_rank0_train_500_64", "dist_2x1_rank1_train_500_64"]
want = []
for s in scenes:
    want += [(s, k) for k in ("expand", "forward")
             + (("backward", "segment_rows") if s.startswith("dist_")
                else ())]
assert [(r["scene"], r["name"]) for r in recs] == want, recs
keys = {"name", "route", "source", "replaces", "launches", "max_abs_err",
        "ms", "plain_ms", "bound_ms", "bound_by", "library_ms"}
for r in recs:
    assert keys <= set(r), r
    assert r["route"] == "cuda" and r["bound_ms"] > 0, r
    if r["name"] == "segment_rows":
        # held against float64: within the bound of its order of adds
        assert r["library_ms"] > 0 and r["bound_ratio"] <= 1.0, r
    else:
        assert r["max_abs_err"] == 0.0 and r["library_ms"] is None, r
assert set(recs[3]["dist"]["its"]) == {"serial", "parallel", "overlap"}
assert recs[3]["it_per_s"] > 0 and recs[3]["dist"]["backend"] == "gloo"
one = recs[0]["dist"]["tiled_one_band"]
assert one["bands"] == 1 and one["diff"] == 0.0
# the serial step's first step run twice: the loss and every state tensor
first = recs[0]["dist"]["default_mode_first_step_diff"]
assert {"loss", "params.opacity", "mu.means", "nu.scales",
        "dstate.grad_accum", "gen"} <= set(first), first
assert not any(first.values()), first
for r in recs[6:14]:
    d = r["dist"]
    assert d["1x2"]["rows"] == 512 and d["1x2"]["means_diff"] == 0.0
    assert 2 * d["1x2"]["moment_bytes"] == d["1x2"]["whole_bytes"]
    for w in ("parallel", "overlap"):
        assert d[w]["means_diff"] <= 1e-5, d
tiled = [r["tiled"] for r in recs if "tiled" in r]
assert [t["bands"] for t in tiled] == [2, 2]
assert all(t["diff"] <= 2e-3 and t["over_bar"]["rest"] == 0
           and t["tie_pixels"] >= 0 for t in tiled)
assert [r["launches"] for r in recs[4:6]] == [0, 0]    # the CPU's
assert "the parallel and overlap steps bitwise the serial step" in out
assert "with both ranks' parameters bitwise equal" in out
assert "MultiHostTrainer's losses bitwise equal across ranks" in out
assert "[rank 0]" in out and "[rank 1]" in out
for m in %r:
    assert sys.modules.get(m) is None, m
print("PHASE14 OK")
""" % (BLOCKED, BLOCKED)


def test_phase_14_rehearsal_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, "-c", _RUN], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-4000:]
    assert "PHASE14 OK" in res.stdout
