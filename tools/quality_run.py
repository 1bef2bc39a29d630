#!/usr/bin/env python3
"""The port's quality check on one NVIDIA card: train the procedural
``tpu_bricks`` scene with the flags of the JAX package's own quality runs
and hold the eval PSNR against theirs.

    python3 tools/quality_run.py [--legs mcmc,2dgs] [--data DIR]
                                 [--out output/quality]

It generates the full ``tpu_bricks`` (100 train and 25 test views at
800x800, ``divshot_tpu_torch.gsio.procedural`` traced on the card) into a
temporary directory outside the repo (or uses ``--data``), then runs
``divshot_tpu_torch.apps.train`` in this process for each leg with the
reference run's flags. A leg keeps the reference's ``num_iters`` (every
schedule derives from it) and stops after the last eval step it needs:

- ``mcmc``: ``runs/run_quality.sh:10-14`` (MCMC, the default strategy,
  30K-step schedule), evals at 2000 and 4000 against
  ``runs/tpu_bricks_mcmc/eval_curve.json``;
- ``2dgs``: 2DGS by flattened 3D gaussians (``--model_type 1
  --surfel_exact 0``), 12K-step schedule, evals every 1500: what
  ``runs/tpu_bricks_2dgs2.log`` ran (its progress bar counts 12000 steps
  and its first eval is at 1500; ``runs/QUALITY_r05.md`` gives the mode),
  where ``runs/run_quality_r5.sh:17-18`` reads 24000 and 2000; the eval at
  3000 against ``runs/tpu_bricks_2dgs2/eval_curve.json``.

The bar: at each reference step the port's eval PSNR is at least the
reference's less ``BAR_DB``. Each leg's eval curve, it/s (evals and
checkpoints excluded) and wall time go to ``--out`` and to one JSON line
on stdout, with the card's ``nvidia-smi`` name and power limit. A leg
that misses the bar is reported (``"pass": false``), never retried with
other flags.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

BAR_DB = 0.5
LEGS = {
    "mcmc": dict(
        flags=["--eval_every", "2000", "--white_background", "1",
               "--cap_max", "262144", "--instance_capacity_mult", "32"],
        steps=(2000, 4000), reference="runs/tpu_bricks_mcmc/eval_curve.json"),
    "2dgs": dict(
        flags=["--eval_every", "1500", "--checkpoint_every", "2000",
               "--white_background", "1", "--cap_max", "262144",
               "--model_type", "1", "--surfel_exact", "0",
               "--num_iters", "12000"],
        steps=(3000,), reference="runs/tpu_bricks_2dgs2/eval_curve.json"),
}


def smi() -> str | None:
    if not shutil.which("nvidia-smi"):
        return None
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "-i", "0"],
                         capture_output=True, text=True, timeout=60)
    return res.stdout.strip() or None


def run_leg(name: str, data: str, work: str, out_dir: Path,
            device: str = "cuda") -> dict:
    import torch

    from divshot_tpu_torch.apps import train as train_app
    leg = LEGS[name]
    ref = {e["step"]: e["psnr"] for e in json.loads(
        (REPO / leg["reference"]).read_text())}
    stop = max(leg["steps"])
    argv = ["--source_path", data, "--model_path", f"{work}/{name}",
            "--device", device, *leg["flags"]]
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        tr = train_app.run(argv, max_steps=stop)
    if device == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    log = buf.getvalue()
    (out_dir / f"{name}.log").write_text(log)
    curve = json.loads(Path(work, name, "eval_curve.json").read_text())
    shutil.copy(Path(work, name, "eval_curve.json"),
                out_dir / f"{name}_eval_curve.json")
    its = [float(ln.split("(")[1].split()[0]) for ln in log.splitlines()
           if ln.startswith("trained ")][0]
    port = {e["step"]: e["psnr"] for e in curve}
    bars = [{"step": s, "reference_psnr": ref[s], "port_psnr": port[s],
             "pass": port[s] >= ref[s] - BAR_DB} for s in leg["steps"]]
    out = {"leg": name, "argv": argv[4:], "stop": stop,
           "num_iters": tr.cfg.num_iters, "curve": curve, "bars": bars,
           "pass": all(b["pass"] for b in bars), "it_per_s": its,
           "wall_s": wall, "num_alive": tr.state.params.num_alive,
           "instance_capacity": tr.instance_capacity}
    print(f"{name}: " + ", ".join(
        f"{b['step']}: {b['port_psnr']:.3f} dB (reference "
        f"{b['reference_psnr']:.3f}, {'pass' if b['pass'] else 'MISS'})"
        for b in bars) + f"; {its:.2f} it/s, wall {wall:.1f} s", flush=True)
    del tr
    if device == "cuda":
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--legs", default="mcmc,2dgs")
    p.add_argument("--data", default=None,
                   help="an existing tpu_bricks directory")
    p.add_argument("--out", default=str(REPO / "output" / "quality"))
    ns = p.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device: tools/quality_run.py needs an NVIDIA card",
              file=sys.stderr)
        return 1
    from divshot_tpu_torch.gsio.procedural import generate_dataset
    card = smi() or torch.cuda.get_device_name(0)
    print(card, flush=True)
    out_dir = Path(ns.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    result = {"card": card, "bar_db": BAR_DB, "legs": []}
    with tempfile.TemporaryDirectory() as work:
        data = ns.data
        if data is None:
            data = f"{work}/tpu_bricks"
            t0 = time.perf_counter()
            generate_dataset(data, n_train=100, n_test=25, width=800,
                             height=800, device=torch.device("cuda"))
            result["generate_s"] = time.perf_counter() - t0
            print(f"tpu_bricks 100 + 25 views at 800x800 generated in "
                  f"{result['generate_s']:.1f} s", flush=True)
        for name in ns.legs.split(","):
            result["legs"].append(run_leg(name, data, work, out_dir))
    line = json.dumps(result)
    (out_dir / "quality.json").write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
