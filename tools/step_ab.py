#!/usr/bin/env python3
"""The train and train2d cells' steps of two checkouts, in turns, on one
card.

    python3 tools/step_ab.py --roots PARENT,CHANGE [--order 0110]

Each turn is a process of its own, started from that checkout's root: it
builds the checkout's kernels and runs its ``chip_smoke.train_bench`` at
``chip_smoke.FULL`` (phase 5(b)'s train cell and 6(b)'s train2d cell:
warm-up, then 30 steps timed with CUDA events, and the card's busy share
of a step from the profiler). ``--order`` lists the roots' indices in
turn (default parent, change, change, parent). Prints one ``AB`` line of
JSON a turn: the root, the cell, it/s and the busy share.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

TURN = r"""
import json, sys, time
import torch
sys.path.insert(0, ".")
import chip_smoke as CS
from divshot_tpu_torch import _build
_build.library()
dev = torch.device("cuda")
for model_type, cell in ((0, "train"), (1, "train2d")):
    b = CS.train_bench(dev, CS.FULL, model_type=model_type)
    print("AB " + json.dumps(dict(root=sys.argv[1], cell=cell,
                                  it_per_s=b["its"],
                                  device_busy=b["device_busy"])),
          flush=True)
"""


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--roots", required=True)
    ap.add_argument("--order", default="0110")
    args = ap.parse_args()
    roots = [Path(r).resolve() for r in args.roots.split(",")]
    for i in args.order:
        root = roots[int(i)]
        res = subprocess.run([sys.executable, "-c", TURN, str(root)],
                             cwd=root, capture_output=True, text=True)
        for line in res.stdout.splitlines():
            if line.startswith("AB "):
                print(line, flush=True)
        if res.returncode != 0:
            print(res.stderr[-3000:], file=sys.stderr)
            return res.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main())
