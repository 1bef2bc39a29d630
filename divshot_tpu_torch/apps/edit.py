"""Headless splat editing CLI (counterpart of ``divshot_tpu/apps/edit.py``):
selection, delete, crop, transform, paint, merge and undo, each as
``op:arg1,arg2,...`` applied in order on the ``--device`` (the card by
default).

  python -m divshot_tpu_torch.apps.edit --input in.ply --output out.ply \\
      --op select_sphere:0,0,0,1.5 --op select_inverse --op delete \\
      --op crop_box:-2,-2,-2,2,2,2 \\
      --op transform_translate:0,1,0 --op transform_scale:2 \\
      --op transform_rotate_y:45 --op paint:1,0,0 --op compact

  # merge another model, export an HTML viewer
  python -m divshot_tpu_torch.apps.edit --input a.ply --merge b.ply \\
      --output merged.spz --html view.html
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from divshot_tpu_torch.edit.ops import EditSession
from divshot_tpu_torch.gsio.io import load_model, save_model
from divshot_tpu_torch.viewer.html_export import export_html


def _floats(arg: str) -> list[float]:
    return [float(x) for x in arg.split(",")] if arg else []


def _rotation(axis: str, degrees: float) -> np.ndarray:
    th = np.radians(degrees)
    c, s = np.cos(th), np.sin(th)
    m = np.eye(4, dtype=np.float32)
    if axis == "x":
        m[1:3, 1:3] = [[c, -s], [s, c]]
    elif axis == "y":
        m[0, 0], m[0, 2], m[2, 0], m[2, 2] = c, s, -s, c
    else:
        m[0:2, 0:2] = [[c, -s], [s, c]]
    return m


def apply_op(sess: EditSession, op: str) -> None:
    name, _, arg = op.partition(":")
    v = _floats(arg)
    simple = {"select_all": sess.select_all, "select_none": sess.select_none,
              "select_inverse": sess.select_inverse,
              "delete": sess.delete_selected, "hide": sess.hide_selected,
              "unhide": sess.unhide_all, "compact": sess.compact,
              "undo": sess.undo, "redo": sess.redo}
    if name in simple:
        simple[name]()
    elif name == "select_sphere":
        sess.select_sphere(v[:3], v[3])
    elif name == "select_box":
        sess.select_box(v[:3], v[3:6])
    elif name == "paint":
        sess.paint_selected(v[:3])
    elif name == "crop_box":
        sess.apply_crop([{"type": "box", "lo": v[:3], "hi": v[3:6]}])
    elif name == "crop_sphere":
        sess.apply_crop([{"type": "sphere", "center": v[:3],
                          "radius": v[3]}])
    elif name.startswith("transform_"):
        m = np.eye(4, dtype=np.float32)
        if name == "transform_translate":
            m[:3, 3] = v[:3]
        elif name == "transform_scale":
            m[:3, :3] *= v[0]
        elif name in ("transform_rotate_x", "transform_rotate_y",
                      "transform_rotate_z"):
            m = _rotation(name[-1], v[0])
        else:
            raise SystemExit(f"unknown op: {name}")
        sess.select_all()
        sess.transform_selected(m)
    else:
        raise SystemExit(f"unknown op: {name}")


def main(argv=None) -> int:
    p = argparse.ArgumentParser("divshot-tpu-torch edit")
    p.add_argument("--input", required=True)
    p.add_argument("--output", default="")
    p.add_argument("--merge", action="append", default=[],
                   help="additional models to merge in")
    p.add_argument("--op", action="append", default=[],
                   help="edit op, e.g. select_sphere:0,0,0,1 delete")
    p.add_argument("--html", default="", help="export an HTML viewer")
    p.add_argument("--stats", action="store_true",
                   help="print splat statistics and exit")
    p.add_argument("--device", default="cuda")
    ns = p.parse_args(argv)

    params, meta = load_model(ns.input, device=ns.device)
    sess = EditSession(params)
    for path in ns.merge:
        other, _ = load_model(path, device=ns.device)
        sess.merge(other)
    for op in ns.op:
        apply_op(sess, op)

    vis = sess.visible_params()
    if ns.stats:
        m = vis.means.cpu().numpy()
        a = vis.alive.cpu().numpy()
        alive = int(a.sum())
        print(f"splats: {alive} (capacity {vis.capacity})")
        if alive:
            print(f"bounds: {m[a].min(0)} .. {m[a].max(0)}")
        return 0

    if ns.output:
        save_model(ns.output, vis,
                   antialiased=bool(meta.get("antialiased", False)))
        print(f"saved {ns.output}")
    if ns.html:
        export_html(ns.html, vis)
        print(f"saved {ns.html}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
