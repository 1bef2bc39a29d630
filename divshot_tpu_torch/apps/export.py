"""Export CLI (counterpart of ``divshot_tpu/apps/export.py``): convert
between splat formats, or extract a mesh.

  python -m divshot_tpu_torch.apps.export --input m.ply --output m.spz
  python -m divshot_tpu_torch.apps.export --input m.ply --output mesh.obj \\
      --views 24 --mesh_resolution 128 [--device cuda|cpu]

The output's extension picks the format (``gsio/io.save_model``: ``.ply``,
``.compressed.ply``, ``.reduced.ply``, ``.splat``, ``.spz``, ``.dvsplat``);
``.obj`` extracts a mesh (``viewer/mesh.extract_mesh``) from ``--views``
orbit cameras at 512 px around the model, the depths through the kernels.
Runs on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch


def main(argv=None) -> int:
    p = argparse.ArgumentParser("divshot-tpu-torch export")
    p.add_argument("--input", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--antialiased", action="store_true")
    p.add_argument("--views", type=int, default=24,
                   help="cameras for mesh extraction")
    p.add_argument("--mesh_resolution", type=int, default=128)
    p.add_argument("--device", default="cuda")
    ns = p.parse_args(argv)

    from divshot_tpu_torch.gsio.io import load_model, save_model

    device = torch.device(ns.device)
    params, meta = load_model(ns.input, device=device)
    print(f"loaded {params.num_alive} splats")
    aa = ns.antialiased or meta.get("antialiased", False)

    if ns.output.endswith(".obj"):
        from divshot_tpu_torch.gsio.synthetic import orbit_cameras
        from divshot_tpu_torch.viewer.mesh import extract_mesh
        d = params.compact_numpy()
        extent = float(np.abs(d["means"] - d["means"].mean(0)).max())
        cams = orbit_cameras(ns.views, radius=max(2.5 * extent, 1.0),
                             width=512, device=device)
        verts, faces = extract_mesh(
            params, cams, resolution=ns.mesh_resolution, out_path=ns.output,
            render_kw={"instance_capacity": 1 << 20})
        print(f"wrote {ns.output}: {len(verts)} verts, {len(faces)} faces")
    else:
        save_model(ns.output, params, antialiased=aa)
        print(f"wrote {ns.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
