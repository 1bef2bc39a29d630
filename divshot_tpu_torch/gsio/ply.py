"""Standard 3DGS PLY loading (counterpart of ``divshot_tpu/gsio/ply.py:41-119``).

Record layout of the files this repo writes: 59 float32 per splat (x y z,
f_dc_0..2, f_rest_0..44 channel-major, opacity logit, scale_0..2 log,
rot_0..3 wxyz). The reader also takes graphdeco files with normals and any
property order. Parsing is numpy only; the arrays become tensors at the end.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from divshot_tpu_torch.splat.gaussians import GaussianParams

_PROP_TYPES = {
    "float": "<f4", "float32": "<f4", "double": "<f8", "float64": "<f8",
    "uchar": "<u1", "uint8": "<u1", "uint": "<u4", "int": "<i4",
    "uint32": "<u4", "ushort": "<u2", "short": "<i2", "char": "<i1",
    "uint16": "<u2", "u8": "<u1", "f16": "<f2", "half": "<f2",
}


@dataclass
class PlyElement:
    name: str
    count: int
    props: list[tuple[str, str]]    # (dtype, name)
    data: np.ndarray | None = None  # structured array


def read_ply_header(f) -> tuple[list[PlyElement], list[str], str]:
    if f.readline().strip() != b"ply":
        raise ValueError("not a PLY file")
    elements: list[PlyElement] = []
    comments: list[str] = []
    fmt = "binary_little_endian"
    cur: PlyElement | None = None
    while True:
        line = f.readline()
        if not line:
            raise ValueError("unexpected EOF in PLY header")
        tok = line.decode("ascii", "replace").strip().split()
        if not tok:
            continue
        if tok[0] == "format":
            fmt = tok[1]
        elif tok[0] == "comment":
            comments.append(" ".join(tok[1:]))
        elif tok[0] == "element":
            cur = PlyElement(tok[1], int(tok[2]), [])
            elements.append(cur)
        elif tok[0] == "property":
            if tok[1] == "list":
                raise ValueError("list properties unsupported in splat PLY")
            cur.props.append((_PROP_TYPES[tok[1]], tok[2]))
        elif tok[0] == "end_header":
            return elements, comments, fmt


def read_ply_arrays(path: str) -> tuple[dict[str, np.ndarray], dict]:
    """-> (float32 arrays ``means scales quats opacity sh0 shN``, meta with
    ``antialiased`` and ``sh_degree``)."""
    with open(path, "rb") as f:
        elements, comments, fmt = read_ply_header(f)
        if fmt != "binary_little_endian":
            raise ValueError(f"unsupported PLY format {fmt}")
        for el in elements:
            dt = np.dtype([(name, t) for t, name in el.props])
            el.data = np.frombuffer(f.read(dt.itemsize * el.count),
                                    dtype=dt, count=el.count)

    vert = next(e for e in elements if e.name == "vertex")
    d = vert.data
    n = vert.count

    def cols(*names):
        return np.stack([d[nm] for nm in names], -1).astype(np.float32)

    rest_names = sorted(
        (nm for _, nm in vert.props if nm.startswith("f_rest_")),
        key=lambda s: int(s.split("_")[-1]))
    k = len(rest_names) // 3
    if rest_names:
        # disk is channel-major (15R, 15G, 15B) -> (N, K, 3)
        shN = cols(*rest_names).reshape(n, 3, k).transpose(0, 2, 1)
    else:
        shN = np.zeros((n, 0, 3), np.float32)
    sh_degree = {0: 0, 3: 1, 8: 2, 15: 3}.get(k, 3)
    arrays = {
        "means": cols("x", "y", "z"),
        "scales": cols("scale_0", "scale_1", "scale_2"),
        "quats": cols("rot_0", "rot_1", "rot_2", "rot_3"),
        "opacity": d["opacity"].astype(np.float32),
        "sh0": cols("f_dc_0", "f_dc_1", "f_dc_2"),
        "shN": shN,
    }
    antialiased = any("splatx.anti_aliasing=1" in c for c in comments)
    return arrays, {"antialiased": antialiased, "sh_degree": sh_degree}


def load_ply(path: str, *, device="cuda") -> tuple[GaussianParams, dict]:
    """Load a 3DGS splat PLY -> (params on ``device``, meta)."""
    a, meta = read_ply_arrays(path)
    params = GaussianParams.create(
        a["means"], scales=a["scales"], quats=a["quats"],
        opacity=a["opacity"], sh0=a["sh0"],
        shN=a["shN"] if a["shN"].shape[1] else None,
        sh_degree=meta["sh_degree"], device=device)
    return params, meta
