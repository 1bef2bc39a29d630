"""Standard 3DGS PLY and antimatter15 ``.splat`` I/O (counterpart of
``divshot_tpu/gsio/ply.py``), byte for byte the files the JAX package
writes.

Record layout of the files this repo writes: 59 float32 per splat (x y z,
f_dc_0..2, f_rest_0..44 channel-major, opacity logit, scale_0..2 log,
rot_0..3 wxyz); the antialiasing flag is the header comment
``splatx.anti_aliasing=1``. The reader also takes graphdeco files with
normals and any property order. Parsing and packing are numpy only; the
arrays become tensors at the end. The writers drop dead splats
(``GaussianParams.compact_numpy``).
"""

from __future__ import annotations

import io
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


def save_ply(path: str, params: GaussianParams, *,
             antialiased: bool = False) -> None:
    """Write the tinygsplat-layout 3DGS PLY (59 floats, no normals)."""
    d = params.compact_numpy()
    n = d["means"].shape[0]
    k = d["shN"].shape[1]

    header = io.BytesIO()
    header.write(b"ply\nformat binary_little_endian 1.0\n")
    header.write(b"comment generated by divshot_tpu\n")
    if antialiased:
        header.write(b"comment splatx.anti_aliasing=1\n")
    header.write(f"element vertex {n}\n".encode())
    for nm in ("x", "y", "z", "f_dc_0", "f_dc_1", "f_dc_2"):
        header.write(f"property float {nm}\n".encode())
    for i in range(45):  # the format always carries 45 rest floats
        header.write(f"property float f_rest_{i}\n".encode())
    for nm in ("opacity", "scale_0", "scale_1", "scale_2",
               "rot_0", "rot_1", "rot_2", "rot_3"):
        header.write(f"property float {nm}\n".encode())
    header.write(b"end_header\n")

    rec = np.zeros((n, 59), np.float32)
    rec[:, 0:3] = d["means"]
    rec[:, 3:6] = d["sh0"]
    rest = np.zeros((n, 3, 15), np.float32)
    if k:
        rest[:, :, :k] = d["shN"].transpose(0, 2, 1)  # channel-major
    rec[:, 6:51] = rest.reshape(n, 45)
    rec[:, 51] = d["opacity"]
    rec[:, 52:55] = d["scales"]
    rec[:, 55:59] = d["quats"]
    with open(path, "wb") as f:
        f.write(header.getvalue())
        f.write(rec.tobytes())


# ---------------------------------------------------------------------------
# antimatter15 .splat: 32 bytes a splat (xyz and linear scales as float32,
# RGBA and the quaternion as uint8)

SH_C0 = 0.28209479177387814


def save_splat(path: str, params: GaussianParams) -> None:
    d = params.compact_numpy()
    n = d["means"].shape[0]
    buf = np.zeros((n, 32), np.uint8)
    f32 = buf.view("<f4").reshape(n, 8)
    f32[:, 0:3] = d["means"]
    f32[:, 3:6] = np.exp(d["scales"])
    color = np.clip((0.5 + SH_C0 * d["sh0"]) * 255, 0, 255).astype(np.uint8)
    buf[:, 24:27] = color
    buf[:, 27] = np.clip(
        (1 / (1 + np.exp(-d["opacity"]))) * 255, 0, 255).astype(np.uint8)
    q = d["quats"] / np.linalg.norm(d["quats"], axis=1,
                                    keepdims=True).clip(1e-8)
    buf[:, 28:32] = np.clip(q * 128 + 128, 0, 255).astype(np.uint8)
    with open(path, "wb") as f:
        f.write(buf.tobytes())


def load_splat(path: str, *, device="cuda") -> GaussianParams:
    raw = np.fromfile(path, np.uint8)
    n = raw.size // 32
    buf = raw[: n * 32].reshape(n, 32)
    f32 = buf.view("<f4").reshape(n, 8)
    means = f32[:, 0:3].copy()
    scales = np.log(np.maximum(f32[:, 3:6], 1e-10))
    sh0 = (buf[:, 24:27].astype(np.float32) / 255.0 - 0.5) / SH_C0
    a = np.clip(buf[:, 27].astype(np.float32) / 255.0, 1e-4, 1 - 1e-4)
    opacity = np.log(a) - np.log1p(-a)
    quats = (buf[:, 28:32].astype(np.float32) - 128.0) / 128.0
    return GaussianParams.create(
        means, scales=scales, quats=quats, opacity=opacity, sh0=sh0,
        sh_degree=0, device=device)


def save_point_cloud_ply(path: str, points: np.ndarray,
                         colors: np.ndarray | None = None) -> None:
    """Plain xyz + rgb point cloud PLY (the SfM sparse-cloud export)."""
    n = points.shape[0]
    if colors is None:
        colors = np.full((n, 3), 0.5, np.float32)
    rgb = np.clip(colors * 255, 0, 255).astype(np.uint8)
    header = (
        "ply\nformat binary_little_endian 1.0\n"
        f"element vertex {n}\n"
        "property float x\nproperty float y\nproperty float z\n"
        "property uchar red\nproperty uchar green\nproperty uchar blue\n"
        "end_header\n")
    rec = np.zeros(n, dtype=[("xyz", "<f4", 3), ("rgb", "u1", 3)])
    rec["xyz"] = points.astype(np.float32)
    rec["rgb"] = rgb
    with open(path, "wb") as f:
        f.write(header.encode())
        f.write(rec.tobytes())
