"""Reduced PLY (EAGLES-style) codec (counterpart of
``divshot_tpu/gsio/reduced.py``): four ``vertex`` elements, one for each
SH degree bucket, each record [xyz float32 or float16, uint8 dc ids x 3,
uint8 rest ids x 3 a coefficient, uint8 opacity id, uint8 scale ids x 3,
uint8 rotation ids x 4 (re, im, im, im)], then a ``cook_center`` element
of the k-means codebook centres, 20 float32 an entry (dc, 15 rest,
opacity, scaling, rot_re, rot_im). The codebooks are computed on the
params' device (``gsio/kmeans.py``).
"""

from __future__ import annotations

import io

import numpy as np

from divshot_tpu_torch.gsio.kmeans import make_codebooks
from divshot_tpu_torch.gsio.ply import read_ply_header
from divshot_tpu_torch.splat.gaussians import GaussianParams

_COEFFS = [0, 3, 8, 15]


def default_degrees(params_d: dict, threshold: float = 1e-3) -> np.ndarray:
    """A splat's SH degree: its highest band with an entry above
    ``threshold``."""
    shN = params_d["shN"]
    n, k = shN.shape[0], shN.shape[1]
    deg = np.zeros(n, np.uint8)
    for lo, hi, d in ((0, 3, 1), (3, 8, 2), (8, 15, 3)):
        if k >= hi:
            mag = np.abs(shN[:, lo:hi, :]).max(axis=(1, 2))
            deg = np.where(mag > threshold, d, deg).astype(np.uint8)
    return deg


def save_reduced_ply(path: str, params: GaussianParams, *,
                     quantised: bool = True, half_float: bool = False,
                     degrees: np.ndarray | None = None,
                     kmeans_iters: int = 10) -> None:
    d = params.compact_numpy()
    n = d["means"].shape[0]
    if degrees is None:
        degrees = default_degrees(d)
    if not quantised:
        raise NotImplementedError("non-quantised reduced ply: use save_ply")

    books = make_codebooks(d, iters=kmeans_iters, device=params.device)
    dc_ids = books["feature_dc"][1].reshape(n, 3)
    rest_ids = [books[f"feature_rest_{i}"][1] for i in range(15)]
    op_ids = books["opacity"][1]
    sc_ids = books["scaling"][1].reshape(n, 3)
    re_ids = books["rotation_re"][1]
    im_ids = books["rotation_im"][1].reshape(n, 3)

    xyz_size = 6 if half_float else 12
    deg2id = [np.nonzero(degrees == sd)[0] for sd in range(4)]

    body = io.BytesIO()
    for sd in range(4):
        ids = deg2id[sd]
        coeffs = _COEFFS[sd]
        stride = xyz_size + 3 * (1 + coeffs) + 1 + 3 + 4
        rec = np.zeros((len(ids), stride), np.uint8)
        xyz = d["means"][ids]
        if half_float:
            rec[:, 0:6] = xyz.astype("<f2").view(np.uint8).reshape(-1, 6)
        else:
            rec[:, 0:12] = xyz.astype("<f4").view(np.uint8).reshape(-1, 12)
        rec[:, xyz_size: xyz_size + 3] = dc_ids[ids]
        for j in range(coeffs):
            r = rest_ids[j].reshape(n, 3)[ids]
            rec[:, xyz_size + 3 * (j + 1): xyz_size + 3 * (j + 2)] = r
        so = xyz_size + 3 * (1 + coeffs)
        rec[:, so] = op_ids[ids]
        rec[:, so + 1: so + 4] = sc_ids[ids]
        rec[:, so + 4] = re_ids[ids]
        rec[:, so + 5: so + 8] = im_ids[ids]
        body.write(rec.tobytes())

    k = len(books["opacity"][0])
    centers = np.zeros((k, 20), np.float32)
    centers[:, 0] = books["feature_dc"][0]
    for i in range(15):
        centers[:, 1 + i] = books[f"feature_rest_{i}"][0]
    centers[:, 16] = books["opacity"][0]
    centers[:, 17] = books["scaling"][0]
    centers[:, 18] = books["rotation_re"][0]
    centers[:, 19] = books["rotation_im"][0]
    body.write(centers.astype("<f4").tobytes())

    header = io.BytesIO()
    header.write(b"ply\nformat binary_little_endian 1.0\n")
    header.write(b"comment generated by divshot_tpu\n")
    ftype = "f16" if half_float else "float"
    for sd in range(4):
        header.write(f"element vertex {len(deg2id[sd])}\n".encode())
        for nme in ("x", "y", "z"):
            header.write(f"property {ftype} {nme}\n".encode())
        for i in range(3):
            header.write(f"property u8 f_dc_{i}\n".encode())
        for i in range(_COEFFS[sd] * 3):
            header.write(f"property u8 f_rest_{i}\n".encode())
        for nme in ("opacity", "scale_0", "scale_1", "scale_2",
                    "rot_0", "rot_1", "rot_2", "rot_3"):
            header.write(f"property u8 {nme}\n".encode())
    header.write(f"element cook_center {k}\n".encode())
    header.write(b"property float f_dc\n")
    for i in range(15):
        header.write(f"property float f_rest_{i}\n".encode())
    for nme in ("opacity", "scale", "rot_re", "rot_im"):
        header.write(f"property float {nme}\n".encode())
    header.write(b"end_header\n")

    with open(path, "wb") as f:
        f.write(header.getvalue())
        f.write(body.getvalue())


def load_reduced_ply(path: str, *, device="cuda"
                     ) -> tuple[GaussianParams, dict]:
    with open(path, "rb") as f:
        elements, _comments, _fmt = read_ply_header(f)
        body = f.read()

    verts = [e for e in elements if e.name == "vertex"]
    cook = next(e for e in elements if e.name == "cook_center")
    half_float = verts[0].props[0][0] == "<f2"
    xyz_size = 6 if half_float else 12
    counts = [e.count for e in verts]
    strides = [xyz_size + 3 * (1 + _COEFFS[sd]) + 8 for sd in range(4)]

    k = cook.count
    cook_off = sum(c * s for c, s in zip(counts, strides))
    centers = np.frombuffer(
        body[cook_off: cook_off + k * 80], "<f4").reshape(k, 20)

    means_l, scales_l, quats_l, op_l, sh0_l, shN_l = [], [], [], [], [], []
    off = 0
    for sd in range(4):
        c, stride = counts[sd], strides[sd]
        if c == 0:
            continue
        rec = np.frombuffer(body[off: off + c * stride], np.uint8
                            ).reshape(c, stride)
        off += c * stride
        if half_float:
            xyz = rec[:, 0:6].copy().view("<f2").astype(np.float32
                                                        ).reshape(c, 3)
        else:
            xyz = rec[:, 0:12].copy().view("<f4").reshape(c, 3)
        dc = centers[rec[:, xyz_size:xyz_size + 3].astype(np.int64), 0]
        shn = np.zeros((c, 15, 3), np.float32)
        for j in range(_COEFFS[sd]):
            ids = rec[:, xyz_size + 3 * (j + 1): xyz_size + 3 * (j + 2)]
            shn[:, j, :] = centers[ids.astype(np.int64), 1 + j]
        so = xyz_size + 3 * (1 + _COEFFS[sd])
        op = centers[rec[:, so].astype(np.int64), 16]
        sc = centers[rec[:, so + 1:so + 4].astype(np.int64), 17]
        re = centers[rec[:, so + 4].astype(np.int64), 18]
        im = centers[rec[:, so + 5:so + 8].astype(np.int64), 19]

        means_l.append(xyz)
        scales_l.append(sc)
        quats_l.append(np.concatenate([re[:, None], im], 1))
        op_l.append(op)
        sh0_l.append(dc)
        shN_l.append(shn)

    params = GaussianParams.create(
        np.concatenate(means_l), scales=np.concatenate(scales_l),
        quats=np.concatenate(quats_l), opacity=np.concatenate(op_l),
        sh0=np.concatenate(sh0_l), shN=np.concatenate(shN_l), sh_degree=3,
        device=device)
    return params, {}
