"""``.dvsplat`` codec, the reference's own compact format (counterpart of
``divshot_tpu/gsio/dvsplat.py``):

a header {uint32 numSplats, numChunks, numVertexs[4], flag}; the splats
Morton-ordered; per 256-splat chunk 6 float32 position bounds, and per
splat a uint32 ``packed_position`` (11-10-11 in the chunk's bounds); then
the quantised attributes grouped into the 4 SH-degree buckets (Morton
order within a bucket): [uint8 scale x 3 ((s + 10) * 16), uint8 rot x 3
(xyz of the sign-normalised quaternion * 127.5 + 127.5; w reconstructed),
uint8 opacity (sigmoid * 255), uint8 colour x 3 (c * 0.15 * 255 + 127.5),
uint8 SH x 3 a coefficient (* 128 + 128, 5 / 4-bit buckets)].
"""

from __future__ import annotations

import struct

import numpy as np

from divshot_tpu_torch.gsio.compressed import (_pack_111011, _unit,
                                               _unpack_111011, morton_order)
from divshot_tpu_torch.gsio.reduced import _COEFFS, default_degrees
from divshot_tpu_torch.gsio.spz import COLOR_SCALE, _quantize_sh, _to_u8
from divshot_tpu_torch.splat.gaussians import GaussianParams


def save_dvsplat(path: str, params: GaussianParams, *,
                 degrees: np.ndarray | None = None) -> None:
    d = params.compact_numpy()
    order = morton_order(d["means"])
    pos = d["means"][order]
    scales = d["scales"][order]
    quats = d["quats"][order]
    sh0 = d["sh0"][order]
    shN = d["shN"][order]
    op = d["opacity"][order]
    if degrees is None:
        degrees = default_degrees({"shN": shN})
    else:
        degrees = np.asarray(degrees)[order]

    # grouped by SH-degree bucket (Morton order within a bucket), positions
    # and attributes alike, so that the streams stay index-aligned
    bucket_order = np.concatenate(
        [np.nonzero(degrees == sd)[0] for sd in range(4)])
    pos = pos[bucket_order]
    scales = scales[bucket_order]
    quats = quats[bucket_order]
    sh0 = sh0[bucket_order]
    shN = shN[bucket_order]
    op = op[bucket_order]
    degrees = degrees[bucket_order]

    n = len(pos)
    nchunks = (n + 255) // 256
    deg2id = [np.nonzero(degrees == sd)[0] for sd in range(4)]
    header = struct.pack("<7I", n, nchunks, *(len(x) for x in deg2id), 0)

    chunk_bounds = np.zeros((nchunks, 6), np.float32)
    packed_pos = np.zeros(n, np.uint32)
    for ci in range(nchunks):
        s, e = ci * 256, min(n, (ci + 1) * 256)
        pmin, pmax = pos[s:e].min(0), pos[s:e].max(0)
        chunk_bounds[ci, 0:3] = pmin
        chunk_bounds[ci, 3:6] = pmax
        packed_pos[s:e] = _pack_111011(
            *[_unit(pos[s:e, i], pmin[i], pmax[i]) for i in range(3)])

    out = [header, chunk_bounds.astype("<f4").tobytes(),
           packed_pos.astype("<u4").tobytes()]

    q = quats / np.linalg.norm(quats, axis=1, keepdims=True).clip(1e-12)
    sign = np.where(q[:, 0:1] < 0, -1.0, 1.0)
    q8 = _to_u8(q * sign * 127.5 + 127.5)

    for sd in range(4):
        ids = deg2id[sd]
        coeffs = _COEFFS[sd]
        if len(ids) == 0:
            continue
        rec = np.zeros((len(ids), 10 + 3 * coeffs), np.uint8)
        rec[:, 0:3] = _to_u8((scales[ids] + 10.0) * 16.0)
        rec[:, 3:6] = q8[ids][:, 1:4]
        rec[:, 6] = _to_u8(1.0 / (1.0 + np.exp(-op[ids])) * 255.0)
        rec[:, 7:10] = _to_u8(sh0[ids] * (COLOR_SCALE * 255.0) + 127.5)
        flat = shN[ids][:, :coeffs, :].reshape(len(ids), -1)
        for j in range(3 * coeffs):
            bits = 5 if j < 9 else 4
            rec[:, 10 + j] = _quantize_sh(flat[:, j], 1 << (8 - bits))
        out.append(rec.tobytes())

    with open(path, "wb") as f:
        f.write(b"".join(out))


def load_dvsplat(path: str, *, device="cuda") -> tuple[GaussianParams, dict]:
    with open(path, "rb") as f:
        raw = f.read()
    n, nchunks, n0, n1, n2, n3, _flag = struct.unpack("<7I", raw[:28])
    counts = [n0, n1, n2, n3]
    off = 28
    chunk_bounds = np.frombuffer(raw[off: off + nchunks * 24], "<f4"
                                 ).reshape(nchunks, 6)
    off += nchunks * 24
    packed_pos = np.frombuffer(raw[off: off + n * 4], "<u4")
    off += n * 4

    ci = np.minimum(np.arange(n) // 256, nchunks - 1)
    pmin, pmax = chunk_bounds[ci, 0:3], chunk_bounds[ci, 3:6]
    means = pmin + np.stack(_unpack_111011(packed_pos), 1) * (pmax - pmin)

    scales = np.zeros((n, 3), np.float32)
    quats = np.zeros((n, 4), np.float32)
    opacity = np.zeros(n, np.float32)
    sh0 = np.zeros((n, 3), np.float32)
    shN = np.zeros((n, 15, 3), np.float32)

    cursor = 0
    for sd in range(4):
        c = counts[sd]
        if c == 0:
            continue
        coeffs = _COEFFS[sd]
        stride = 10 + 3 * coeffs
        rec = np.frombuffer(raw[off: off + c * stride], np.uint8
                            ).reshape(c, stride)
        off += c * stride
        sl = slice(cursor, cursor + c)
        scales[sl] = rec[:, 0:3].astype(np.float32) / 16.0 - 10.0
        xyz = (rec[:, 3:6].astype(np.float32) - 127.5) / 127.5
        w = np.sqrt(np.clip(1.0 - np.sum(xyz ** 2, 1), 0, 1))
        quats[sl] = np.concatenate([w[:, None], xyz], 1)
        a = np.clip(rec[:, 6].astype(np.float32) / 255.0, 1e-4, 1 - 1e-4)
        opacity[sl] = -np.log(1.0 / a - 1.0)
        sh0[sl] = ((rec[:, 7:10].astype(np.float32) / 255.0 - 0.5)
                   / COLOR_SCALE)
        if coeffs:
            flat = (rec[:, 10:].astype(np.float32) - 128.0) / 128.0
            shN[sl, :coeffs, :] = flat.reshape(c, coeffs, 3)
        cursor += c

    params = GaussianParams.create(
        means.astype(np.float32), scales=scales, quats=quats,
        opacity=opacity, sh0=sh0, shN=shN, sh_degree=3, device=device)
    return params, {}
