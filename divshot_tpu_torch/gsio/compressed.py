"""PlayCanvas compressed PLY codec (counterpart of
``divshot_tpu/gsio/compressed.py``), byte for byte the files the JAX
package writes:

- splats Morton-ordered (21-bit interleaved code over the positions
  normalised to the global bounding box);
- 256-splat chunks; a ``chunk`` element of 12 float32 bounds a chunk (min
  and max xyz position, min and max xyz log-scale);
- a ``vertex`` element of 4 uint32 a splat: ``packed_position`` (11-10-11
  in the chunk's bounds), ``packed_rotation`` (a 2-bit index of the
  largest component and 3 x 10 bits of the others), ``packed_scale``
  (11-10-11), ``packed_color`` (8888: rgb = SH_C0 f_dc + 0.5, a =
  sigmoid(opacity));
- the SH rest dropped; the antialiasing flag as in the standard PLY.

The packing is numpy on the host. ``morton_order`` codes through the host
library's multithreaded C++ coder (``core/native.py``) when it is built,
as JAX does, and with numpy when it is not; the two can differ at a
bucket edge by float rounding, each as in JAX (``tests/test_torch_jpeg.py``
holds both against JAX's).
"""

from __future__ import annotations

import io

import numpy as np

from divshot_tpu_torch.gsio.ply import read_ply_header
from divshot_tpu_torch.splat.gaussians import GaussianParams

SH_C0 = 0.28209479177387814

CHUNK_PROPS = ["min_x", "min_y", "min_z", "max_x", "max_y", "max_z",
               "min_scale_x", "min_scale_y", "min_scale_z",
               "max_scale_x", "max_scale_y", "max_scale_z"]
VERTEX_PROPS = ["packed_position", "packed_rotation", "packed_scale",
                "packed_color"]


def morton_order(pos: np.ndarray) -> np.ndarray:
    """Sort order by the 21-bit-per-axis interleaved Morton code of the
    positions in their bounding box (stable)."""
    from divshot_tpu_torch.core import native
    codes = native.morton_codes(np.asarray(pos, np.float32))
    if codes is not None:
        return np.argsort(codes, kind="stable")
    pos = np.asarray(pos, np.float32)
    pmin = pos.min(0)
    pmax = pos.max(0)
    rel = (pos - pmin) / np.where(pmax - pmin > 0, pmax - pmin, 1.0)
    xyz = (rel * ((1 << 21) - 1)).astype(np.uint64)
    code = np.zeros(len(pos), np.uint64)
    for i in range(21):
        code |= (xyz[:, 0] & np.uint64(1 << i)) << np.uint64(2 * i + 0)
        code |= (xyz[:, 1] & np.uint64(1 << i)) << np.uint64(2 * i + 1)
        code |= (xyz[:, 2] & np.uint64(1 << i)) << np.uint64(2 * i + 2)
    return np.argsort(code, kind="stable")


def _pack_unorm(x: np.ndarray, bits: int) -> np.ndarray:
    t = (1 << bits) - 1
    return np.clip(np.floor(x * t + 0.5), 0, t).astype(np.uint32)


def _unpack_unorm(p: np.ndarray, bits: int) -> np.ndarray:
    m = (1 << bits) - 1
    return (p & m).astype(np.float32) / m


def _pack_111011(x, y, z) -> np.ndarray:
    return (_pack_unorm(x, 11) << 21) | (_pack_unorm(y, 10) << 11) \
        | _pack_unorm(z, 11)


def _unpack_111011(p):
    return (_unpack_unorm(p >> 21, 11), _unpack_unorm(p >> 11, 10),
            _unpack_unorm(p, 11))


def _pack_rot(quats: np.ndarray) -> np.ndarray:
    """quats (N, 4) in storage order (w, x, y, z)."""
    q = quats / np.linalg.norm(quats, axis=1, keepdims=True).clip(1e-12)
    largest = np.argmax(np.abs(q), axis=1)
    sign = np.sign(np.take_along_axis(q, largest[:, None], 1)[:, 0])
    sign = np.where(sign == 0, 1.0, sign)
    q = q * sign[:, None]
    norm = np.sqrt(2.0) * 0.5
    out = largest.astype(np.uint32)
    for i in range(4):
        comp = _pack_unorm(q[:, i] * norm + 0.5, 10)
        out = np.where(i == largest, out, (out << 10) | comp)
    return out.astype(np.uint32)


def _unpack_rot(p: np.ndarray) -> np.ndarray:
    largest = (p >> 30).astype(np.int64)
    norm = np.sqrt(2.0) * 0.5
    c0 = (_unpack_unorm(p >> 20, 10) - 0.5) / norm
    c1 = (_unpack_unorm(p >> 10, 10) - 0.5) / norm
    c2 = (_unpack_unorm(p, 10) - 0.5) / norm
    q = np.zeros((len(p), 4), np.float32)
    rest = np.stack([c0, c1, c2], 1)
    for li in range(4):
        m = largest == li
        others = [i for i in range(4) if i != li]
        for k, oi in enumerate(others):
            q[m, oi] = rest[m, k]
        q[m, li] = np.sqrt(np.clip(1.0 - np.sum(rest[m] ** 2, 1), 0, 1))
    return q


def _unit(x, lo, hi):
    """``x`` in [lo, hi] to [0, 1]; 0 where the range is below 1e-5."""
    rng = hi - lo
    return np.where(rng < 1e-5, 0.0, (x - lo) / np.where(rng == 0, 1, rng))


def save_compressed_ply(path: str, params: GaussianParams, *,
                        antialiased: bool = False) -> None:
    d = params.compact_numpy()
    order = morton_order(d["means"])
    pos = d["means"][order]
    scales = d["scales"][order]
    quats = d["quats"][order]
    sh0 = d["sh0"][order]
    op = d["opacity"][order]

    n = len(pos)
    nchunks = (n + 255) // 256
    chunk_data = np.zeros((nchunks, 12), np.float32)
    vert = np.zeros((n, 4), np.uint32)
    for ci in range(nchunks):
        s, e = ci * 256, min(n, (ci + 1) * 256)
        pmin, pmax = pos[s:e].min(0), pos[s:e].max(0)
        smin, smax = scales[s:e].min(0), scales[s:e].max(0)
        chunk_data[ci, 0:3] = pmin
        chunk_data[ci, 3:6] = pmax
        chunk_data[ci, 6:9] = smin
        chunk_data[ci, 9:12] = smax
        vert[s:e, 0] = _pack_111011(*[_unit(pos[s:e, i], pmin[i], pmax[i])
                                      for i in range(3)])
        vert[s:e, 2] = _pack_111011(*[_unit(scales[s:e, i], smin[i],
                                            smax[i]) for i in range(3)])

    vert[:, 1] = _pack_rot(quats)
    a = 1.0 / (1.0 + np.exp(-op))
    vert[:, 3] = ((_pack_unorm(sh0[:, 0] * SH_C0 + 0.5, 8) << 24)
                  | (_pack_unorm(sh0[:, 1] * SH_C0 + 0.5, 8) << 16)
                  | (_pack_unorm(sh0[:, 2] * SH_C0 + 0.5, 8) << 8)
                  | _pack_unorm(a, 8))

    header = io.BytesIO()
    header.write(b"ply\nformat binary_little_endian 1.0\n")
    header.write(b"comment generated by divshot_tpu\n")
    if antialiased:
        header.write(b"comment splatx.anti_aliasing=1\n")
    header.write(f"element chunk {nchunks}\n".encode())
    for p in CHUNK_PROPS:
        header.write(f"property float {p}\n".encode())
    header.write(f"element vertex {n}\n".encode())
    for p in VERTEX_PROPS:
        header.write(f"property uint {p}\n".encode())
    header.write(b"end_header\n")

    with open(path, "wb") as f:
        f.write(header.getvalue())
        f.write(chunk_data.astype("<f4").tobytes())
        f.write(vert.astype("<u4").tobytes())


def load_compressed_ply(path: str, *, device="cuda"
                        ) -> tuple[GaussianParams, dict]:
    with open(path, "rb") as f:
        elements, comments, _fmt = read_ply_header(f)
        body = f.read()
    chunk_el = next(e for e in elements if e.name == "chunk")
    vert_el = next(e for e in elements if e.name == "vertex")
    nchunks, n = chunk_el.count, vert_el.count

    chunk = np.frombuffer(body[: nchunks * 48], "<f4").reshape(nchunks, 12)
    vert = np.frombuffer(body[nchunks * 48: nchunks * 48 + n * 16],
                         "<u4").reshape(n, 4)

    ci = np.minimum(np.arange(n) // 256, nchunks - 1)
    pmin, pmax = chunk[ci, 0:3], chunk[ci, 3:6]
    smin, smax = chunk[ci, 6:9], chunk[ci, 9:12]

    pos = pmin + np.stack(_unpack_111011(vert[:, 0]), 1) * (pmax - pmin)
    scales = smin + np.stack(_unpack_111011(vert[:, 2]), 1) * (smax - smin)
    quats = _unpack_rot(vert[:, 1])
    sh0 = np.stack([(_unpack_unorm(vert[:, 3] >> s, 8) - 0.5) / SH_C0
                    for s in (24, 16, 8)], 1)
    av = np.clip(_unpack_unorm(vert[:, 3], 8), 1e-4, 1 - 1e-4)
    opacity = -np.log(1.0 / av - 1.0)

    antialiased = any("splatx.anti_aliasing=1" in c for c in comments)
    params = GaussianParams.create(
        pos.astype(np.float32), scales=scales.astype(np.float32),
        quats=quats, opacity=opacity.astype(np.float32),
        sh0=sh0.astype(np.float32), sh_degree=0, device=device)
    return params, {"antialiased": antialiased}
