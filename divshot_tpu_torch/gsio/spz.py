"""Niantic ``.spz`` codec (counterpart of ``divshot_tpu/gsio/spz.py``):
gzip-wrapped packed gaussians, header magic NGSP 0x5053474e version 3,
24-bit fixed-point positions (12 fractional bits), uint8 log-scales
((s + 10) * 16), smallest-three quaternions (a 2-bit index and 3 x (sign +
9 bits) in a little-endian uint32), uint8 sigmoid alphas, uint8 colours
(c * 0.15 * 255 + 127.5) and uint8 SH (x * 128 + 128, bucketed to 5 / 4
bits on save).

Payload order: header, positions, alphas, colours, scales, rotations, SH.
Quaternions are stored (x, y, z, w). The payload is the JAX package's
byte for byte; ``gzip.compress`` stamps the time into the gzip header, so
two files of one payload differ there.
"""

from __future__ import annotations

import gzip
import struct

import numpy as np

from divshot_tpu_torch.splat.gaussians import GaussianParams

MAGIC = 0x5053474E
COLOR_SCALE = 0.15
FLAG_ANTIALIASED = 0x1
_DIM_FOR_DEGREE = {0: 0, 1: 3, 2: 8, 3: 15}
_DEGREE_FOR_DIM = {v: k for k, v in _DIM_FOR_DEGREE.items()}
SQRT1_2 = np.sqrt(0.5)


def _cpp_round(x):
    """``std::round``: half away from zero (``np.round`` rounds half to
    even)."""
    return np.trunc(x + np.copysign(0.5, x))


def _to_u8(x):
    return np.clip(_cpp_round(x), 0, 255).astype(np.uint8)


def _quantize_sh(x: np.ndarray, bucket: int) -> np.ndarray:
    """Round, bucket to the nearest centre with C++'s truncating integer
    division, clamp."""
    q = _cpp_round(x * 128.0) + 128.0
    q = np.trunc((q + bucket // 2) / bucket) * bucket
    return np.clip(q, 0, 255).astype(np.uint8)


def _pack_quat_smallest_three(quats_wxyz: np.ndarray) -> np.ndarray:
    """(N, 4) wxyz -> (N, 4) uint8, the packed uint32 little-endian."""
    q = quats_wxyz / np.linalg.norm(quats_wxyz, axis=1,
                                    keepdims=True).clip(1e-12)
    xyzw = q[:, [1, 2, 3, 0]]
    largest = np.argmax(np.abs(xyzw), axis=1)
    lv = np.take_along_axis(xyzw, largest[:, None], 1)[:, 0]
    negate = lv < 0
    comp = largest.astype(np.uint32)
    for i in range(4):
        qi = xyzw[:, i]
        negbit = ((qi < 0) ^ negate).astype(np.uint32)
        mag = np.minimum(
            (np.abs(qi) / SQRT1_2 * 511.0 + 0.5).astype(np.uint32), 511)
        field = (negbit << 9) | mag
        comp = np.where(i == largest, comp, (comp << 10) | field)
    return comp.astype("<u4").view(np.uint8).reshape(-1, 4)


def _unpack_quat_smallest_three(raw: np.ndarray) -> np.ndarray:
    """(N, 4) uint8 -> (N, 4) wxyz."""
    comp = raw.reshape(-1, 4).copy().view("<u4")[:, 0]
    largest = (comp >> 30).astype(np.int64)
    xyzw = np.zeros((len(comp), 4), np.float32)
    fields = [(comp >> 20) & 0x3FF, (comp >> 10) & 0x3FF, comp & 0x3FF]
    for li in range(4):
        m = largest == li
        others = [i for i in range(4) if i != li]
        ssum = np.zeros(m.sum(), np.float32)
        for k, oi in enumerate(others):
            f = fields[k][m]
            mag = (f & 0x1FF).astype(np.float32) / 511.0 * SQRT1_2
            sign = np.where((f >> 9) & 1, -1.0, 1.0)
            xyzw[m, oi] = sign * mag
            ssum += (sign * mag) ** 2
        xyzw[m, li] = np.sqrt(np.clip(1.0 - ssum, 0, 1))
    return xyzw[:, [3, 0, 1, 2]]


def save_spz(path: str, params: GaussianParams, *,
             antialiased: bool = False, fractional_bits: int = 12) -> None:
    d = params.compact_numpy()
    n = d["means"].shape[0]
    sh_dim = d["shN"].shape[1]
    sh_degree = _DEGREE_FOR_DIM.get(sh_dim, 3)

    header = struct.pack("<IIIBBBB", MAGIC, 3, n, sh_degree,
                         fractional_bits,
                         FLAG_ANTIALIASED if antialiased else 0, 0)
    scale = float(1 << fractional_bits)
    fixed = _cpp_round(d["means"].astype(np.float64) * scale).astype(np.int32)
    pos_bytes = np.zeros((n, 3, 3), np.uint8)
    for b in range(3):
        pos_bytes[:, :, b] = (fixed >> (8 * b)).astype(np.uint32) & 0xFF

    alphas = _to_u8(1.0 / (1.0 + np.exp(-d["opacity"])) * 255.0)
    colors = _to_u8(d["sh0"] * (COLOR_SCALE * 255.0) + 127.5)
    scales = _to_u8((d["scales"] + 10.0) * 16.0)
    rots = _pack_quat_smallest_three(d["quats"])

    sh_bytes = np.zeros((n, 0), np.uint8)
    if sh_degree > 0:
        sh = np.zeros((n, sh_dim, 3), np.uint8)
        for k in range(sh_dim):
            bits = 5 if k < 3 else 4
            sh[:, k, :] = _quantize_sh(d["shN"][:, k, :], 1 << (8 - bits))
        sh_bytes = sh.reshape(n, -1)
    payload = (header + pos_bytes.tobytes() + alphas.tobytes()
               + colors.tobytes() + scales.tobytes() + rots.tobytes()
               + sh_bytes.tobytes())
    with open(path, "wb") as f:
        f.write(gzip.compress(payload))


def load_spz(path: str, *, device="cuda") -> tuple[GaussianParams, dict]:
    with open(path, "rb") as f:
        payload = gzip.decompress(f.read())
    magic, version, n, sh_degree, fractional_bits, flags, _ = struct.unpack(
        "<IIIBBBB", payload[:16])
    if magic != MAGIC:
        raise ValueError("not an SPZ file")
    if version not in (2, 3):
        raise ValueError(f"unsupported SPZ version {version}")
    sh_dim = _DIM_FOR_DEGREE[sh_degree]
    off = 16

    pos_bytes = np.frombuffer(payload[off: off + n * 9], np.uint8
                              ).reshape(n, 3, 3)
    off += n * 9
    fixed = (pos_bytes[:, :, 0].astype(np.int32)
             | (pos_bytes[:, :, 1].astype(np.int32) << 8)
             | (pos_bytes[:, :, 2].astype(np.int32) << 16))
    fixed = np.where(fixed & 0x800000, fixed - (1 << 24), fixed)
    means = fixed.astype(np.float32) / (1 << fractional_bits)

    alphas = np.frombuffer(payload[off: off + n], np.uint8)
    off += n
    a = np.clip(alphas.astype(np.float32) / 255.0, 1e-4, 1 - 1e-4)
    opacity = -np.log(1.0 / a - 1.0)

    colors = np.frombuffer(payload[off: off + n * 3], np.uint8).reshape(n, 3)
    off += n * 3
    sh0 = (colors.astype(np.float32) / 255.0 - 0.5) / COLOR_SCALE

    scales_u8 = np.frombuffer(payload[off: off + n * 3], np.uint8
                              ).reshape(n, 3)
    off += n * 3
    scales = scales_u8.astype(np.float32) / 16.0 - 10.0

    rot_bytes = 4 if version >= 3 else 3
    rots_raw = np.frombuffer(payload[off: off + n * rot_bytes], np.uint8)
    off += n * rot_bytes
    if version >= 3:
        quats = _unpack_quat_smallest_three(rots_raw)
    else:  # the first-three format
        r = rots_raw.reshape(n, 3).astype(np.float32) / 127.5 - 1.0
        w = np.sqrt(np.clip(1.0 - np.sum(r ** 2, 1), 0, 1))
        quats = np.concatenate([w[:, None], r], 1)

    shN = None
    if sh_dim:
        sh_raw = np.frombuffer(payload[off: off + n * sh_dim * 3], np.uint8)
        shN = ((sh_raw.reshape(n, sh_dim, 3).astype(np.float32) - 128.0)
               / 128.0)

    params = GaussianParams.create(
        means, scales=scales, quats=quats, opacity=opacity, sh0=sh0,
        shN=shN, sh_degree=sh_degree, device=device)
    return params, {"antialiased": bool(flags & FLAG_ANTIALIASED)}
