"""Radiance ``.hdr`` (RGBE) reading, the port's own: the stand-in for
``imageio.v3.imread`` of a Radiance file in
``divshot_tpu/scene/components.py`` (``Environment.load_hdr``).

``imageio`` reads such a file through its OpenCV plugin, which decodes the
RGBE pixels to float (``rgbe2float``: each mantissa times 2^(e - 136), 0
where e is 0) and converts them to 8 bits as ``convertTo(CV_8U, 255)``
does: each value times 255, rounded half to even and saturated. So
``read_hdr`` returns uint8 (H, W, 3) RGB, and so does JAX's plate there;
the value times 255 is exact in float64 (a mantissa below 256 times 255),
so the rounding here is that one's.

Scanlines: new-style run-length encoded ones and flat RGBE quadruples. As
in the Radiance reference reader that OpenCV carries, the first scanline
decides: if it is flat, the rest of the image is read flat. Only the
standard orientation ``-Y h +X w`` is read; the others, and the XYZE
format, raise ``ValueError``.
"""

from __future__ import annotations

import numpy as np


def is_hdr(head: bytes) -> bool:
    return head.startswith(b"#?")


def _header(data: bytes, path: str) -> tuple[int, int, int]:
    """-> (height, width, the offset of the pixel data)."""
    pos = 0
    fmt = None
    while True:
        end = data.find(b"\n", pos)
        if end < 0:
            raise ValueError(f"{path}: truncated Radiance header")
        line = data[pos:end].strip()
        pos = end + 1
        if not line:
            break
        if line.startswith(b"FORMAT="):
            fmt = line[7:].decode("ascii", "replace")
    if fmt not in (None, "32-bit_rle_rgbe"):
        raise ValueError(f"{path}: Radiance FORMAT={fmt} is not supported "
                         f"(32-bit_rle_rgbe only)")
    end = data.find(b"\n", pos)
    tok = data[pos:end if end >= 0 else len(data)].split()
    if len(tok) != 4 or tok[0] != b"-Y" or tok[2] != b"+X":
        raise ValueError(f"{path}: Radiance orientation "
                         f"{b' '.join(tok).decode('ascii', 'replace')!r} is "
                         f"not supported (-Y h +X w only)")
    return int(tok[1]), int(tok[3]), (end + 1 if end >= 0 else len(data))


def _rle_line(data: bytes, pos: int, w: int, path: str
              ) -> tuple[np.ndarray, int]:
    """One new-style run-length encoded scanline (its 4-byte header
    already read) -> ((w, 4) uint8, the position after it)."""
    line = np.empty((4, w), np.uint8)
    for ch in range(4):
        x = 0
        while x < w:
            if pos >= len(data):
                raise ValueError(f"{path}: truncated Radiance scanline")
            count = data[pos]
            pos += 1
            if count > 128:                         # a run
                count -= 128
                if count > w - x or pos >= len(data):
                    raise ValueError(f"{path}: bad Radiance run length")
                line[ch, x:x + count] = data[pos]
                pos += 1
            else:                                   # literal bytes
                if count == 0 or count > w - x:
                    raise ValueError(f"{path}: bad Radiance run length")
                line[ch, x:x + count] = np.frombuffer(
                    data[pos:pos + count], np.uint8)
                pos += count
            x += count
    return line.T, pos


def rgbe_pixels(path: str) -> np.ndarray:
    """The raw RGBE quadruples, (H, W, 4) uint8."""
    with open(path, "rb") as f:
        data = f.read()
    if not is_hdr(data):
        raise ValueError(f"{path}: not a Radiance file")
    h, w, pos = _header(data, path)
    out = np.empty((h, w, 4), np.uint8)
    for y in range(h):
        head = data[pos:pos + 4]
        if (8 <= w <= 0x7FFF and len(head) == 4 and head[0] == 2
                and head[1] == 2 and not head[2] & 0x80):
            if (head[2] << 8 | head[3]) != w:
                raise ValueError(f"{path}: Radiance scanline width "
                                 f"mismatch")
            out[y], pos = _rle_line(data, pos + 4, w, path)
            continue
        # flat from here to the end of the image
        rest = np.frombuffer(data[pos:pos + (h - y) * w * 4], np.uint8)
        if rest.size != (h - y) * w * 4:
            raise ValueError(f"{path}: truncated Radiance pixel data")
        out[y:] = rest.reshape(h - y, w, 4)
        break
    return out


def read_hdr(path: str) -> np.ndarray:
    """-> uint8 (H, W, 3) RGB, each float value times 255, rounded half to
    even and saturated, as ``imageio.v3.imread`` gives it through OpenCV."""
    px = rgbe_pixels(path)
    e = px[..., 3:4].astype(np.float64)
    val = px[..., :3].astype(np.float64) * 255.0 * np.exp2(e - 136.0)
    val = np.where(e > 0, val, 0.0)
    return np.clip(np.rint(val), 0, 255).astype(np.uint8)
