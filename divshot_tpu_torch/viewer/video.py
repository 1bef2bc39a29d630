"""Motion-JPEG AVI writer (counterpart of ``divshot_tpu/viewer/video.py``):
the container is JAX's, byte for byte; each frame is encoded by the
port's own baseline JPEG encoder (``viewer/jpeg.py``, 4:2:0, libjpeg's
quality tables) in place of Pillow's.
"""

from __future__ import annotations

import struct

import numpy as np
import torch

from divshot_tpu_torch.viewer.jpeg import encode_jpeg


def to_uint8(img) -> torch.Tensor:
    """An (H, W, 3) uint8 or [0, 1] float image (tensor or numpy) as a
    uint8 tensor on its device: float clipped, scaled by 255 and
    truncated, as JAX's ``astype(np.uint8)``."""
    img = torch.as_tensor(img)
    if img.dtype != torch.uint8:
        img = (torch.clamp(img, 0, 1) * 255).to(torch.uint8)
    return img


class MJPEGWriter:
    def __init__(self, path: str, fps: int = 30, quality: int = 90):
        self.path = path
        self.fps = fps
        self.quality = quality
        self.frames: list[bytes] = []
        self.size: tuple[int, int] | None = None

    def add_frame(self, img) -> None:
        """img: (H, W, 3) uint8, or float in [0, 1]; a tensor is encoded
        on its device."""
        img = to_uint8(img)
        h, w = img.shape[:2]
        if self.size is None:
            self.size = (w, h)
        assert self.size == (w, h), "frame size changed"
        data = encode_jpeg(img, self.quality)
        if len(data) % 2:
            data += b"\x00"
        self.frames.append(data)

    def close(self) -> None:
        if not self.frames or self.size is None:
            raise ValueError("no frames")
        w, h = self.size
        n = len(self.frames)

        def chunk(fourcc: bytes, payload: bytes) -> bytes:
            return fourcc + struct.pack("<I", len(payload)) + payload \
                + (b"\x00" if len(payload) % 2 else b"")

        def lst(fourcc: bytes, payload: bytes) -> bytes:
            return chunk(b"LIST", fourcc + payload)

        max_size = max(len(f) for f in self.frames)
        avih = struct.pack(
            "<14I",
            int(1e6 / self.fps), max_size * self.fps, 0, 0x10,  # HASINDEX
            n, 0, 1, max_size, w, h, 0, 0, 0, 0)
        strh = (b"vids" + b"MJPG" + struct.pack(
            "<IHHIIIIIIII", 0, 0, 0, 0, 1, self.fps, 0, n, max_size, 0, 0)
            + struct.pack("<4H", 0, 0, w, h))
        strf = struct.pack("<IiiHH4sIiiII", 40, w, h, 1, 24, b"MJPG",
                           w * h * 3, 0, 0, 0, 0)
        hdrl = lst(b"hdrl", chunk(b"avih", avih)
                   + lst(b"strl", chunk(b"strh", strh) + chunk(b"strf", strf)))

        movi_payload = b"".join(chunk(b"00dc", f) for f in self.frames)
        movi = lst(b"movi", movi_payload)

        idx = b""
        off = 4
        for f in self.frames:
            sz = len(f)
            idx += b"00dc" + struct.pack("<III", 0x10, off, sz)
            off += 8 + sz + (sz % 2)
        idx1 = chunk(b"idx1", idx)

        riff_payload = b"AVI " + hdrl + movi + idx1
        with open(self.path, "wb") as f:
            f.write(b"RIFF" + struct.pack("<I", len(riff_payload))
                    + riff_payload)


def read_mjpeg_avi(path: str) -> list[bytes]:
    """The frame payloads of an AVI written by ``MJPEGWriter``, found
    through its ``idx1`` (offsets from the ``movi`` list's fourcc) and
    checked against the ``00dc`` chunks they point at; raises
    ``ValueError`` on any mismatch."""
    data = open(path, "rb").read()
    if data[:4] != b"RIFF" or data[8:12] != b"AVI ":
        raise ValueError("not a RIFF AVI file")
    if struct.unpack("<I", data[4:8])[0] != len(data) - 8:
        raise ValueError("RIFF size does not match the file")
    movi = data.find(b"LIST", 12)
    while movi >= 0 and data[movi + 8:movi + 12] != b"movi":
        size = struct.unpack("<I", data[movi + 4:movi + 8])[0]
        movi = data.find(b"LIST", movi + 8 + size)
    if movi < 0:
        raise ValueError("no movi list")
    base = movi + 8
    end = base + struct.unpack("<I", data[movi + 4:movi + 8])[0]
    if data[end:end + 4] != b"idx1":
        raise ValueError("no idx1 after the movi list")
    n_idx = struct.unpack("<I", data[end + 4:end + 8])[0] // 16
    frames = []
    for i in range(n_idx):
        fourcc, _flags, off, size = struct.unpack(
            "<4sIII", data[end + 8 + 16 * i:end + 24 + 16 * i])
        at = base + off
        if fourcc != b"00dc" or data[at:at + 4] != b"00dc" or \
                struct.unpack("<I", data[at + 4:at + 8])[0] != size:
            raise ValueError(f"idx1 entry {i} does not point at its chunk")
        frames.append(data[at + 8:at + 8 + size])
    return frames


def write_video(path: str, frames, fps: int = 30, quality: int = 90) -> None:
    wtr = MJPEGWriter(path, fps=fps, quality=quality)
    for fr in frames:
        wtr.add_frame(fr if isinstance(fr, torch.Tensor) else np.asarray(fr))
    wtr.close()
