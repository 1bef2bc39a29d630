"""PNG reading and writing, and resizing, on the standard library
and numpy: the port's stand-in for the Pillow calls of
``divshot_tpu/gsio/datasets.py:_load_image`` and
``divshot_tpu/gsio/procedural.py:generate_dataset``.

- ``read_png``: 8-bit greyscale, RGB and RGBA, not interlaced, every row
  filter (None, Sub, Up, Average, Paeth: Pillow writes adaptive filters).
  Anything else (16-bit, palette, grey + alpha, interlaced) raises
  ``ValueError`` naming the format. None, Sub and Up are whole-row numpy
  operations; Average and Paeth depend on the pixel to the left, so they
  walk the row in Python, correct but slow.
- ``write_png``: greyscale, RGB or RGBA, every row unfiltered (None), so
  the port's own files decode at numpy speed.
- ``resize_lanczos``: Pillow's ``Image.resize(size, Image.LANCZOS)``, a
  separable three-lobe Lanczos whose support widens with the downscale,
  horizontal pass first, each pass in Pillow's 22-bit fixed point and
  rounded to uint8 (``ImagingResample``); RGBA goes through premultiplied
  alpha as Pillow's ``RGBa`` mode does. ``resize_bicubic`` is the same
  pipeline with Pillow's bicubic kernel (a = -0.5, support 2), its default
  ``Image.resize(size)``, for the environment plate of
  ``divshot_tpu/scene/components.py``.
- ``png_size``: the width and height from the IHDR chunk alone
  (``gsio/image.image_size``).
- ``resize_nearest`` and ``to_grey``: Pillow's ``Image.NEAREST`` resize and
  ``convert("L")``, for the masks of ``divshot_tpu/gsio/datasets.py``.
"""

from __future__ import annotations

import math
import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> channels; 3 (palette) and 4 (grey + alpha) are not read
_CHANNELS = {0: 1, 2: 3, 6: 4}
_COLOUR_NAMES = {0: "greyscale", 2: "RGB", 3: "palette", 4: "greyscale + "
                 "alpha (LA)", 6: "RGBA"}


def _chunks(data: bytes):
    pos = len(_SIGNATURE)
    while pos + 8 <= len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        yield tag, data[pos + 8:pos + 8 + length]
        if tag == b"IEND":
            return
        pos += 12 + length
    raise ValueError("PNG ends without an IEND chunk")


def _unfilter_average(row: bytearray, prev: bytes, bpp: int) -> None:
    for i in range(len(row)):
        a = row[i - bpp] if i >= bpp else 0
        row[i] = (row[i] + ((a + prev[i]) >> 1)) & 0xFF


def _unfilter_paeth(row: bytearray, prev: bytes, bpp: int) -> None:
    for i in range(len(row)):
        if i >= bpp:
            a, c = row[i - bpp], prev[i - bpp]
        else:
            a = c = 0
        b = prev[i]
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        row[i] = (row[i] + pred) & 0xFF


def png_size(path: str) -> tuple[int, int] | None:
    """(width, height) from a PNG's IHDR chunk; None when the file is not
    a PNG."""
    with open(path, "rb") as f:
        head = f.read(24)
    if len(head) < 24 or head[:8] != _SIGNATURE or head[12:16] != b"IHDR":
        return None
    return struct.unpack(">II", head[16:24])


def read_png(path: str) -> np.ndarray:
    """-> uint8 (H, W) for greyscale, (H, W, 3) for RGB, (H, W, 4) for
    RGBA."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(_SIGNATURE):
        raise ValueError(f"{path}: not a PNG file")
    header, idat = None, []
    for tag, body in _chunks(data):
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError(f"{path}: PNG without an IHDR chunk")
    w, h, depth, colour, _comp, _filt, interlace = header
    if colour not in _CHANNELS:
        raise ValueError(f"{path}: {_COLOUR_NAMES.get(colour, colour)} PNG "
                         f"is not supported (8-bit greyscale, RGB or RGBA "
                         f"only)")
    if depth != 8:
        raise ValueError(f"{path}: {depth}-bit PNG is not supported (8-bit "
                         f"only)")
    if interlace:
        raise ValueError(f"{path}: interlaced PNG is not supported")
    ch = _CHANNELS[colour]
    stride = w * ch
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size < h * (stride + 1):
        raise ValueError(f"{path}: truncated image data")
    raw = raw[:h * (stride + 1)].reshape(h, stride + 1)
    out = np.empty((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        ftype, row = raw[y, 0], raw[y, 1:]
        if ftype == 0:
            cur = row
        elif ftype == 1:    # Sub: a running sum per channel, mod 256
            cur = np.cumsum(row.reshape(w, ch), 0, dtype=np.uint8
                            ).reshape(stride)
        elif ftype == 2:    # Up
            cur = row + prev
        elif ftype in (3, 4):
            buf = bytearray(row.tobytes())
            (_unfilter_average if ftype == 3 else _unfilter_paeth)(
                buf, prev.tobytes(), ch)
            cur = np.frombuffer(bytes(buf), np.uint8)
        else:
            raise ValueError(f"{path}: unknown PNG row filter {ftype}")
        out[y] = cur
        prev = out[y]
    return out.reshape(h, w) if ch == 1 else out.reshape(h, w, ch)


def write_png(path: str, img: np.ndarray) -> None:
    """Write an (H, W) greyscale, (H, W, 3) RGB or (H, W, 4) RGBA uint8
    image as an 8-bit PNG, every row unfiltered (filter None)."""
    img = np.ascontiguousarray(img, np.uint8)
    if img.ndim == 2:
        img = img[..., None]
    h, w, ch = img.shape
    colour = {1: 0, 3: 2, 4: 6}[ch]
    raw = np.concatenate([np.zeros((h, 1), np.uint8),
                          img.reshape(h, w * ch)], axis=1)

    def chunk(tag: bytes, data: bytes) -> bytes:
        body = tag + data
        return (struct.pack(">I", len(data)) + body
                + struct.pack(">I", zlib.crc32(body) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(_SIGNATURE)
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, colour, 0,
                                           0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)))
        f.write(chunk(b"IEND", b""))


# ---------------------------------------------------------------------------
# Lanczos and bicubic resize (Pillow's libImaging/Resample.c)

_PRECISION_BITS = 32 - 8 - 2


def _lanczos(x: np.ndarray) -> np.ndarray:
    def sinc(t):
        with np.errstate(invalid="ignore", divide="ignore"):
            s = np.sin(t * math.pi) / (t * math.pi)
        return np.where(t == 0.0, 1.0, s)
    return np.where((x >= -3.0) & (x < 3.0), sinc(x) * sinc(x / 3.0), 0.0)


def _bicubic(x: np.ndarray) -> np.ndarray:
    """Pillow's ``bicubic_filter`` (a = -0.5), support 2."""
    a = -0.5
    x = np.abs(x)
    near = ((a + 2.0) * x - (a + 3.0)) * x * x + 1
    far = (((x - 5) * x + 8) * x - 4) * a
    return np.where(x < 1.0, near, np.where(x < 2.0, far, 0.0))


# each filter's kernel and support, as Pillow's ``struct filter``
_FILTERS = {"lanczos": (_lanczos, 3.0), "bicubic": (_bicubic, 2.0)}


def _coeffs(in_size: int, out_size: int, kind: str = "lanczos"):
    """-> (first input index (out,), fixed-point weights (out, ksize)) of
    one axis, as Pillow's ``precompute_coeffs`` and
    ``normalize_coeffs_8bpc`` make them."""
    kernel, base_support = _FILTERS[kind]
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = base_support * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    center = (np.arange(out_size) + 0.5) * scale
    xmin = np.maximum((center - support + 0.5).astype(np.int64), 0)
    xmax = np.minimum((center + support + 0.5).astype(np.int64), in_size) \
        - xmin
    x = np.arange(ksize)
    w = kernel((x[None, :] + xmin[:, None] - center[:, None] + 0.5)
               / filterscale)
    w = np.where(x[None, :] < xmax[:, None], w, 0.0)
    ww = w.sum(1, keepdims=True)
    w = np.where(ww != 0.0, w / np.where(ww != 0.0, ww, 1.0), w)
    w = w * (1 << _PRECISION_BITS)
    k = np.where(w < 0, -0.5 + w, 0.5 + w).astype(np.int64)  # C truncation
    return xmin, k


def _resample_axis0(img: np.ndarray, out_size: int,
                    kind: str = "lanczos") -> np.ndarray:
    """Resample axis 0 of a uint8 (N, ...) array to ``out_size``."""
    xmin, k = _coeffs(img.shape[0], out_size, kind)
    ksize = k.shape[1]
    src = np.concatenate([img.astype(np.int64),
                          np.zeros((ksize,) + img.shape[1:], np.int64)])
    k = k.reshape(k.shape + (1,) * (img.ndim - 1))
    ss = np.full((out_size,) + img.shape[1:], 1 << (_PRECISION_BITS - 1),
                 np.int64)
    for j in range(ksize):
        ss += src[xmin + j] * k[:, j]
    return np.clip(ss >> _PRECISION_BITS, 0, 255).astype(np.uint8)


def _premultiply(img: np.ndarray) -> np.ndarray:
    """RGBA -> Pillow's ``RGBa`` (``rgbA2rgba``: MULDIV255)."""
    out = img.copy()
    a = img[..., 3:4].astype(np.uint32)
    t = img[..., :3].astype(np.uint32) * a + 128
    out[..., :3] = ((t >> 8) + t) >> 8
    return out


def _unpremultiply(img: np.ndarray) -> np.ndarray:
    """Pillow's ``RGBa`` -> RGBA (``rgba2rgbA``)."""
    out = img.copy()
    a = img[..., 3:4].astype(np.int64)
    div = np.minimum((255 * img[..., :3].astype(np.int64))
                     // np.maximum(a, 1), 255)
    keep = (a == 0) | (a == 255)
    out[..., :3] = np.where(keep, img[..., :3], div).astype(np.uint8)
    return out


def resize_lanczos(img: np.ndarray, width: int, height: int,
                   kind: str = "lanczos") -> np.ndarray:
    """Resize a uint8 (H, W), (H, W, 3) or (H, W, 4) image to
    ``width`` x ``height`` as Pillow's LANCZOS (or, with ``kind``
    "bicubic", its BICUBIC) does: the horizontal pass rounded to uint8,
    then the vertical pass."""
    h, w = img.shape[:2]
    if (width, height) == (w, h):      # Pillow returns a copy, untouched
        return img.copy()
    rgba = img.ndim == 3 and img.shape[2] == 4
    out = _premultiply(img) if rgba else img
    if width != w:
        out = np.swapaxes(_resample_axis0(np.swapaxes(out, 0, 1), width,
                                          kind), 0, 1)
    if height != h:
        out = _resample_axis0(out, height, kind)
    out = np.ascontiguousarray(out)
    return _unpremultiply(out) if rgba else out


def resize_bicubic(img: np.ndarray, width: int, height: int) -> np.ndarray:
    """Pillow's default ``Image.resize(size)`` (BICUBIC) of a uint8 image."""
    return resize_lanczos(img, width, height, kind="bicubic")


def to_grey(img: np.ndarray) -> np.ndarray:
    """Pillow's ``convert("L")``: greyscale as is; RGB and RGBA (alpha
    ignored) by ITU-R 601-2 luma in its 16-bit fixed point, rounded."""
    if img.ndim == 2:
        return img
    rgb = img[..., :3].astype(np.uint32)
    return ((rgb[..., 0] * 19595 + rgb[..., 1] * 38470 + rgb[..., 2] * 7471
             + 0x8000) >> 16).astype(np.uint8)


def _nearest_index(in_size: int, out_size: int) -> np.ndarray:
    """The source index of each output position: Pillow walks the centres
    as a float64 running sum, start ``scale / 2``, step ``scale``, and
    truncates (``ImagingScaleAffine``)."""
    scale = in_size / out_size
    pos = np.add.accumulate(np.concatenate(
        [[scale * 0.5], np.full(out_size - 1, scale)]))
    return np.minimum(pos.astype(np.int64), in_size - 1)


def resize_nearest(img: np.ndarray, width: int, height: int) -> np.ndarray:
    """Pillow's ``Image.resize(size, Image.NEAREST)`` of an (H, W) or
    (H, W, C) uint8 image."""
    return img[_nearest_index(img.shape[0], height)][
        :, _nearest_index(img.shape[1], width)]
