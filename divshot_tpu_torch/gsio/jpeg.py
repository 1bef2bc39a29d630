"""JPEG decoding, the port's own: the stand-in for the Pillow reads of
``divshot_tpu/gsio/datasets.py`` (``Image.open`` then ``np.asarray``) for
JPEG files.

The markers are parsed here; the entropy decode and the pixels are the
host library's C++ (``native/jpeg_decode.cpp``, through
``core/native.py``), which follows libjpeg-turbo's default decompression
bit for bit: the ISLOW integer IDCT, fancy upsampling and its fixed-point
YCbCr -> RGB tables. So ``read_jpeg`` returns what Pillow returns.

Read: baseline (SOF0) and extended sequential (SOF1) Huffman files with
8-bit samples, greyscale (H, W) or three components (H, W, 3), any
integral sampling factors (4:4:4, 4:2:2, 4:2:0, 4:4:0), restart
intervals, interleaved or single-component scans, and the colour space as
libjpeg infers it (JFIF: YCbCr; Adobe APP14: its transform flag; else the
component ids). Progressive, arithmetic-coded, lossless, hierarchical and
12-bit files, and CMYK / YCCK (four components), raise ``ValueError``
naming the file and the feature. EXIF orientation is not applied, as
Pillow's ``Image.open`` does not apply it.

``jpeg_size`` reads the size from the SOF header alone;
``decode_coefficients`` returns the quantised DCT blocks the entropy
decode yields, in the order ``viewer/jpeg.quantized_blocks`` lists them.
"""

from __future__ import annotations

import struct

import numpy as np

_SOF_KINDS = {
    0xC2: "progressive", 0xC3: "lossless", 0xC5: "hierarchical",
    0xC6: "hierarchical progressive", 0xC7: "hierarchical lossless",
    0xC9: "arithmetic-coded", 0xCA: "arithmetic-coded progressive",
    0xCB: "arithmetic-coded lossless", 0xCD: "arithmetic-coded "
    "hierarchical", 0xCE: "arithmetic-coded hierarchical progressive",
    0xCF: "arithmetic-coded hierarchical lossless"}
_SCAN_ERRORS = {-1: "a bad Huffman code", -2: "a missing restart marker",
                -3: "an undefined or bad Huffman table"}


def _unsupported(path: str, what: str) -> ValueError:
    return ValueError(
        f"{path}: {what} JPEG is not supported; divshot_tpu_torch reads "
        f"baseline and extended sequential Huffman JPEG with 8-bit samples "
        f"and one or three components (ROADMAP Queue A item 9)")


def is_jpeg(head: bytes) -> bool:
    return head[:3] == b"\xff\xd8\xff"


def _marker_at(data: bytes, pos: int, path: str) -> tuple[int, int]:
    """The next marker at or after ``pos`` -> (its code, the position after
    it); fill bytes (0xFF) before a marker are skipped."""
    n = len(data)
    while pos < n and data[pos] != 0xFF:
        pos += 1
    while pos < n and data[pos] == 0xFF:
        pos += 1
    if pos >= n:
        raise ValueError(f"{path}: truncated JPEG (no EOI marker)")
    return data[pos], pos + 1


def _segment(data: bytes, pos: int, path: str) -> tuple[bytes, int]:
    if pos + 2 > len(data):
        raise ValueError(f"{path}: truncated JPEG segment")
    (length,) = struct.unpack(">H", data[pos:pos + 2])
    if length < 2 or pos + length > len(data):
        raise ValueError(f"{path}: truncated JPEG segment")
    return data[pos + 2:pos + length], pos + length


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def _frame(body: bytes, marker: int, path: str) -> dict:
    if marker in _SOF_KINDS:
        raise _unsupported(path, _SOF_KINDS[marker])
    precision, h, w, nc = struct.unpack(">BHHB", body[:6])
    if precision != 8:
        raise _unsupported(path, f"{precision}-bit")
    if nc == 4:
        raise _unsupported(path, "CMYK or YCCK (four-component)")
    if nc not in (1, 3):
        raise _unsupported(path, f"{nc}-component")
    if h == 0 or w == 0:
        raise _unsupported(path, "DNL-sized (height 0)")
    comps = []
    for i in range(nc):
        cid, hv, tq = body[6 + 3 * i:9 + 3 * i]
        if not (1 <= hv >> 4 <= 4 and 1 <= hv & 15 <= 4) or tq > 3:
            raise ValueError(f"{path}: bad JPEG component {cid}")
        comps.append({"id": cid, "h": hv >> 4, "v": hv & 15, "tq": tq,
                      "q": None})
    hmax = max(c["h"] for c in comps)
    vmax = max(c["v"] for c in comps)
    mcux = _ceil_div(w, 8 * hmax)
    mcuy = _ceil_div(h, 8 * vmax)
    offset = 0
    for c in comps:
        c["bw"], c["bh"] = mcux * c["h"], mcuy * c["v"]
        c["offset"] = offset
        offset += c["bw"] * c["bh"] * 64
        # the component's own size in blocks (non-interleaved scans)
        c["nbw"] = _ceil_div(_ceil_div(w * c["h"], hmax), 8)
        c["nbh"] = _ceil_div(_ceil_div(h * c["v"], vmax), 8)
    return {"width": w, "height": h, "comps": comps, "mcux": mcux,
            "mcuy": mcuy, "coef_size": offset, "marker": marker}


def jpeg_size(path: str) -> tuple[int, int] | None:
    """(width, height) from a JPEG's SOF header; None when the file is not
    a JPEG or its headers end before a frame header."""
    with open(path, "rb") as f:
        data = f.read()
    if not is_jpeg(data):
        return None
    pos = 2
    try:
        while True:
            m, pos = _marker_at(data, pos, path)
            if m == 0xD9 or m == 0xDA:
                return None
            if 0xD0 <= m <= 0xD7 or m == 0x01:
                continue
            body, pos = _segment(data, pos, path)
            if 0xC0 <= m <= 0xCF and m not in (0xC4, 0xC8, 0xCC):
                h, w = struct.unpack(">HH", body[1:5])
                return w, h
    except (ValueError, struct.error):
        return None


def _decode(path: str) -> tuple[dict, np.ndarray, dict]:
    """-> (the frame, the coefficients (int16, every component's blocks in
    zigzag order), the colour-space markers)."""
    from divshot_tpu_torch.core import native
    with open(path, "rb") as f:
        data = f.read()
    if not is_jpeg(data):
        raise ValueError(f"{path}: not a JPEG file")
    lib = native.get_lib()
    if lib is None:
        raise RuntimeError(f"{path}: the JPEG decoder is in the host "
                           f"library, which did not build: "
                           f"{native.BUILD_ERROR}")
    buf = np.frombuffer(data, np.uint8)
    qt: dict[int, np.ndarray] = {}
    dc_bits = np.zeros((4, 16), np.uint8)
    dc_vals = np.zeros((4, 256), np.uint8)
    ac_bits = np.zeros((4, 16), np.uint8)
    ac_vals = np.zeros((4, 256), np.uint8)
    restart = 0
    frame = coef = None
    marks = {"jfif": False, "adobe": None}
    pos = 2
    while True:
        m, pos = _marker_at(data, pos, path)
        if m == 0xD9:
            break
        if 0xD0 <= m <= 0xD7 or m == 0x01:
            continue
        body, pos = _segment(data, pos, path)
        if m == 0xDB:                                      # DQT
            i = 0
            while i < len(body):
                pq, tq = body[i] >> 4, body[i] & 15
                size = 128 if pq else 64
                qt[tq] = np.frombuffer(
                    body[i + 1:i + 1 + size], ">u2" if pq else np.uint8
                ).astype(np.uint16)
                i += 1 + size
        elif m == 0xC4:                                    # DHT
            i = 0
            while i < len(body):
                tc, th = body[i] >> 4, body[i] & 15
                counts = np.frombuffer(body[i + 1:i + 17], np.uint8)
                nv = int(counts.sum())
                bits, vals = (dc_bits, dc_vals) if tc == 0 else \
                    (ac_bits, ac_vals)
                if th > 3 or nv > 256:
                    raise ValueError(f"{path}: bad JPEG Huffman table")
                bits[th] = counts
                vals[th] = 0
                vals[th, :nv] = np.frombuffer(body[i + 17:i + 17 + nv],
                                              np.uint8)
                i += 17 + nv
        elif m == 0xCC:
            raise _unsupported(path, "arithmetic-coded")
        elif 0xC0 <= m <= 0xCF and m != 0xC8:              # SOFn
            if frame is not None:
                raise _unsupported(path, "multi-frame")
            frame = _frame(body, m, path)
            coef = np.zeros(frame["coef_size"], np.int16)
        elif m == 0xDD:                                    # DRI
            (restart,) = struct.unpack(">H", body[:2])
        elif m == 0xE0 and body[:5] == b"JFIF\x00":
            marks["jfif"] = True
        elif m == 0xEE and body[:5] == b"Adobe" and len(body) >= 12:
            marks["adobe"] = body[11]
        elif m == 0xDA:                                    # SOS
            if frame is None:
                raise ValueError(f"{path}: JPEG scan before its frame")
            ns = body[0]
            ss, se, a = body[1 + 2 * ns:4 + 2 * ns]
            if ss != 0 or se != 63 or a != 0:
                raise _unsupported(path, "progressive")
            by_id = {c["id"]: c for c in frame["comps"]}
            info, offsets = [], []
            for i in range(ns):
                cid, t = body[1 + 2 * i:3 + 2 * i]
                c = by_id.get(cid)
                if c is None:
                    raise ValueError(f"{path}: JPEG scan of an unknown "
                                     f"component {cid}")
                if c["q"] is None:         # latched at its first scan
                    if c["tq"] not in qt:
                        raise ValueError(f"{path}: JPEG component {cid} "
                                         f"has no quantisation table")
                    c["q"] = qt[c["tq"]].copy()
                info += [c["h"], c["v"], c["bw"], c["nbw"], c["nbh"], t]
                offsets.append(c["offset"])
            end = lib.jpeg_decode_scan(
                buf, len(buf), pos, ns, np.asarray(info, np.int32),
                np.asarray(offsets, np.int64), frame["mcux"], frame["mcuy"],
                np.ascontiguousarray(dc_bits), np.ascontiguousarray(dc_vals),
                np.ascontiguousarray(ac_bits), np.ascontiguousarray(ac_vals),
                restart, coef)
            if end < 0:
                raise ValueError(f"{path}: corrupt JPEG scan "
                                 f"({_SCAN_ERRORS.get(end, end)})")
            pos = int(end)
    if frame is None:
        raise ValueError(f"{path}: JPEG without a frame header")
    if any(c["q"] is None for c in frame["comps"]):
        raise ValueError(f"{path}: a JPEG component has no scan")
    return frame, coef, marks


def _ycc(frame: dict, marks: dict) -> bool:
    """libjpeg's default colour space of a three-component file
    (``jdapimin.c``, ``default_decompress_parms``): YCbCr unless an Adobe
    marker says RGB (transform 0) or, with neither a JFIF nor an Adobe
    marker, the component ids spell 'R', 'G', 'B'."""
    if marks["jfif"]:
        return True
    if marks["adobe"] is not None:
        return marks["adobe"] != 0
    ids = tuple(c["id"] for c in frame["comps"])
    return ids != (82, 71, 66)


def read_jpeg(path: str) -> np.ndarray:
    """-> uint8 (H, W) for a greyscale JPEG, (H, W, 3) RGB otherwise, as
    Pillow's ``np.asarray(Image.open(path))``."""
    from divshot_tpu_torch.core import native
    frame, coef, marks = _decode(path)
    comps = frame["comps"]
    nc = len(comps)
    h, w = frame["height"], frame["width"]
    out = np.empty((h, w, nc), np.uint8)
    info = np.asarray([[c["h"], c["v"], c["bw"], c["bh"]] for c in comps],
                      np.int32)
    err = native.get_lib().jpeg_reconstruct(
        coef, nc, info.reshape(-1),
        np.asarray([c["offset"] for c in comps], np.int64),
        np.ascontiguousarray(np.stack([c["q"] for c in comps])),
        w, h, int(nc == 3 and _ycc(frame, marks)), out)
    if err:
        raise _unsupported(path, "non-integral sampling factor")
    return out[..., 0] if nc == 1 else out


def decode_coefficients(path: str) -> np.ndarray:
    """The quantised DCT coefficients the entropy decode yields, (blocks,
    64) int32 in zigzag order, MCU by MCU as an interleaved scan walks
    them: each component's h x v blocks in turn (for 4:2:0, four luma
    blocks then Cb then Cr, as ``viewer/jpeg.quantized_blocks`` lists
    them); a greyscale file's blocks row by row."""
    frame, coef, _ = _decode(path)
    parts = []
    for c in frame["comps"]:
        blocks = coef[c["offset"]:c["offset"] + c["bw"] * c["bh"] * 64]
        blocks = blocks.reshape(frame["mcuy"], c["v"], frame["mcux"],
                                c["h"], 64).transpose(0, 2, 1, 3, 4)
        parts.append(blocks.reshape(frame["mcuy"], frame["mcux"], -1, 64))
    return np.concatenate(parts, 2).reshape(-1, 64).astype(np.int32)
