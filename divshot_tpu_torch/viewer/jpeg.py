"""Baseline JPEG encoder (port only): the stand-in for the Pillow JPEG
save of ``divshot_tpu/viewer/video.py:24-32``, which the card's host
lacks.

- YCbCr (JFIF) with 4:2:0 chroma, Pillow's default, the image padded to
  whole 16x16 MCUs by repeating its last row and column;
- the standard luma and chroma quantisation tables (ITU T.81 Annex K.1)
  scaled by libjpeg's quality rule, as Pillow's ``quality=`` sets them;
- the standard Huffman tables (Annex K.3), 0xFF byte stuffing.

The colour conversion, the 8x8 DCT (two tensor products with the
orthonormal DCT-II matrix, the JPEG normalisation) and the quantisation
run on the frame's device; the entropy coding is whole-array numpy on the
host (the run lengths, symbols and bit fields of every block at once, then
one bit packing), with no loop over coefficients.
"""

from __future__ import annotations

import math
import struct

import numpy as np
import torch

_LUMA_Q = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99])
_CHROMA_Q = np.array([
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99]
    + [99] * 32)

# natural (row-major) index of each zigzag position
ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])

_AC_LUMA_VALS = bytes.fromhex(
    "01020300041105122131410613516107227114328191a1082342b1c11552d1f0"
    "2433627282090a161718191a25262728292a3435363738393a43444546474849"
    "4a535455565758595a636465666768696a737475767778797a83848586878889"
    "8a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5"
    "c6c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8"
    "f9fa")
_AC_CHROMA_VALS = bytes.fromhex(
    "000102031104052131061241510761711322328108144291a1b1c109233352f0"
    "156272d10a162434e125f11718191a262728292a35363738393a434445464748"
    "494a535455565758595a636465666768696a737475767778797a828384858687"
    "88898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3"
    "c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8"
    "f9fa")

# (code-length counts 1..16, symbols) of the four standard tables
HUFFMAN = {
    "dc_luma": ((0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0),
                bytes(range(12))),
    "dc_chroma": ((0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0),
                  bytes(range(12))),
    "ac_luma": ((0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d),
                _AC_LUMA_VALS),
    "ac_chroma": ((0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77),
                  _AC_CHROMA_VALS),
}


def _codes(bits, vals) -> tuple[np.ndarray, np.ndarray]:
    """-> (code, length) lookup arrays of 256 symbols (Annex C)."""
    code_of = np.zeros(256, np.int64)
    len_of = np.zeros(256, np.int64)
    code, k = 0, 0
    for length, count in enumerate(bits, start=1):
        for _ in range(count):
            code_of[vals[k]] = code
            len_of[vals[k]] = length
            code += 1
            k += 1
        code <<= 1
    return code_of, len_of


_TABLES = {k: _codes(*v) for k, v in HUFFMAN.items()}


def quant_tables(quality: int) -> tuple[np.ndarray, np.ndarray]:
    """libjpeg's ``jpeg_set_quality(quality, force_baseline=TRUE)``: the
    standard tables scaled by 5000 / q below 50, 200 - 2q from 50, each
    entry rounded and clamped to 1..255. Natural order."""
    q = min(max(int(quality), 1), 100)
    scale = 5000 // q if q < 50 else 200 - 2 * q
    return tuple(np.clip((t * scale + 50) // 100, 1, 255).astype(np.int64)
                 for t in (_LUMA_Q, _CHROMA_Q))


def _dct_matrix(device) -> torch.Tensor:
    k = np.arange(8)
    d = np.cos((2 * k[None, :] + 1) * k[:, None] * math.pi / 16) * 0.5
    d[0] = math.sqrt(1 / 8)
    return torch.as_tensor(d, dtype=torch.float32, device=device)


def quantized_blocks(img: torch.Tensor, quality: int) -> np.ndarray:
    """An (H, W, 3) uint8 image -> its quantised DCT blocks in scan order,
    (blocks, 64) int32 in zigzag order: per 16x16 MCU four luma blocks,
    then Cb, then Cr. Computed on the image's device."""
    dev = img.device
    h, w = img.shape[:2]
    hp, wp = -(-h // 16) * 16, -(-w // 16) * 16
    x = img.float()
    x = torch.cat([x, x[-1:].expand(hp - h, w, 3)], 0)
    x = torch.cat([x, x[:, -1:].expand(hp, wp - w, 3)], 1)
    r, g, b = x.unbind(-1)
    y = 0.299 * r + 0.587 * g + 0.114 * b - 128.0
    cb = -0.168736 * r - 0.331264 * g + 0.5 * b
    cr = 0.5 * r - 0.418688 * g - 0.081312 * b
    my, mx = hp // 16, wp // 16

    def half(c):          # 2x2 box average: 4:2:0
        return c.reshape(hp // 2, 2, wp // 2, 2).mean((1, 3))

    yb = y.reshape(my, 2, 8, mx, 2, 8).permute(0, 3, 1, 4, 2, 5)
    yb = yb.reshape(my, mx, 4, 8, 8)
    cbb, crb = (half(c).reshape(my, 8, mx, 8).permute(0, 2, 1, 3)[:, :, None]
                for c in (cb, cr))
    blocks = torch.cat([yb, cbb, crb], 2)                  # (my, mx, 6, 8, 8)
    d = _dct_matrix(dev)
    coef = torch.einsum("ux,mnbxy,vy->mnbuv", d, blocks, d)
    ql, qc = quant_tables(quality)
    qt = torch.as_tensor(np.stack([ql] * 4 + [qc] * 2).reshape(6, 8, 8),
                         dtype=torch.float32, device=dev)
    v = coef / qt
    v = torch.sign(v) * torch.floor(torch.abs(v) + 0.5)   # half away from 0
    zz = torch.as_tensor(ZIGZAG, device=dev)
    return v.reshape(-1, 64)[:, zz].to(torch.int32).cpu().numpy()


def _size(v: np.ndarray) -> np.ndarray:
    """Bit length of |v| (0 for 0)."""
    return np.frexp(np.abs(v).astype(np.float64))[1].astype(np.int64)


def _bits(v: np.ndarray, s: np.ndarray) -> np.ndarray:
    """The JPEG extra bits of v at size s (ones' complement if < 0)."""
    v = v.astype(np.int64)
    return np.where(v >= 0, v, v + (1 << s) - 1)


def entropy_code(zz: np.ndarray) -> bytes:
    """The Huffman-coded, byte-stuffed scan of (blocks, 64) zigzag
    coefficients in 4:2:0 scan order."""
    nb = zz.shape[0]
    comp = np.tile(np.array([0, 0, 0, 0, 1, 2]), nb // 6)
    chroma = comp > 0
    # DC: the difference to the previous block of the same component
    dc = zz[:, 0].astype(np.int64)
    diff = np.empty_like(dc)
    for c in range(3):
        d = dc[comp == c]
        diff[comp == c] = d - np.concatenate([[0], d[:-1]])
    s = _size(diff)
    dl, dc_ = _TABLES["dc_luma"], _TABLES["dc_chroma"]
    keys = [np.arange(nb) * 512]
    hcode = [np.where(chroma, dc_[0][s], dl[0][s])]
    hlen = [np.where(chroma, dc_[1][s], dl[1][s])]
    extra, elen = [_bits(diff, s)], [s]
    # AC: (run, size) symbols, ZRL for each 16 zeros, EOB after the last
    blk, pos = np.nonzero(zz[:, 1:])
    k = pos + 1
    first = np.ones(len(blk), bool)
    first[1:] = blk[1:] != blk[:-1]
    prev = np.where(first, 0, np.concatenate([[0], k[:-1]]))
    run = k - prev - 1
    v = zz[blk, k].astype(np.int64)
    s = _size(v)
    al, ac = _TABLES["ac_luma"], _TABLES["ac_chroma"]
    sym = (run % 16) * 16 + s
    ch = chroma[blk]
    keys.append(blk * 512 + k * 4 + 3)
    hcode.append(np.where(ch, ac[0][sym], al[0][sym]))
    hlen.append(np.where(ch, ac[1][sym], al[1][sym]))
    extra.append(_bits(v, s))
    elen.append(s)
    nzrl = run // 16
    zi = np.repeat(np.arange(len(blk)), nzrl)
    j = np.arange(len(zi)) - np.repeat(np.cumsum(nzrl) - nzrl, nzrl)
    zch = chroma[blk[zi]]
    keys.append(blk[zi] * 512 + k[zi] * 4 + j)
    hcode.append(np.where(zch, ac[0][0xF0], al[0][0xF0]))
    hlen.append(np.where(zch, ac[1][0xF0], al[1][0xF0]))
    extra.append(np.zeros(len(zi), np.int64))
    elen.append(np.zeros(len(zi), np.int64))
    last = np.zeros(nb, np.int64)
    last[blk] = k                     # k ascends within a block
    eob = np.nonzero(last < 63)[0]
    keys.append(eob * 512 + 511)
    hcode.append(np.where(chroma[eob], ac[0][0], al[0][0]))
    hlen.append(np.where(chroma[eob], ac[1][0], al[1][0]))
    extra.append(np.zeros(len(eob), np.int64))
    elen.append(np.zeros(len(eob), np.int64))

    order = np.argsort(np.concatenate(keys), kind="stable")
    el = np.concatenate(elen)[order]
    val = (np.concatenate(hcode)[order] << el) | np.concatenate(extra)[order]
    length = np.concatenate(hlen)[order] + el
    data = _pack(val, length)
    ff = np.nonzero(data == 0xFF)[0]
    return np.insert(data, ff + 1, 0).tobytes()


def _pack(val: np.ndarray, length: np.ndarray) -> np.ndarray:
    """Bit fields (each at most 32 bits), most significant bit first, as
    bytes padded with 1-bits: each field ORed into the 64-bit big-endian
    word where it starts, its spill into the next."""
    total = int(length.sum())
    start = np.cumsum(length) - length
    word = start >> 6
    end = (start & 63) + length
    val = val.astype(np.uint64)
    fits = end <= 64
    head = np.where(fits, val << (64 - np.minimum(end, 64)).astype(np.uint64),
                    val >> (np.maximum(end, 64) - 64).astype(np.uint64))
    words = np.zeros(int(word[-1]) + 2 if len(word) else 1, np.uint64)
    first = np.concatenate([[0], np.nonzero(np.diff(word))[0] + 1])
    words[word[first]] = np.bitwise_or.reduceat(head, first)
    spill = ~fits
    words[word[spill] + 1] |= val[spill] << (128 - end[spill]).astype(
        np.uint64)
    data = words.astype(">u8").view(np.uint8)[:(total + 7) // 8].copy()
    if total % 8:
        data[-1] |= (1 << (8 - total % 8)) - 1
    return data


def _segment(marker: int, payload: bytes) -> bytes:
    return struct.pack(">HH", marker, len(payload) + 2) + payload


def headers(width: int, height: int, quality: int) -> bytes:
    """SOI, JFIF APP0, DQT, SOF0 (4:2:0), DHT and SOS."""
    ql, qc = quant_tables(quality)
    dqt = (b"\x00" + bytes(ql[ZIGZAG].tolist())
           + b"\x01" + bytes(qc[ZIGZAG].tolist()))
    sof = struct.pack(">BHHB", 8, height, width, 3) + bytes(
        [1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1])
    dht = b""
    for tc, name in ((0x00, "dc_luma"), (0x10, "ac_luma"),
                     (0x01, "dc_chroma"), (0x11, "ac_chroma")):
        counts, vals = HUFFMAN[name]
        dht += bytes([tc, *counts]) + vals
    sos = bytes([3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0])
    return (b"\xff\xd8"
            + _segment(0xFFE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00"
                       b"\x00")
            + _segment(0xFFDB, dqt) + _segment(0xFFC0, sof)
            + _segment(0xFFC4, dht) + _segment(0xFFDA, sos))


def encode_jpeg(img, quality: int = 90) -> bytes:
    """An (H, W, 3) uint8 image (tensor on any device, or numpy) -> a
    baseline 4:2:0 JFIF JPEG."""
    img = torch.as_tensor(img)
    if img.dtype != torch.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError("encode_jpeg takes an (H, W, 3) uint8 image")
    h, w = img.shape[:2]
    return (headers(w, h, quality)
            + entropy_code(quantized_blocks(img, quality)) + b"\xff\xd9")
