"""ctypes loader for the host library (counterpart of
``divshot_tpu/core/native.py``).

The library is ``divshot_tpu_torch/native/*.cpp`` (a copy of the JAX
package's ``native/divshot_native.cpp`` and the port's JPEG decoder),
compiled with ``g++`` at first use into ``build/divshot_tpu_torch/``
(``_build.build_native``), never at import. As in JAX, each entry point
returns ``None`` when the library cannot be built, and its callers
(``gsio/colmap.py``, ``gsio/compressed.py``, ``gsio/ply.py``) then take
their numpy paths, which give the same results. ``BUILD_ERROR`` keeps the
reason. The JPEG decoder (``gsio/jpeg.py``) has no numpy path and raises
instead.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_tried = False
BUILD_ERROR: str | None = None


def get_lib() -> ctypes.CDLL | None:
    global _lib, _tried, BUILD_ERROR
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        from divshot_tpu_torch import _build
        try:
            so, _ = _build.build_native()
        except RuntimeError as e:
            BUILD_ERROR = str(e)
            return None
        lib = ctypes.CDLL(str(so))
        c_i64 = ctypes.c_int64
        c_i32 = ctypes.c_int32
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C")
        f64p = np.ctypeslib.ndpointer(np.float64, flags="C")
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C")
        u64p = np.ctypeslib.ndpointer(np.uint64, flags="C")
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C")
        i64p = np.ctypeslib.ndpointer(np.int64, flags="C")
        i16p = np.ctypeslib.ndpointer(np.int16, flags="C")
        u16p = np.ctypeslib.ndpointer(np.uint16, flags="C")
        lib.colmap_points3d_count.restype = c_i64
        lib.colmap_points3d_count.argtypes = [u8p, c_i64]
        lib.colmap_points3d_parse.restype = c_i64
        lib.colmap_points3d_parse.argtypes = [u8p, c_i64, f64p, u8p]
        lib.colmap_images_count.restype = c_i64
        lib.colmap_images_count.argtypes = [u8p, c_i64]
        lib.colmap_images_parse.restype = c_i64
        lib.colmap_images_parse.argtypes = [
            u8p, c_i64, i32p, f64p, f64p, i32p,
            ctypes.c_char_p, c_i64]
        lib.morton_codes.restype = None
        lib.morton_codes.argtypes = [f32p, c_i64, u64p]
        lib.pack_ply_records.restype = None
        lib.pack_ply_records.argtypes = [f32p, f32p, f32p, f32p, f32p, f32p,
                                         c_i64, c_i64, f32p]
        lib.jpeg_decode_scan.restype = c_i64
        lib.jpeg_decode_scan.argtypes = [
            u8p, c_i64, c_i64, c_i32, i32p, i64p, c_i32, c_i32, u8p, u8p,
            u8p, u8p, c_i32, i16p]
        lib.jpeg_reconstruct.restype = c_i32
        lib.jpeg_reconstruct.argtypes = [i16p, c_i32, i32p, i64p, u16p,
                                         c_i32, c_i32, c_i32, u8p]
        _lib = lib
        return _lib


def parse_points3d_bin(raw: bytes):
    """-> (xyz (N,3) f32, rgb (N,3) f32 in [0,1]) or None if unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    buf = np.frombuffer(raw, np.uint8)
    n = lib.colmap_points3d_count(buf, len(buf))
    if n < 0:
        return None
    xyz = np.empty((n, 3), np.float64)
    rgb = np.empty((n, 3), np.uint8)
    got = lib.colmap_points3d_parse(buf, len(buf), xyz, rgb)
    if got != n:
        return None
    return xyz.astype(np.float32), rgb.astype(np.float32) / 255.0


def parse_images_bin(raw: bytes, max_name: int = 256):
    """-> list of (id, qvec, tvec, camera_id, name) or None."""
    lib = get_lib()
    if lib is None:
        return None
    buf = np.frombuffer(raw, np.uint8)
    n = lib.colmap_images_count(buf, len(buf))
    if n < 0:
        return None
    ids = np.empty(n, np.int32)
    qvecs = np.empty((n, 4), np.float64)
    tvecs = np.empty((n, 3), np.float64)
    cam_ids = np.empty(n, np.int32)
    names = ctypes.create_string_buffer(int(n * max_name))
    got = lib.colmap_images_parse(buf, len(buf), ids, qvecs, tvecs,
                                  cam_ids, names, max_name)
    if got != n:
        return None
    out = []
    for i in range(n):
        nm = names.raw[i * max_name:(i + 1) * max_name].split(b"\0")[0]
        out.append((int(ids[i]), qvecs[i].copy(), tvecs[i].copy(),
                    int(cam_ids[i]), nm.decode()))
    return out


def morton_codes(pos: np.ndarray) -> np.ndarray | None:
    lib = get_lib()
    if lib is None:
        return None
    pos = np.ascontiguousarray(pos, np.float32)
    codes = np.empty(len(pos), np.uint64)
    lib.morton_codes(pos, len(pos), codes)
    return codes


def pack_ply_records(means, sh0, shN, opacity, scales, quats
                     ) -> np.ndarray | None:
    lib = get_lib()
    if lib is None:
        return None
    n = len(means)
    k = shN.shape[1]
    out = np.empty((n, 59), np.float32)
    lib.pack_ply_records(
        np.ascontiguousarray(means, np.float32),
        np.ascontiguousarray(sh0, np.float32),
        np.ascontiguousarray(shN, np.float32),
        np.ascontiguousarray(opacity, np.float32),
        np.ascontiguousarray(scales, np.float32),
        np.ascontiguousarray(quats, np.float32),
        n, k, out)
    return out
