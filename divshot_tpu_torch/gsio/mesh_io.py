"""Mesh asset import (counterpart of ``divshot_tpu/gsio/mesh_io.py``,
copied): OBJ (+ MTL), glTF 2.0 (.gltf / .glb) and binary FBX into one
triangle-soup ``Mesh`` (positions, normals, uvs, colours, faces and a
per-face material colour).

The parsers stand alone (numpy, ``zlib`` and ``struct``): OBJ and MTL are
text; glTF is JSON and raw buffers; GLB is the 12-byte-header chunk
container; binary FBX is the 7.x node-record format (zlib-compressed
property arrays), from which the Geometry's Vertices and
PolygonVertexIndex are read.
"""

from __future__ import annotations

import json
import os
import struct
import zlib
from dataclasses import dataclass, field

import numpy as np


@dataclass
class Mesh:
    positions: np.ndarray               # (V, 3) f32
    faces: np.ndarray                   # (F, 3) i32
    normals: np.ndarray | None = None   # (V, 3) f32 (per-vertex)
    uvs: np.ndarray | None = None       # (V, 2) f32
    colors: np.ndarray | None = None    # (V, 3) f32 per-vertex
    face_colors: np.ndarray | None = None  # (F, 3) f32 material diffuse
    name: str = "mesh"

    @property
    def num_vertices(self) -> int:
        return int(self.positions.shape[0])

    @property
    def num_faces(self) -> int:
        return int(self.faces.shape[0])

    def with_vertex_normals(self) -> "Mesh":
        """Area-weighted vertex normals if none were imported."""
        if self.normals is not None:
            return self
        p = self.positions
        f = self.faces
        fn = np.cross(p[f[:, 1]] - p[f[:, 0]], p[f[:, 2]] - p[f[:, 0]])
        n = np.zeros_like(p)
        for k in range(3):
            np.add.at(n, f[:, k], fn)
        norm = np.linalg.norm(n, axis=1, keepdims=True)
        n = n / np.maximum(norm, 1e-12)
        return Mesh(self.positions, f, n.astype(np.float32), self.uvs,
                    self.colors, self.face_colors, self.name)


# ---------------------------------------------------------------------------
# OBJ / MTL


def _load_mtl(path: str) -> dict[str, np.ndarray]:
    mats: dict[str, np.ndarray] = {}
    cur = None
    if not os.path.exists(path):
        return mats
    for line in open(path, errors="ignore"):
        t = line.split()
        if not t:
            continue
        if t[0] == "newmtl":
            cur = t[1]
            mats[cur] = np.asarray([0.8, 0.8, 0.8], np.float32)
        elif t[0] == "Kd" and cur is not None:
            mats[cur] = np.asarray([float(x) for x in t[1:4]], np.float32)
    return mats


def load_obj(path: str) -> Mesh:
    """Wavefront OBJ: v/vn/vt/f (+usemtl diffuse from the .mtl).
    Faces are triangulated (fan); per-face material color carried."""
    vs, vns, vts = [], [], []
    faces, face_mat = [], []
    mats: dict[str, np.ndarray] = {}
    cur_mat = None
    # OBJ indexes v/vt/vn independently; we re-index to a unified vertex
    corner_index: dict[tuple, int] = {}
    out_pos, out_nrm, out_uv = [], [], []
    any_n, any_t = False, False

    def corner(tok: str) -> int:
        nonlocal any_n, any_t
        parts = (tok.split("/") + ["", ""])[:3]
        vi = int(parts[0])
        ti = int(parts[1]) if parts[1] else 0
        ni = int(parts[2]) if parts[2] else 0
        keyt = (vi, ti, ni)
        if keyt in corner_index:
            return corner_index[keyt]
        idx = len(out_pos)
        corner_index[keyt] = idx
        out_pos.append(vs[vi - 1 if vi > 0 else len(vs) + vi])
        if ni:
            any_n = True
            out_nrm.append(vns[ni - 1 if ni > 0 else len(vns) + ni])
        else:
            out_nrm.append((0.0, 0.0, 0.0))
        if ti:
            any_t = True
            out_uv.append(vts[ti - 1 if ti > 0 else len(vts) + ti])
        else:
            out_uv.append((0.0, 0.0))
        return idx

    for line in open(path, errors="ignore"):
        t = line.split()
        if not t:
            continue
        if t[0] == "v":
            vs.append(tuple(float(x) for x in t[1:4]))
        elif t[0] == "vn":
            vns.append(tuple(float(x) for x in t[1:4]))
        elif t[0] == "vt":
            vts.append(tuple(float(x) for x in t[1:3]))
        elif t[0] == "mtllib":
            mats.update(_load_mtl(os.path.join(os.path.dirname(path), t[1])))
        elif t[0] == "usemtl":
            cur_mat = t[1]
        elif t[0] == "f":
            ids = [corner(x) for x in t[1:]]
            col = mats.get(cur_mat, np.asarray([0.8, 0.8, 0.8], np.float32))
            for k in range(1, len(ids) - 1):          # fan triangulation
                faces.append((ids[0], ids[k], ids[k + 1]))
                face_mat.append(col)

    return Mesh(
        positions=np.asarray(out_pos, np.float32),
        faces=np.asarray(faces, np.int32).reshape(-1, 3),
        normals=np.asarray(out_nrm, np.float32) if any_n else None,
        uvs=np.asarray(out_uv, np.float32) if any_t else None,
        face_colors=np.asarray(face_mat, np.float32).reshape(-1, 3),
        name=os.path.splitext(os.path.basename(path))[0],
    ).with_vertex_normals()


# ---------------------------------------------------------------------------
# glTF 2.0 / GLB


_GLTF_CTYPE = {5120: np.int8, 5121: np.uint8, 5122: np.int16,
               5123: np.uint16, 5125: np.uint32, 5126: np.float32}
_GLTF_NCOMP = {"SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4,
               "MAT4": 16}


def _gltf_accessor(gltf: dict, buffers: list[bytes], idx: int) -> np.ndarray:
    acc = gltf["accessors"][idx]
    bv = gltf["bufferViews"][acc["bufferView"]]
    dtype = _GLTF_CTYPE[acc["componentType"]]
    ncomp = _GLTF_NCOMP[acc["type"]]
    start = bv.get("byteOffset", 0) + acc.get("byteOffset", 0)
    count = acc["count"]
    buf = buffers[bv.get("buffer", 0)]
    stride = bv.get("byteStride") or ncomp * np.dtype(dtype).itemsize
    if stride == ncomp * np.dtype(dtype).itemsize:
        arr = np.frombuffer(buf, dtype, count * ncomp, start)
        return arr.reshape(count, ncomp).copy()
    rows = [np.frombuffer(buf, dtype, ncomp, start + i * stride)
            for i in range(count)]
    return np.stack(rows)


def load_gltf(path: str) -> Mesh:
    """glTF 2.0: .gltf (JSON + external .bin) or .glb (binary container).
    All mesh primitives are merged into one triangle soup; the material
    baseColorFactor becomes the per-face color."""
    if path.lower().endswith(".glb"):
        raw = open(path, "rb").read()
        magic, _ver, _len = struct.unpack_from("<III", raw, 0)
        assert magic == 0x46546C67, "not a GLB file"
        off = 12
        gltf, bin_chunk = None, b""
        while off < len(raw):
            clen, ctype = struct.unpack_from("<II", raw, off)
            data = raw[off + 8: off + 8 + clen]
            if ctype == 0x4E4F534A:          # 'JSON'
                gltf = json.loads(data)
            elif ctype == 0x004E4942:        # 'BIN'
                bin_chunk = data
            off += 8 + clen
        buffers = [bin_chunk]
    else:
        gltf = json.load(open(path))
        base = os.path.dirname(path)
        buffers = []
        for b in gltf.get("buffers", []):
            uri = b["uri"]
            if uri.startswith("data:"):
                import base64
                buffers.append(base64.b64decode(uri.split(",", 1)[1]))
            else:
                buffers.append(open(os.path.join(base, uri), "rb").read())

    pos_l, nrm_l, uv_l, fc_l, faces_l = [], [], [], [], []
    voff = 0
    any_n = any_t = False
    for mesh in gltf.get("meshes", []):
        for prim in mesh.get("primitives", []):
            if prim.get("mode", 4) != 4:     # triangles only
                continue
            attrs = prim["attributes"]
            pos = _gltf_accessor(gltf, buffers, attrs["POSITION"]) \
                .astype(np.float32)
            n = pos.shape[0]
            if "indices" in prim:
                idx = _gltf_accessor(gltf, buffers, prim["indices"]) \
                    .reshape(-1).astype(np.int32)
            else:
                idx = np.arange(n, dtype=np.int32)
            tri = idx.reshape(-1, 3)
            color = np.asarray([0.8, 0.8, 0.8], np.float32)
            if "material" in prim:
                mat = gltf["materials"][prim["material"]]
                pbr = mat.get("pbrMetallicRoughness", {})
                color = np.asarray(
                    pbr.get("baseColorFactor", [0.8, 0.8, 0.8, 1])[:3],
                    np.float32)
            pos_l.append(pos)
            if "NORMAL" in attrs:
                any_n = True
                nrm_l.append(_gltf_accessor(
                    gltf, buffers, attrs["NORMAL"]).astype(np.float32))
            else:
                nrm_l.append(np.zeros_like(pos))
            if "TEXCOORD_0" in attrs:
                any_t = True
                uv_l.append(_gltf_accessor(
                    gltf, buffers, attrs["TEXCOORD_0"])[:, :2]
                    .astype(np.float32))
            else:
                uv_l.append(np.zeros((n, 2), np.float32))
            faces_l.append(tri + voff)
            fc_l.append(np.tile(color, (tri.shape[0], 1)))
            voff += n

    return Mesh(
        positions=np.concatenate(pos_l) if pos_l
        else np.zeros((0, 3), np.float32),
        faces=np.concatenate(faces_l).astype(np.int32) if faces_l
        else np.zeros((0, 3), np.int32),
        normals=np.concatenate(nrm_l) if any_n else None,
        uvs=np.concatenate(uv_l) if any_t else None,
        face_colors=np.concatenate(fc_l) if fc_l else None,
        name=os.path.splitext(os.path.basename(path))[0],
    ).with_vertex_normals()


# ---------------------------------------------------------------------------
# FBX (binary, 7.x)


def _fbx_read_props(raw: bytes, off: int, n: int):
    vals = []
    for _ in range(n):
        t = raw[off:off + 1]
        off += 1
        if t in b"CFDILY":
            fmt = {b"C": "<b", b"F": "<f", b"D": "<d", b"I": "<i",
                   b"L": "<q", b"Y": "<h"}[t]
            v = struct.unpack_from(fmt, raw, off)[0]
            off += struct.calcsize(fmt)
            vals.append(v)
        elif t in b"SR":
            ln = struct.unpack_from("<I", raw, off)[0]
            off += 4
            vals.append(raw[off:off + ln])
            off += ln
        elif t in b"fdli":
            count, enc, clen = struct.unpack_from("<III", raw, off)
            off += 12
            dt = {b"f": np.float32, b"d": np.float64,
                  b"l": np.int64, b"i": np.int32}[t]
            if enc:
                data = zlib.decompress(raw[off:off + clen])
                off += clen
            else:
                nb = count * np.dtype(dt).itemsize
                data = raw[off:off + nb]
                off += nb
            vals.append(np.frombuffer(data, dt, count))
        else:
            raise ValueError(f"unknown FBX property type {t!r}")
    return vals, off


def _fbx_parse_nodes(raw: bytes, off: int, end: int, big: bool):
    """-> (list of (name, props, children), offset past the list)."""
    nodes = []
    sentinel = 25 if big else 13              # all-zero null record
    while off < end:
        if big:
            end_off, n_props, _plen = struct.unpack_from("<QQQ", raw, off)
            hdr = 24
        else:
            end_off, n_props, _plen = struct.unpack_from("<III", raw, off)
            hdr = 12
        if end_off == 0:                      # null record = end of list
            return nodes, off + sentinel
        p = off + hdr
        name_len = raw[p]
        p += 1
        name = raw[p:p + name_len].decode("ascii", "ignore")
        p += name_len
        props, p = _fbx_read_props(raw, p, n_props)
        children = []
        if p < end_off:
            children, _ = _fbx_parse_nodes(raw, p, end_off, big)
        nodes.append((name, props, children))
        off = end_off
    return nodes, off


def load_fbx(path: str) -> Mesh:
    """Binary FBX 7.x: Geometry Vertices + PolygonVertexIndex (negative
    index closes a polygon; fan-triangulated). Text FBX is not supported."""
    raw = open(path, "rb").read()
    if not raw.startswith(b"Kaydara FBX Binary"):
        raise ValueError("only binary FBX supported")
    version = struct.unpack_from("<I", raw, 23)[0]
    big = version >= 7500
    nodes, _ = _fbx_parse_nodes(raw, 27, len(raw), big)

    def find_all(nlist, name):
        out = []
        for nm, props, ch in nlist:
            if nm == name:
                out.append((props, ch))
            out.extend(find_all(ch, name))
        return out

    pos_l, faces_l = [], []
    voff = 0
    for props, ch in find_all(nodes, "Geometry"):
        verts = find_all(ch, "Vertices")
        polys = find_all(ch, "PolygonVertexIndex")
        if not verts or not polys:
            continue
        p = np.asarray(verts[0][0][0], np.float64).reshape(-1, 3) \
            .astype(np.float32)
        idx = np.asarray(polys[0][0][0], np.int64)
        # split on negative (XOR -1) terminators, fan-triangulate
        faces = []
        poly: list[int] = []
        for i in idx:
            if i < 0:
                poly.append(int(~i))
                for k in range(1, len(poly) - 1):
                    faces.append((poly[0], poly[k], poly[k + 1]))
                poly = []
            else:
                poly.append(int(i))
        pos_l.append(p)
        faces_l.append(np.asarray(faces, np.int32) + voff)
        voff += p.shape[0]

    return Mesh(
        positions=np.concatenate(pos_l) if pos_l
        else np.zeros((0, 3), np.float32),
        faces=np.concatenate(faces_l) if faces_l
        else np.zeros((0, 3), np.int32),
        name=os.path.splitext(os.path.basename(path))[0],
    ).with_vertex_normals()


def load_mesh(path: str) -> Mesh:
    """Dispatch by extension (obj/gltf/glb/fbx — model_loader parity)."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".obj":
        return load_obj(path)
    if ext in (".gltf", ".glb"):
        return load_gltf(path)
    if ext == ".fbx":
        return load_fbx(path)
    raise ValueError(f"unsupported mesh format: {ext}")
