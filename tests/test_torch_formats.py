"""Every splat format, the pose readers, the mesh readers and the export
app of the port against the JAX package on the CPU.

- Each format written by both packages from the same params: the bytes
  equal (``.spz``: the payload after gunzip, and the gzip header but its
  time stamp, bytes 4-7). Each package reads the other's file to the same
  arrays.
- ``tests/test_golden_bytes.py``'s hand-derived fixtures through the
  port's writers and readers (the golden tests run as they are, with the
  JAX writers swapped for the port's).
- The dispatch; ``morton_order`` against JAX's (its native C++ coder, and
  its numpy coder); ``kmeans_1d`` and ``make_codebooks`` against JAX's.
- The pose readers on ``tests/test_readers.py``'s fixtures (its OpenSfM
  images JPEG, as there; a JPEG's size from its SOF header): the loaded
  datasets equal to JAX's (images bitwise, cameras rtol 1e-6); the mesh
  readers on ``tests/test_mesh_io.py``'s fixtures: every array equal.
- ``apps.export``: each format and back, against JAX's app.
"""

import gzip
import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import tests.test_golden_bytes as golden
from divshot_tpu.apps import export as jax_export
from divshot_tpu.core import native as jax_native
from divshot_tpu.gsio import compressed as JC
from divshot_tpu.gsio import io as JIO
from divshot_tpu.gsio import kmeans as JK
from divshot_tpu.gsio import mesh_io as JM
from divshot_tpu.gsio import spz as JSPZ
from divshot_tpu.gsio.datasets import load_dataset as jax_load_dataset
from divshot_tpu.gsio.synthetic import random_scene as jax_random_scene

from divshot_tpu_torch.apps import export as export_app
from divshot_tpu_torch.core import native as port_native
from divshot_tpu_torch.gsio import compressed as TC
from divshot_tpu_torch.gsio import io as TIO
from divshot_tpu_torch.gsio import kmeans as TK
from divshot_tpu_torch.gsio import mesh_io as TM
from divshot_tpu_torch.gsio import readers
from divshot_tpu_torch.gsio.datasets import load_dataset
from divshot_tpu_torch.gsio.jpeg import jpeg_size
from divshot_tpu_torch.gsio.png import png_size
from divshot_tpu_torch.splat.gaussians import GaussianParams
from tests.test_mesh_io import CUBE_F, CUBE_V, _write_fbx
from tests.test_readers import _gl_c2w, _write_img
from tests.test_torch_datasets import _assert_same_dataset

CPU = "cpu"
FIELDS = ("means", "scales", "quats", "opacity", "sh0", "shN", "alive")
NAMES = ("m.ply", "m.compressed.ply", "m.reduced.ply", "m.splat", "m.spz",
         "m.dvsplat")


def _carry(jp) -> GaussianParams:
    return GaussianParams.from_numpy(
        {f: np.asarray(getattr(jp, f)) for f in FIELDS}, device=CPU)


def _scene(sh_degree=3, n=700, capacity=800, seed=0):
    """JAX params with a dead tail and the same params in the port."""
    jp = jax_random_scene(np.random.default_rng(seed), n,
                          sh_degree=sh_degree, capacity=capacity)
    return jp, _carry(jp)


def _same_bytes(a: bytes, b: bytes, name: str) -> None:
    if name.endswith(".spz"):
        # the gzip header carries the time in bytes 4-7
        assert a[:4] == b[:4] and a[8:10] == b[8:10], name
        a, b = gzip.decompress(a), gzip.decompress(b)
    assert a == b, name


def _compact(p) -> dict:
    if isinstance(p, GaussianParams):
        return p.compact_numpy()
    return p.compact_numpy()


def _same_params(tp: GaussianParams, jp) -> None:
    a, b = _compact(tp), _compact(jp)
    for k in ("means", "scales", "quats", "opacity", "sh0", "shN"):
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("sh_degree", [0, 1, 3])
@pytest.mark.parametrize("name", NAMES)
def test_writers_match_jax_bytes(tmp_path, name, sh_degree):
    jp, tp = _scene(sh_degree)
    if name == "m.reduced.ply" and sh_degree < 3:
        # both packages' reduced writers reshape every band's ids to the
        # splat count, so a model below SH degree 3 raises in both
        for mod, p in ((JIO, jp), (TIO, tp)):
            with pytest.raises(ValueError, match="cannot reshape"):
                mod.save_model(str(tmp_path / name), p)
        return
    JIO.save_model(str(tmp_path / f"j{name}"), jp, antialiased=True)
    TIO.save_model(str(tmp_path / f"t{name}"), tp, antialiased=True)
    _same_bytes((tmp_path / f"t{name}").read_bytes(),
                (tmp_path / f"j{name}").read_bytes(), name)


@pytest.mark.parametrize("name", NAMES)
def test_each_package_reads_the_others_file(tmp_path, name):
    jp, tp = _scene(3, n=300, capacity=300, seed=1)
    jpath, tpath = str(tmp_path / f"j{name}"), str(tmp_path / f"t{name}")
    JIO.save_model(jpath, jp)
    TIO.save_model(tpath, tp)
    for path in (jpath, tpath):
        tl, tmeta = TIO.load_model(path, device=CPU)
        jl, jmeta = JIO.load_model(path)
        assert tl.capacity == int(jl.capacity) and tl.device.type == "cpu"
        assert tmeta == jmeta
        _same_params(tl, jl)


def test_reduced_half_float_and_degrees_match_jax(tmp_path):
    from divshot_tpu.gsio import reduced as JR
    from divshot_tpu_torch.gsio import reduced as TR
    jp, tp = _scene(3, n=400, capacity=400, seed=2)
    deg = np.random.default_rng(3).integers(0, 4, 400).astype(np.uint8)
    JR.save_reduced_ply(str(tmp_path / "j.reduced.ply"), jp, half_float=True,
                        degrees=deg, kmeans_iters=4)
    TR.save_reduced_ply(str(tmp_path / "t.reduced.ply"), tp, half_float=True,
                        degrees=deg, kmeans_iters=4)
    assert ((tmp_path / "t.reduced.ply").read_bytes()
            == (tmp_path / "j.reduced.ply").read_bytes())
    tl, _ = TR.load_reduced_ply(str(tmp_path / "t.reduced.ply"), device=CPU)
    _same_params(tl, JR.load_reduced_ply(str(tmp_path / "j.reduced.ply"))[0])
    np.testing.assert_array_equal(TR.default_degrees(tp.compact_numpy()),
                                  JR.default_degrees(jp.compact_numpy()))


# ---------------------------------------------------------------------------
# the golden fixtures through the port's writers


class _PortWriters:
    """JAX's writer and reader names, backed by the port's: params carried
    across on the way in, numpy arrays on the way out."""

    @staticmethod
    def wrap_save(fn):
        def save(path, params, **kw):
            return fn(path, _carry(params), **kw)
        return save

    @staticmethod
    def wrap_load(fn):
        def load(path):
            p, meta = fn(path, device=CPU)
            return p, meta
        return load


@pytest.mark.parametrize("test", [
    "test_splat_golden_bytes", "test_compressed_ply_golden_bytes",
    "test_spz_golden_bytes", "test_spz_golden_roundtrip"])
def test_golden_fixtures_through_the_port(tmp_path, monkeypatch, test):
    from divshot_tpu.gsio import ply as JP
    from divshot_tpu_torch.gsio import ply as TP
    from divshot_tpu_torch.gsio import spz as TSPZ
    w = _PortWriters
    monkeypatch.setattr(JP, "save_splat", w.wrap_save(TP.save_splat))
    monkeypatch.setattr(JC, "save_compressed_ply",
                        w.wrap_save(TC.save_compressed_ply))
    monkeypatch.setattr(JSPZ, "save_spz", w.wrap_save(TSPZ.save_spz))
    monkeypatch.setattr(JSPZ, "load_spz", w.wrap_load(TSPZ.load_spz))
    getattr(golden, test)(tmp_path)


# ---------------------------------------------------------------------------
# the dispatch, Morton order, k-means


def test_dispatch(tmp_path):
    jp, tp = _scene(3, n=50, capacity=50)
    for name in NAMES:
        p = str(tmp_path / name)
        TIO.save_model(p, tp)
        loaded, _ = TIO.load_model(p, device=CPU)
        assert loaded.capacity == 50 and loaded.device.type == "cpu"
    # a chunked PLY is read as compressed whatever its name
    os.rename(tmp_path / "m.compressed.ply", tmp_path / "plain.ply")
    sniffed, _ = TIO.load_model(str(tmp_path / "plain.ply"), device=CPU)
    assert sniffed.sh_degree == 0
    for bad in ("m.obj", "m.npz"):
        with pytest.raises(ValueError, match="unknown splat format"):
            TIO.save_model(str(tmp_path / bad), tp)
        with pytest.raises(ValueError, match="unknown splat format"):
            TIO.load_model(str(tmp_path / bad), device=CPU)


def test_morton_order_matches_both_jax_coders(monkeypatch):
    """JAX orders by its native C++ coder when the library builds (it does
    on this host: ``native.get_lib()``), else by its numpy coder; the
    port's order (its own host library's coder, and its numpy coder) is
    the same as both."""
    rng = np.random.default_rng(5)
    pos = np.concatenate([rng.normal(0, 1, (2000, 3)),
                          np.zeros((3, 3)), np.ones((2, 3))]).astype(
        np.float32)
    port = TC.morton_order(pos)
    assert jax_native.get_lib() is not None
    np.testing.assert_array_equal(port, JC.morton_order(pos))
    monkeypatch.setattr(jax_native, "morton_codes", lambda p: None)
    np.testing.assert_array_equal(port, JC.morton_order(pos))
    monkeypatch.setattr(port_native, "morton_codes", lambda p: None)
    np.testing.assert_array_equal(TC.morton_order(pos), port)
    flat = np.zeros((4, 3), np.float32)     # a zero-size bounding box
    np.testing.assert_array_equal(TC.morton_order(flat),
                                  JC.morton_order(flat))


@pytest.mark.parametrize("k,iters,chunk", [(8, 15, 1 << 16), (256, 10, 512),
                                           (256, 3, 1000)])
def test_kmeans_1d_matches_jax(k, iters, chunk):
    rng = np.random.default_rng(k + iters)
    vals = np.concatenate([rng.normal(-5, 0.1, 1000), rng.normal(0, 0.1, 900),
                           rng.normal(5, 0.1, 1100), np.full(20, 0.25)]
                          ).astype(np.float32)
    cj, ij = JK.kmeans_1d(jnp.asarray(vals), k=k, iters=iters, chunk=chunk)
    ct, it = TK.kmeans_1d(torch.from_numpy(vals), k=k, iters=iters,
                          chunk=chunk)
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    recon = ct.numpy()[it.numpy()]
    assert np.abs(recon - vals).mean() < 0.15


def test_make_codebooks_matches_jax():
    jp, _ = _scene(3, n=300, capacity=300, seed=7)
    d = jp.compact_numpy()
    tb = TK.make_codebooks(d, iters=4, device=CPU)
    jb = JK.make_codebooks(d, iters=4)
    assert list(tb) == list(jb) and len(tb) == 20
    for name in jb:
        np.testing.assert_array_equal(tb[name][0], jb[name][0], name)
        assert tb[name][1].dtype == np.uint8
        np.testing.assert_array_equal(tb[name][1], jb[name][1], name)


# ---------------------------------------------------------------------------
# the pose readers


def _nerfstudio(root, sizes=True):
    (root / "images").mkdir(parents=True)
    frames = []
    for i, eye in enumerate([[3, 1, 0], [0, 1.5, 3], [-2, 0.5, -2]]):
        name = f"images/frame_{i:05d}.png"
        _write_img(str(root / name), seed=i,
                   alpha=np.linspace(0, 1, 32 * 24).reshape(24, 32)
                   if i == 1 else None)
        frames.append({"file_path": name,
                       "transform_matrix": _gl_c2w(eye).tolist()})
    meta = {"fl_x": 40.0, "fl_y": 41.0, "cx": 16.0, "cy": 12.0,
            "frames": frames}
    if sizes:
        meta.update(w=32, h=24)
    (root / "transforms.json").write_text(json.dumps(meta))
    return str(root)


def _opensfm(root):
    (root / "images").mkdir(parents=True)
    # the fixture's images as JPEG, as tests/test_readers.py writes them
    for n in ("a.jpg", "b.jpg"):
        _write_img(str(root / "images" / n))
    rec = [{
        "cameras": {"cam1": {"projection_type": "perspective",
                             "width": 32, "height": 24, "focal": 0.9},
                    "fish": {"projection_type": "fisheye",
                             "width": 32, "height": 24}},
        "shots": {
            "a.jpg": {"camera": "cam1", "rotation": [0.0, 0.0, 0.0],
                      "translation": [0.0, 0.0, 4.0]},
            "b.jpg": {"camera": "cam1", "rotation": [0.0, 0.3, 0.0],
                      "translation": [0.5, 0.0, 4.0]},
            "c.jpg": {"camera": "fish", "rotation": [0.1, 0.0, 0.0],
                      "translation": [0.0, 0.0, 4.0]},
        },
        "points": {
            "1": {"coordinates": [0, 0, 0], "color": [255, 0, 0]},
            "2": {"coordinates": [1, 0, 0], "color": [0, 255, 0]},
        },
    }]
    (root / "reconstruction.json").write_text(json.dumps(rec))
    return str(root)


def _realitycapture(root):
    root.mkdir()
    for n in ("i1.png", "i2.png"):
        _write_img(str(root / n))
    (root / "cameras.csv").write_text(
        "#name,x,y,z,heading,pitch,roll,f,px,py\n"
        "i1.png,1.0,2.0,3.0,0.0,0.0,0.0,36.0,0.0,0.0\n"
        "i2.png,-1.0,2.0,3.0,90.0,10.0,0.0,36.0,0.01,-0.01\n")
    return str(root / "cameras.csv")


def _metashape(root):
    (root / "images").mkdir(parents=True)
    for n in ("c0.png", "c1.png"):
        _write_img(str(root / "images" / n))
    c2w0 = np.eye(4)
    c2w0[:3, 3] = [0, 0, -5]
    c2w1 = np.eye(4)
    c2w1[:3, 3] = [1, 0, -5]
    cams = "".join(
        f'<camera id="{i}" sensor_id="0" label="c{i}.png"><transform>'
        f"{' '.join(str(v) for v in m.ravel())}</transform></camera>"
        for i, m in enumerate((c2w0, c2w1)))
    (root / "cameras.xml").write_text(
        '<?xml version="1.0"?><document><chunk><sensors><sensor id="0">'
        '<calibration><resolution width="32" height="24"/><f>40.0</f>'
        "<cx>0.5</cx><cy>-0.5</cy></calibration></sensor></sensors>"
        "<transform><rotation>0 -1 0 1 0 0 0 0 1</rotation><translation>"
        "0.5 0 0.25</translation><scale>2</scale></transform>"
        f"<cameras>{cams}</cameras></chunk></document>")
    return str(root / "cameras.xml")


READERS = {"nerfstudio": _nerfstudio, "opensfm": _opensfm,
           "realitycapture": _realitycapture, "metashape": _metashape}


@pytest.mark.parametrize("kind", list(READERS))
def test_pose_readers_match_jax(tmp_path, kind):
    src = READERS[kind](tmp_path / kind)
    kw = dict(eval_holdout=2, max_width=24, use_mask=True,
              white_background=True)
    train, ev = load_dataset(src, kind, device=CPU, **kw)
    jtrain, jev = jax_load_dataset(src, kind, **kw)
    _assert_same_dataset(train, jtrain)
    _assert_same_dataset(ev, jev)
    np.testing.assert_array_equal(train.masks.numpy(),
                                  np.asarray(jtrain.masks))


def test_nerfstudio_sizes_and_type_codes(tmp_path):
    """Frames without w / h take the image's size from its header (JAX:
    Pillow's), a PNG's and a JPEG's; the integer code 0 is nerfstudio; a
    file path dispatches by extension."""
    src = _nerfstudio(tmp_path / "ns", sizes=False)
    # frame 2 as a JPEG under its own name
    meta = json.loads((tmp_path / "ns" / "transforms.json").read_text())
    meta["frames"][2]["file_path"] = "images/frame_00002.jpg"
    _write_img(f"{src}/images/frame_00002.jpg", seed=2)
    (tmp_path / "ns" / "transforms.json").write_text(json.dumps(meta))
    train, _ = load_dataset(src, 0, device=CPU)
    jtrain, _ = jax_load_dataset(src, 0)
    _assert_same_dataset(train, jtrain)
    assert png_size(f"{src}/images/frame_00000.png") == (32, 24)
    assert jpeg_size(f"{src}/images/frame_00002.jpg") == (32, 24)
    t2, _ = load_dataset(f"{src}/transforms.json", device=CPU)
    assert t2.num_views == 3


def test_realitycapture_size_from_png_header(tmp_path):
    """The size comes from the PNG's IHDR chunk, or a JPEG's SOF header
    whatever the file's name; a file that is neither raises JAX's own
    "pass width=/height=" error, and the given width and height are taken
    as they are."""
    csv = _realitycapture(tmp_path / "rc")
    cams, paths, _, _ = readers.load_realitycapture(csv, device=CPU)
    assert (cams[0].width, cams[0].height) == (32, 24)
    _write_img(str(tmp_path / "rc" / "i1.jpg"), w=40, h=30)
    os.replace(tmp_path / "rc" / "i1.jpg", tmp_path / "rc" / "i1.png")
    cams, _, _, _ = readers.load_realitycapture(csv, device=CPU)
    assert (cams[0].width, cams[0].height) == (40, 30)
    (tmp_path / "rc" / "i1.png").write_bytes(b"\xff\xd8\xff\xe0 not a png")
    with pytest.raises(ValueError, match="pass width=/height="):
        readers.load_realitycapture(csv, device=CPU)
    cams, _, _, _ = readers.load_realitycapture(csv, width=64, height=48,
                                                device=CPU)
    assert cams[1].fx == pytest.approx(64.0)


def test_nerfstudio_seed_ply(tmp_path):
    from divshot_tpu.gsio.readers import load_nerfstudio as jax_ns
    from divshot_tpu_torch.gsio.ply import save_point_cloud_ply
    src = _nerfstudio(tmp_path / "ns")
    meta = json.loads((tmp_path / "ns" / "transforms.json").read_text())
    meta["ply_file_path"] = "seed.ply"
    (tmp_path / "ns" / "transforms.json").write_text(json.dumps(meta))
    pts = np.random.default_rng(0).normal(size=(40, 3)).astype(np.float32)
    save_point_cloud_ply(f"{src}/seed.ply", pts,
                         np.linspace(0, 1, 120).reshape(40, 3))
    _, _, tp, tc = readers.load_nerfstudio(f"{src}/transforms.json",
                                           device=CPU)
    _, _, jpts, jcols = jax_ns(f"{src}/transforms.json")
    np.testing.assert_array_equal(tp, jpts)
    np.testing.assert_array_equal(tc, jcols)


# ---------------------------------------------------------------------------
# the mesh readers


def _obj(tmp_path):
    (tmp_path / "m.mtl").write_text("newmtl red\nKd 1.0 0.1 0.1\n")
    lines = ["mtllib m.mtl"] + [f"v {x} {y} {z}" for x, y, z in CUBE_V]
    lines += ["vt 0.5 0.25", "vn 0 0 1", "usemtl red"]
    lines += [f"f {a + 1}/1/1 {b + 1}/1/1 {c + 1}/1/1" for a, b, c in CUBE_F]
    lines += ["f 1 2 4 3"]                         # a quad, fan-split
    (tmp_path / "cube.obj").write_text("\n".join(lines))
    return str(tmp_path / "cube.obj")


def _gltf(tmp_path):
    pos = CUBE_V.astype(np.float32)
    idx = CUBE_F.astype(np.uint32).reshape(-1)
    blob = pos.tobytes() + idx.tobytes()
    gltf = {
        "asset": {"version": "2.0"},
        "buffers": [{"byteLength": len(blob), "uri": "cube.bin"}],
        "bufferViews": [
            {"buffer": 0, "byteOffset": 0, "byteLength": pos.nbytes},
            {"buffer": 0, "byteOffset": pos.nbytes,
             "byteLength": idx.nbytes}],
        "accessors": [
            {"bufferView": 0, "componentType": 5126, "count": 8,
             "type": "VEC3"},
            {"bufferView": 1, "componentType": 5125, "count": 36,
             "type": "SCALAR"}],
        "materials": [{"pbrMetallicRoughness":
                       {"baseColorFactor": [0.2, 0.9, 0.3, 1.0]}}],
        "meshes": [{"primitives": [
            {"attributes": {"POSITION": 0}, "indices": 1, "material": 0}]}],
    }
    (tmp_path / "cube.bin").write_bytes(blob)
    (tmp_path / "cube.gltf").write_text(json.dumps(gltf))
    return str(tmp_path / "cube.gltf")


def _fbx(tmp_path):
    _write_fbx(str(tmp_path / "cube.fbx"))
    return str(tmp_path / "cube.fbx")


@pytest.mark.parametrize("maker", [_obj, _gltf, _fbx])
def test_mesh_readers_match_jax(tmp_path, maker):
    path = maker(tmp_path)
    tm, jm = TM.load_mesh(path), JM.load_mesh(path)
    assert tm.num_faces >= 12 and tm.num_vertices >= 8
    for f in ("positions", "faces", "normals", "uvs", "colors",
              "face_colors"):
        a, b = getattr(tm, f), getattr(jm, f)
        assert (a is None) == (b is None), f
        if a is not None:
            np.testing.assert_array_equal(a, b, err_msg=f)
    assert tm.name == jm.name
    with pytest.raises(ValueError, match="unsupported mesh format"):
        TM.load_mesh(str(tmp_path / "x.stl"))


# ---------------------------------------------------------------------------
# the export app


@pytest.mark.parametrize("name", NAMES[1:])
def test_export_app_matches_jax(tmp_path, name):
    jp, tp = _scene(3, n=300, capacity=300, seed=4)
    src = str(tmp_path / "in.ply")
    TIO.save_model(src, tp, antialiased=True)
    t_out, j_out = str(tmp_path / f"t{name}"), str(tmp_path / f"j{name}")
    assert export_app.main(["--input", src, "--output", t_out,
                            "--device", "cpu"]) == 0
    assert jax_export.main(["--input", src, "--output", j_out]) == 0
    _same_bytes(open(t_out, "rb").read(), open(j_out, "rb").read(), name)
    back, meta = TIO.load_model(t_out, device=CPU)
    _same_params(back, JIO.load_model(j_out)[0])
    assert meta.get("antialiased", False) == (
        name.endswith((".compressed.ply", ".spz")))
    # and back to a plain PLY through the app
    again = str(tmp_path / "again.ply")
    assert export_app.main(["--input", t_out, "--output", again,
                            "--device", "cpu"]) == 0
    _same_params(TIO.load_model(again, device=CPU)[0],
                 JIO.load_model(again)[0])
    np.testing.assert_array_equal(
        TIO.load_model(again, device=CPU)[0].compact_numpy()["means"],
        back.compact_numpy()["means"])
