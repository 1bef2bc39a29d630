"""Splat -> mesh extraction (counterpart of ``divshot_tpu/viewer/mesh.py``):
each view's expected depth composited through the kernels, TSDF fusion
into a voxel grid on the card, marching tetrahedra on the host, OBJ out.

- ``render_depth``: the splats' camera-space depth as a three-channel
  colour (``render(override_colors=...)``: the expand and forward
  kernels, no autograd), normalised by the alpha;
- ``tsdf_fuse``: torch on the depths' device, chunked over voxels, the
  JAX function's arithmetic in float32;
- ``marching_tetrahedra`` and ``save_obj``: numpy on the host, JAX's
  arithmetic (the marching walks only the cubes the surface crosses).
"""

from __future__ import annotations

import numpy as np
import torch

from divshot_tpu_torch.raster.render import render
from divshot_tpu_torch.splat.camera import Camera
from divshot_tpu_torch.splat.gaussians import GaussianParams
from divshot_tpu_torch.splat.math import matvec3


def render_depth(params: GaussianParams, camera: Camera,
                 **render_kw) -> tuple[torch.Tensor, torch.Tensor]:
    """-> (expected depth (H, W), alpha (H, W)), on the params' device:
    the depth composited as a per-splat colour, divided by the alpha
    (at least 1e-6)."""
    R, t = camera.rotation, camera.translation
    m = params.means
    z = R[2][0] * m[:, 0] + R[2][1] * m[:, 1] + R[2][2] * m[:, 2] + t[2]
    with torch.no_grad():
        out = render(params, camera,
                     override_colors=torch.stack([z, z, z], -1), **render_kw)
    depth = out.image[..., 0] / torch.clamp_min(out.alpha, 1e-6)
    return depth, out.alpha


def tsdf_fuse(
    depths: list[torch.Tensor], alphas: list[torch.Tensor],
    cameras: list[Camera], *,
    resolution: int = 128,
    bounds: tuple[np.ndarray, np.ndarray] | None = None,
    trunc: float | None = None,
    alpha_thresh: float = 0.5,
    chunk: int = 1 << 20,
) -> tuple[np.ndarray, np.ndarray, float]:
    """Fuse depth maps (tensors, or numpy arrays) into a TSDF grid ->
    (tsdf (R, R, R) float32, the grid's minimum corner, the cell size).
    Without ``bounds`` the grid spans the camera centres' mean +- 0.7 of
    their largest distance from it."""
    def tensor(x, device=None):
        if not isinstance(x, torch.Tensor):
            x = torch.from_numpy(np.array(x, np.float32))
        return x if device is None else x.to(device)

    dev = tensor(depths[0]).device
    if bounds is None:
        centers = np.stack([c.campos.cpu().numpy() for c in cameras])
        mid = centers.mean(0)
        rad = np.linalg.norm(centers - mid, axis=1).max() * 0.7
        lo, hi = mid - rad, mid + rad
    else:
        lo, hi = bounds
    lo = np.asarray(lo, np.float32)
    hi = np.asarray(hi, np.float32)
    cell = float((hi - lo).max() / resolution)
    if trunc is None:
        trunc = 4.0 * cell
    trunc = float(np.float32(trunc))

    # the voxel centres, x slowest, in JAX's float32 arithmetic
    r = resolution
    ii = np.arange(r, dtype=np.float32) + 0.5
    gx, gy, gz = np.meshgrid(ii, ii, ii, indexing="ij")
    pts = torch.as_tensor(np.stack([lo[0] + gx * (hi[0] - lo[0]) / r,
                                    lo[1] + gy * (hi[1] - lo[1]) / r,
                                    lo[2] + gz * (hi[2] - lo[2]) / r],
                                   -1).reshape(-1, 3), device=dev)
    n = pts.shape[0]
    acc = torch.zeros((n,), device=dev)
    wacc = torch.zeros((n,), device=dev)
    views = [(cam, tensor(d, dev), tensor(a, dev))
             for cam, d, a in zip(cameras, depths, alphas)]
    for s in range(0, n, chunk):
        e = min(n, s + chunk)
        for cam, depth, alpha in views:
            p = matvec3(cam.rotation, pts[s:e], cam.translation)
            z = p[:, 2]
            H, W = depth.shape
            zc = torch.clamp_min(z, 1e-6)
            u = (cam.fx * p[:, 0] / zc + cam.cx).to(torch.int32)
            v = (cam.fy * p[:, 1] / zc + cam.cy).to(torch.int32)
            inside = (z > 0.01) & (u >= 0) & (u < W) & (v >= 0) & (v < H)
            uu = torch.clamp(u, 0, W - 1).long()
            vv = torch.clamp(v, 0, H - 1).long()
            d = depth[vv, uu]
            a = alpha[vv, uu]
            sdf = (d - z) / trunc
            valid = inside & (a > alpha_thresh) & (sdf > -1.0)
            w = valid.float()
            acc[s:e] += w * torch.clamp(sdf, -1.0, 1.0)
            wacc[s:e] += w
    tsdf = torch.where(wacc > 0, acc / torch.clamp_min(wacc, 1e-6),
                       torch.ones((), device=dev))
    return tsdf.cpu().numpy().reshape(r, r, r), lo, cell


# ---------------------------------------------------------------------------
# marching tetrahedra

# six tetrahedra a cube (corner indices into the 8 cube corners)
_TETS = np.array([
    [0, 5, 1, 6], [0, 1, 2, 6], [0, 2, 3, 6],
    [0, 3, 7, 6], [0, 7, 4, 6], [0, 4, 5, 6],
])
_CUBE_OFFS = np.array([
    [0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
    [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1],
])
# a tetrahedron's 6 edges, and its triangles as edge-index triples by the
# 4-bit case of its corners inside (tsdf < 0)
_TET_EDGES = [(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)]
_TRI_TABLE = {
    0b0001: [(0, 1, 2)], 0b1110: [(0, 2, 1)],
    0b0010: [(0, 4, 3)], 0b1101: [(0, 3, 4)],
    0b0100: [(1, 3, 5)], 0b1011: [(1, 5, 3)],
    0b1000: [(2, 5, 4)], 0b0111: [(2, 4, 5)],
    0b0011: [(1, 2, 4), (2, 3, 4)], 0b1100: [(1, 4, 2), (2, 4, 3)],
    0b0101: [(0, 3, 2), (2, 3, 5)], 0b1010: [(0, 2, 3), (2, 5, 3)],
    0b0110: [(0, 4, 1), (1, 4, 5)], 0b1001: [(0, 1, 4), (1, 5, 4)],
}


def marching_tetrahedra(tsdf: np.ndarray, grid_min: np.ndarray,
                        cell: float) -> tuple[np.ndarray, np.ndarray]:
    """The zero isosurface -> (vertices (V, 3) float32, faces (F, 3)
    int32); vertices closer than 1e-4 cells merged, degenerate faces
    dropped. Only the cubes the surface crosses (corners of both signs)
    are walked, in the grid's order: the others make no triangle, so the
    result is JAX's, which walks every cube."""
    r = tsdf.shape[0]
    corners = np.stack([tsdf[dx:dx + r - 1, dy:dy + r - 1, dz:dz + r - 1]
                        for dx, dy, dz in _CUBE_OFFS], -1).reshape(-1, 8)
    neg = corners < 0
    crossed = np.nonzero(neg.any(1) & ~neg.all(1))[0]
    base = np.stack(np.unravel_index(crossed, (r - 1,) * 3), -1)
    corner_idx = base[:, None, :] + _CUBE_OFFS[None, :, :]   # (C, 8, 3)
    vals = corners[crossed]
    pos = grid_min[None, None, :] + corner_idx.astype(np.float32) * cell

    verts_out = []
    for tet in _TETS:
        tv = vals[:, tet]                    # (C, 4)
        tp = pos[:, tet]                     # (C, 4, 3)
        inside = tv < 0
        case = (inside[:, 0].astype(int) | (inside[:, 1].astype(int) << 1)
                | (inside[:, 2].astype(int) << 2)
                | (inside[:, 3].astype(int) << 3))

        def edge_pt(ei):
            a, b = _TET_EDGES[ei]
            va, vb = tv[:, a], tv[:, b]
            t = va / np.where(np.abs(va - vb) < 1e-12, 1e-12, va - vb)
            t = np.clip(t, 0.0, 1.0)[:, None]
            return tp[:, a] * (1 - t) + tp[:, b] * t

        epts = None
        for code, tris in _TRI_TABLE.items():
            m = case == code
            if not m.any():
                continue
            if epts is None:
                epts = [edge_pt(e) for e in range(6)]
            for (e0, e1, e2) in tris:
                verts_out.append(np.stack(
                    [epts[e0][m], epts[e1][m], epts[e2][m]], 1))

    if not verts_out:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32)
    flat = np.concatenate(verts_out).reshape(-1, 3)
    uniq, inv = np.unique(np.round(flat / (cell * 1e-4)).astype(np.int64),
                          axis=0, return_inverse=True)
    inv = inv.reshape(-1)
    verts = np.zeros((len(uniq), 3), np.float32)
    verts[inv] = flat
    faces = inv.reshape(-1, 3).astype(np.int32)
    ok = ((faces[:, 0] != faces[:, 1]) & (faces[:, 1] != faces[:, 2])
          & (faces[:, 0] != faces[:, 2]))
    return verts, faces[ok]


def save_obj(path: str, verts: np.ndarray, faces: np.ndarray) -> None:
    with open(path, "w") as f:
        f.write("# divshot_tpu mesh export\n")
        for v in verts:
            f.write(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
        for face in faces + 1:
            f.write(f"f {face[0]} {face[1]} {face[2]}\n")


def extract_mesh(params: GaussianParams, cameras: list[Camera], *,
                 resolution: int = 128, out_path: str | None = None,
                 render_kw: dict | None = None
                 ) -> tuple[np.ndarray, np.ndarray]:
    """Depth of each camera, TSDF fusion, marching tetrahedra, and the OBJ
    written to ``out_path`` when given -> (vertices, faces)."""
    rk = render_kw or {}
    depths, alphas = [], []
    for cam in cameras:
        d, a = render_depth(params, cam, **rk)
        depths.append(d)
        alphas.append(a)
    tsdf, lo, cell = tsdf_fuse(depths, alphas, cameras,
                               resolution=resolution)
    verts, faces = marching_tetrahedra(tsdf, lo, cell)
    if out_path:
        save_obj(out_path, verts, faces)
    return verts, faces
