"""Mesh G-buffer rasterization and splat compositing (counterpart of
``divshot_tpu/raster/mesh_raster.py``; XLA there, torch ops here).

Triangles are binned to 16x16 tiles by the splats' binning
(``raster/tiles.bin_gaussians``, a triangle's screen box as a centre and
a radius, its mean depth as the key), with JAX's ``tile_capacity``,
``instance_capacity`` and ``chunk``: the instances past either capacity
are dropped, as there. Each tile then z-buffers its triangles a chunk at
a time (barycentrics from edge functions, perspective-correct 1/z,
nearest triangle per pixel; a tie keeps the earlier triangle of the
depth order, as JAX's ``argmin`` and strict ``<`` do), and interpolates
the winner's normal and albedo. Each chunk is walked by the tiles that
hold a triangle in it, and no further than the densest tile's count: a
column without a triangle changes no pixel, so the result is JAX's.

Outputs (the G-buffer): depth (inf = miss), camera-space normal, albedo,
triangle id (-1 = miss; the picking buffer).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from divshot_tpu_torch.raster import tiles as T
from divshot_tpu_torch.splat.camera import Camera
from divshot_tpu_torch.splat.math import matvec3


class GBuffer(NamedTuple):
    depth: torch.Tensor    # (H, W) view z, +inf on miss
    normal: torch.Tensor   # (H, W, 3) camera-space
    albedo: torch.Tensor   # (H, W, 3)
    tri_id: torch.Tensor   # (H, W) int32, -1 on miss


_ZERO3 = (0.0, 0.0, 0.0)


def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``jnp.cross`` of (..., 3) vectors, component for component."""
    a0, a1, a2 = a.unbind(-1)
    b0, b1, b2 = b.unbind(-1)
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2,
                        a0 * b1 - a1 * b0], -1)


def _norm(x: torch.Tensor, keepdim: bool = False) -> torch.Tensor:
    """``jnp.linalg.norm`` over the last axis of 3-vectors."""
    return torch.sqrt((x * x).sum(-1, keepdim=keepdim))


def _interp(wz: torch.Tensor, attr: torch.Tensor) -> torch.Tensor:
    """sum_v wz[..., v] * attr[..., v, :] of (..., 3) weights and (..., 3v,
    3) vertex attributes."""
    return (wz[..., 0:1] * attr[..., 0, :] + wz[..., 1:2] * attr[..., 1, :]
            + wz[..., 2:3] * attr[..., 2, :])


def _project_tris(positions, faces, camera: Camera):
    """-> per-face screen vertices (F, 3, 2), view-space z (F, 3),
    camera-space vertex positions (F, 3, 3)."""
    pv = matvec3(camera.rotation, positions, camera.translation)
    z = torch.clamp_min(pv[:, 2], 1e-6)
    u = camera.fx * pv[:, 0] / z + camera.cx
    v = camera.fy * pv[:, 1] / z + camera.cy
    scr = torch.stack([u, v], -1)
    return scr[faces], pv[faces][..., 2], pv[faces]


def rasterize_mesh(
    positions,                  # (V, 3) world
    faces,                      # (F, 3) int
    camera: Camera,
    *,
    normals=None,               # (V, 3) world, per-vertex
    colors=None,                # (V, 3) per-vertex albedo
    face_colors=None,           # (F, 3) per-face albedo
    tile_size: int = 16,
    tile_capacity: int = 256,
    instance_capacity: int = 1 << 18,
    chunk: int = 16,
) -> GBuffer:
    """Z-buffered G-buffer rasterization of a triangle mesh on the
    camera's device."""
    dev = camera.device
    positions = _f32(positions, dev)
    faces = torch.as_tensor(faces, device=dev).long()
    W, H = camera.width, camera.height
    tw, th = T._tile_grid(W, H, tile_size)
    num_tiles = tw * th
    px = tile_size * tile_size
    F = faces.shape[0]

    scr, zf, pvf = _project_tris(positions, faces, camera)
    front = torch.all(zf > 1e-4, dim=1)
    lo = scr.amin(1)
    hi = scr.amax(1)
    center = 0.5 * (lo + hi)
    radius = torch.ceil(0.5 * (hi - lo).amax(1)) + 1.0
    radius = torch.where(front, radius, 0.0)
    depth_c = zf.mean(1)

    bins = T.bin_gaussians(center, depth_c, radius, W, H,
                           tile_size=tile_size, tile_capacity=tile_capacity,
                           instance_capacity=instance_capacity,
                           max_tiles_per_gaussian=256, build_ids_mat=True)
    ids_mat = bins.ids_mat                              # (T, K)

    if normals is not None:
        ncam = matvec3(camera.rotation, _f32(normals, dev), _ZERO3)
        nrm_f = ncam[faces]                             # (F, 3v, 3)
    else:
        fn = _cross(pvf[:, 1] - pvf[:, 0], pvf[:, 2] - pvf[:, 0])
        fn = fn / torch.clamp_min(_norm(fn, keepdim=True), 1e-12)
        nrm_f = fn[:, None, :].expand(F, 3, 3)
    if colors is not None:
        col_f = _f32(colors, dev)[faces]
    elif face_colors is not None:
        col_f = _f32(face_colors, dev)[:, None, :].expand(F, 3, 3)
    else:
        col_f = torch.full((F, 3, 3), 0.8, device=dev)

    pix = torch.as_tensor(T._pixel_coords(W, H, tile_size), device=dev)
    zb = torch.full((num_tiles, px), math.inf, device=dev)
    nb = torch.zeros((num_tiles, px, 3), device=dev)
    ab = torch.zeros((num_tiles, px, 3), device=dev)
    ib = torch.full((num_tiles, px), -1, dtype=torch.int32, device=dev)
    counts = (ids_mat >= 0).sum(1)
    filled = int(counts.max()) if ids_mat.numel() else 0
    for lo_c in range(0, min(filled, ids_mat.shape[1] // chunk * chunk),
                      chunk):
        act = torch.nonzero(counts > lo_c).squeeze(1)   # tiles in the chunk
        ids = ids_mat[act, lo_c:lo_c + chunk]           # (A, C)
        pxx = pix[act, None, :, 0]                      # (A, 1, px)
        pyy = pix[act, None, :, 1]
        safe = torch.clamp_min(ids, 0).long()
        v2 = scr[safe]                                  # (A, C, 3, 2)
        zc = zf[safe]                                   # (A, C, 3)
        ax, ay = v2[..., 0, 0, None], v2[..., 0, 1, None]
        bx, by = v2[..., 1, 0, None], v2[..., 1, 1, None]
        cx, cy = v2[..., 2, 0, None], v2[..., 2, 1, None]
        den = (by - cy) * (ax - cx) + (cx - bx) * (ay - cy)
        den_ok = torch.abs(den) > 1e-12
        den_s = torch.where(den_ok, den, 1.0)
        w0 = ((by - cy) * (pxx - cx) + (cx - bx) * (pyy - cy)) / den_s
        w1 = ((cy - ay) * (pxx - cx) + (ax - cx) * (pyy - cy)) / den_s
        w2 = 1.0 - w0 - w1
        inside = ((w0 >= 0) & (w1 >= 0) & (w2 >= 0) & den_ok
                  & (ids[..., None] >= 0))
        # perspective-correct: interpolate 1/z and attr/z
        iz = w0 / zc[..., 0:1] + w1 / zc[..., 1:2] + w2 / zc[..., 2:3]
        zpx = 1.0 / torch.clamp_min(iz, 1e-12)          # (A, C, px)
        zpx = torch.where(inside, zpx, math.inf)
        # the chunk's nearest triangle per pixel (the first of a tie)
        zbest, arg = torch.min(zpx, dim=1)              # (A, px)
        better = zbest < zb[act]
        # the winner's attributes: its weights over 1/z, times its z
        a = arg[:, None, :]
        wst = torch.stack([w0.gather(1, a)[:, 0], w1.gather(1, a)[:, 0],
                           w2.gather(1, a)[:, 0]], -1)  # (A, px, 3)
        win = safe.gather(1, arg)                       # (A, px)
        izc = 1.0 / zc.gather(1, arg[..., None].expand(-1, -1, 3))
        wz = wst * izc
        nbest = _interp(wz, nrm_f[win]) * zbest[..., None]
        cbest = _interp(wz, col_f[win]) * zbest[..., None]
        ibest = torch.where(torch.isfinite(zbest), win, -1).to(torch.int32)
        zb[act] = torch.where(better, zbest, zb[act])
        nb[act] = torch.where(better[..., None], nbest, nb[act])
        ab[act] = torch.where(better[..., None], cbest, ab[act])
        ib[act] = torch.where(better, ibest, ib[act])

    def to_img(rows, c):
        img = rows.reshape(th, tw, tile_size, tile_size, c)
        img = img.permute(0, 2, 1, 3, 4).reshape(th * tile_size,
                                                 tw * tile_size, c)
        return img[:H, :W]

    return GBuffer(depth=to_img(zb[..., None], 1)[..., 0],
                   normal=to_img(nb, 3), albedo=to_img(ab, 3),
                   tri_id=to_img(ib[..., None], 1)[..., 0])


def shade_gbuffer(gb: GBuffer, *, light_dir=(0.4, -0.7, -0.6),
                  ambient: float = 0.35) -> torch.Tensor:
    """Simple lambertian shade of the G-buffer (camera-space light)."""
    ld = _f32(light_dir, gb.depth.device)
    ld = ld / _norm(ld)
    ndl = torch.clamp(-(gb.normal * ld).sum(-1), 0.0, 1.0)
    hit = torch.isfinite(gb.depth)
    rgb = gb.albedo * (ambient + (1 - ambient) * ndl)[..., None]
    return torch.where(hit[..., None], rgb, 0.0)


def shade_gbuffer_lights(gb: GBuffer, camera: Camera, lights, *,
                         ambient: float = 0.15) -> torch.Tensor:
    """Shade the G-buffer with the scene's analytic lights
    (``scene.components.Light``): DIRECTIONAL, POINT (smooth range
    falloff), SPOT (inner / outer cone); RECT, DISK and CYLINDER as point
    lights at their centre with area-scaled intensity. Positions and
    directions are world-space; shading happens in world space."""
    from divshot_tpu_torch.raster.path_trace import _gbuffer_world
    from divshot_tpu_torch.scene.components import LightType
    H, W = gb.depth.shape
    dev = gb.depth.device
    hit = torch.isfinite(gb.depth)
    pos_w, n_w = _gbuffer_world(gb, camera)

    radiance = torch.full((H, W, 3), ambient, device=dev)
    for lt in lights:
        col = _f32(lt.color, dev) * float(lt.intensity)
        if lt.type == LightType.DIRECTIONAL:
            ld = _f32(lt.direction, dev)
            ld = ld / torch.clamp_min(_norm(ld), 1e-8)
            ndl = torch.clamp(-(n_w * ld).sum(-1), 0.0, 1.0)
            radiance = radiance + ndl[..., None] * col
            continue
        if lt.type in (LightType.RECT, LightType.DISK, LightType.CYLINDER):
            area = max(float(lt.size[0]) * float(lt.size[1]), 1e-4)
            col = col * area
        lp = _f32(lt.position, dev)
        to_l = lp[None, None, :] - pos_w
        dist = torch.clamp_min(_norm(to_l), 1e-6)
        ldir = to_l / dist[..., None]
        ndl = torch.clamp((n_w * ldir).sum(-1), 0.0, 1.0)
        rng = max(float(lt.range), 1e-3)
        # UE-style smooth range window over inverse-square falloff
        q = dist / rng
        q = q * q
        win = torch.clamp(1.0 - q * q, 0.0, 1.0)
        atten = win * win / (1.0 + dist * dist)
        if lt.type == LightType.SPOT:
            sd = _f32(lt.direction, dev)
            sd = sd / torch.clamp_min(_norm(sd), 1e-8)
            cos = (-ldir * sd[None, None, :]).sum(-1)
            ci = float(np.cos(lt.inner_angle))
            co = float(np.cos(lt.outer_angle))
            cone = torch.clamp((cos - co) / max(ci - co, 1e-4), 0.0, 1.0)
            atten = atten * cone * cone
        radiance = radiance + (ndl * atten)[..., None] * col

    rgb = gb.albedo * radiance
    return torch.where(hit[..., None], rgb, 0.0)


def composite_splats_over_mesh(splat_rgb, splat_alpha, splat_depth,
                               gb: GBuffer, mesh_rgb, background=None):
    """Hybrid composite (the deferred renderer's depth test): where the
    mesh surface is closer than the splats' depth, the mesh shades in
    front; elsewhere the splats blend over the mesh, which replaces the
    background for the rays that hit it."""
    dev = gb.depth.device
    if background is None:
        background = torch.zeros((3,), device=dev)
    background = _f32(background, dev)
    hit = torch.isfinite(gb.depth)
    mesh_col = torch.where(hit[..., None], mesh_rgb,
                           background[None, None, :])
    splat_front = (~hit) | (splat_depth <= gb.depth)
    over = splat_rgb + (1.0 - splat_alpha)[..., None] * mesh_col
    return torch.where(splat_front[..., None], over, mesh_col)


def pick_triangle(gb: GBuffer, x: int, y: int) -> int:
    """Object / face picking: the triangle id under a pixel (-1 = none)."""
    return int(gb.tri_id[y, x])
