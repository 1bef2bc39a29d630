"""Path-traced render mode for mesh + splat scenes (counterpart of
``divshot_tpu/raster/path_trace.py``; XLA there, torch ops here).

Primary visibility is the z-buffered G-buffer (``mesh_raster.py``); the
secondary rays (cosine-sampled environment bounces and a sun shadow ray)
are Möller-Trumbore tests against every triangle, no BVH, as in JAX. The
(rays x faces) tests run in blocks of at most 2^24 pairs, so a 1080p frame
against a mesh of thousands of faces never holds its whole block at once;
an OR over the blocks is JAX's OR over its face chunks, bit for bit. Only
the rays of pixels that hit the mesh are traced: the others' visibility
is 0 in JAX too.

Random draws come from a ``torch.Generator`` where JAX splits a PRNG key
(``_cosine_dirs`` takes its two uniforms); ``_path_trace`` takes the
draws, so the tests can give it JAX's.

Splats composite over the path-traced surface through the hybrid depth
test (``composite_splats_over_mesh``); ``render_hybrid_pt`` takes the
splat image, alpha and depth from the caller, e.g. ``render()`` on the
kernel route.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from divshot_tpu_torch.models.background import sample_envmap
from divshot_tpu_torch.raster.mesh_raster import (GBuffer, _cross, _f32,
                                                  _norm,
                                                  composite_splats_over_mesh,
                                                  rasterize_mesh)
from divshot_tpu_torch.splat.camera import Camera
from divshot_tpu_torch.splat.math import matvec3

# (rays x faces) pairs a block of ray_occluded
BLOCK_PAIRS = 1 << 24


def ray_occluded(origins: torch.Tensor,      # (M, 3)
                 dirs: torch.Tensor,         # (M, 3) normalized
                 positions,                  # (V, 3)
                 faces,                      # (F, 3)
                 *, t_min: float = 1e-3, chunk: int = 256,
                 t_max=None) -> torch.Tensor:
    """-> (M,) bool: does any triangle block the ray in (t_min, t_max)?
    Möller-Trumbore with JAX's arithmetic, component for component.
    ``t_max`` (scalar or (M,)) bounds shadow rays toward lights; None is
    unbounded. ``chunk`` is the least face block (JAX's scan chunk); the
    blocks never change the result."""
    dev = origins.device
    positions = _f32(positions, dev)
    faces = torch.as_tensor(faces, device=dev).long()
    tri = positions[faces]                               # (F, 3, 3)
    v0 = tri[:, 0]
    e1 = tri[:, 1] - tri[:, 0]
    e2 = tri[:, 2] - tri[:, 0]
    M, F = origins.shape[0], faces.shape[0]
    occ = torch.zeros(M, dtype=torch.bool, device=dev)
    if M == 0 or F == 0:
        return occ
    fb = min(F, max(chunk, BLOCK_PAIRS // M))
    rb = max(1, BLOCK_PAIRS // fb)
    tm_rows = (t_max is not None and isinstance(t_max, torch.Tensor)
               and t_max.ndim > 0)
    for f0 in range(0, F, fb):
        a = [x[f0:f0 + fb].unbind(-1) for x in (v0, e1, e2)]
        (p0, p1, p2), (a0, a1, a2), (b0, b1, b2) = a
        for r0 in range(0, M, rb):
            d0, d1, d2 = (x[:, None] for x in dirs[r0:r0 + rb].unbind(-1))
            o0, o1, o2 = (x[:, None] for x in origins[r0:r0 + rb].unbind(-1))
            h0 = d1 * b2 - d2 * b1                       # h = d x e2
            h1 = d2 * b0 - d0 * b2
            h2 = d0 * b1 - d1 * b0
            det = a0 * h0 + a1 * h1 + a2 * h2            # (rb, fb)
            ok = torch.abs(det) > 1e-12
            inv = torch.where(ok, 1.0 / det, 0.0)
            s0, s1, s2 = o0 - p0, o1 - p1, o2 - p2
            u = (s0 * h0 + s1 * h1 + s2 * h2) * inv
            q0 = s1 * a2 - s2 * a1                       # q = s x e1
            q1 = s2 * a0 - s0 * a2
            q2 = s0 * a1 - s1 * a0
            v = (d0 * q0 + d1 * q1 + d2 * q2) * inv
            t = (b0 * q0 + b1 * q1 + b2 * q2) * inv
            hit = ok & (u >= 0) & (v >= 0) & (u + v <= 1) & (t > t_min)
            if t_max is not None:
                tm = t_max[r0:r0 + rb, None] if tm_rows else t_max
                hit = hit & (t < tm)
            occ[r0:r0 + rb] |= hit.any(1)
    return occ


def _transposed(camera: Camera) -> list[list[float]]:
    R = camera.rotation
    return [[R[j][i] for j in range(3)] for i in range(3)]


def _gbuffer_world(gb: GBuffer, camera: Camera):
    """World-space hit positions and normals (H, W, 3) from the
    camera-space G-buffer."""
    H, W = gb.depth.shape
    dev = gb.depth.device
    x = (torch.arange(W, dtype=torch.float32, device=dev) + 0.5
         - camera.cx) / camera.fx
    y = (torch.arange(H, dtype=torch.float32, device=dev) + 0.5
         - camera.cy) / camera.fy
    d = torch.where(torch.isfinite(gb.depth), gb.depth, 0.0)
    pos_cam = torch.stack([x[None, :] * d, y[:, None] * d, d], -1)
    t = _f32(camera.translation, dev)
    Rt = _transposed(camera)
    zero = (0.0, 0.0, 0.0)
    return matvec3(Rt, pos_cam - t, zero), matvec3(Rt, gb.normal, zero)


def _cosine_dirs(n: torch.Tensor, u1: torch.Tensor, u2: torch.Tensor
                 ) -> torch.Tensor:
    """Cosine-weighted hemisphere directions around normals n (..., 3)
    from two uniforms (...) in [0, 1)."""
    r = torch.sqrt(u1)
    phi = 2.0 * math.pi * u2
    lx = r * torch.cos(phi)
    ly = r * torch.sin(phi)
    lz = torch.sqrt(torch.clamp_min(1.0 - u1, 0.0))
    # a tangent basis (Frisvad-style, branchless)
    dev = n.device
    up = torch.where(torch.abs(n[..., 2:3]) < 0.9,
                     torch.tensor([0.0, 0.0, 1.0], device=dev),
                     torch.tensor([1.0, 0.0, 0.0], device=dev))
    tgt = _cross(up, n)
    tgt = tgt / torch.clamp_min(_norm(tgt, keepdim=True), 1e-8)
    btg = _cross(n, tgt)
    return tgt * lx[..., None] + btg * ly[..., None] + n * lz[..., None]


class PTOutput(NamedTuple):
    image: torch.Tensor   # (H, W, 3) path-traced mesh radiance (0 on miss)
    gbuffer: GBuffer


def _hit_rays_occluded(org, dirs, hit, positions, faces, t_max=None
                       ) -> torch.Tensor:
    """``ray_occluded`` of the rays (..., 3) of the pixels that hit the
    mesh, (H, W) bool, False elsewhere; ``t_max`` (H, W) or None."""
    flat = hit.reshape(-1)
    occ = torch.zeros_like(flat)
    occ[flat] = ray_occluded(
        org.reshape(-1, 3)[flat], dirs.reshape(-1, 3)[flat], positions,
        faces, t_max=None if t_max is None else t_max.reshape(-1)[flat])
    return occ.reshape(hit.shape)


def _path_trace(gb: GBuffer, positions, faces, camera: Camera, envmap,
                uniforms: torch.Tensor, sun_dir, sun_radiance: float
                ) -> PTOutput:
    """``path_trace_mesh`` after the raster, with its draws: ``uniforms``
    (n_samples, 2, H, W), each sample's two uniforms of ``_cosine_dirs``."""
    dev = gb.depth.device
    pos_w, n_w = _gbuffer_world(gb, camera)
    H, W = gb.depth.shape
    hit = torch.isfinite(gb.depth)
    org = (pos_w + n_w * 1e-3).reshape(-1, 3)
    positions = _f32(positions, dev)
    envmap = _f32(envmap, dev)
    n_samples = uniforms.shape[0]
    amb = torch.zeros((H, W, 3), device=dev)
    for s in range(n_samples):
        dirs = _cosine_dirs(n_w, uniforms[s, 0], uniforms[s, 1])
        occ = _hit_rays_occluded(org, dirs, hit, positions, faces)
        vis = torch.where(occ | ~hit, 0.0, 1.0)
        amb = amb + vis[..., None] * sample_envmap(envmap, dirs)
    amb = amb / n_samples

    sd = _f32(sun_dir, dev)
    sd = sd / _norm(sd)
    ndl = torch.clamp((n_w * sd[None, None, :]).sum(-1), 0.0, 1.0)
    occ_sun = _hit_rays_occluded(org, sd.expand(H, W, 3), hit, positions,
                                 faces)
    vis_sun = torch.where(occ_sun | ~hit, 0.0, 1.0)
    direct = (vis_sun * ndl * sun_radiance)[..., None]

    img = gb.albedo * (amb + direct)
    return PTOutput(image=torch.where(hit[..., None], img, 0.0), gbuffer=gb)


def path_trace_mesh(positions, faces, camera: Camera, envmap,
                    generator: torch.Generator | None = None, *,
                    normals=None, colors=None, face_colors=None,
                    n_samples: int = 8, sun_dir=(0.4, -0.8, 0.45),
                    sun_radiance: float = 2.0,
                    instance_capacity: int = 1 << 18) -> PTOutput:
    """One-bounce Monte Carlo: per G-buffer hit, cosine-sampled
    environment irradiance with triangle-occluded visibility and a sun
    shadow ray. Lo = albedo * (1/N sum_s vis_s * env(dir_s) + vis_sun *
    sun * n.l) (the cosine pdf cancels the env term's n.l). The draws come
    from ``generator`` (a generator on the camera's device, or the
    default one)."""
    gb = rasterize_mesh(positions, faces, camera, normals=normals,
                        colors=colors, face_colors=face_colors,
                        instance_capacity=instance_capacity)
    H, W = gb.depth.shape
    uniforms = torch.rand((n_samples, 2, H, W), generator=generator,
                          device=gb.depth.device)
    return _path_trace(gb, positions, faces, camera, envmap, uniforms,
                       sun_dir, sun_radiance)


def render_hybrid_pt(splat_out, positions, faces, camera: Camera, envmap,
                     generator: torch.Generator | None = None, *,
                     splat_depth, n_samples: int = 8, background=None,
                     **mesh_kw):
    """A path-traced frame: the path-traced mesh surface with the splats
    (``splat_out.image``, ``.alpha`` and ``splat_depth``) composited over
    it by the hybrid depth test -> (image (H, W, 3), ``PTOutput``)."""
    pt = path_trace_mesh(positions, faces, camera, envmap, generator,
                         n_samples=n_samples, **mesh_kw)
    img = composite_splats_over_mesh(
        splat_out.image, splat_out.alpha, splat_depth, pt.gbuffer,
        pt.image, background=background)
    return img, pt
