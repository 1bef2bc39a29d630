"""Global-illumination estimators over the deferred G-buffer (counterpart
of ``divshot_tpu/raster/gi.py``; XLA there, torch ops here), dense
(H, W, ...) tensor ops on the G-buffer's device:

- ``restir_direct``: resampled importance sampling over the scene's
  analytic lights with per-pixel weighted reservoirs, temporal reuse (the
  returned ``Reservoir`` fed back) and spatial neighbour reuse; with
  ``occluders``, one shadow ray a pixel against the chosen sample
  (``path_trace.ray_occluded``).
- ``ssgi``: screen-space ambient occlusion and one bounce of indirect
  light from the lit G-buffer.
- ``deferred_shade_gi``: both over a ``mesh_raster.rasterize_mesh``
  G-buffer.

The draws come from a ``torch.Generator`` where JAX splits a PRNG key;
``_restir`` and ``_ssgi`` take them (``RestirDraws``, the angle field), so
the tests can give them JAX's.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from divshot_tpu_torch.raster.mesh_raster import GBuffer, _norm
from divshot_tpu_torch.raster.path_trace import (_gbuffer_world,
                                                 _hit_rays_occluded)
from divshot_tpu_torch.splat.camera import Camera


class LightsSoA(NamedTuple):
    """Scene lights as dense tensors (L, ...) for vectorized sampling."""
    position: torch.Tensor    # (L, 3)
    direction: torch.Tensor   # (L, 3) normalized (spot / directional)
    color: torch.Tensor       # (L, 3) color * intensity (area-scaled)
    range: torch.Tensor       # (L,)
    cos_inner: torch.Tensor   # (L,)
    cos_outer: torch.Tensor   # (L,)
    is_dir: torch.Tensor      # (L,) bool
    is_spot: torch.Tensor     # (L,) bool


def lights_to_soa(lights, device="cuda") -> LightsSoA:
    from divshot_tpu_torch.scene.components import LightType
    pos, dirn, col, rng_, ci, co, isd, iss = [], [], [], [], [], [], [], []
    for lt in lights:
        c = np.asarray(lt.color, np.float32) * float(lt.intensity)
        if lt.type in (LightType.RECT, LightType.DISK, LightType.CYLINDER):
            c = c * max(float(lt.size[0]) * float(lt.size[1]), 1e-4)
        d = np.asarray(lt.direction, np.float32)
        d = d / max(np.linalg.norm(d), 1e-8)
        pos.append(np.asarray(lt.position, np.float32))
        dirn.append(d)
        col.append(c)
        rng_.append(max(float(lt.range), 1e-3))
        ci.append(float(np.cos(getattr(lt, "inner_angle", 0.3))))
        co.append(float(np.cos(getattr(lt, "outer_angle", 0.6))))
        isd.append(lt.type == LightType.DIRECTIONAL)
        iss.append(lt.type == LightType.SPOT)

    def f(x, dt=torch.float32):
        return torch.as_tensor(np.asarray(x), dtype=dt, device=device)

    return LightsSoA(f(np.stack(pos).astype(np.float32)),
                     f(np.stack(dirn).astype(np.float32)),
                     f(np.stack(col).astype(np.float32)), f(rng_), f(ci),
                     f(co), f(isd, torch.bool), f(iss, torch.bool))


def _eval_light(soa: LightsSoA, idx: torch.Tensor, pos_w, n_w):
    """Unshadowed radiance of light ``idx`` (..., int) at surface points
    pos_w / n_w (..., 3) -> (rgb (..., 3), light_dir (..., 3), the shadow
    ray's length (...))."""
    idx = idx.long()
    lp = soa.position[idx]
    col = soa.color[idx]
    ld_spot = soa.direction[idx]
    to_l = lp - pos_w
    dist = torch.clamp_min(_norm(to_l), 1e-6)
    ldir_pt = to_l / dist[..., None]
    # directional lights: fixed direction, no falloff, "infinite" distance
    is_dir = soa.is_dir[idx]
    ldir = torch.where(is_dir[..., None], -ld_spot, ldir_pt)
    ndl = torch.clamp((n_w * ldir).sum(-1), 0.0, 1.0)
    q = dist / soa.range[idx]
    q = q * q
    win = torch.clamp(1.0 - q * q, 0.0, 1.0)
    atten = win * win / (1.0 + dist * dist)
    cos = (-ldir_pt * ld_spot).sum(-1)
    co = soa.cos_outer[idx]
    cone = torch.clamp((cos - co) / torch.clamp_min(soa.cos_inner[idx] - co,
                                                    1e-4), 0.0, 1.0)
    atten = torch.where(soa.is_spot[idx], atten * cone * cone, atten)
    atten = torch.where(is_dir, 1.0, atten)
    rgb = col * (ndl * atten)[..., None]
    sh_dist = torch.where(is_dir, 1e8, dist)
    return rgb, ldir, sh_dist


def _lum(rgb: torch.Tensor) -> torch.Tensor:
    return (0.2126 * rgb[..., 0] + 0.7152 * rgb[..., 1]
            + 0.0722 * rgb[..., 2])


class Reservoir(NamedTuple):
    """Per-pixel weighted reservoir (Bitterli et al. 2020)."""
    y: torch.Tensor       # (H, W) int32 chosen light index
    w_sum: torch.Tensor   # (H, W) sum of RIS weights
    m: torch.Tensor       # (H, W) int32 candidate count
    p_hat: torch.Tensor   # (H, W) target pdf of the chosen sample


def _reservoir_merge(a: Reservoir, b: Reservoir, u) -> Reservoir:
    """Merge reservoir b into a (the standard ReSTIR combine)."""
    w_sum = a.w_sum + b.w_sum
    take_b = u * torch.clamp_min(w_sum, 1e-12) < b.w_sum
    return Reservoir(y=torch.where(take_b, b.y, a.y), w_sum=w_sum,
                     m=a.m + b.m,
                     p_hat=torch.where(take_b, b.p_hat, a.p_hat))


class RestirDraws(NamedTuple):
    """The draws of one ``restir_direct`` frame."""
    cand: torch.Tensor    # (n_candidates, H, W) int light picks in [0, L)
    us: torch.Tensor      # (n_candidates, H, W) uniforms of the RIS picks
    u_t: torch.Tensor     # (H, W) uniform of the temporal merge
    u_s: torch.Tensor     # (spatial taps, H, W) uniforms of the taps


def _tap_offsets(spatial_taps: int, radius: int):
    return [(radius, 0), (0, radius), (-radius, 3),
            (5, -radius)][:spatial_taps]


def _restir(gb: GBuffer, camera: Camera, soa: LightsSoA, draws: RestirDraws,
            *, state: Reservoir | None, n_candidates: int,
            spatial_taps: int, spatial_radius: int, m_cap: int, occluders,
            ambient: float) -> tuple[torch.Tensor, Reservoir]:
    """``restir_direct`` with its draws."""
    H, W = gb.depth.shape
    dev = gb.depth.device
    L = soa.position.shape[0]
    hit = torch.isfinite(gb.depth)
    pos_w, n_w = _gbuffer_world(gb, camera)

    # candidate generation: M uniform light picks a pixel (RIS)
    res = Reservoir(y=torch.zeros((H, W), dtype=torch.int32, device=dev),
                    w_sum=torch.zeros((H, W), device=dev),
                    m=torch.zeros((H, W), dtype=torch.int32, device=dev),
                    p_hat=torch.zeros((H, W), device=dev))
    for i in range(n_candidates):
        idx = draws.cand[i].to(torch.int32)
        rgb, _, _ = _eval_light(soa, idx, pos_w, n_w)
        p_hat = _lum(rgb)
        w = p_hat * L                      # p = 1/L uniform source pdf
        w_sum = res.w_sum + w
        take = draws.us[i] * torch.clamp_min(w_sum, 1e-12) < w
        res = Reservoir(y=torch.where(take, idx, res.y), w_sum=w_sum,
                        m=res.m + 1, p_hat=torch.where(take, p_hat,
                                                       res.p_hat))

    # temporal reuse (clamped history)
    if state is not None:
        prev = state
        keep = torch.clamp_max(prev.m, m_cap - n_candidates)
        scale = keep.float() / torch.clamp_min(prev.m.float(), 1.0)
        prev = Reservoir(y=prev.y, w_sum=prev.w_sum * scale, m=keep,
                         p_hat=prev.p_hat)
        res = _reservoir_merge(res, prev, draws.u_t)

    out_state = res

    # spatial reuse (fixed taps; the neighbour's target re-evaluated here)
    for k, (dy, dx) in enumerate(_tap_offsets(spatial_taps,
                                              spatial_radius)):
        nb = Reservoir(*(torch.roll(x, (dy, dx), (0, 1)) for x in res))
        rgb_n, _, _ = _eval_light(soa, nb.y, pos_w, n_w)
        p_here = _lum(rgb_n)
        ratio = p_here / torch.clamp_min(nb.p_hat, 1e-12)
        nb = Reservoir(y=nb.y, w_sum=nb.w_sum * ratio, m=nb.m, p_hat=p_here)
        res = _reservoir_merge(res, nb, draws.u_s[k])

    # final shading: W_Y = w_sum / (M * p_hat(Y))
    rgb_y, ldir, sh_dist = _eval_light(soa, res.y, pos_w, n_w)
    W_y = res.w_sum / torch.clamp_min(res.m.float() * res.p_hat, 1e-12)
    radiance = rgb_y * W_y[..., None]

    if occluders is not None:
        positions, faces = occluders
        occ = _hit_rays_occluded(pos_w + n_w * 1e-3, ldir, hit, positions,
                                 faces, torch.clamp_max(sh_dist, 1e7) - 2e-3)
        radiance = torch.where(occ[..., None], 0.0, radiance)

    img = gb.albedo * (radiance + ambient)
    return torch.where(hit[..., None], img, 0.0), out_state


def restir_direct(
    gb: GBuffer,
    camera: Camera,
    soa: LightsSoA,
    generator: torch.Generator | None = None,
    *,
    state: Reservoir | None = None,
    n_candidates: int = 8,
    spatial_taps: int = 2,
    spatial_radius: int = 8,
    m_cap: int = 160,
    occluders: tuple | None = None,    # (positions (V, 3), faces (F, 3))
    ambient: float = 0.0,
) -> tuple[torch.Tensor, Reservoir]:
    """ReSTIR direct lighting over the G-buffer -> (shaded rgb (H, W, 3),
    the reservoir state to feed back next frame). Temporal reuse assumes
    a static camera between frames; ``m_cap`` bounds the history. With
    ``occluders`` one shadow ray a pixel is traced against the chosen
    sample (only the pixels that hit the mesh: the others are 0)."""
    H, W = gb.depth.shape
    dev = gb.depth.device
    L = soa.position.shape[0]
    n_taps = len(_tap_offsets(spatial_taps, spatial_radius))
    draws = RestirDraws(
        cand=torch.randint(0, L, (n_candidates, H, W), generator=generator,
                           device=dev),
        us=torch.rand((n_candidates, H, W), generator=generator, device=dev),
        u_t=torch.rand((H, W), generator=generator, device=dev),
        u_s=torch.rand((n_taps, H, W), generator=generator, device=dev))
    return _restir(gb, camera, soa, draws, state=state,
                   n_candidates=n_candidates, spatial_taps=spatial_taps,
                   spatial_radius=spatial_radius, m_cap=m_cap,
                   occluders=occluders, ambient=ambient)


def _ssgi(gb: GBuffer, camera: Camera, lit: torch.Tensor,
          ang0: torch.Tensor, *, taps: int, radius_px: int,
          indirect_strength: float) -> tuple[torch.Tensor, torch.Tensor]:
    """``ssgi`` with its angle field ``ang0`` (H, W) in [0, 2 pi)."""
    H, W = gb.depth.shape
    dev = gb.depth.device
    hit = torch.isfinite(gb.depth)
    pos_w, n_w = _gbuffer_world(gb, camera)
    yy = torch.arange(H, device=dev)[:, None]
    xx = torch.arange(W, device=dev)[None, :]

    ao_acc = torch.zeros((H, W), device=dev)
    ind_acc = torch.zeros((H, W, 3), device=dev)
    for t in range(taps):
        ang = ang0 + (t * 2.399963)             # golden-angle spiral
        r = radius_px * float((t + 0.7) / taps)
        sy = torch.clamp((yy + (r * torch.sin(ang))).to(torch.int32), 0,
                         H - 1).long()
        sx = torch.clamp((xx + (r * torch.cos(ang))).to(torch.int32), 0,
                         W - 1).long()
        p_s = pos_w[sy, sx]
        n_s = n_w[sy, sx]
        lit_s = lit[sy, sx]
        hit_s = hit[sy, sx]
        d = p_s - pos_w
        dist2 = (d * d).sum(-1)
        dist = torch.sqrt(torch.clamp_min(dist2, 1e-12))
        dirn = d / dist[..., None]
        cos_i = torch.clamp((n_w * dirn).sum(-1), 0.0, 1.0)
        cos_j = torch.clamp(-(n_s * dirn).sum(-1), 0.0, 1.0)
        # horizon occlusion: a nearby sample above the tangent plane
        occ = cos_i * torch.clamp(1.0 - dist / 0.8, 0.0, 1.0)
        ao_acc = ao_acc + torch.where(hit_s, occ, 0.0)
        # one-bounce form factor (clamped to tame the 1/r^2 singularity)
        ff = cos_i * cos_j / (1.0 + dist2 * 4.0)
        ind_acc = ind_acc + torch.where(hit_s[..., None],
                                        lit_s * ff[..., None], 0.0)

    ao = torch.clamp(1.0 - ao_acc / taps, 0.0, 1.0)
    indirect = ind_acc * (indirect_strength / taps)
    ao = torch.where(hit, ao, 1.0)
    return ao, torch.where(hit[..., None], indirect, 0.0)


def ssgi(gb: GBuffer, camera: Camera, lit: torch.Tensor,
         generator: torch.Generator | None = None, *, taps: int = 8,
         radius_px: int = 24, indirect_strength: float = 1.0
         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Screen-space AO and one-bounce indirect light -> (ao (H, W) in
    [0, 1], indirect (H, W, 3)). Each pixel takes ``taps`` spiral samples
    of its neighbours' position, normal and lit radiance (``lit``, (H, W,
    3)): the horizon term gives occlusion, the form-factor-weighted
    neighbour radiance one bounce of colour bleed."""
    H, W = gb.depth.shape
    ang0 = torch.rand((H, W), generator=generator,
                      device=gb.depth.device) * (2.0 * np.pi)
    return _ssgi(gb, camera, lit, ang0, taps=taps, radius_px=radius_px,
                 indirect_strength=indirect_strength)


def deferred_shade_gi(
    gb: GBuffer,
    camera: Camera,
    lights,
    generator: torch.Generator | None = None,
    *,
    state: Reservoir | None = None,
    occluders: tuple | None = None,
    with_ssgi: bool = True,
    ambient: float = 0.05,
) -> tuple[torch.Tensor, Reservoir]:
    """The GI combine over a G-buffer: ReSTIR direct, then SSGI's AO and
    indirect -> (rgb (H, W, 3), reservoir state)."""
    soa = lights_to_soa(lights, gb.depth.device)
    direct, res = restir_direct(gb, camera, soa, generator, state=state,
                                occluders=occluders, ambient=ambient)
    if with_ssgi:
        ao, indirect = ssgi(gb, camera, direct, generator)
        img = direct * ao[..., None] + gb.albedo * indirect
    else:
        img = direct
    return img, res
