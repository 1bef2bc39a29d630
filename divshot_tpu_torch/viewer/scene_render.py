"""Scene rendering (counterpart of ``divshot_tpu/viewer/scene_render.py``):
walks the entities with their world transforms baked in, colour grading,
crops and render types, over the environment's plate; and the editor's
selection tint and outline.

SPLAT, DEPTH and NORMAL, the tint and the outline render through
``render`` on the kernel route (the expand and forward kernels on a
card), the per-splat depth, normal or tint as ``override_colors``. RINGS,
ELLIPSOIDS, CENTERS and POINT composite through ``raster/dense.py``:
O(N * pixels) debug views, clarity over speed.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from divshot_tpu_torch.raster import dense as _dense
from divshot_tpu_torch.raster.project import project_gaussians
from divshot_tpu_torch.raster.render import render
from divshot_tpu_torch.scene import (Environment, GaussianComponent,
                                     GaussianRenderType, Scene)
from divshot_tpu_torch.splat.camera import Camera
from divshot_tpu_torch.splat.gaussians import GaussianParams
from divshot_tpu_torch.splat.math import (dot3, quat_multiply,
                                          rotmat_to_quat_np, safe_normalize)
from divshot_tpu_torch.splat.sh import eval_sh_color, rotate_sh
from divshot_tpu_torch.splat.transform_palette import (affine_means,
                                                       polar_rotation)
from divshot_tpu_torch.train import geometry as G
from divshot_tpu_torch.viewer.post import window_max


def transform_params(params: GaussianParams, m: np.ndarray
                     ) -> GaussianParams:
    """Bake a rigid (+ uniform scale) 4x4 transform into splat params,
    rotating the quaternions and the SH."""
    m = np.asarray(m, np.float64)
    if np.allclose(m, np.eye(4)):
        return params
    A = m[:3, :3]
    Rm = polar_rotation(A)
    s = float(np.cbrt(max(abs(np.linalg.det(A)), 1e-12)))
    rq = torch.as_tensor(rotmat_to_quat_np(Rm), device=params.device)
    shN = params.shN
    if shN.shape[1]:
        shN = rotate_sh(shN, Rm)
    return dataclasses.replace(
        params, means=affine_means(m, params.means),
        quats=quat_multiply(rq[None], params.quats),
        scales=params.scales + float(np.float32(np.log(max(s, 1e-12)))),
        shN=shN)


def _nanpercentile(x: torch.Tensor, q: float) -> torch.Tensor:
    """``jnp.nanpercentile`` (linear interpolation) of a float tensor."""
    return torch.nanquantile(x.reshape(-1), q / 100.0)


def _depth_image(params, camera, **rk):
    """The alpha-normalised composite of camera-space depth, as grey."""
    z = dot3(camera.rotation[2], params.means) + camera.translation[2]
    out = render(params, camera, override_colors=torch.stack([z, z, z], -1),
                 **rk)
    alpha = torch.clamp_min(out.alpha, 1e-6)
    depth = out.image[..., 0] / alpha
    masked = torch.where(out.alpha > 0.1, depth, torch.nan)
    lo = torch.nan_to_num(_nanpercentile(masked, 5), nan=0.0)
    hi = torch.nan_to_num(_nanpercentile(masked, 95), nan=1.0)
    g = torch.clamp((depth - lo) / torch.clamp_min(hi - lo, 1e-6), 0, 1)
    g = torch.where(out.alpha > 1e-3, g, 1.0)
    return torch.stack([g, g, g], -1), out.alpha


def _normal_image(params, camera, **rk):
    aux = G.splat_normals(params, camera) * 0.5 + 0.5
    out = render(params, camera, override_colors=aux, **rk)
    alpha = torch.clamp_min(out.alpha, 1e-6)
    img = torch.clamp(out.image / alpha[..., None], 0, 1)
    img = torch.where(out.alpha[..., None] > 1e-3, img, 0.0)
    return img, out.alpha


def _debug_ellipse_image(params, camera, falloff, color=None, **_rk):
    """Rings / Ellipsoids / Centers debug modes through the dense
    compositor."""
    proj = project_gaussians(params.means, params.scales, params.quats,
                             camera)
    if color is None:
        dirs = safe_normalize(params.means - camera.campos[None, :])
        colors = eval_sh_color(params.sh0, params.shN, dirs, 0)
    else:
        colors = torch.as_tensor(np.asarray(color, np.float32),
                                 device=params.device)[None, :].expand(
                                     params.capacity, 3)
    return _dense.composite_dense(proj, colors, params.effective_opacity(),
                                  camera.width, camera.height,
                                  falloff=falloff)


def render_component(comp: GaussianComponent, camera: Camera,
                     world: np.ndarray | None = None,
                     **rk) -> tuple[torch.Tensor, torch.Tensor]:
    """-> (rgb, alpha) of one gaussian component with its settings, on
    the camera's device."""
    params = comp.graded_params(camera.device)
    if world is not None:
        params = transform_params(params, world)
    ty = comp.render_type
    rk.setdefault("sh_degree", min(comp.sh_degree, params.sh_degree))

    if ty == GaussianRenderType.SPLAT:
        out = render(params, camera, **rk)
        return out.image, out.alpha
    if ty == GaussianRenderType.DEPTH:
        return _depth_image(params, camera, **rk)
    if ty == GaussianRenderType.NORMAL:
        return _normal_image(params, camera, **rk)
    if ty in (GaussianRenderType.POINT, GaussianRenderType.CENTERS):
        # splat centres as small fixed-size dots
        tiny = dataclasses.replace(
            params,
            scales=torch.full_like(params.scales,
                                   float(np.float32(np.log(1e-3)))),
            opacity=torch.full_like(params.opacity, 8.0))
        color = (1.0, 1.0, 1.0) if ty == GaussianRenderType.CENTERS else None
        return _debug_ellipse_image(tiny, camera, "solid", color=color)
    if ty == GaussianRenderType.RINGS:
        return _debug_ellipse_image(params, camera, "ring")
    if ty == GaussianRenderType.ELLIPSOIDS:
        return _debug_ellipse_image(params, camera, "solid")
    raise ValueError(f"unknown render type {ty}")


def render_scene(scene: Scene, camera: Camera, **rk) -> torch.Tensor:
    """Every active gaussian entity back to front over the scene's
    environment plate -> (H, W, 3) float image on the camera's device."""
    dev = camera.device
    env = None
    for e in scene.entities_with(Environment):
        if e.active:
            env = e.get(Environment)
            break
    bg = env.sample_background(camera.width, camera.height) if env \
        else np.zeros((camera.height, camera.width, 3), np.float32)

    layers = []
    campos = camera.campos.cpu().numpy()
    for e in scene.entities_with(GaussianComponent):
        comp = e.get(GaussianComponent)
        if not e.active or comp.skip_render or not comp.participate_render:
            continue
        img, alpha = render_component(comp, camera, e.world_transform(scene),
                                      **rk)
        # entities ordered by the camera distance of their splat centroid
        params = comp.load(dev)
        centroid = torch.mean(torch.where(params.alive[:, None],
                                          params.means, 0.0), dim=0)
        dist = float(np.linalg.norm(centroid.cpu().numpy() - campos))
        layers.append((dist, img, alpha))

    out = torch.as_tensor(np.array(bg, np.float32), device=dev)
    for _dist, img, alpha in sorted(layers, key=lambda t: -t[0]):
        out = img + (1.0 - alpha[..., None]) * out
    return out


# -- selection overlays -------------------------------------------------------

SELECT_TINT = np.asarray([1.0, 0.45, 0.05], np.float32)   # editor orange
TINT_STRENGTH = 0.55


def selection_colors(colors: torch.Tensor, selected: torch.Tensor,
                     tint_strength: float = TINT_STRENGTH) -> torch.Tensor:
    """(N, 3) colours, the selected splats' tinted toward the highlight
    colour."""
    tint = torch.as_tensor(SELECT_TINT, device=colors.device)
    return torch.where(selected[:, None],
                       (1 - tint_strength) * colors + tint_strength * tint,
                       colors)


def render_with_selection(params: GaussianParams, camera: Camera,
                          selected: torch.Tensor, *,
                          tint_strength: float = TINT_STRENGTH,
                          **rk) -> tuple[torch.Tensor, torch.Tensor]:
    """Splat render with the selected splats tinted toward the highlight
    colour (a per-splat colour override through the compositor)."""
    dirs = safe_normalize(params.means - camera.campos[None, :])
    colors = eval_sh_color(params.sh0, params.shN, dirs,
                           rk.pop("sh_degree", params.sh_degree))
    out = render(params, camera, override_colors=selection_colors(
        colors, selected, tint_strength), **rk)
    return out.image, out.alpha


def selection_outline(params: GaussianParams, camera: Camera,
                      selected: torch.Tensor, *,
                      thickness: int = 2, **rk) -> torch.Tensor:
    """(H, W) outline of the selection's silhouette: the selected subset's
    alpha, thresholded, and its morphological edge (dilate - erode)."""
    sub = dataclasses.replace(params, alive=params.alive & selected)
    out = render(sub, camera, **rk)
    hard = (out.alpha > 0.35).float()
    k = 2 * thickness + 1
    return window_max(hard, k) + window_max(-hard, k)


def composite_outline(image: torch.Tensor, outline: torch.Tensor,
                      color=(1.0, 0.6, 0.1)) -> torch.Tensor:
    """Draw the outline mask over an image."""
    c = torch.as_tensor(np.asarray(color, np.float32), device=image.device)
    return image * (1.0 - outline[..., None]) + outline[..., None] * c
