"""The static training step and its host loop (counterpart of
``divshot_tpu/train/trainer.py``).

One step: pick a view (or a batch of them), render it through the
kernels, L1 + D-SSIM loss (plus the 2DGS geometry losses where
configured), the backward kernel and the per-splat reduce, autograd back
through projection and SH, per-group Adam, densification statistics, then
refine, alpha reset or MCMC noise on the schedule. The step is eager
PyTorch: the schedule's branches are plain Python on the host step count,
and nothing in the step reads a value back from the card (but
``debug_nan``'s checks); ``Trainer.run`` reads the metrics only where it
logs them.

Routes, as in JAX: 3DGS (``model_type=0``) renders through the 3DGS
kernels (``render``); exact 2DGS (``model_type=1``, ``surfel_exact``, the
default) through the surfel kernels (``surfel_raster.render_surfels``);
flattened 2DGS (``surfel_exact=False``) flattens the splats and renders
them through the 3DGS kernels. A ``render_kwargs["backend"]`` overrides
the route, as JAX's does: ``"tiles"``, ``"dense"`` or ``"pallas"`` with
``binning="xla"`` for 3DGS and flattened 2DGS, ``"surfel"`` (the XLA
compositor's counterpart, ``surfel.render_surfels``) for exact 2DGS. With
the normal-consistency or the depth-distortion loss, or on 2DGS, the step
composites the planes ``[z, z^2, nx, ny]``: in the same pass on the
``"pallas"`` and surfel routes (the surfel compositors' own depth planes,
or the 3DGS kernels' extra channels), in two more renders of
``override_colors`` on ``"tiles"`` and ``"dense"``.

The JAX trainer's options: the envmap background (``enable_bg``,
``models/background.py``, with its own Adam), masks (``use_mask``: image
and ground truth multiplied by the mask before the photometric loss),
batches of views (``batch_size``), progressive resolution
(``progressive_train``: x4, then x2, then full), images streamed from host
memory (``Dataset.from_views(stream=True)``, ``gsio/loader.py``), bf16
``shN`` and moments (``pack_level``, raised automatically above half the
device's memory) and ``debug_nan``. JAX's ``jax_debug_nans`` raises at the
first primitive that makes a NaN; the port's checks are coarser, each
stage's output (projection, SH colour, the kernels' image and alpha, the
loss, the backward under ``torch.autograd.detect_anomaly``, each gradient,
the parameters after Adam and after refine), raising
``FloatingPointError`` naming the stage; off, they add nothing.

Still raising ``NotImplementedError`` naming ROADMAP.md: gradient
all-reduce across chips (``grad_psum_axis``). The dynamic models have
their own step (``models/dynamic.py``).
"""

from __future__ import annotations

import dataclasses
import time
import warnings
from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch

from divshot_tpu_torch.core.config import (DensifyStrategy, ModelType,
                                           TrainConfig)
from divshot_tpu_torch.gsio.loader import HostImageStore, Prefetcher
from divshot_tpu_torch.models.background import (init_envmap,
                                                 render_background)
from divshot_tpu_torch.raster.render import frame_inputs, render
from divshot_tpu_torch.raster.surfel import \
    render_surfels as render_surfels_xla
from divshot_tpu_torch.raster.surfel_raster import (render_surfels,
                                                    surfel_inputs)
from divshot_tpu_torch.splat.camera import Camera, batch_cameras
from divshot_tpu_torch.splat.gaussians import GaussianParams, to_tensor
from divshot_tpu_torch.splat.math import matvec3
from divshot_tpu_torch.train import geometry as G
from divshot_tpu_torch.train import strategy as S
from divshot_tpu_torch.train.losses import photometric_loss, psnr
from divshot_tpu_torch.train.optim import PARAM_FIELDS, AdamState, adam_update


def _unported(what: str):
    return NotImplementedError(
        f"{what} is not ported to divshot_tpu_torch yet (ROADMAP.md, "
        f"Queue A)")


@dataclass
class TrainState:
    params: GaussianParams
    opt: AdamState
    dstate: S.DensifyState
    gen: torch.Generator      # the strategies' random draws
    bg: dict | None = None    # {"params", "mu", "nu"} envmap with enable_bg

    @property
    def step(self) -> int:
        return self.opt.step

    @classmethod
    def init(cls, params: GaussianParams, seed: int = 0,
             bg: dict | None = None) -> "TrainState":
        gen = torch.Generator(device=params.device)
        gen.manual_seed(seed)
        return cls(params=params, opt=AdamState.init(params),
                   dstate=S.DensifyState.init(params.capacity,
                                              params.device), gen=gen, bg=bg)

    @classmethod
    def from_numpy(cls, d: dict, *, seed: int = 0,
                   device="cuda") -> "TrainState":
        """Carry a JAX ``TrainState`` across: ``d["params"]`` as for
        ``GaussianParams.from_numpy``; ``d["mu"]`` and ``d["nu"]`` map each
        parameter field to its Adam moment, ``d["step"]`` is the Adam step,
        ``d["dstate"]`` holds ``grad_accum``, ``count`` and ``max_radii``,
        and ``d["bg"]``, with ``enable_bg``, the envmap's ``params``,
        ``mu`` and ``nu``; all numpy, bf16 leaves kept bf16. The JAX random key has no counterpart: the port's draws
        come from a generator seeded with ``seed``."""
        params = GaussianParams.from_numpy(d["params"], device=device)

        def t(x):
            return to_tensor(x, device)

        opt = AdamState(mu={f: t(d["mu"][f]) for f in PARAM_FIELDS},
                        nu={f: t(d["nu"][f]) for f in PARAM_FIELDS},
                        step=int(d["step"]))
        ds = S.DensifyState(**{k: t(d["dstate"][k]) for k in
                               ("grad_accum", "count", "max_radii")})
        bg = None
        if d.get("bg") is not None:
            bg = {k: t(d["bg"][k]) for k in ("params", "mu", "nu")}
        state = cls.init(params, seed)
        return dataclasses.replace(state, opt=opt, dstate=ds, bg=bg)


@dataclass
class Dataset:
    """Training views: ``cameras`` share one resolution; ``images`` is
    (V, H, W, 3) uint8, on the device, or, streamed, a numpy array on the
    host that ``gsio/loader.py`` sends to the device a view at a time;
    ``masks`` (V, H, W), uint8 ``m * 255`` or float in [0, 1], where
    given, with the images."""
    cameras: list[Camera]
    images: torch.Tensor | np.ndarray
    scene_extent: float
    points: np.ndarray | None = None   # seed point cloud
    colors: np.ndarray | None = None
    masks: torch.Tensor | np.ndarray | None = None
    times: np.ndarray | None = None

    @property
    def num_views(self) -> int:
        return self.images.shape[0]

    @property
    def device(self) -> torch.device:
        return self.cameras[0].device

    @property
    def streamed(self) -> bool:
        """True when the images stay in host memory and stream to the
        device per step."""
        return isinstance(self.images, np.ndarray)

    @classmethod
    def from_views(cls, cams: list[Camera], images: np.ndarray, points=None,
                   colors=None, stream: bool = False, masks=None,
                   **kw) -> "Dataset":
        cams = batch_cameras(cams)
        vms = np.stack([c.viewmat for c in cams])
        centers = -np.einsum("nij,ni->nj", vms[:, :3, :3], vms[:, :3, 3])
        center = centers.mean(0)
        extent = float(np.linalg.norm(centers - center, axis=1).max()) * 1.1
        images = np.asarray(images)
        if images.dtype != np.uint8:
            images = (np.clip(images, 0, 1) * 255).astype(np.uint8)
        dev = cams[0].device

        def place(x):
            x = np.ascontiguousarray(x)
            return x if stream else torch.as_tensor(x, device=dev)

        return cls(cameras=cams, images=place(images),
                   scene_extent=max(extent, 1e-3), points=points,
                   colors=colors,
                   masks=None if masks is None else place(masks), **kw)


def sh_band_mask(num_coeffs: int, degree: int,
                 device) -> torch.Tensor:
    """(1, K, 1) mask enabling the SH bands up to ``degree``."""
    band = torch.tensor([1, 1, 1, 2, 2, 2, 2, 2, 3, 3, 3, 3, 3, 3, 3],
                        device=device)[:num_coeffs]
    return (band[None, :, None] <= degree).float()


def hypers_from_config(cfg: TrainConfig) -> dict[str, float]:
    """The run-time adjustable scalars of the step (learning rates and
    loss weights), float32-rounded as the JAX package holds them."""
    f = lambda x: float(np.float32(x))  # noqa: E731
    return {
        "pos_lr_init": f(cfg.optim.pos_lr_init),
        "pos_lr_final": f(cfg.optim.pos_lr_final),
        "scaling_lr": f(cfg.optim.scaling_lr),
        "rotation_lr": f(cfg.optim.rotation_lr),
        "opacity_lr": f(cfg.optim.opacity_lr),
        "feature_lr": f(cfg.optim.feature_lr),
        "ssim_weight": f(cfg.ssim_weight),
        "normal_loss_weight": f(cfg.normal_loss_weight),
        "dist_loss_weight": f(cfg.dist_loss_weight),
        "noise_lr": f(cfg.densify.noise_lr),
        "grow_grad2d": f(cfg.densify.grow_grad2d),
    }


def _structure_key(cfg: TrainConfig) -> TrainConfig:
    """The part of the config the step functions are built from: all of it
    but the live hypers (``hypers_from_config``, passed to every step).
    Loss weights that switch extra work on keep only their > 0 bit."""
    o = dataclasses.replace(cfg.optim, pos_lr_init=0.0, pos_lr_final=0.0,
                            scaling_lr=0.0, rotation_lr=0.0, opacity_lr=0.0,
                            feature_lr=0.0)
    d = dataclasses.replace(cfg.densify, noise_lr=0.0, grow_grad2d=0.0)
    return dataclasses.replace(
        cfg, optim=o, densify=d,
        ssim_weight=float(cfg.ssim_weight > 0),
        normal_loss_weight=0.0,
        dist_loss_weight=float(cfg.dist_loss_weight > 0))


def check_supported(cfg: TrainConfig, dataset: Dataset | None = None,
                    *, grad_psum_axis: str | None = None) -> None:
    """Raise ``NotImplementedError`` for every option of the JAX trainer
    that the port does not run yet: gradient all-reduce across chips. (The
    dynamic models train through ``models/dynamic.py``; this step, as
    JAX's, ignores a dataset's times.)"""
    if grad_psum_axis is not None:
        raise _unported("grad_psum_axis (multi-chip training)")


def render_kwargs_from_config(cfg: TrainConfig) -> dict[str, Any]:
    """The step's render arguments; ``backend`` from the model type:
    ``"surfel_pallas"`` for exact 2DGS, else ``"pallas"``."""
    rc = cfg.raster
    exact2d = cfg.model_type == ModelType.GS2D and cfg.surfel_exact
    return dict(
        backend="surfel_pallas" if exact2d else "pallas",
        tile_size=rc.tile_size, antialiased=rc.mip_antialiased,
        eps2d=rc.eps2d, radius_clip=rc.radius_clip,
        t_eps=rc.transmittance_min,
        max_tiles_per_gaussian=rc.max_instances_per_gaussian,
        instance_capacity_mult=rc.instance_capacity_mult,
        cull_sh_radius=3.0 if cfg.cull_sh else 0.0,
        # the AbsGS rows are consumed only by the ADC strategies
        with_absgrad=bool(cfg.densify.use_abs_grad
                          and cfg.densify.strategy != DensifyStrategy.MCMC))


def geometry_loss(cfg: TrainConfig, planes: torch.Tensor,
                  alpha: torch.Tensor, camera: Camera, step: int,
                  hyp: dict[str, float]) -> torch.Tensor | float:
    """The step's 2DGS geometry terms from the composited planes (H, W, 4)
    ``[z, z^2, nx, ny]`` and the alpha (H, W): the normal-consistency loss
    (with ``normal_consistency_loss`` or on 2DGS) and the depth-distortion
    loss (``dist_loss_weight`` > 0), each weighted 0 before its start step
    and still computed, as in JAX."""
    # torch.maximum / minimum, not clamp: at a tie (dist = 0 exactly at a
    # pixel one splat covers) they pass half the gradient, as jnp.maximum
    # does, where clamp passes all of it
    zero = torch.zeros((), device=alpha.device)
    alpha_s = torch.maximum(alpha, zero + 1e-6)
    depth = planes[..., 0] / alpha_s
    loss = 0.0
    if cfg.normal_consistency_loss or cfg.model_type == ModelType.GS2D:
        nx = planes[..., 2] / alpha_s
        ny = planes[..., 3] / alpha_s
        nz = -torch.sqrt(torch.minimum(torch.maximum(
            1.0 - nx ** 2 - ny ** 2, zero + 1e-6), zero + 1.0))
        nloss = G.normal_consistency_loss(torch.stack([nx, ny, nz], -1),
                                          depth, alpha, camera)
        w = hyp["normal_loss_weight"] if step >= cfg.normal_start_iter \
            else 0.0
        loss = loss + w * nloss
    if cfg.dist_loss_weight > 0:
        # depth distortion (2DGS): sum_ij w_i w_j (z_i - z_j)^2 =
        # 2 (sum w z^2 sum w - (sum w z)^2) per pixel, from the planes
        dist = planes[..., 1] * alpha - planes[..., 0] ** 2
        wd = hyp["dist_loss_weight"] if step >= cfg.dist_start_iter else 0.0
        loss = loss + wd * torch.maximum(dist, zero).mean()
    return loss


def scaled_camera(camera: Camera, res_scale: int) -> Camera:
    """``camera`` at 1/``res_scale`` resolution: the width and height
    floor-divided, the intrinsics times 1/``res_scale`` in float32."""
    s = np.float32(1.0 / res_scale)
    f = lambda x: float(np.float32(x) * s)  # noqa: E731
    return dataclasses.replace(
        camera, fx=f(camera.fx), fy=f(camera.fy), cx=f(camera.cx),
        cy=f(camera.cy), width=camera.width // res_scale,
        height=camera.height // res_scale)


def check_finite(stage: str, *tensors) -> None:
    """``debug_nan``: raise ``FloatingPointError`` naming ``stage`` when a
    tensor holds a NaN or an infinity (a read back from the device)."""
    for t in tensors:
        if t is not None and not bool(torch.isfinite(t.detach()).all()):
            raise FloatingPointError(
                f"debug_nan: a non-finite value at the {stage} stage")


def make_train_step(cfg: TrainConfig, dataset: Dataset,
                    render_kwargs: dict[str, Any] | None = None,
                    res_scale: int = 1, streamed: bool = False,
                    grad_psum_axis: str | None = None) -> Callable:
    """-> ``train_step(state, view_idx, gt_stream=None, mask_stream=None,
    hypers=None) -> (state, metrics)``. ``metrics`` holds device scalars:
    loss, psnr, num_alive and the binning's num_instances and
    max_tile_count.

    ``view_idx`` is an int, or a sequence of B view indices for a batched
    step: one loss, the mean over the views, one backward, the sinks
    shared, so the densification gradients are the mean over the views;
    the radii and the binning metrics are the largest over them, the PSNR
    that of the first. ``res_scale`` > 1 trains at 1/``res_scale``
    resolution (``scaled_camera``; the ground truth, cropped to the
    scaled size times ``res_scale``, average-pooled). ``streamed``: the
    ground truth (and mask) of the step's views arrive as ``gt_stream``
    (and ``mask_stream``) from ``gsio/loader.py`` instead of from
    ``dataset.images``."""
    check_supported(cfg, dataset, grad_psum_axis=grad_psum_axis)
    rk = render_kwargs_from_config(cfg)
    rk.update(render_kwargs or {})
    backend = rk["backend"]
    surfel = (cfg.model_type == ModelType.GS2D
              and backend not in ("tiles", "dense", "pallas"))
    # the XLA surfel compositor's counterpart; its pixel counts come out
    # of the forward, not out of a kernel's backward
    surfel_xla = surfel and backend != "surfel_pallas"
    srk = {k: v for k, v in rk.items()
           if k in ("tile_size", "instance_capacity", "instance_capacity_mult",
                    "max_tiles_per_gaussian", "t_eps")
           + (("tile_capacity", "chunk") if surfel_xla else ())}
    need_geom = (cfg.normal_consistency_loss
                 or cfg.model_type == ModelType.GS2D
                 or cfg.dist_loss_weight > 0)
    # the planes in the render's own pass; else two more renders
    single_pass = need_geom and (backend == "pallas" or surfel)
    debug = cfg.debug_nan
    extent = dataset.scene_extent
    dcfg = cfg.densify
    dev = dataset.device
    # with the envmap the splats composite over black, and the envmap
    # fills what they leave
    bg = torch.full((3,), 1.0 if cfg.white_background and not cfg.enable_bg
                    else 0.0, device=dev)
    cams = dataset.cameras if res_scale == 1 else [
        scaled_camera(c, res_scale) for c in dataset.cameras]
    W, H = cams[0].width, cams[0].height
    ndc_scale = torch.tensor([W / 2.0, H / 2.0], device=dev)

    def pool(img: torch.Tensor) -> torch.Tensor:
        """(h, w, C) -> average-pooled to (H, W, C)."""
        if res_scale == 1:
            return img
        s = res_scale
        img = img[:H * s, :W * s]
        return img.reshape(H, s, W, s, img.shape[-1]).mean((1, 3))

    def mask_of(raw: torch.Tensor) -> torch.Tensor:
        m = raw.float()
        if raw.dtype == torch.uint8:
            m = m / 255.0
        return pool(m[..., None])[..., 0]

    def check_inputs(p: GaussianParams, camera: Camera) -> None:
        """``debug_nan``: the projection and SH colour stages' outputs."""
        with torch.no_grad():
            if surfel:
                proj, colors, _ = surfel_inputs(p, camera,
                                                with_geometry=need_geom)
                proj = list(proj.values())
            else:
                proj, colors, _ = frame_inputs(
                    p, camera, eps2d=rk["eps2d"],
                    antialiased=rk["antialiased"])
            check_finite("projection", *proj)
            check_finite("SH colour", colors)

    def render_view(p: GaussianParams, camera: Camera, sinks):
        """-> (the view's RenderOutput, the planes [z, z^2, nx, ny] and
        their alpha when the geometry losses need them, the XLA surfel
        route's forward pixel counts or None)."""
        sink_kw = dict(absgrad_sink=sinks[0], means2d_sink=sinks[1],
                       npix_sink=sinks[2])
        if surfel:
            if debug:
                check_inputs(p, camera)
            if surfel_xla:
                out, npix = render_surfels_xla(
                    p, camera, background=bg, with_geometry=need_geom,
                    **sink_kw, **srk)
            else:
                out, npix = render_surfels(
                    p, camera, background=bg, with_geometry=need_geom,
                    **sink_kw, **srk), None
            return out, (out.extra, out.alpha), npix
        if cfg.model_type == ModelType.GS2D:
            p = G.flatten_to_surfels(p)
        if debug:
            check_inputs(p, camera)
        if not need_geom:
            return render(p, camera, background=bg, **sink_kw, **rk), \
                None, None
        # camera-space depth and normals; camera-facing, so nz < 0 is
        # recoverable from (nx, ny); z and z^2 feed the distortion
        z = matvec3(camera.rotation, p.means, camera.translation)[:, 2]
        n_cam = matvec3(camera.rotation, G.splat_normals(p, camera),
                        (0.0, 0.0, 0.0))
        aux = torch.stack([z, z * z, n_cam[:, 0], n_cam[:, 1]], 1)
        if single_pass:
            out = render(p, camera, background=bg, extra_colors=aux,
                         **sink_kw, **rk)
            return out, (out.extra, out.alpha), None
        out = render(p, camera, background=bg, **sink_kw, **rk)
        # [z, z^2, nx] and [z^2, ny, ny], spliced as JAX splices them
        out2 = render(p, camera, override_colors=aux[:, :3], **rk)
        out3 = render(p, camera, override_colors=aux[:, [1, 3, 3]], **rk)
        planes = torch.cat([out2.image[..., 0:1], out3.image[..., 0:1],
                            out2.image[..., 2:3], out3.image[..., 1:2]], -1)
        return out, (planes, out2.alpha), None

    def view_loss(p, env, camera, gt, mask, sinks, step, hyp):
        """One view's render and loss -> (loss, RenderOutput)."""
        out, geom, npix = render_view(p, camera, sinks)
        if debug:
            check_finite("render (image and alpha)", out.image, out.alpha)
        img = out.image
        if env is not None:
            img = img + (1.0 - out.alpha)[..., None] \
                * render_background(env, camera)
        if mask is not None:
            img = img * mask[..., None]
            gt = gt * mask[..., None]
        loss = photometric_loss(img, gt, hyp["ssim_weight"],
                                use_ssim=cfg.ssim_weight > 0)
        if npix is not None:
            # zero-valued: npix_sink's gradient is the forward's counts
            loss = loss + (sinks[2] * npix).sum()
        if need_geom:
            # the geometry terms stay unmasked, as in JAX
            loss = loss + geometry_loss(cfg, *geom, camera, step, hyp)
        return loss, out

    def train_step(state: TrainState, view_idx, gt_stream=None,
                   mask_stream=None, hypers: dict[str, float] | None = None):
        hyp = hypers if hypers is not None else hypers_from_config(cfg)
        batched = not isinstance(view_idx, (int, np.integer))
        views = [int(v) for v in view_idx] if batched else [int(view_idx)]
        if streamed:
            raws = list(gt_stream) if batched else [gt_stream]
            mraws = None if mask_stream is None else (
                list(mask_stream) if batched else [mask_stream])
        else:
            raws = [dataset.images[v] for v in views]
            mraws = None if dataset.masks is None else [
                dataset.masks[v] for v in views]
        gts = [pool(r.float() / 255.0) for r in raws]
        masks = [None] * len(views) if mraws is None else [
            mask_of(m) for m in mraws]
        if cfg.enable_bg and state.bg is None:
            raise ValueError("enable_bg: the state has no envmap (TrainState"
                             ".bg); Trainer makes one")
        step = state.opt.step
        params = state.params
        cap = params.capacity
        deg = min(step // cfg.sh_degree_interval, cfg.sh_degree)

        leaves = {f: getattr(params, f).detach().requires_grad_(True)
                  for f in PARAM_FIELDS}
        env = state.bg["params"].detach().requires_grad_(True) \
            if cfg.enable_bg else None
        sinks = [torch.zeros(shape, device=dev, requires_grad=True)
                 for shape in ((cap, 2), (cap, 2), (cap,))]
        p = dataclasses.replace(params, **leaves)
        p = dataclasses.replace(
            p, shN=p.shN * sh_band_mask(p.shN.shape[1], deg, dev))
        losses, outs = [], []
        for v, gt, mask in zip(views, gts, masks):
            loss, out = view_loss(p, env, cams[v], gt, mask, sinks, step,
                                  hyp)
            losses.append(loss)
            outs.append(out)
        loss = torch.stack(losses).mean() if batched else losses[0]
        if debug:
            check_finite("loss", loss)
        inputs = [*leaves.values(), *([env] if env is not None else []),
                  *sinks]
        if debug:
            try:
                with warnings.catch_warnings():
                    warnings.simplefilter("ignore")
                    with torch.autograd.detect_anomaly(check_nan=True):
                        raw_grads = torch.autograd.grad(loss, inputs,
                                                        allow_unused=True)
            except RuntimeError as e:
                raise FloatingPointError(
                    f"debug_nan: a NaN at the backward stage ({e})") from e
        else:
            raw_grads = torch.autograd.grad(loss, inputs, allow_unused=True)
        grads = [torch.zeros_like(x) if g is None else g
                 for x, g in zip(inputs, raw_grads)]
        g_fields = dict(zip(PARAM_FIELDS, grads[:len(PARAM_FIELDS)]))
        g_env = grads[len(PARAM_FIELDS)] if env is not None else None
        g_abs, g_m2d, g_npix = grads[-3:]
        if len(views) > 1 and not surfel_xla:
            # the kernels' pixel counts do not scale with the loss: their
            # sum over the views, made the mean as for the other sinks (the
            # XLA surfel route's term is in the loss, so a mean already)
            g_npix = g_npix / len(views)
        if debug:
            for name, g in zip((*PARAM_FIELDS, "the envmap"), grads):
                check_finite(f"gradient ({name})", g)

        with torch.no_grad():
            radii = outs[0].proj.radii if not batched else torch.stack(
                [o.proj.radii for o in outs]).amax(0)
            obs = S.DensifyObs(
                grad2d=torch.linalg.vector_norm(g_m2d * ndc_scale, dim=-1),
                absgrad2d=torch.linalg.vector_norm(g_abs * ndc_scale,
                                                   dim=-1),
                radii=radii, npix=g_npix, width=W, height=H)
            dstate = S.update_stats(state.dstate, obs, dcfg.use_abs_grad,
                                    cfg.pixel_grad_scale)
            params, opt = adam_update(cfg.optim, state.params, g_fields,
                                      state.opt, extent, radii > 0,
                                      hypers=hyp)
            params = dataclasses.replace(params, opacity=torch.where(
                params.alive, params.opacity,
                torch.full((), -15.0, device=dev)))
            new_bg = state.bg
            if env is not None:
                # the envmap's own Adam: no bias correction, as in JAX
                b1b, b2b, lr_bg = 0.9, 0.999, 0.01
                mu = state.bg["mu"] * b1b + (1 - b1b) * g_env
                nu = state.bg["nu"] * b2b + (1 - b2b) * g_env * g_env
                new_bg = {"params": state.bg["params"]
                          - lr_bg * mu / (torch.sqrt(nu) + 1e-8),
                          "mu": mu, "nu": nu}
            if debug:
                check_finite("Adam", *(getattr(params, f)
                                       for f in PARAM_FIELDS),
                             *(new_bg or {}).values())
            if (dcfg.prune_interval > 0 and step > 0
                    and step % dcfg.prune_interval == 0):
                params, opt = S.periodic_prune(dcfg, params, opt, dstate,
                                               extent)
            in_window = dcfg.warmup_length <= step < dcfg.refine_stop_iter
            if in_window and step > 0 and step % dcfg.refine_every == 0:
                params, opt, dstate = S.refine(dcfg, params, opt, dstate,
                                               step, extent, hyp,
                                               gen=state.gen)
            if dcfg.strategy != DensifyStrategy.MCMC:
                if (in_window and step > 0
                        and step % dcfg.reset_alpha_every == 0):
                    params, opt = S.alpha_reset(dcfg, params, opt)
            else:
                params = S.mcmc_noise(dcfg, cfg.optim, params, step, extent,
                                      hyp, gen=state.gen)
            if debug:
                check_finite("refine", *(getattr(params, f)
                                         for f in PARAM_FIELDS))
            zero = torch.zeros((), dtype=torch.int32, device=dev)
            n_inst = [zero if o.num_instances is None else o.num_instances
                      for o in outs]
            max_tc = [zero if o.max_tile_count is None else o.max_tile_count
                      for o in outs]
            metrics = {
                "loss": loss.detach(),
                "psnr": psnr(outs[0].image.detach(), gts[0]),
                "num_alive": params.alive.sum(),
                "num_instances": torch.stack(n_inst).amax(),
                "max_tile_count": torch.stack(max_tc).amax(),
            }
        return TrainState(params=params, opt=opt, dstate=dstate,
                          gen=state.gen, bg=new_bg), metrics

    return train_step


def _device_memory_bytes(device) -> int:
    """The device's memory: a card's total, else JAX's 16 GiB fallback."""
    device = torch.device(device)
    if device.type == "cuda":
        return int(torch.cuda.get_device_properties(device).total_memory)
    return 16 * 1024 ** 3


class Trainer:
    """Host loop over the step: random views, progress logging, and the
    instance capacity grown from measured demand."""

    def __init__(self, cfg: TrainConfig, dataset: Dataset,
                 params: GaussianParams,
                 render_kwargs: dict[str, Any] | None = None):
        check_supported(cfg, dataset)
        self.cfg = cfg
        self.dataset = dataset
        # packLevel, raised with the reference's memory guard (splats x 236
        # B x 10 above half the device's memory); bit 1 stores shN and its
        # Adam moments in bf16
        pack = cfg.pack_level
        if params.capacity * 236 * 10 > 0.5 * _device_memory_bytes(
                params.device):
            pack |= 3
        self.pack_level = pack
        if pack & 1 and params.shN.dtype != torch.bfloat16:
            params = dataclasses.replace(params,
                                         shN=params.shN.to(torch.bfloat16))
        bg = None
        if cfg.enable_bg:
            env = init_envmap(init_color=(1, 1, 1) if cfg.white_background
                              else (0, 0, 0), device=params.device)
            bg = {"params": env, "mu": torch.zeros_like(env),
                  "nu": torch.zeros_like(env)}
        self.state = TrainState.init(params, cfg.seed, bg=bg)
        self._render_kwargs = dict(render_kwargs or {})
        self._hypers = hypers_from_config(cfg)
        self._streamed = dataset.streamed
        self._build_steps()
        self._np_rng = np.random.default_rng(cfg.seed)
        self._pending: list[int] = []    # streamed views drawn ahead
        self._prefetch = None
        if self._streamed:
            dev = dataset.device
            self._prefetch = Prefetcher(
                HostImageStore(images=dataset.images,
                               pin=dev.type == "cuda"), depth=2,
                masks=dataset.masks, device=dev)
        self.metrics_history: list[dict] = []
        self.last_metrics: dict | None = None

    def _build_steps(self) -> None:
        """The step functions: full resolution, and with
        ``progressive_train`` one per scale of the schedule."""
        rk = self._render_kwargs
        cap = self.state.params.capacity
        mult = rk.get("instance_capacity_mult",
                      self.cfg.raster.instance_capacity_mult)
        self._instance_capacity = rk.get("instance_capacity") \
            or max(1 << 16, int(mult * cap))
        # per-tile truncation exists only in the id matrix ("tiles")
        self._tile_capacity = rk.get("tile_capacity", 1024) \
            if rk.get("backend") == "tiles" else None
        self._warned_instance_overflow = False
        self._warned_tile_overflow = False
        rk = {**rk, "instance_capacity": self._instance_capacity}
        self._steps = {s: make_train_step(self.cfg, self.dataset, rk,
                                          res_scale=s,
                                          streamed=self._streamed)
                       for s in (1, *self._schedule_scales())}

    def apply_config(self, new_cfg: TrainConfig) -> None:
        """Apply a (possibly live-updated) config. A change of the hypers
        alone (learning rates, loss weights) reaches the next step through
        ``hypers``; any other change rebuilds the step functions."""
        rebuild = _structure_key(new_cfg) != _structure_key(self.cfg)
        self.cfg = new_cfg
        self._hypers = hypers_from_config(new_cfg)
        if rebuild:
            self._build_steps()

    def _schedule_scales(self) -> tuple[int, ...]:
        if self.cfg.progressive_train and self.cfg.resolution_schedule > 0:
            return (4, 2)
        return ()

    def res_scale(self, step: int) -> int:
        """The resolution divisor of ``step``: 4 below
        ``resolution_schedule``, 2 below twice that, then 1. A resumed run
        takes the scale of its step."""
        if self._schedule_scales():
            sched = self.cfg.resolution_schedule
            if step < sched:
                return 4
            if step < 2 * sched:
                return 2
        return 1

    @property
    def instance_capacity(self) -> int:
        """The instance capacity the step renders with now."""
        return self._instance_capacity

    @property
    def pending_views(self) -> list[int]:
        """A streamed run's views drawn ahead and not trained on yet."""
        return list(self._pending)

    def set_pending_views(self, views: list[int]) -> None:
        """Replace the views drawn ahead (a streamed run's resume): the
        prefetcher's transfers in flight are taken and dropped, the given
        views scheduled."""
        for _ in self._pending:
            self._prefetch.get()
        self._pending = [int(v) for v in views]
        for v in self._pending:
            self._prefetch.schedule(v)

    def step_once(self) -> dict:
        """One step on random views: ``cfg.batch_size`` of them when > 1,
        in the order the device-resident and streamed runs share."""
        bsz = max(1, self.cfg.batch_size)
        step_fn = self._steps[self.res_scale(self.state.step)]
        if self._streamed:
            if bsz > 1:
                raise NotImplementedError(
                    "batch_size > 1 requires in-HBM images (stream=False)")
            # keep 2 host->device transfers in flight ahead of compute
            while len(self._pending) < 2:
                v = int(self._np_rng.integers(self.dataset.num_views))
                self._prefetch.schedule(v)
                self._pending.append(v)
            view, gt, mask = self._prefetch.get()
            self._pending.pop(0)
            self.state, metrics = step_fn(self.state, view, gt, mask,
                                          hypers=self._hypers)
        else:
            if bsz > 1:
                view = [int(v) for v in self._np_rng.integers(
                    self.dataset.num_views, size=bsz)]
            else:
                view = int(self._np_rng.integers(self.dataset.num_views))
            self.state, metrics = step_fn(self.state, view,
                                          hypers=self._hypers)
        self.last_metrics = metrics
        return metrics

    def close(self) -> None:
        """Stop a streamed run's prefetch thread."""
        if self._prefetch is not None:
            self._prefetch.close()

    def run(self, num_iters: int | None = None, log_every: int = 500,
            callback: Callable | None = None) -> None:
        n = num_iters if num_iters is not None else self.cfg.num_iters
        t0 = time.time()
        for i in range(n):
            metrics = self.step_once()
            if log_every and (i + 1) % log_every == 0:
                m = {k: float(v) for k, v in metrics.items()}
                m["iters_per_s"] = (i + 1) / (time.time() - t0)
                self.metrics_history.append(m)
                self.check_overflow(m)
                if self.cfg.verbose:
                    print(f"[{i + 1}/{n}] loss={m['loss']:.4f} "
                          f"psnr={m['psnr']:.2f} "
                          f"alive={int(m['num_alive'])} "
                          f"({m['iters_per_s']:.1f} it/s)")
            if callback is not None:
                callback(i, self.state, metrics)

    def check_overflow(self, metrics: dict) -> None:
        """With ``raster.auto_instance_capacity`` (default), grow the
        instance buffer from measured demand when it nears the capacity
        (demand x 1.3, rounded up to a power of two, at least doubled);
        else warn once when demand reaches the guard band, where binning
        drops instances. On the ``"tiles"`` route, also warn once when the
        densest tile holds more instances than ``tile_capacity``."""
        ni = int(metrics.get("num_instances", 0))
        icap = self._instance_capacity
        if self.cfg.raster.auto_instance_capacity and ni > 0.9 * icap:
            new_cap = 1 << max(int(np.ceil(np.log2(max(ni, 1) * 1.3))),
                               int(np.log2(icap)) + 1)
            print(f"[capacity] tile-instance demand {ni} near/over "
                  f"instance_capacity {icap}: growing to {new_cap}",
                  flush=True)
            self._render_kwargs["instance_capacity"] = new_cap
            self._build_steps()
            return
        if ni > icap - 2048 and not self._warned_instance_overflow:
            self._warned_instance_overflow = True
            warnings.warn(
                f"tile-instance demand {ni} reaches the instance_capacity "
                f"{icap} guard band; excess instances are DROPPED. Raise "
                f"raster.instance_capacity_mult.", RuntimeWarning,
                stacklevel=2)
        mtc = int(metrics.get("max_tile_count", 0))
        if self._tile_capacity is not None and mtc > self._tile_capacity \
                and not self._warned_tile_overflow:
            self._warned_tile_overflow = True
            warnings.warn(
                f"densest tile holds {mtc} instances > tile_capacity "
                f"{self._tile_capacity}; the tile's farthest splats are "
                f"DROPPED. Raise tile_capacity.", RuntimeWarning,
                stacklevel=2)
