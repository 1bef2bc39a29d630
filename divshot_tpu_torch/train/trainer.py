"""The static training step and its host loop (counterpart of
``divshot_tpu/train/trainer.py``).

One step: pick a view, render it through the kernels, L1 + D-SSIM loss
(plus the 2DGS geometry losses where configured), the backward kernel and
the per-splat reduce, autograd back through projection and SH, per-group
Adam, densification statistics, then refine, alpha reset or MCMC noise on
the schedule. The step is eager PyTorch: the schedule's branches are plain
Python on the host step count, and nothing in the step reads a value back
from the card; ``Trainer.run`` reads the metrics only where it logs them.

Routes, as in JAX: 3DGS (``model_type=0``) renders through the 3DGS
kernels (``render``); exact 2DGS (``model_type=1``, ``surfel_exact``, the
default) through the surfel kernels (``render_surfels``); flattened 2DGS
(``surfel_exact=False``) flattens the splats and renders them through the
3DGS kernels. A ``render_kwargs["backend"]`` overrides the route. With
the normal-consistency or the depth-distortion loss, or on 2DGS, the step
composites the planes ``[z, z^2, nx, ny]`` in the same pass (the surfel
kernels' own depth planes, or the 3DGS kernels' extra channels).

Ported: the 3DGS and 2DGS models, the geometry losses, one view per step,
full resolution, images held on the device, the ADC, ADC+ and MCMC
strategies and the periodic prune. The rest raises ``NotImplementedError``
naming ROADMAP.md: the background model, masks, dynamic models, streamed
datasets, batches, progressive resolution, gradient all-reduce across
chips, buffer packing, NaN debugging and the XLA surfel compositor
(``backend="surfel"``).
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
from divshot_tpu_torch.raster.render import render
from divshot_tpu_torch.raster.surfel_raster import render_surfels
from divshot_tpu_torch.splat.camera import Camera, batch_cameras
from divshot_tpu_torch.splat.gaussians import GaussianParams
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

    @property
    def step(self) -> int:
        return self.opt.step

    @classmethod
    def init(cls, params: GaussianParams, seed: int = 0) -> "TrainState":
        gen = torch.Generator(device=params.device)
        gen.manual_seed(seed)
        return cls(params=params, opt=AdamState.init(params),
                   dstate=S.DensifyState.init(params.capacity,
                                              params.device), gen=gen)

    @classmethod
    def from_numpy(cls, d: dict, *, seed: int = 0,
                   device="cuda") -> "TrainState":
        """Carry a JAX ``TrainState`` across: ``d["params"]`` as for
        ``GaussianParams.from_numpy``; ``d["mu"]`` and ``d["nu"]`` map each
        parameter field to its Adam moment, ``d["step"]`` is the Adam step,
        ``d["dstate"]`` holds ``grad_accum``, ``count`` and ``max_radii``;
        all numpy. The JAX random key has no counterpart: the port's draws
        come from a generator seeded with ``seed``."""
        params = GaussianParams.from_numpy(d["params"], device=device)

        def t(x):
            return torch.as_tensor(np.array(x, np.float32), device=device)

        opt = AdamState(mu={f: t(d["mu"][f]) for f in PARAM_FIELDS},
                        nu={f: t(d["nu"][f]) for f in PARAM_FIELDS},
                        step=int(d["step"]))
        ds = S.DensifyState(**{k: t(d["dstate"][k]) for k in
                               ("grad_accum", "count", "max_radii")})
        state = cls.init(params, seed)
        return dataclasses.replace(state, opt=opt, dstate=ds)


@dataclass
class Dataset:
    """Training views held on the device: ``cameras`` share one resolution,
    ``images`` is (V, H, W, 3) uint8."""
    cameras: list[Camera]
    images: torch.Tensor
    scene_extent: float
    points: np.ndarray | None = None   # seed point cloud
    colors: np.ndarray | None = None
    masks: torch.Tensor | None = None
    times: np.ndarray | None = None

    @property
    def num_views(self) -> int:
        return self.images.shape[0]

    @classmethod
    def from_views(cls, cams: list[Camera], images: np.ndarray, points=None,
                   colors=None, stream: bool = False, masks=None,
                   **kw) -> "Dataset":
        if stream:
            raise _unported("a streamed dataset")
        if masks is not None:
            raise _unported("training with masks")
        cams = batch_cameras(cams)
        vms = np.stack([c.viewmat for c in cams])
        centers = -np.einsum("nij,ni->nj", vms[:, :3, :3], vms[:, :3, 3])
        center = centers.mean(0)
        extent = float(np.linalg.norm(centers - center, axis=1).max()) * 1.1
        images = np.asarray(images)
        if images.dtype != np.uint8:
            images = (np.clip(images, 0, 1) * 255).astype(np.uint8)
        return cls(cameras=cams,
                   images=torch.as_tensor(images, device=cams[0].device),
                   scene_extent=max(extent, 1e-3), points=points,
                   colors=colors, **kw)


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


def check_supported(cfg: TrainConfig, dataset: Dataset | None = None,
                    *, batch_size: int = 1, res_scale: int = 1,
                    streamed: bool = False,
                    grad_psum_axis: str | None = None) -> None:
    """Raise ``NotImplementedError`` for every option of the JAX trainer
    that the port does not run yet."""
    checks = [
        (cfg.model_type not in (ModelType.GS3D, ModelType.GS2D),
         f"model_type={cfg.model_type} (the dynamic models)"),
        (cfg.enable_bg, "enable_bg (the background model)"),
        (cfg.use_mask, "use_mask (training with masks)"),
        (max(batch_size, cfg.batch_size) > 1, "batch_size > 1"),
        (res_scale > 1 or cfg.progressive_train,
         "progressive resolution (res_scale > 1)"),
        (streamed, "a streamed dataset"),
        (grad_psum_axis is not None, "grad_psum_axis (multi-chip training)"),
        (cfg.pack_level != 0, "pack_level (packed training buffers)"),
        (cfg.debug_nan, "debug_nan"),
    ]
    if dataset is not None:
        checks += [(dataset.masks is not None, "training with masks"),
                   (dataset.times is not None, "a dynamic dataset")]
    for bad, what in checks:
        if bad:
            raise _unported(what)


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


def make_train_step(cfg: TrainConfig, dataset: Dataset,
                    render_kwargs: dict[str, Any] | None = None,
                    batch_size: int = 1, res_scale: int = 1,
                    streamed: bool = False,
                    grad_psum_axis: str | None = None) -> Callable:
    """-> ``train_step(state, view_idx, hypers=None) -> (state, metrics)``.
    ``metrics`` holds device scalars: loss, psnr, num_alive and the
    binning's num_instances and max_tile_count."""
    check_supported(cfg, dataset, batch_size=batch_size,
                    res_scale=res_scale, streamed=streamed,
                    grad_psum_axis=grad_psum_axis)
    rk = render_kwargs_from_config(cfg)
    rk.update(render_kwargs or {})
    backend = rk["backend"]
    surfel = (cfg.model_type == ModelType.GS2D
              and backend not in ("tiles", "dense", "pallas"))
    if surfel and backend != "surfel_pallas":
        raise _unported(f"render backend {backend!r} (the XLA surfel "
                        f"compositor)")
    srk = {k: v for k, v in rk.items()
           if k in ("tile_size", "instance_capacity", "instance_capacity_mult",
                    "max_tiles_per_gaussian", "t_eps")}
    need_geom = (cfg.normal_consistency_loss
                 or cfg.model_type == ModelType.GS2D
                 or cfg.dist_loss_weight > 0)
    extent = dataset.scene_extent
    dcfg = cfg.densify
    dev = dataset.images.device
    bg = torch.full((3,), 1.0 if cfg.white_background else 0.0, device=dev)
    W, H = dataset.cameras[0].width, dataset.cameras[0].height
    ndc_scale = torch.tensor([W / 2.0, H / 2.0], device=dev)

    def render_view(p: GaussianParams, camera: Camera, sinks):
        """-> the view's RenderOutput; its ``extra`` holds the planes
        [z, z^2, nx, ny] when the geometry losses need them."""
        sink_kw = dict(absgrad_sink=sinks[0], means2d_sink=sinks[1],
                       npix_sink=sinks[2])
        if surfel:
            return render_surfels(p, camera, background=bg,
                                  with_geometry=need_geom, **sink_kw, **srk)
        if cfg.model_type == ModelType.GS2D:
            p = G.flatten_to_surfels(p)
        aux = None
        if need_geom:
            # camera-space depth and normals; camera-facing, so nz < 0 is
            # recoverable from (nx, ny); z and z^2 feed the distortion
            z = matvec3(camera.rotation, p.means, camera.translation)[:, 2]
            n_cam = matvec3(camera.rotation, G.splat_normals(p, camera),
                            (0.0, 0.0, 0.0))
            aux = torch.stack([z, z * z, n_cam[:, 0], n_cam[:, 1]], 1)
        return render(p, camera, background=bg, extra_colors=aux,
                      **sink_kw, **rk)

    def train_step(state: TrainState, view_idx: int,
                   hypers: dict[str, float] | None = None):
        hyp = hypers if hypers is not None else hypers_from_config(cfg)
        camera = dataset.cameras[view_idx]
        gt = dataset.images[view_idx].float() / 255.0
        step = state.opt.step
        params = state.params
        cap = params.capacity
        deg = min(step // cfg.sh_degree_interval, cfg.sh_degree)

        leaves = {f: getattr(params, f).detach().requires_grad_(True)
                  for f in PARAM_FIELDS}
        sinks = [torch.zeros(shape, device=dev, requires_grad=True)
                 for shape in ((cap, 2), (cap, 2), (cap,))]
        p = dataclasses.replace(params, **leaves)
        p = dataclasses.replace(
            p, shN=p.shN * sh_band_mask(p.shN.shape[1], deg, dev))
        out = render_view(p, camera, sinks)
        loss = photometric_loss(out.image, gt, hyp["ssim_weight"],
                                use_ssim=cfg.ssim_weight > 0)
        if need_geom:
            loss = loss + geometry_loss(cfg, out.extra, out.alpha, camera,
                                        step, hyp)
        inputs = [*leaves.values(), *sinks]
        grads = [torch.zeros_like(x) if g is None else g for x, g in zip(
            inputs, torch.autograd.grad(loss, inputs, allow_unused=True))]
        g_fields = dict(zip(PARAM_FIELDS, grads[:len(PARAM_FIELDS)]))
        g_abs, g_m2d, g_npix = grads[len(PARAM_FIELDS):]

        with torch.no_grad():
            radii = out.proj.radii
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
            metrics = {
                "loss": loss.detach(),
                "psnr": psnr(out.image.detach(), gt),
                "num_alive": params.alive.sum(),
                "num_instances": out.num_instances,
                "max_tile_count": out.max_tile_count,
            }
        return TrainState(params=params, opt=opt, dstate=dstate,
                          gen=state.gen), metrics

    return train_step


class Trainer:
    """Host loop over the step: random views, progress logging, and the
    instance capacity grown from measured demand."""

    def __init__(self, cfg: TrainConfig, dataset: Dataset,
                 params: GaussianParams,
                 render_kwargs: dict[str, Any] | None = None):
        check_supported(cfg, dataset)
        self.cfg = cfg
        self.dataset = dataset
        self.state = TrainState.init(params, cfg.seed)
        self._render_kwargs = dict(render_kwargs or {})
        self._hypers = hypers_from_config(cfg)
        self._build_steps()
        self._np_rng = np.random.default_rng(cfg.seed)
        self.metrics_history: list[dict] = []
        self.last_metrics: dict | None = None

    def _build_steps(self) -> None:
        rk = self._render_kwargs
        cap = self.state.params.capacity
        mult = rk.get("instance_capacity_mult",
                      self.cfg.raster.instance_capacity_mult)
        self._instance_capacity = rk.get("instance_capacity") \
            or max(1 << 16, int(mult * cap))
        self._warned_instance_overflow = False
        self._step_fn = make_train_step(
            self.cfg, self.dataset,
            {**rk, "instance_capacity": self._instance_capacity})

    @property
    def instance_capacity(self) -> int:
        """The instance capacity the step renders with now."""
        return self._instance_capacity

    def step_once(self) -> dict:
        """One step on a random view."""
        view = int(self._np_rng.integers(self.dataset.num_views))
        self.state, metrics = self._step_fn(self.state, view,
                                            hypers=self._hypers)
        self.last_metrics = metrics
        return metrics

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
        drops instances."""
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
