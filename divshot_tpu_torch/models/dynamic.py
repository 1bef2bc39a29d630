"""Dynamic gaussians (counterpart of ``divshot_tpu/models/dynamic.py``):
deformable 3DGS (a D-NeRF-style deformation MLP) and 4D gaussians (a
HexPlane spatio-temporal field) in front of the shared rasterizer.

A deformation network maps (canonical mean, time) to deltas of the mean,
rotation and log-scale. The canonical splats stay a capacity-padded
``GaussianParams`` under the per-group splat Adam (``train/optim.py``);
the network is an ``nn.Module`` under its own Adam, optax's ``adam``
(bias-corrected, float32) written out (``NetAdamState``).

Fresh networks are initialised as flax initialises the JAX modules: the
dense kernels LeCun-normal (a normal truncated at two standard
deviations, of variance 1 / fan_in), the biases zero, the heads zero, the
spatial planes ones and the time planes uniform in [0, 0.1). The draws
come from a CPU ``torch.Generator`` seeded by the caller, so one seed
gives the same network on the CPU and on a card. ``load_flax`` carries a
JAX network's parameters across (a Dense kernel (in, out) becomes the
Linear weight (out, in)).

The step is the static step's (``train/trainer.py``) with the network in
front: on a card it renders through ``RasterBinned`` and the kernels
(expand, forward, backward), on the CPU through their plain versions.
"""

from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from divshot_tpu_torch.core.config import DensifyStrategy, ModelType
from divshot_tpu_torch.splat.gaussians import GaussianParams, to_tensor

# flax's lecun_normal: a normal truncated to [-2, 2] standard deviations,
# its scale divided by the truncated normal's standard deviation
_TRUNC_STD = 0.87962566103423978


def posenc(x: torch.Tensor, n_freqs: int) -> torch.Tensor:
    """NeRF positional encoding, (..., D) -> (..., D * 2 * n_freqs): per
    coordinate the sines, then the cosines, of x * 2^k."""
    freqs = 2.0 ** torch.arange(n_freqs, dtype=torch.float32,
                                device=x.device)
    ang = x[..., None] * freqs
    enc = torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)
    return enc.reshape(*x.shape[:-1], -1)


def _generator(seed: int) -> torch.Generator:
    gen = torch.Generator()
    gen.manual_seed(int(seed))
    return gen


class Dense(nn.Module):
    """flax ``nn.Dense``: ``x @ kernel + bias``, the kernel stored as a
    Linear weight (out, in); LeCun-normal from ``gen``, or zero."""

    def __init__(self, fan_in: int, fan_out: int, *,
                 gen: torch.Generator | None = None, zero: bool = False):
        super().__init__()
        w = torch.zeros((fan_out, fan_in))
        if not zero:
            std = (1.0 / fan_in) ** 0.5 / _TRUNC_STD
            nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std,
                                  generator=gen)
        self.weight = nn.Parameter(w)
        self.bias = nn.Parameter(torch.zeros((fan_out,)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight, self.bias)


def _heads(module: nn.Module, width: int) -> None:
    module.head_xyz = Dense(width, 3, zero=True)
    module.head_rot = Dense(width, 4, zero=True)
    module.head_scale = Dense(width, 3, zero=True)


def _deltas(module: nn.Module, h: torch.Tensor) -> dict[str, torch.Tensor]:
    return {"dxyz": module.head_xyz(h), "drot": module.head_rot(h),
            "dscale": module.head_scale(h)}


def _times(t, x: torch.Tensor) -> torch.Tensor:
    """A scalar or (N,) time as an (N,) float32 tensor on x's device."""
    t = torch.as_tensor(t, dtype=torch.float32, device=x.device)
    return t.expand(x.shape[0]) if t.dim() == 0 else t


class DeformationMLP(nn.Module):
    """D-NeRF-style deformation field d(x, t) -> (dxyz, drot, dscale)."""

    def __init__(self, width: int = 128, depth: int = 6, x_freqs: int = 10,
                 t_freqs: int = 6, skip_at: int = 3, *, seed: int = 0,
                 device="cpu"):
        super().__init__()
        self.width, self.depth, self.skip_at = width, depth, skip_at
        self.x_freqs, self.t_freqs = x_freqs, t_freqs
        gen = _generator(seed)
        d_in = 3 * 2 * x_freqs + 2 * t_freqs
        fan = d_in
        for i in range(depth):
            setattr(self, f"dense_{i}", Dense(fan, width, gen=gen))
            fan = width + (d_in if i == skip_at else 0)
        _heads(self, fan)
        self.to(device)

    def forward(self, x: torch.Tensor, t) -> dict[str, torch.Tensor]:
        """x (N, 3) canonical means; t a scalar or (N,)."""
        t = _times(t, x)
        h_in = torch.cat([posenc(x, self.x_freqs),
                          posenc(t[:, None], self.t_freqs)], dim=-1)
        h = h_in
        for i in range(self.depth):
            h = torch.relu(getattr(self, f"dense_{i}")(h))
            if i == self.skip_at:
                h = torch.cat([h, h_in], dim=-1)
        return _deltas(self, h)


# the six planes over the (x, y, z, t) pairs: (name, u axis, v axis), axis
# 3 the time
_PLANES = (("xy", 0, 1), ("xz", 0, 2), ("yz", 1, 2), ("xt", 0, 3),
           ("yt", 1, 3), ("zt", 2, 3))


class HexPlaneField(nn.Module):
    """4DGS-style HexPlane: six feature planes over the (x, y, z, t)
    pairs, sampled bilinearly by gather and multiplied, decoded by a small
    MLP into deformation deltas."""

    def __init__(self, resolution: int = 64, time_resolution: int = 32,
                 features: int = 16, width: int = 64, depth: int = 2,
                 bounds: float = 1.6, *, seed: int = 0, device="cpu"):
        super().__init__()
        self.resolution, self.time_resolution = resolution, time_resolution
        self.depth, self.bounds = depth, bounds
        gen = _generator(seed)
        for name, _, vax in _PLANES:
            rv = time_resolution if vax == 3 else resolution
            shape = (resolution, rv, features)
            plane = (torch.rand(shape, generator=gen) * 0.1 if vax == 3
                     else torch.ones(shape))
            setattr(self, f"plane_{name}", nn.Parameter(plane))
        fan = features
        for i in range(depth):
            setattr(self, f"dense_{i}", Dense(fan, width, gen=gen))
            fan = width
        _heads(self, fan)
        self.to(device)

    def forward(self, x: torch.Tensor, t) -> dict[str, torch.Tensor]:
        t = _times(t, x)
        xn = torch.clamp(x / self.bounds, -1, 1) * 0.5 + 0.5
        coords = (xn[:, 0], xn[:, 1], xn[:, 2], torch.clamp(t, 0.0, 1.0))
        feats = None
        for name, uax, vax in _PLANES:
            plane = getattr(self, f"plane_{name}")
            f = _bilinear(plane, coords[uax], coords[vax])
            feats = f if feats is None else feats * f
        h = feats
        for i in range(self.depth):
            h = torch.relu(getattr(self, f"dense_{i}")(h))
        return _deltas(self, h)


def _bilinear(plane: torch.Tensor, u: torch.Tensor, v: torch.Tensor
              ) -> torch.Tensor:
    """Sample (ru, rv, C) at (u, v) in [0, 1]^2 -> (N, C). The corners are
    gathered as rows of the flattened plane by ``F.embedding``, whose
    backward sums the many rows that share a cell (every dead splat sits
    at the origin) by a segmented reduction; a 2-D index's backward adds
    them one at a time."""
    ru, rv, ch = plane.shape
    fu = u * (ru - 1)
    fv = v * (rv - 1)
    u0 = torch.clamp(torch.floor(fu).to(torch.int32), 0, ru - 2)
    v0 = torch.clamp(torch.floor(fv).to(torch.int32), 0, rv - 2)
    au = (fu - u0)[:, None]
    av = (fv - v0)[:, None]
    rows = plane.reshape(ru * rv, ch)
    i00 = u0.long() * rv + v0.long()

    def at(i):
        return F.embedding(i, rows)

    return ((1 - au) * (1 - av) * at(i00) + (1 - au) * av * at(i00 + 1)
            + au * (1 - av) * at(i00 + rv) + au * av * at(i00 + rv + 1))


def flax_named(tree: dict) -> dict[str, np.ndarray]:
    """A flax parameter tree (numpy leaves, with or without its ``params``
    level) by the port's parameter names: a Dense's ``kernel`` (in, out)
    as ``<name>.weight`` (out, in), its ``bias`` as ``<name>.bias``, any
    other leaf (a plane) under its own name."""
    tree = tree.get("params", tree)
    out = {}
    for name, leaf in tree.items():
        if isinstance(leaf, dict):
            out[f"{name}.weight"] = np.ascontiguousarray(
                np.asarray(leaf["kernel"]).T)
            out[f"{name}.bias"] = np.asarray(leaf["bias"])
        else:
            out[name] = np.asarray(leaf)
    return out


def load_flax(module: nn.Module, tree: dict) -> nn.Module:
    """Set ``module``'s parameters from a flax parameter tree
    (``flax_named``). Raises on a missing or extra name."""
    got = flax_named(tree)
    own = dict(module.named_parameters())
    if set(own) != set(got):
        raise ValueError(f"flax tree {sorted(got)} against the module's "
                         f"{sorted(own)}")
    with torch.no_grad():
        for name, p in own.items():
            p.copy_(torch.from_numpy(np.array(got[name], np.float32)))
    return module


def apply_deformation(params: GaussianParams,
                      deltas: dict[str, torch.Tensor]) -> GaussianParams:
    """Canonical -> deformed splats at one time."""
    return dataclasses.replace(
        params, means=params.means + deltas["dxyz"],
        quats=params.quats + deltas["drot"],
        scales=params.scales + deltas["dscale"])


# ---------------------------------------------------------------------------
# the network's Adam (optax.adam)


@dataclass
class NetAdamState:
    """optax ``ScaleByAdamState``: the moments by parameter name and the
    step count."""
    mu: dict[str, torch.Tensor]
    nu: dict[str, torch.Tensor]
    count: int = 0

    @classmethod
    def init(cls, named: dict[str, torch.Tensor]) -> "NetAdamState":
        """Zero moments for ``named`` ({name: parameter})."""
        return cls(mu={k: torch.zeros_like(p) for k, p in named.items()},
                   nu={k: torch.zeros_like(p) for k, p in named.items()})


def net_adam_update(named: dict[str, torch.Tensor],
                    grads: dict[str, torch.Tensor], state: NetAdamState,
                    lr: float, b1: float = 0.9, b2: float = 0.999,
                    eps: float = 1e-8) -> NetAdamState:
    """One ``optax.adam(lr)`` step of the tensors ``named`` ({name:
    parameter}), in place -> the new state. optax's order: the moments,
    the bias corrections 1 - b^count in float32, mu_hat / (sqrt(nu_hat) +
    eps), times -lr."""
    count = state.count + 1
    f = np.float32
    bc1 = float(f(1) - f(b1) ** f(count))
    bc2 = float(f(1) - f(b2) ** f(count))
    mu, nu = {}, {}
    with torch.no_grad():
        for k, p in named.items():
            g = grads[k]
            mu[k] = (1 - b1) * g + b1 * state.mu[k]
            nu[k] = (1 - b2) * (g * g) + b2 * state.nu[k]
            upd = (mu[k] / bc1) / (torch.sqrt(nu[k] / bc2) + eps)
            p.add_(-lr * upd)
    return NetAdamState(mu=mu, nu=nu, count=count)


# ---------------------------------------------------------------------------
# dynamic training


@dataclass
class DynTrainState:
    params: GaussianParams
    opt: Any                  # AdamState of the splats
    dstate: Any               # DensifyState
    net: nn.Module            # the deformation network, trained in place
    net_opt: NetAdamState
    gen: torch.Generator      # the strategies' random draws

    @property
    def step(self) -> int:
        return self.opt.step

    @classmethod
    def from_numpy(cls, d: dict, net: nn.Module, *, seed: int = 0,
                   device="cuda") -> "DynTrainState":
        """Carry a JAX ``DynTrainState`` across: ``d`` as for
        ``TrainState.from_numpy`` (``params``, ``mu``, ``nu``, ``step``,
        ``dstate``), plus ``net_params`` (the flax tree, loaded into
        ``net``) and ``net_opt``: optax's ``mu`` and ``nu`` trees and its
        ``count``. The JAX random key has no counterpart: the draws come
        from a generator seeded with ``seed``."""
        from divshot_tpu_torch.train.trainer import TrainState
        st = TrainState.from_numpy(d, seed=seed, device=device)
        load_flax(net, d["net_params"]).to(device)
        moments = {key: {k: to_tensor(v, device) for k, v in
                         flax_named(d["net_opt"][key]).items()}
                   for key in ("mu", "nu")}
        net_opt = NetAdamState(mu=moments["mu"], nu=moments["nu"],
                               count=int(d["net_opt"]["count"]))
        return cls(params=st.params, opt=st.opt, dstate=st.dstate, net=net,
                   net_opt=net_opt, gen=st.gen)


def make_dynamic_train_step(cfg, dataset, net: nn.Module,
                            render_kwargs: dict | None = None,
                            net_lr: float = 8e-4
                            ) -> tuple[Callable, Callable]:
    """-> (``init_fn(params, seed) -> DynTrainState``, ``step_fn(state,
    view_idx, hypers=None) -> (state, metrics)``). ``dataset.times`` (V,)
    in [0, 1] gives each view's time (the D-NeRF layout). The render
    route is the kernels' (``"pallas"``), whatever the platform, unless
    ``render_kwargs`` name another of ``render``'s (``"tiles"``, JAX's
    route off the TPU, ``"dense"``, ``binning="xla"``)."""
    from divshot_tpu_torch.raster.render import render
    from divshot_tpu_torch.train import strategy as S
    from divshot_tpu_torch.train.losses import photometric_loss, psnr
    from divshot_tpu_torch.train.optim import (PARAM_FIELDS, AdamState,
                                               adam_update)
    from divshot_tpu_torch.train.trainer import (hypers_from_config,
                                                 sh_band_mask)

    dcfg = cfg.densify
    rk = dict(backend="pallas",
              with_absgrad=bool(dcfg.use_abs_grad
                                and dcfg.strategy != DensifyStrategy.MCMC))
    rk.update(render_kwargs or {})
    extent = dataset.scene_extent
    dev = dataset.device
    bg = torch.full((3,), 1.0 if cfg.white_background else 0.0, device=dev)
    cams = dataset.cameras
    W, H = cams[0].width, cams[0].height
    ndc_scale = torch.tensor([W / 2.0, H / 2.0], device=dev)
    times = np.asarray(dataset.times, np.float32)

    def init_fn(params: GaussianParams, seed: int = 0) -> DynTrainState:
        gen = torch.Generator(device=params.device)
        gen.manual_seed(int(seed))
        return DynTrainState(
            params=params, opt=AdamState.init(params),
            dstate=S.DensifyState.init(params.capacity, params.device),
            net=net,
            net_opt=NetAdamState.init(dict(net.named_parameters())),
            gen=gen)

    def step_fn(state: DynTrainState, view_idx,
                hypers: dict | None = None):
        hyp = hypers if hypers is not None else hypers_from_config(cfg)
        v = int(view_idx)
        camera = cams[v]
        gt = dataset.images[v].float() / 255.0
        t = float(times[v])
        step = state.opt.step
        deg = min(step // cfg.sh_degree_interval, cfg.sh_degree)
        params = state.params
        cap = params.capacity

        leaves = {f: getattr(params, f).detach().requires_grad_(True)
                  for f in PARAM_FIELDS}
        sinks = [torch.zeros((cap, 2), device=dev, requires_grad=True)
                 for _ in range(2)]
        p = dataclasses.replace(params, **leaves)
        p = dataclasses.replace(
            p, shN=p.shN * sh_band_mask(p.shN.shape[1], deg, dev))
        # warm-up: the canonical splats alone for the first steps
        zero_warm = float(step >= dcfg.warmup_length)
        deltas = {k: d * zero_warm for k, d in state.net(p.means, t).items()}
        p = apply_deformation(p, deltas)
        out = render(p, camera, background=bg, absgrad_sink=sinks[0],
                     means2d_sink=sinks[1], **rk)
        loss = photometric_loss(out.image, gt, hyp["ssim_weight"],
                                use_ssim=cfg.ssim_weight > 0)
        names = [k for k, _ in state.net.named_parameters()]
        inputs = [*leaves.values(),
                  *(q for _, q in state.net.named_parameters()), *sinks]
        raw = torch.autograd.grad(loss, inputs, allow_unused=True)
        grads = [torch.zeros_like(x) if g is None else g
                 for x, g in zip(inputs, raw)]
        nf = len(PARAM_FIELDS)
        g_fields = dict(zip(PARAM_FIELDS, grads[:nf]))
        g_net = dict(zip(names, grads[nf:nf + len(names)]))
        g_abs, g_m2d = grads[-2:]

        with torch.no_grad():
            radii = out.proj.radii
            obs = S.DensifyObs(
                grad2d=torch.linalg.vector_norm(g_m2d * ndc_scale, dim=-1),
                absgrad2d=torch.linalg.vector_norm(g_abs * ndc_scale,
                                                   dim=-1),
                radii=radii, width=W, height=H)
            dstate = S.update_stats(state.dstate, obs, dcfg.use_abs_grad)
            params, opt = adam_update(cfg.optim, state.params, g_fields,
                                      state.opt, extent, radii > 0,
                                      hypers=hyp)
            params = dataclasses.replace(params, opacity=torch.where(
                params.alive, params.opacity,
                torch.full((), -15.0, device=dev)))
            net_opt = net_adam_update(dict(state.net.named_parameters()),
                                      g_net, state.net_opt, net_lr)

            in_window = dcfg.warmup_length <= step < dcfg.refine_stop_iter
            if in_window and step > 0 and step % dcfg.refine_every == 0:
                params, opt, dstate = S.refine(dcfg, params, opt, dstate,
                                               step, extent, hyp,
                                               gen=state.gen)
            if dcfg.strategy == DensifyStrategy.MCMC:
                params = S.mcmc_noise(dcfg, cfg.optim, params, step, extent,
                                      hyp, gen=state.gen)
            elif (in_window and step > 0
                  and step % dcfg.reset_alpha_every == 0):
                params, opt = S.alpha_reset(dcfg, params, opt)
            metrics = {"loss": loss.detach(),
                       "psnr": psnr(out.image.detach(), gt),
                       "num_alive": params.alive.sum(),
                       "num_instances": out.num_instances
                       if out.num_instances is not None
                       else torch.zeros((), dtype=torch.int32, device=dev)}
        return DynTrainState(params=params, opt=opt, dstate=dstate,
                             net=state.net, net_opt=net_opt,
                             gen=state.gen), metrics

    return init_fn, step_fn


# ---------------------------------------------------------------------------
# the host loop (the app's and the checkpoints' surface)


def net_for_model_type(model_type: int, *, seed: int = 0,
                       device="cpu") -> nn.Module:
    """The JAX defaults: a ``HexPlaneField`` for ``HEXPLANE``, else a
    ``DeformationMLP``, initialised from ``seed``."""
    if model_type == ModelType.HEXPLANE:
        return HexPlaneField(seed=seed, device=device)
    return DeformationMLP(seed=seed, device=device)


class DynamicTrainer:
    """Host loop of the dynamic models, the ``Trainer`` counterpart that
    the app drives when ``model_type`` is DEFORM or HEXPLANE: ``state``,
    ``step_once()``, ``run()``; random views from a numpy generator seeded
    with ``cfg.seed``."""

    def __init__(self, cfg, dataset, params: GaussianParams,
                 render_kwargs: dict | None = None):
        if dataset.times is None:
            raise ValueError(
                "dynamic training needs per-view times (D-NeRF layout: "
                "'time' in transforms frames)")
        self.cfg = cfg
        self.dataset = dataset
        self.net = net_for_model_type(cfg.model_type, seed=cfg.seed,
                                      device=params.device)
        rk = dict(render_kwargs or {})
        if "instance_capacity" not in rk:
            rk["instance_capacity"] = max(
                1 << 16,
                int(cfg.raster.instance_capacity_mult * params.capacity))
        self.render_kwargs = rk
        self.instance_capacity = rk["instance_capacity"]
        init_fn, self._step_fn = make_dynamic_train_step(
            cfg, dataset, self.net, render_kwargs=rk)
        self.state = init_fn(params, cfg.seed)
        self._np_rng = np.random.default_rng(cfg.seed)
        self.last_metrics: dict | None = None

    def step_once(self) -> dict:
        view = int(self._np_rng.integers(self.dataset.num_views))
        self.state, m = self._step_fn(self.state, view)
        self.last_metrics = m
        return m

    def run(self, num_iters: int | None = None, callback=None) -> None:
        n = num_iters if num_iters is not None else self.cfg.num_iters
        for i in range(n):
            m = self.step_once()
            if callback is not None:
                callback(i, self.state, m)

    def deformed_params(self, t: float) -> GaussianParams:
        """The canonical splats deformed to time ``t``."""
        with torch.no_grad():
            deltas = self.net(self.state.params.means, t)
        return apply_deformation(self.state.params, deltas)


def evaluate_dynamic(state: DynTrainState, net: nn.Module, eval_ds, *,
                     render_kwargs: dict | None = None,
                     background=None) -> dict:
    """Test-split PSNR and SSIM of a dynamic scene: each view renders the
    canonical splats deformed to that view's time. -> {"psnr", "ssim",
    "n_views", "views_per_s"}."""
    from divshot_tpu_torch.raster.render import render
    from divshot_tpu_torch.train.losses import psnr, ssim

    rk = dict(render_kwargs or {})
    times = np.asarray(eval_ds.times, np.float32)
    psnrs, ssims = [], []
    t0 = time.perf_counter()
    with torch.no_grad():
        for i in range(eval_ds.num_views):
            p = apply_deformation(state.params,
                                  net(state.params.means, float(times[i])))
            img = render(p, eval_ds.cameras[i], background=background,
                         **rk).image
            gt = eval_ds.images[i].float() / 255.0
            psnrs.append(float(psnr(img, gt)))
            ssims.append(float(ssim(img, gt)))
    dt = time.perf_counter() - t0
    return {"psnr": float(np.mean(psnrs)), "ssim": float(np.mean(ssims)),
            "n_views": eval_ds.num_views,
            "views_per_s": eval_ds.num_views / max(dt, 1e-9)}
