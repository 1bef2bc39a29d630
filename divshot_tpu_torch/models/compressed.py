"""EAGLES-style compressed splats (counterpart of
``divshot_tpu/models/compressed.py``): per-splat quantised latents decoded
by small MLPs into colour, opacity and scale + rotation.

Stored per splat: 3 float32 of position and ``latent_dim`` int8 codes
(the latent is codes / 127), 28 bytes at the default 16 against 236 raw.
``distill`` fits the latents (straight-through quantised) and the
decoders to reproduce a model's attributes, under one Adam (optax's,
``models/dynamic.net_adam_update``). The decoders are dense layers named
as flax names them (``Dense_0``, ...), initialised as flax does from a
``torch.Generator`` seeded by the caller. ``save_compressed`` writes JAX's
npz keys (``w{i}|[j]['params']['Dense_k']['bias' | 'kernel']``, the
kernel (in, out)), so each package reads the other's file.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from divshot_tpu_torch.models.dynamic import (Dense, NetAdamState,
                                              _generator, load_flax,
                                              net_adam_update, posenc)
from divshot_tpu_torch.splat.gaussians import GaussianParams
from divshot_tpu_torch.splat.math import safe_normalize
from divshot_tpu_torch.splat.sh import SH_C0, eval_sh_color


def _quantize_ste(x: torch.Tensor) -> torch.Tensor:
    """Straight-through 8-bit quantisation of latents in [-1, 1]."""
    q = torch.round(torch.clamp(x, -1.0, 1.0) * 127.0) / 127.0
    return x + (q - x).detach()


def _mlp(module: nn.Module, sizes: list[int], gen) -> None:
    """``Dense_0 .. Dense_{n-1}`` between consecutive ``sizes``."""
    for i, (a, b) in enumerate(zip(sizes[:-1], sizes[1:])):
        setattr(module, f"Dense_{i}", Dense(a, b, gen=gen))


class ColorMLP(nn.Module):
    """latent + view direction (4-band encoding) -> rgb logits."""

    def __init__(self, latent_dim: int = 16, width: int = 64, *, gen=None):
        super().__init__()
        _mlp(self, [latent_dim + 24, width, width, 3], gen)

    def forward(self, z, dirs):
        h = torch.cat([z, posenc(dirs, 4)], dim=-1)
        h = torch.relu(self.Dense_0(h))
        h = torch.relu(self.Dense_1(h))
        return self.Dense_2(h)


class OpacityMLP(nn.Module):
    def __init__(self, latent_dim: int = 16, width: int = 32, *, gen=None):
        super().__init__()
        _mlp(self, [latent_dim, width, 1], gen)

    def forward(self, z):
        return self.Dense_1(torch.relu(self.Dense_0(z)))[..., 0]


class ScaleRotMLP(nn.Module):
    def __init__(self, latent_dim: int = 16, width: int = 64, *, gen=None):
        super().__init__()
        _mlp(self, [latent_dim, width, width, 3], gen)
        self.Dense_3 = Dense(width, 4, gen=gen)

    def forward(self, z):
        h = torch.relu(self.Dense_0(z))
        h = torch.relu(self.Dense_1(h))
        return self.Dense_2(h), self.Dense_3(h)


@dataclass
class CompressedSplats:
    """Positions, quantised latents and the decoders."""
    means: torch.Tensor       # (N, 3) float32
    codes: torch.Tensor       # (N, D) int8 (z = codes / 127)
    alive: torch.Tensor       # (N,) bool
    color: ColorMLP
    opacity: OpacityMLP
    scalerot: ScaleRotMLP
    latent_dim: int = 16

    @property
    def latents(self) -> torch.Tensor:
        return self.codes.float() / 127.0

    def bytes_per_splat(self) -> int:
        return 12 + self.latent_dim

    def decoders(self) -> tuple[nn.Module, nn.Module, nn.Module]:
        return self.color, self.opacity, self.scalerot

    def decode(self, campos: torch.Tensor) -> GaussianParams:
        """-> ``GaussianParams`` of SH degree 0: the view dependence baked
        into the DC colour for this camera position."""
        z = self.latents
        with torch.no_grad():
            dirs = safe_normalize(self.means - campos[None, :])
            rgb = self.color(z, dirs)
            sh0 = (torch.sigmoid(rgb) - 0.5) / SH_C0
            opacity = self.opacity(z)
            scales, quats = self.scalerot(z)
        return GaussianParams(
            means=self.means, scales=scales, quats=quats, opacity=opacity,
            sh0=sh0, shN=torch.zeros((self.means.shape[0], 0, 3),
                                     device=self.means.device),
            alive=self.alive)


def _decoders(latent_dim: int, gen, device):
    return (ColorMLP(latent_dim, gen=gen).to(device),
            OpacityMLP(latent_dim, gen=gen).to(device),
            ScaleRotMLP(latent_dim, gen=gen).to(device))


def init_compressed(params: GaussianParams, seed: int = 0,
                    latent_dim: int = 16) -> CompressedSplats:
    """Latents drawn N(0, 0.1^2) and fresh decoders, from ``seed``."""
    gen = _generator(seed)
    z0 = torch.randn((params.capacity, latent_dim), generator=gen) * 0.1
    color, opacity, scalerot = _decoders(latent_dim, gen, params.device)
    codes = torch.round(torch.clamp(z0, -1, 1) * 127).to(torch.int8)
    return CompressedSplats(
        means=params.means, codes=codes.to(params.device),
        alive=params.alive, color=color, opacity=opacity, scalerot=scalerot,
        latent_dim=latent_dim)


def distill(params: GaussianParams, seed: int = 0, *, latent_dim: int = 16,
            steps: int = 2000, lr: float = 5e-3, batch_dirs: int = 8,
            log_every: int = 0) -> tuple[CompressedSplats, dict]:
    """Fit the latents and decoders to the splats' attributes
    (attribute-space distillation): the SH colour along one random
    direction a step, the opacity logit, the log-scales and the
    quaternion up to sign. -> (compressed, {"loss": the last step's,
    "losses": every step's, "bytes_per_splat"})."""
    comp = init_compressed(params, seed, latent_dim)
    dev = params.device
    gen = _generator(seed + 1)
    z = comp.latents.clone().requires_grad_(True)
    named = {"z": z}
    for tag, mod in zip(("color", "op", "sr"), comp.decoders()):
        named.update({f"{tag}.{k}": p for k, p in mod.named_parameters()})
    opt = NetAdamState.init(named)

    alive = params.alive
    a3 = alive[:, None]
    target_op = params.opacity
    target_scales = params.scales
    target_quats = params.quats / torch.clamp_min(
        torch.linalg.vector_norm(params.quats, dim=1, keepdim=True), 1e-8)
    zero = torch.zeros((), device=dev)

    def loss_fn(dirs):
        zq = _quantize_ste(z)
        d = dirs.expand(params.capacity, 3)
        tgt_rgb = torch.clamp(eval_sh_color(params.sh0, params.shN, d,
                                            params.sh_degree), 0.0, 1.0)
        pred = torch.sigmoid(comp.color(zq, d))
        l_rgb = torch.where(a3, (pred - tgt_rgb) ** 2, zero).mean()
        l_op = torch.where(alive, (comp.opacity(zq) - target_op) ** 2,
                           zero).mean()
        s, q = comp.scalerot(zq)
        qn = q / torch.clamp_min(torch.linalg.vector_norm(q, dim=1,
                                                          keepdim=True),
                                 1e-8)
        l_q = torch.where(alive, 1.0 - torch.abs((qn * target_quats).sum(1)),
                          zero).mean()
        l_s = torch.where(a3, (s - target_scales) ** 2, zero).mean()
        return l_rgb + 0.1 * l_op + 0.1 * l_s + 0.1 * l_q

    losses = []
    for i in range(steps):
        d = safe_normalize(torch.randn((3,), generator=gen).to(dev))
        loss = loss_fn(d)
        grads = torch.autograd.grad(loss, list(named.values()))
        opt = net_adam_update(named, dict(zip(named, grads)), opt, lr)
        losses.append(loss.detach())
        if log_every and (i + 1) % log_every == 0:
            print(f"[distill {i + 1}/{steps}] loss={float(loss):.5f}")

    losses = torch.stack(losses).cpu().numpy().tolist() if losses else []
    codes = torch.round(torch.clamp(z.detach(), -1, 1) * 127).to(torch.int8)
    out = CompressedSplats(
        means=params.means, codes=codes, alive=params.alive,
        color=comp.color, opacity=comp.opacity, scalerot=comp.scalerot,
        latent_dim=latent_dim)
    return out, {"loss": losses[-1] if losses else 0.0, "losses": losses,
                 "bytes_per_splat": out.bytes_per_splat()}


def _npz_leaves(comp: CompressedSplats):
    """-> [(npz key, numpy leaf)] in JAX's flattening order: decoder j,
    then its Dense layers by name, then bias before kernel."""
    out = []
    for j, mod in enumerate(comp.decoders()):
        names = sorted({k.split(".")[0] for k, _ in mod.named_parameters()})
        for layer in names:
            lin = getattr(mod, layer)
            for leaf, arr in (("bias", lin.bias), ("kernel", lin.weight.T)):
                out.append((f"[{j}]['params']['{layer}']['{leaf}']",
                            arr.detach().cpu().numpy()))
    return [(f"w{i}|{key}", a) for i, (key, a) in enumerate(out)]


def save_compressed(path: str, comp: CompressedSplats) -> None:
    """NPZ container: positions float32, codes int8, alive, the latent
    size and the decoders' parameters under JAX's keys."""
    arrays = {"means": comp.means.detach().cpu().numpy(),
              "codes": comp.codes.cpu().numpy(),
              "alive": comp.alive.cpu().numpy(),
              "latent_dim": np.asarray(comp.latent_dim)}
    arrays.update(dict(_npz_leaves(comp)))
    np.savez_compressed(path, **arrays)


def load_compressed(path: str, *, device="cuda") -> CompressedSplats:
    npz = np.load(path)
    latent_dim = int(npz["latent_dim"])
    dev = torch.device(device)
    mods = _decoders(latent_dim, None, "cpu")
    trees = [{} for _ in mods]
    for key in npz.files:
        if not key.startswith("w"):
            continue
        # w{i}|[j]['params']['Dense_k']['bias' | 'kernel']
        parts = key.split("|", 1)[1].replace("]", "").split("[")[1:]
        j, layer, leaf = int(parts[0]), parts[2].strip("'"), \
            parts[3].strip("'")
        trees[j].setdefault(layer, {})[leaf] = npz[key]
    for mod, tree in zip(mods, trees):
        load_flax(mod, tree).to(dev)
    return CompressedSplats(
        means=torch.as_tensor(npz["means"], device=dev),
        codes=torch.as_tensor(npz["codes"], device=dev),
        alive=torch.as_tensor(npz["alive"], device=dev),
        color=mods[0], opacity=mods[1], scalerot=mods[2],
        latent_dim=latent_dim)
