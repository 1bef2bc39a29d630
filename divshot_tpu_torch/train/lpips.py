"""LPIPS perceptual distance (Zhang et al. 2018; counterpart of
``divshot_tpu/train/lpips.py``).

A channel-normalised, linearly weighted L2 over VGG-16 conv feature
stacks. The pretrained VGG-16 and LPIPS linear weights do not ship with
this repo and are never downloaded: point ``DIVSHOT_LPIPS_WEIGHTS`` at a
weights file to enable the metric:

    weights.npz with arrays
      features.<i>.weight / features.<i>.bias   (torchvision VGG-16 conv
                                                 layout, i in VGG16_CONV)
      lin.<k>.weight                            (LPIPS linear heads, k 0..4)

``lpips_fn(weights)`` returns ``(img_a, img_b) -> scalar`` on (H, W, 3)
images in [0, 1], on whatever device the images are (the weights follow
them). The convolutions are ``F.conv2d`` in float32, TF32 off, as JAX's
``lax.conv_general_dilated`` computes them on the CPU; ``evaluate`` reports
the metric when weights are configured.
"""

from __future__ import annotations

import functools
import os

import numpy as np
import torch
import torch.nn.functional as F

# torchvision VGG-16 conv indices and the slice boundaries after which
# LPIPS taps features (relu1_2, relu2_2, relu3_3, relu4_3, relu5_3)
VGG16_CONV = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28)
_TAPS = (2, 7, 14, 21, 28)          # conv index whose relu output is tapped
_POOL_AFTER = (2, 7, 14, 21)        # maxpool after these taps

# ImageNet normalisation LPIPS uses (on [-1, 1]-scaled input)
_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32)


# (cout, cin) of each VGG-16 conv in VGG16_CONV, and the heads' widths
_VGG16_SHAPES = ((64, 3), (64, 64), (128, 64), (128, 128), (256, 128),
                 (256, 256), (256, 256), (512, 256), (512, 512), (512, 512),
                 (512, 512), (512, 512), (512, 512))
_LIN_WIDTHS = (64, 128, 256, 512, 512)


def random_weights(path: str, seed: int = 0) -> str:
    """Write random weights in the torchvision layout to ``path`` (He-scaled
    convs, small biases, positive heads): a stand-in for the pretrained
    file when checking the network itself -> ``path``."""
    rng = np.random.default_rng(seed)
    d = {}
    for i, (co, ci) in zip(VGG16_CONV, _VGG16_SHAPES):
        d[f"features.{i}.weight"] = (rng.standard_normal((co, ci, 3, 3))
                                     * np.sqrt(2.0 / (ci * 9))
                                     ).astype(np.float32)
        d[f"features.{i}.bias"] = (0.01 * rng.standard_normal(co)
                                   ).astype(np.float32)
    for k, c in enumerate(_LIN_WIDTHS):
        d[f"lin.{k}.weight"] = rng.uniform(0, 1, (1, c, 1, 1)).astype(
            np.float32)
    with open(path, "wb") as f:
        np.savez(f, **d)
    return str(path)


def load_weights(path: str) -> dict:
    """weights.npz -> {conv_idx: (w (cout, cin, kh, kw), b (cout,)),
    "lin": [5 x (c,)]}, float32 CPU tensors; the torchvision layout is
    already ``F.conv2d``'s."""
    z = np.load(path)
    out = {}
    for i in VGG16_CONV:
        out[i] = (torch.from_numpy(np.array(z[f"features.{i}.weight"],
                                            np.float32)),
                  torch.from_numpy(np.array(z[f"features.{i}.bias"],
                                            np.float32)))
    out["lin"] = [torch.from_numpy(np.array(z[f"lin.{k}.weight"],
                                            np.float32).reshape(-1))
                  for k in range(5)]
    return out


def _on(weights: dict, device: torch.device) -> dict:
    return {k: ([t.to(device) for t in v]) for k, v in weights.items()}


def _features(img: torch.Tensor, w: dict) -> list[torch.Tensor]:
    """img (H, W, 3) in [0, 1] -> the 5 tapped feature maps, (1, C, h, w)."""
    shift = torch.from_numpy(_SHIFT).to(img.device)
    scale = torch.from_numpy(_SCALE).to(img.device)
    x = (img.float() * 2.0 - 1.0 - shift) / scale
    x = x.permute(2, 0, 1)[None]
    feats = []
    for i in VGG16_CONV:
        wi, bi = w[i]
        x = F.relu(F.conv2d(x, wi, bi, padding=1))
        if i in _TAPS:
            feats.append(x)
        if i in _POOL_AFTER:
            x = F.max_pool2d(x, 2, 2)
    return feats


def _unit_norm(f: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    return f * torch.rsqrt(torch.sum(f * f, dim=1, keepdim=True) + eps)


def lpips_fn(weights: dict):
    """-> (img_a (H, W, 3), img_b (H, W, 3)) -> scalar LPIPS tensor, with
    no gradient."""
    cache: dict = {}

    def fn(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        dev = a.device
        if dev not in cache:
            cache[dev] = _on(weights, dev)
        w = cache[dev]
        cudnn = torch.backends.cudnn
        with torch.no_grad(), cudnn.flags(
                enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                deterministic=cudnn.deterministic, allow_tf32=False):
            fa = _features(a, w)
            fb = _features(b, w)
            total = torch.zeros((), device=dev)
            for k, (x, y) in enumerate(zip(fa, fb)):
                d = _unit_norm(x) - _unit_norm(y)
                d2 = torch.sum(d * d * w["lin"][k][None, :, None, None],
                               dim=1)
                total = total + d2.mean()
        return total

    return fn


@functools.lru_cache(maxsize=4)
def _lpips_from(path: str):
    return lpips_fn(load_weights(path))


def default_lpips():
    """The metric from ``$DIVSHOT_LPIPS_WEIGHTS``, or None when it is unset
    or names no file. Cached by path, so the variable may change during a
    process (JAX caches the first answer whatever the variable says
    later)."""
    path = os.environ.get("DIVSHOT_LPIPS_WEIGHTS", "")
    if path and os.path.exists(path):
        return _lpips_from(path)
    return None
