"""Held-out evaluation: test-split PSNR and SSIM over a ``Dataset``
(counterpart of ``divshot_tpu/train/evaluate.py``), used by
``apps/train.py`` every ``eval_every`` steps and at the end of training.

Each view is rendered through the port's ``render`` (the kernels on a
card) and scored with the port's ``psnr`` and ``ssim``, one view at a
time with no gradient. LPIPS (``train/lpips.py``) is reported, as the
mean over the views, only when pretrained weights are configured
(``DIVSHOT_LPIPS_WEIGHTS``), as in JAX.
"""

from __future__ import annotations

import time
from typing import Any

import numpy as np
import torch

from divshot_tpu_torch.raster.render import render
from divshot_tpu_torch.train.losses import psnr, ssim
from divshot_tpu_torch.train.lpips import default_lpips


def evaluate(params, eval_ds, *, render_kwargs: dict[str, Any] | None = None,
             background: torch.Tensor | None = None,
             max_views: int | None = None) -> dict:
    """-> {"psnr": float, "ssim": float, "n_views": int,
    "per_view_psnr": [...], "views_per_s": float}, and "lpips": float when
    ``default_lpips()`` has weights. Renders every eval view (or the first
    ``max_views``) with the given render kwargs."""
    lp = default_lpips()
    rk = dict(render_kwargs or {})
    n = eval_ds.num_views if max_views is None \
        else min(max_views, eval_ds.num_views)
    psnrs, ssims, lpipss = [], [], []
    t0 = time.perf_counter()
    with torch.no_grad():
        for i in range(n):
            gt = eval_ds.images[i].float() / 255.0
            img = render(params, eval_ds.cameras[i], background=background,
                         **rk).image
            psnrs.append(float(psnr(img, gt)))
            ssims.append(float(ssim(img, gt)))
            if lp is not None:
                lpipss.append(float(lp(img, gt)))
    dt = time.perf_counter() - t0
    out = {"psnr": float(np.mean(psnrs)), "ssim": float(np.mean(ssims)),
           "n_views": n, "per_view_psnr": psnrs,
           "views_per_s": n / max(dt, 1e-9)}
    if lpipss:
        out["lpips"] = float(np.mean(lpipss))
    return out
