"""Held-out evaluation: test-split PSNR and SSIM over a ``Dataset``
(counterpart of ``divshot_tpu/train/evaluate.py``), used by
``apps/train.py`` every ``eval_every`` steps and at the end of training.

Each view is rendered through the port's ``render`` (the kernels on a
card) and scored with the port's ``psnr`` and ``ssim``, one view at a
time with no gradient. LPIPS is reported only when pretrained weights are
configured (``DIVSHOT_LPIPS_WEIGHTS``), as in JAX; its network is not
ported yet, so then evaluation raises instead of leaving it out.
"""

from __future__ import annotations

import os
import time
from typing import Any

import numpy as np
import torch

from divshot_tpu_torch.raster.render import render
from divshot_tpu_torch.train.losses import psnr, ssim


def evaluate(params, eval_ds, *, render_kwargs: dict[str, Any] | None = None,
             background: torch.Tensor | None = None,
             max_views: int | None = None) -> dict:
    """-> {"psnr": float, "ssim": float, "n_views": int,
    "per_view_psnr": [...], "views_per_s": float}. Renders every eval view
    (or the first ``max_views``) with the given render kwargs."""
    if os.environ.get("DIVSHOT_LPIPS_WEIGHTS"):
        raise NotImplementedError(
            "DIVSHOT_LPIPS_WEIGHTS is set, but LPIPS (train/lpips.py) is "
            "not ported to divshot_tpu_torch yet (ROADMAP.md, Queue A "
            "item 4)")
    rk = dict(render_kwargs or {})
    n = eval_ds.num_views if max_views is None \
        else min(max_views, eval_ds.num_views)
    psnrs, ssims = [], []
    t0 = time.perf_counter()
    with torch.no_grad():
        for i in range(n):
            gt = eval_ds.images[i].float() / 255.0
            img = render(params, eval_ds.cameras[i], background=background,
                         **rk).image
            psnrs.append(float(psnr(img, gt)))
            ssims.append(float(ssim(img, gt)))
    dt = time.perf_counter() - t0
    return {"psnr": float(np.mean(psnrs)), "ssim": float(np.mean(ssims)),
            "n_views": n, "per_view_psnr": psnrs,
            "views_per_s": n / max(dt, 1e-9)}
