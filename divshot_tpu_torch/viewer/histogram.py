"""Image histogram and levels (counterpart of
``divshot_tpu/viewer/histogram.py``, copied: pure numpy) — the editor's
histogram panel
(``application/editor/source/histogram_panel.h:14-153``): per-channel and
luminance histograms, percentile-based black/white point suggestions, and
a levels application that matches the SH0-domain grading in
``scene.components.GaussianComponent``."""

from __future__ import annotations

import numpy as np


def image_histogram(img: np.ndarray, bins: int = 256
                    ) -> dict[str, np.ndarray]:
    """(H, W, 3) in [0, 1] -> dict(r, g, b, luma) of (bins,) counts."""
    img = np.clip(np.asarray(img, np.float32), 0.0, 1.0)
    out = {}
    for i, name in enumerate("rgb"):
        out[name] = np.histogram(img[..., i], bins=bins, range=(0, 1))[0]
    luma = img @ np.asarray([0.2126, 0.7152, 0.0722], np.float32)
    out["luma"] = np.histogram(luma, bins=bins, range=(0, 1))[0]
    return out


def suggest_levels(img: np.ndarray, clip_percent: float = 0.5
                   ) -> dict[str, float]:
    """Auto-levels: black/white points at the clip percentiles of the luma
    distribution (the histogram panel's auto button)."""
    img = np.clip(np.asarray(img, np.float32), 0.0, 1.0)
    luma = img @ np.asarray([0.2126, 0.7152, 0.0722], np.float32)
    lo = float(np.percentile(luma, clip_percent))
    hi = float(np.percentile(luma, 100.0 - clip_percent))
    return {"black_point": lo, "white_point": max(hi, lo + 1e-3),
            "brightness": 0.0}


def apply_levels(img: np.ndarray, black_point: float = 0.0,
                 white_point: float = 1.0, brightness: float = 0.0,
                 albedo=(1.0, 1.0, 1.0)) -> np.ndarray:
    """Apply levels to an image with the same formula the splat grading
    uses in color space: c' = offset + c*albedo*scale."""
    offset = -black_point + brightness
    scale = 1.0 / max(white_point - black_point, 1e-6)
    out = offset + np.asarray(img, np.float32) * np.asarray(albedo) * scale
    return np.clip(out, 0.0, 1.0)
