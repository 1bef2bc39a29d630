"""Extension-dispatched model loading (counterpart of
``divshot_tpu/gsio/io.py:41``). Only the plain 3DGS ``.ply`` is ported; the
compressed, reduced, ``.splat``, ``.spz`` and ``.dvsplat`` formats raise
``NotImplementedError`` until their modules are ported.
"""

from __future__ import annotations

import os

from divshot_tpu_torch.gsio.ply import load_ply
from divshot_tpu_torch.splat.gaussians import GaussianParams


def load_model(path: str, *, device="cuda") -> tuple[GaussianParams, dict]:
    ext = os.path.splitext(path)[1].lower()
    name = os.path.basename(path).lower()
    if ext == ".ply":
        if (".compressed" in name or ".reduced" in name
                or _sniff_compressed(path)):
            raise NotImplementedError(
                f"{path}: compressed and reduced PLY are not ported yet")
        return load_ply(path, device=device)
    if ext in (".splat", ".spz", ".dvsplat"):
        raise NotImplementedError(f"{path}: {ext} is not ported yet")
    raise ValueError(f"unknown splat format: {path}")


def _sniff_compressed(path: str) -> bool:
    """Detect a chunked compressed PLY by its header elements."""
    with open(path, "rb") as f:
        return b"element chunk" in f.read(4096)
