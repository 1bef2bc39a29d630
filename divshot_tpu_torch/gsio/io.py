"""Extension-dispatched model I/O (counterpart of
``divshot_tpu/gsio/io.py``). Ported: the plain 3DGS ``.ply`` both ways and
the antimatter15 ``.splat`` on save; the compressed and reduced PLY,
``.spz`` and ``.dvsplat`` (and reading ``.splat`` through this dispatch)
raise ``NotImplementedError`` naming ROADMAP.md, Queue A item 5.
"""

from __future__ import annotations

import os

from divshot_tpu_torch.gsio.ply import load_ply, save_ply, save_splat
from divshot_tpu_torch.splat.gaussians import GaussianParams


def _unported(path: str, what: str):
    return NotImplementedError(
        f"{path}: {what} is not ported yet (ROADMAP.md, Queue A item 5)")


def save_model(path: str, params: GaussianParams, *,
               antialiased: bool = False, **kw) -> None:
    ext = os.path.splitext(path)[1].lower()
    name = os.path.basename(path).lower()
    if ext == ".ply":
        if ".compressed" in name:
            raise _unported(path, "the compressed PLY")
        if ".reduced" in name:
            raise _unported(path, "the reduced PLY")
        save_ply(path, params, antialiased=antialiased)
    elif ext == ".splat":
        save_splat(path, params)
    elif ext in (".spz", ".dvsplat"):
        raise _unported(path, ext)
    else:
        raise ValueError(f"unknown splat format: {path}")


def load_model(path: str, *, device="cuda") -> tuple[GaussianParams, dict]:
    ext = os.path.splitext(path)[1].lower()
    name = os.path.basename(path).lower()
    if ext == ".ply":
        if (".compressed" in name or ".reduced" in name
                or _sniff_compressed(path)):
            raise _unported(path, "the compressed and reduced PLY")
        return load_ply(path, device=device)
    if ext in (".splat", ".spz", ".dvsplat"):
        raise _unported(path, ext)
    raise ValueError(f"unknown splat format: {path}")


def _sniff_compressed(path: str) -> bool:
    """Detect a chunked compressed PLY by its header elements."""
    with open(path, "rb") as f:
        return b"element chunk" in f.read(4096)
