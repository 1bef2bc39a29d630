"""Extension-dispatched splat model I/O (counterpart of
``divshot_tpu/gsio/io.py``): ``.ply`` (the standard 3DGS PLY;
``.compressed`` or ``.reduced`` in the name selects the PlayCanvas
compressed or the EAGLES-style reduced PLY, and a PLY with a ``chunk``
element reads as compressed), ``.splat``, ``.spz`` and ``.dvsplat``. The
files are the JAX package's byte for byte (``.spz``: its payload, under a
gzip header that carries the time). Loads go to ``device``.
"""

from __future__ import annotations

import os

from divshot_tpu_torch.gsio.compressed import (load_compressed_ply,
                                               save_compressed_ply)
from divshot_tpu_torch.gsio.dvsplat import load_dvsplat, save_dvsplat
from divshot_tpu_torch.gsio.ply import (load_ply, load_splat, save_ply,
                                        save_splat)
from divshot_tpu_torch.gsio.reduced import load_reduced_ply, save_reduced_ply
from divshot_tpu_torch.gsio.spz import load_spz, save_spz
from divshot_tpu_torch.splat.gaussians import GaussianParams


def save_model(path: str, params: GaussianParams, *,
               antialiased: bool = False, **kw) -> None:
    """``kw`` goes to the reduced PLY's writer."""
    ext = os.path.splitext(path)[1].lower()
    name = os.path.basename(path).lower()
    if ext == ".ply":
        if ".compressed" in name:
            save_compressed_ply(path, params, antialiased=antialiased)
        elif ".reduced" in name:
            save_reduced_ply(path, params, **kw)
        else:
            save_ply(path, params, antialiased=antialiased)
    elif ext == ".splat":
        save_splat(path, params)
    elif ext == ".spz":
        save_spz(path, params, antialiased=antialiased)
    elif ext == ".dvsplat":
        save_dvsplat(path, params)
    else:
        raise ValueError(f"unknown splat format: {path}")


def load_model(path: str, *, device="cuda") -> tuple[GaussianParams, dict]:
    ext = os.path.splitext(path)[1].lower()
    name = os.path.basename(path).lower()
    if ext == ".ply":
        if ".compressed" in name or _sniff_compressed(path):
            return load_compressed_ply(path, device=device)
        if ".reduced" in name:
            return load_reduced_ply(path, device=device)
        return load_ply(path, device=device)
    if ext == ".splat":
        return load_splat(path, device=device), {}
    if ext == ".spz":
        return load_spz(path, device=device)
    if ext == ".dvsplat":
        return load_dvsplat(path, device=device)
    raise ValueError(f"unknown splat format: {path}")


def _sniff_compressed(path: str) -> bool:
    """Detect a chunked compressed PLY by its header elements."""
    try:
        with open(path, "rb") as f:
            return b"element chunk" in f.read(4096)
    except OSError:
        return False
