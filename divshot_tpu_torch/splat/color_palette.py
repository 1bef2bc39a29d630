"""Splat paint-colour palette (counterpart of
``divshot_tpu/splat/color_palette.py``): painting gives splats a 16-bit
palette index instead of rewriting their SH, so the editor can recolour
groups and bake once. Index 0 is unpainted.

The colour table lives on the host, the per-splat indices on the device;
``apply`` is the render-time view and ``bake`` flattens the palette into
``sh0`` / ``shN`` (DC set to the colour, the higher bands zeroed).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from divshot_tpu_torch.splat.gaussians import GaussianParams

MAX_ENTRIES = 1 << 16
SH_C0 = 0.28209479177387814


class SplatPaintColorPalette:
    """Host colour table + per-splat colour indices on ``device``."""

    def __init__(self, capacity: int, device="cuda"):
        self.capacity = capacity
        self.colors: list[np.ndarray] = [np.zeros(3, np.float32)]  # 0: none
        self.indices = torch.zeros((capacity,), dtype=torch.int32,
                                   device=device)

    @property
    def num_entries(self) -> int:
        return len(self.colors)

    def add(self, color) -> int:
        """-> the palette slot of ``color`` (new, or an identical one)."""
        c = np.asarray(color, np.float32).reshape(3)
        for i, e in enumerate(self.colors[1:], start=1):
            if np.array_equal(e, c):
                return i
        if len(self.colors) >= MAX_ENTRIES:
            raise ValueError("paint palette full (65536 entries)")
        self.colors.append(c)
        return len(self.colors) - 1

    def assign(self, mask: torch.Tensor, slot: int) -> None:
        self.indices = torch.where(mask, slot, self.indices).to(torch.int32)

    def clear(self, mask: torch.Tensor) -> None:
        self.indices = torch.where(mask, 0, self.indices).to(torch.int32)

    def table(self) -> torch.Tensor:
        """(K, 3) float32 colour table on the indices' device."""
        return torch.as_tensor(np.stack(self.colors, axis=0),
                               device=self.indices.device)

    def apply(self, params: GaussianParams) -> GaussianParams:
        """Render-time view: painted splats show their palette colour."""
        painted = self.indices > 0
        col = self.table()[self.indices.long()]                 # (C, 3)
        sh0_new = (col - 0.5) / SH_C0
        zero = torch.zeros((), dtype=params.shN.dtype, device=params.device)
        return dataclasses.replace(
            params,
            sh0=torch.where(painted[:, None], sh0_new, params.sh0),
            shN=torch.where(painted[:, None, None], zero, params.shN))

    def bake(self, params: GaussianParams) -> GaussianParams:
        """Flatten the palette into ``sh0`` / ``shN`` and reset it."""
        out = self.apply(params)
        self.indices = torch.zeros_like(self.indices)
        self.colors = [np.zeros(3, np.float32)]
        return out
