"""Headless splat editing (counterpart of ``divshot_tpu/edit/ops.py``): the
reference editor's selection tools, state ops, transforms with SH
rotation, crop volumes, merge and undo / redo, as tensor ops on the
params' device.

State bitfield per splat: op_state (8 bits: 1 SELECT, 2 HIDE, 4 DELETE,
8 PAINT) | op_flag (8 bits) | transform index (16 bits). The port stores
it as int32 with JAX's uint32 bits (PyTorch has no bitwise ops on
uint32).

Selection modes Box / Sphere / Rect / Brush / Polygon / Picker work in
world space or on the screen-projected centres; SET / ADD / REMOVE
combine a tool's hits with the selection. Undo records keep the replaced
tensors themselves (no op writes a tensor in place), so an undo restores
the params and state bitwise.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Callable

import numpy as np
import torch

from divshot_tpu_torch.splat.camera import Camera
from divshot_tpu_torch.splat.color_palette import SplatPaintColorPalette
from divshot_tpu_torch.splat.gaussians import GaussianParams
from divshot_tpu_torch.splat.math import (matvec3, quat_multiply,
                                          rotmat_to_quat_np)
from divshot_tpu_torch.splat.sh import rotate_sh
from divshot_tpu_torch.splat.transform_palette import (SplatTransformPalette,
                                                       affine_means,
                                                       polar_rotation)

STATE_SELECT = 0x1
STATE_HIDE = 0x2
STATE_DELETE = 0x4
STATE_PAINT = 0x8

OP_SET = 0
OP_ADD = 1
OP_REMOVE = 2

# elements of the (splats, stroke points) distance block of one brush pass
BRUSH_BLOCK = 1 << 26


def _f32(v) -> torch.Tensor:
    return torch.as_tensor(np.asarray(v, np.float32))


def project_centers(params: GaussianParams, camera: Camera) -> torch.Tensor:
    """(C, 3): screen x, y and view z of the splat centres."""
    p = matvec3(camera.rotation, params.means, camera.translation)
    z = torch.clamp_min(p[:, 2], 1e-6)
    u = camera.fx * p[:, 0] / z + camera.cx
    v = camera.fy * p[:, 1] / z + camera.cy
    return torch.stack([u, v, p[:, 2]], -1)


def _norm(x: torch.Tensor) -> torch.Tensor:
    """Euclidean norm over the last axis, as ``jnp.linalg.norm``."""
    return torch.sqrt(torch.sum(x * x, dim=-1))


def _apply_mode(sel: torch.Tensor, hit: torch.Tensor, mode: int
                ) -> torch.Tensor:
    if mode == OP_SET:
        return hit
    if mode == OP_ADD:
        return sel | hit
    return sel & ~hit


@dataclass
class _UndoRecord:
    description: str
    restore: Callable[["EditSession"], None]


@dataclass
class EditSession:
    """Mutable editing session over a splat model; each op is one device
    computation on the params' device."""

    params: GaussianParams
    state: torch.Tensor = None       # (C,) int32 bitfield
    history: list = field(default_factory=list)
    redo_stack: list = field(default_factory=list)
    max_history: int = 64
    palette: SplatTransformPalette | None = field(default=None, repr=False)
    paint_palette: SplatPaintColorPalette | None = field(default=None,
                                                         repr=False)

    def __post_init__(self):
        if self.state is None:
            self.state = torch.zeros((self.params.capacity,),
                                     dtype=torch.int32,
                                     device=self.params.device)

    # -- bitfield helpers --
    @property
    def selected(self) -> torch.Tensor:
        return (self.state & STATE_SELECT) != 0

    @property
    def hidden(self) -> torch.Tensor:
        return (self.state & STATE_HIDE) != 0

    @property
    def deleted(self) -> torch.Tensor:
        return (self.state & STATE_DELETE) != 0

    def visible_params(self) -> GaussianParams:
        """Params with hidden and deleted splats masked out."""
        dead = self.hidden | self.deleted
        return dataclasses.replace(self.params,
                                   alive=self.params.alive & ~dead)

    def _replace(self, **kw) -> None:
        self.params = dataclasses.replace(self.params, **kw)

    def _push_undo(self, desc: str, restore: Callable) -> None:
        self.history.append(_UndoRecord(desc, restore))
        if len(self.history) > self.max_history:
            self.history.pop(0)
        self.redo_stack.clear()

    def _set_state(self, new_state: torch.Tensor, desc: str) -> None:
        old = self.state

        def restore(s: "EditSession", old=old):
            s.state = old
        self._push_undo(desc, restore)
        self.state = new_state

    def _set_selected_bit(self, sel: torch.Tensor, desc: str) -> None:
        ns = torch.where(sel, self.state | STATE_SELECT,
                         self.state & ~STATE_SELECT)
        self._set_state(ns, desc)

    def _select(self, hit: torch.Tensor, mode: int, desc: str) -> None:
        self._set_selected_bit(_apply_mode(self.selected, hit, mode), desc)

    # -- selection tools --
    def select_all(self) -> None:
        self._set_selected_bit(self.params.alive, "select all")

    def select_none(self) -> None:
        self._set_selected_bit(torch.zeros_like(self.selected),
                               "select none")

    def select_inverse(self) -> None:
        self._set_selected_bit(~self.selected & self.params.alive,
                               "select inverse")

    def select_box(self, lo, hi, mode: int = OP_SET,
                   transform: np.ndarray | None = None) -> None:
        """World-space axis box, optionally in a transformed frame."""
        p = self.params.means
        dev = p.device
        if transform is not None:
            inv = _f32(np.linalg.inv(np.asarray(transform))).to(dev)
            p = p @ inv[:3, :3].T + inv[:3, 3]
        hit = torch.all((p >= _f32(lo).to(dev)) & (p <= _f32(hi).to(dev)),
                        -1)
        self._select(hit & self.params.alive, mode, "select box")

    def select_sphere(self, center, radius: float, mode: int = OP_SET
                      ) -> None:
        d = _norm(self.params.means - _f32(center).to(self.params.device))
        self._select((d <= radius) & self.params.alive, mode,
                     "select sphere")

    def select_rect(self, camera: Camera, x0, y0, x1, y1,
                    mode: int = OP_SET) -> None:
        s = project_centers(self.params, camera)
        lo_x, hi_x = (float(np.float32(v)) for v in (min(x0, x1),
                                                     max(x0, x1)))
        lo_y, hi_y = (float(np.float32(v)) for v in (min(y0, y1),
                                                     max(y0, y1)))
        hit = ((s[:, 0] >= lo_x) & (s[:, 0] <= hi_x) & (s[:, 1] >= lo_y)
               & (s[:, 1] <= hi_y) & (s[:, 2] > 0) & self.params.alive)
        self._select(hit, mode, "select rect")

    def select_brush(self, camera: Camera, stroke_xy: np.ndarray,
                     radius_px: float, mode: int = OP_SET) -> None:
        """Circle brush along a screen-space stroke polyline. The (C, S)
        distance block is taken in pieces of the stroke, at most
        ``BRUSH_BLOCK`` elements each; the minimum is exact, so the hits
        are those of the whole block."""
        s = project_centers(self.params, camera)
        pts = _f32(stroke_xy).reshape(-1, 2).to(s.device)   # (S, 2)
        step = max(1, BRUSH_BLOCK // max(s.shape[0], 1))
        dmin = None
        for i in range(0, pts.shape[0], step):
            d = _norm(s[:, None, :2] - pts[None, i:i + step, :]).amin(1)
            dmin = d if dmin is None else torch.minimum(dmin, d)
        hit = (dmin <= radius_px) & (s[:, 2] > 0) & self.params.alive
        self._select(hit, mode, "select brush")

    def select_polygon(self, camera: Camera, poly_xy: np.ndarray,
                       mode: int = OP_SET) -> None:
        """Point in polygon (lasso and polygon tools) on the projected
        centres, by crossings."""
        s = project_centers(self.params, camera)
        poly = _f32(poly_xy).reshape(-1, 2).to(s.device)    # (P, 2)
        x, y = s[:, 0], s[:, 1]
        x0, y0 = poly[:, 0], poly[:, 1]
        x1 = torch.roll(x0, -1)
        y1 = torch.roll(y0, -1)
        cond = (y0[None] > y[:, None]) != (y1[None] > y[:, None])
        dy = y1 - y0
        xin = (x1 - x0)[None] * (y[:, None] - y0[None]) \
            / torch.where(dy == 0, 1e-9, dy)[None] + x0[None]
        crossings = torch.sum(cond & (x[:, None] < xin), dim=1)
        hit = (crossings % 2 == 1) & (s[:, 2] > 0) & self.params.alive
        self._select(hit, mode, "select polygon")

    def pick(self, camera: Camera, x: float, y: float,
             max_px: float = 12.0) -> int:
        """Picker: the nearest projected centre within ``max_px``; -1 if
        none."""
        s = project_centers(self.params, camera)
        d = _norm(s[:, :2] - _f32([x, y]).to(s.device))
        d = torch.where((s[:, 2] > 0) & self.params.alive, d, torch.inf)
        i = int(torch.argmin(d))
        return i if float(d[i]) <= max_px else -1

    # -- state ops --
    def hide_selected(self) -> None:
        self._set_state(torch.where(self.selected, self.state | STATE_HIDE,
                                    self.state), "hide")

    def unhide_all(self) -> None:
        self._set_state(self.state & ~STATE_HIDE, "unhide all")

    def delete_selected(self) -> None:
        self._set_state(torch.where(self.selected,
                                    self.state | STATE_DELETE, self.state),
                        "delete")

    def reset_states(self) -> None:
        self._set_state(torch.zeros_like(self.state), "reset states")

    def paint_selected(self, color) -> None:
        """A flat colour for the selected splats: DC SH set, the rest
        zeroed, the PAINT bit marked."""
        sel = self.selected
        old_sh0, old_shN, old_state = (self.params.sh0, self.params.shN,
                                       self.state)

        def restore(s, a=old_sh0, b=old_shN, c=old_state):
            s._replace(sh0=a, shN=b)
            s.state = c
        self._push_undo("paint", restore)
        sh0_new = (_f32(color).to(sel.device) - 0.5) / 0.28209479177387814
        zero = torch.zeros((), dtype=self.params.shN.dtype,
                           device=sel.device)
        self._replace(
            sh0=torch.where(sel[:, None], sh0_new[None, :], self.params.sh0),
            shN=torch.where(sel[:, None, None], zero, self.params.shN))
        self.state = torch.where(sel, self.state | STATE_PAINT, self.state)

    # -- transforms --
    def transform_selected(self, matrix: np.ndarray) -> None:
        """A rigid (+ uniform scale) 4x4 transform of the selected splats,
        the rotation baked into the quaternions and the SH."""
        m = np.asarray(matrix, np.float64)
        A = m[:3, :3]
        Rm = polar_rotation(A)
        scale_factor = float(np.cbrt(max(np.linalg.det(A), 1e-12)))

        sel = self.selected
        p = self.params
        old = (p.means, p.quats, p.scales, p.shN)

        def restore(s, o=old):
            s._replace(means=o[0], quats=o[1], scales=o[2], shN=o[3])
        self._push_undo("transform", restore)

        rq = torch.as_tensor(rotmat_to_quat_np(Rm), device=p.device)
        log_s = float(np.float32(np.log(max(scale_factor, 1e-12))))
        self._replace(
            means=torch.where(sel[:, None], affine_means(m, p.means),
                              p.means),
            quats=torch.where(sel[:, None], quat_multiply(rq[None], p.quats),
                              p.quats),
            scales=torch.where(sel[:, None], p.scales + log_s, p.scales),
            shN=torch.where(sel[:, None, None], rotate_sh(p.shN, Rm), p.shN))

    # -- crop volumes --
    def apply_crop(self, volumes: list[dict]) -> None:
        """``volumes``: [{type: 'box' | 'sphere', 'lo' / 'hi' or 'center'
        / 'radius', 'op': 'keep' | 'remove'}], at most 8; splats outside
        the kept volumes or inside a removed one get HIDE."""
        p = self.params.means
        dev = p.device
        keep_any = None
        remove = torch.zeros((self.params.capacity,), dtype=torch.bool,
                             device=dev)
        for v in volumes[:8]:
            if v["type"] == "box":
                hit = torch.all((p >= _f32(v["lo"]).to(dev))
                                & (p <= _f32(v["hi"]).to(dev)), -1)
            else:
                hit = _norm(p - _f32(v["center"]).to(dev)) <= v["radius"]
            if v.get("op", "keep") == "keep":
                keep_any = hit if keep_any is None else (keep_any | hit)
            else:
                remove = remove | hit
        out = remove
        if keep_any is not None:
            out = out | ~keep_any
        self._set_state(torch.where(out & self.params.alive,
                                    self.state | STATE_HIDE, self.state),
                        "crop")

    # -- structure ops --
    def _push_full_undo(self, desc: str) -> None:
        def restore(s, a=self.params, b=self.state):
            s.params = a
            s.state = b
        self._push_undo(desc, restore)

    def compact(self) -> None:
        """Remove the deleted splats (their slots die)."""
        self._push_full_undo("compact")
        dead = self.deleted
        self._replace(alive=self.params.alive & ~dead)
        self.state = torch.where(dead, 0, self.state).to(torch.int32)

    def merge(self, other: GaussianParams) -> None:
        """Append another model's alive splats into free slots, growing
        the capacity when they do not suffice."""
        self._push_full_undo("merge")
        d = other.compact_numpy()
        n_new = d["means"].shape[0]
        free = np.nonzero(~self.params.alive.cpu().numpy())[0]
        if len(free) < n_new:
            grow = n_new - len(free)
            p = self.params

            def pad(x, fill=0.0):
                tail = torch.full((grow, *x.shape[1:]), fill, dtype=x.dtype,
                                  device=x.device)
                return torch.cat([x, tail])

            quats = pad(p.quats)
            quats[p.capacity:, 0] = 1.0
            self._replace(
                means=pad(p.means),
                scales=pad(p.scales, float(np.float32(np.log(0.01)))),
                quats=quats, opacity=pad(p.opacity, -15.0), sh0=pad(p.sh0),
                shN=pad(p.shN), alive=pad(p.alive, False))
            self.state = pad(self.state, 0)
            free = np.nonzero(~self.params.alive.cpu().numpy())[0]
        k = min(n_new, len(free))
        p = self.params
        idx = torch.as_tensor(free[:k], device=p.device)
        upd = {}
        for f in ("means", "scales", "quats", "opacity", "sh0"):
            t = getattr(p, f).clone()
            t[idx] = torch.as_tensor(d[f][:k], dtype=t.dtype,
                                     device=p.device)
            upd[f] = t
        shN_new = d["shN"][:k]
        kcoef = min(shN_new.shape[1], p.shN.shape[1])
        shN = p.shN.clone()
        shN[idx, :kcoef] = torch.as_tensor(shN_new[:, :kcoef],
                                           dtype=shN.dtype, device=p.device)
        alive = p.alive.clone()
        alive[idx] = True
        self._replace(**upd, shN=shN, alive=alive)

    # -- undo / redo --
    def undo(self) -> bool:
        if not self.history:
            return False
        rec = self.history.pop()
        cur_params, cur_state = self.params, self.state
        rec.restore(self)

        def redo_restore(s, a=cur_params, b=cur_state):
            s.params = a
            s.state = b
        self.redo_stack.append(_UndoRecord(rec.description, redo_restore))
        return True

    def redo(self) -> bool:
        if not self.redo_stack:
            return False
        rec = self.redo_stack.pop()
        cur_params, cur_state = self.params, self.state
        rec.restore(self)

        def undo_restore(s, a=cur_params, b=cur_state):
            s.params = a
            s.state = b
        self.history.append(_UndoRecord(rec.description, undo_restore))
        return True


# -- deferred transforms and paint (the palettes) ---------------------------


def _session_palette(session: EditSession) -> SplatTransformPalette:
    if session.palette is None:
        session.palette = SplatTransformPalette(session.params.capacity,
                                                device=session.params.device)
    return session.palette


def _session_paint_palette(session: EditSession) -> SplatPaintColorPalette:
    if session.paint_palette is None:
        session.paint_palette = SplatPaintColorPalette(
            session.params.capacity, device=session.params.device)
    return session.paint_palette


def palette_transform_selected(session: EditSession,
                               matrix: np.ndarray) -> int:
    """Give the selected splats a deferred palette transform (they render
    through it; the model stays unbaked). -> the palette slot."""
    pal = _session_palette(session)
    slot = pal.add(matrix)
    pal.assign(session.selected, slot)
    return slot


def palette_paint_selected(session: EditSession, color) -> int:
    """Deferred painting through the colour palette: the selected splats
    render with the colour; the model's SH stays unbaked. -> the slot."""
    pal = _session_paint_palette(session)
    slot = pal.add(color)

    def restore(s, o=pal.indices):
        _session_paint_palette(s).indices = o
    session._push_undo("palette paint", restore)
    pal.assign(session.selected, slot)
    return slot


def bake_paint_palette(session: EditSession) -> None:
    """Flatten the paint palette into ``sh0`` / ``shN`` (undoable)."""
    pal = session.paint_palette
    if pal is None or pal.num_entries == 1:
        return
    old = session.params

    def restore(s, o=old, oi=pal.indices):
        s.params = o
        _session_paint_palette(s).indices = oi
    session._push_undo("bake paint", restore)
    session.params = pal.bake(old)


def effective_params(session: EditSession) -> GaussianParams:
    """Render-time view of the session's params: the palette transforms
    and the paint palette applied on the fly."""
    p = session.params
    pal = session.palette
    if pal is not None and pal.num_entries > 1:
        p = pal.apply(p)
    ppal = session.paint_palette
    if ppal is not None and ppal.num_entries > 1:
        p = ppal.apply(p)
    return p


def bake_palette(session: EditSession) -> None:
    """Flatten the transform palette into the model (undoable)."""
    pal = session.palette
    if pal is None or pal.num_entries == 1:
        return
    old = session.params

    def restore(s, o=old, op=(list(pal.matrices), pal.indices)):
        s.params = o
        p = _session_palette(s)
        p.matrices, p.indices = list(op[0]), op[1]
    session._push_undo("bake palette", restore)
    session.params = pal.bake(old)
