"""Dense rasterizer: exact front-to-back alpha compositing of every
gaussian against every pixel, over depth-sorted chunks (counterpart of
``divshot_tpu/raster/dense.py``). The editor's debug views (rings,
ellipsoids, centres, points) composite through it; it is plain PyTorch,
as the JAX function is XLA-only code, and O(N * pixels) by design.

The (chunk, pixels) intermediates are taken over blocks of at most
``PIXEL_BLOCK`` pixels, so a 1920x1080 frame fits the card's memory:
each pixel's arithmetic is the same in every block. It is differentiable
by autograd, as the JAX function is by autodiff (``render(backend=
"dense")``): where autograd records, every operation is out of place and
each chunk is checkpointed (``torch.utils.checkpoint``: its (chunk,
pixels) intermediates are made again in the backward, so that 20K splats
at 400x400 fit the card); where nothing requires a gradient (the editor's
debug views), the same arithmetic runs in place, in the same order.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from divshot_tpu_torch.raster.project import Projection

ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.999
PIXEL_BLOCK = 1 << 19      # 512 MB per (256, pixels) float32 intermediate


def _power(con: torch.Tensor, dx: torch.Tensor, dy: torch.Tensor,
           inplace: bool) -> torch.Tensor:
    """-0.5 (a dx dx + c dy dy) - b dx dy of each (splat, pixel) pair, in
    JAX's order."""
    if not inplace:
        return (-0.5 * ((con[:, 0:1] * dx) * dx + (con[:, 2:3] * dy) * dy)
                - (con[:, 1:2] * dx) * dy)
    power = (con[:, 0:1] * dx).mul_(dx)
    power.add_((con[:, 2:3] * dy).mul_(dy)).mul_(-0.5)
    return power.sub_((con[:, 1:2] * dx).mul_(dy))


def _alpha(power: torch.Tensor, op: torch.Tensor, falloff: str,
           inplace: bool) -> torch.Tensor:
    """The fragment response of each (splat, pixel) pair."""
    live = op[:, None] > 0
    if falloff == "ring":
        r = torch.sqrt(torch.clamp_min(-2.0 * power, 0.0))  # Mahalanobis
        r = r.sub_(2.0).abs_() if inplace else torch.abs(r - 2.0)
        return torch.where((r < 0.15) & live, ALPHA_MAX, 0.0)
    if falloff == "solid":
        return torch.where((power >= -2.0) & live, ALPHA_MAX, 0.0)
    if not inplace:
        alpha = torch.clamp_max(op[:, None] * torch.exp(power), ALPHA_MAX)
        return torch.where((power <= 0) & (alpha >= ALPHA_MIN), alpha, 0.0)
    alpha = torch.exp(power).mul_(op[:, None]).clamp_max_(ALPHA_MAX)
    return alpha.masked_fill_((power > 0) | ~(alpha >= ALPHA_MIN), 0.0)


def _step(acc, T, m2d, con, col, op, bx, by, falloff: str, inplace: bool):
    """One depth-sorted chunk of splats over a block of pixels -> the
    accumulated colour (P, 3) and transmittance (P,) after it."""
    dx = bx[None, :] - m2d[:, 0:1]                          # (chunk, P)
    dy = by[None, :] - m2d[:, 1:2]
    alpha = _alpha(_power(con, dx, dy, inplace), op, falloff, inplace)
    # the transmittance before each splat down the depth order
    cp = torch.cumprod(1.0 - alpha, 0)
    if inplace:
        alpha[1:] *= cp[:-1]
        w = alpha.mul_(T[None, :])
    else:
        w = alpha * torch.cat([torch.ones_like(cp[:1]), cp[:-1]]) \
            * T[None, :]
    return acc + torch.einsum("cp,cd->pd", w, col), T * cp[-1]


def composite_dense(
    proj: Projection,
    colors: torch.Tensor,      # (N, 3) per-splat RGB
    opacities: torch.Tensor,   # (N,) post-sigmoid
    width: int,
    height: int,
    *,
    chunk: int = 256,
    background: torch.Tensor | None = None,
    falloff: str = "gaussian",
) -> tuple[torch.Tensor, torch.Tensor]:
    """-> (image (H, W, 3), alpha (H, W)) on the projection's device.

    ``falloff``: "gaussian" (default), "ring" (the 2-sigma contour, the
    Rings render type) or "solid" (opaque inside 2 sigma, Ellipsoids)."""
    dev = proj.means2d.device
    n = proj.means2d.shape[0]
    n_pad = (n + chunk - 1) // chunk * chunk

    visible = proj.radii > 0
    op_eff = torch.where(visible, opacities * proj.comp, 0.0)
    # front to back, stable as jnp.argsort; culled splats last
    order = torch.argsort(torch.where(visible, proj.depths, torch.inf),
                          stable=True)

    def pad_gather(x):
        x = x[order]
        return torch.cat([x, x.new_zeros((n_pad - n, *x.shape[1:]))])

    means2d = pad_gather(proj.means2d).reshape(-1, chunk, 2)
    conics = pad_gather(proj.conics).reshape(-1, chunk, 3)
    cols = pad_gather(colors).reshape(-1, chunk, 3)
    ops = pad_gather(op_eff).reshape(-1, chunk)

    px = torch.arange(width, dtype=torch.float32, device=dev) + 0.5
    py = torch.arange(height, dtype=torch.float32, device=dev) + 0.5
    gy, gx = torch.meshgrid(py, px, indexing="ij")
    gx, gy = gx.reshape(-1), gy.reshape(-1)                    # (P,)
    inplace = not (torch.is_grad_enabled() and any(
        x.requires_grad for x in (means2d, conics, cols, ops)))
    accs, trans = [], []
    for lo in range(0, gx.shape[0], PIXEL_BLOCK):
        bx, by = gx[lo:lo + PIXEL_BLOCK], gy[lo:lo + PIXEL_BLOCK]
        acc_b = torch.zeros((bx.shape[0], 3), device=dev)
        T_b = torch.ones((bx.shape[0],), device=dev)
        for m2d, con, col, op in zip(means2d, conics, cols, ops):
            if inplace:
                acc_b, T_b = _step(acc_b, T_b, m2d, con, col, op, bx, by,
                                   falloff, True)
            else:
                acc_b, T_b = checkpoint(_step, acc_b, T_b, m2d, con, col,
                                        op, bx, by, falloff, False,
                                        use_reentrant=False)
        accs.append(acc_b)
        trans.append(T_b)
    accum, T = torch.cat(accs), torch.cat(trans)

    img = accum.reshape(height, width, 3)
    alpha_img = (1.0 - T).reshape(height, width)
    if background is not None:
        img = img + T.reshape(height, width, 1) * background
    return img, alpha_img
