"""Dense rasterizer: exact front-to-back alpha compositing of every
gaussian against every pixel, over depth-sorted chunks (counterpart of
``divshot_tpu/raster/dense.py``). The editor's debug views (rings,
ellipsoids, centres, points) composite through it; it is plain PyTorch,
as the JAX function is XLA-only code, and O(N * pixels) by design.

The (chunk, pixels) intermediates are taken over blocks of at most
``PIXEL_BLOCK`` pixels, so a 1920x1080 frame fits the card's memory:
each pixel's arithmetic is the same in every block.
"""

from __future__ import annotations

import torch

from divshot_tpu_torch.raster.project import Projection

ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.999
PIXEL_BLOCK = 1 << 19      # 512 MB per (256, pixels) float32 intermediate


def _alpha(power: torch.Tensor, op: torch.Tensor, falloff: str
           ) -> torch.Tensor:
    """The fragment response of each (splat, pixel) pair."""
    live = op[:, None] > 0
    if falloff == "ring":
        r = torch.sqrt(torch.clamp_min(-2.0 * power, 0.0))  # Mahalanobis
        r.sub_(2.0).abs_()
        return torch.where((r < 0.15) & live, ALPHA_MAX, 0.0)
    if falloff == "solid":
        return torch.where((power >= -2.0) & live, ALPHA_MAX, 0.0)
    alpha = torch.exp(power).mul_(op[:, None]).clamp_max_(ALPHA_MAX)
    return alpha.masked_fill_((power > 0) | ~(alpha >= ALPHA_MIN), 0.0)


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
    accum = torch.zeros((gx.shape[0], 3), device=dev)
    T = torch.ones((gx.shape[0],), device=dev)
    for lo in range(0, gx.shape[0], PIXEL_BLOCK):
        bx, by = gx[lo:lo + PIXEL_BLOCK], gy[lo:lo + PIXEL_BLOCK]
        acc_b, T_b = accum[lo:lo + PIXEL_BLOCK], T[lo:lo + PIXEL_BLOCK]
        for m2d, con, col, op in zip(means2d, conics, cols, ops):
            dx = bx[None, :] - m2d[:, 0:1]                  # (chunk, P)
            dy = by[None, :] - m2d[:, 1:2]
            # -0.5 (a dx dx + c dy dy) - b dx dy, in JAX's order
            power = (con[:, 0:1] * dx).mul_(dx)
            power.add_((con[:, 2:3] * dy).mul_(dy)).mul_(-0.5)
            power.sub_((con[:, 1:2] * dx).mul_(dy))
            alpha = _alpha(power, op, falloff)
            # the transmittance before each splat down the depth order
            cp = torch.cumprod(1.0 - alpha, 0)
            alpha[1:] *= cp[:-1]
            alpha *= T_b[None, :]
            acc_b = acc_b + torch.einsum("cp,cd->pd", alpha, col)
            T_b = T_b * cp[-1]
        accum[lo:lo + PIXEL_BLOCK], T[lo:lo + PIXEL_BLOCK] = acc_b, T_b

    img = accum.reshape(height, width, 3)
    alpha_img = (1.0 - T).reshape(height, width)
    if background is not None:
        img = img + T.reshape(height, width, 1) * background
    return img, alpha_img
