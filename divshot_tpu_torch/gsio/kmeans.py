"""K-means for the reduced PLY's codebooks (counterpart of
``divshot_tpu/gsio/kmeans.py``): 1-D scalar codebooks, a quantile
initialisation over a sorted copy, then Lloyd iterations: each value to
its nearest centre by a chunked ``argmin`` of ``|v - c|`` (the first
centre at a tie), each centre the mean of its values by ``index_add_``, a
centre with no values kept. Torch code on the values' device: on a card
the jobs of ``make_codebooks`` run there. On the CPU the sums run in the
values' order, as XLA's scatter-add does, so the codebooks equal JAX's
bitwise; a card's ``index_add_`` adds in the order its atomics land.
"""

from __future__ import annotations

import numpy as np
import torch


def kmeans_init(values: torch.Tensor, k: int) -> torch.Tensor:
    """The k quantile centres of a sorted copy of ``values``."""
    m = values.shape[0]
    sv = torch.sort(values).values
    q = (torch.arange(k, dtype=torch.float32, device=values.device)
         + 0.5) / k
    return sv[torch.clamp((q * m).to(torch.int32), 0, m - 1).long()]


def kmeans_assign(values: torch.Tensor, centers: torch.Tensor,
                  chunk: int = 1 << 16) -> torch.Tensor:
    """Each value's nearest centre (the first at a tie), chunked."""
    return torch.cat([
        torch.argmin(torch.abs(values[s:s + chunk, None] - centers[None, :]),
                     dim=1) for s in range(0, values.shape[0], chunk)])


def kmeans_update(values: torch.Tensor, ids: torch.Tensor,
                  centers: torch.Tensor) -> torch.Tensor:
    """Each centre the mean of its values; a centre with none kept."""
    k = centers.shape[0]
    ssum = torch.zeros((k,), dtype=torch.float32, device=values.device)
    cnt = torch.zeros((k,), dtype=torch.float32, device=values.device)
    ssum.index_add_(0, ids, values)
    cnt.index_add_(0, ids, torch.ones_like(values))
    return torch.where(cnt > 0, ssum / torch.clamp_min(cnt, 1.0), centers)


def kmeans_1d(values: torch.Tensor, *, k: int = 256, iters: int = 10,
              chunk: int = 1 << 16) -> tuple[torch.Tensor, torch.Tensor]:
    """values (M,) float32 -> (centres (k,) float32, ids (M,) int64)."""
    values = values.float()
    centers = kmeans_init(values, k)
    for _ in range(iters):
        centers = kmeans_update(values, kmeans_assign(values, centers,
                                                      chunk), centers)
    return centers, kmeans_assign(values, centers, chunk)


def codebook_jobs(d: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
    """The values of each codebook, by the reference's keys:
    feature_dc, feature_rest_0..14, opacity, scaling, rotation_re,
    rotation_im (a band the model lacks is one zero)."""
    quats = d["quats"] / np.linalg.norm(d["quats"], axis=1,
                                        keepdims=True).clip(1e-12)
    jobs = {
        "feature_dc": d["sh0"].reshape(-1),
        "opacity": d["opacity"].reshape(-1),
        "scaling": d["scales"].reshape(-1),
        "rotation_re": quats[:, 0].copy(),
        "rotation_im": quats[:, 1:].reshape(-1),
    }
    n_sh = d["shN"].shape[1]
    for i in range(15):
        jobs[f"feature_rest_{i}"] = (d["shN"][:, i, :].reshape(-1)
                                     if i < n_sh else
                                     np.zeros((1,), np.float32))
    return jobs


def make_codebooks(d: dict[str, np.ndarray], *, k: int = 256,
                   iters: int = 10, device="cpu"
                   ) -> dict[str, tuple[np.ndarray, np.ndarray]]:
    """The codebooks of ``codebook_jobs(d)``, each computed on ``device``
    -> {key: (centres float32, ids uint8)} on the host."""
    out = {}
    for name, vals in codebook_jobs(d).items():
        c, ids = kmeans_1d(torch.as_tensor(np.asarray(vals, np.float32),
                                           device=device), k=k, iters=iters)
        out[name] = (c.cpu().numpy(), ids.to(torch.uint8).cpu().numpy())
    return out
