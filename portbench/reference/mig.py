"""The reference's gMIG: (mean MI(z_c; y) − mean MI(z_s; y)) / H(y), each MI
the KSG k-nearest-neighbour estimate of one continuous latent against the
discrete label (Kraskov et al. 2004; Ross 2014, as scikit-learn's
``mutual_info_classif`` computes it, k = 3). Plain torch in float64 (the
control's float32 on request), written from that definition:

- each column is scaled by its standard deviation (no centring), then
  dithered by 1e-10 · max(1, mean |x|) · N(0, 1) draws of
  ``numpy.random.RandomState(0)`` over the whole [N, F] matrix;
- per point: the distance to its k-th nearest neighbour of the same label
  (k = min(3, count − 1)), shrunk by one ulp, is its radius; m is the number
  of points of any label, itself included, within that radius; points of
  a label seen once are left out;
- MI = ψ(N) + mean ψ(k) − mean ψ(label count) − mean ψ(m), at least 0.
"""

from __future__ import annotations

import numpy as np
import torch

N_NEIGHBORS = 3


def _scaled(x: torch.Tensor, dtype) -> torch.Tensor:
    x = x.to(dtype)
    std = x.std(0, unbiased=False)
    x = x / torch.where(std > 0, std, torch.ones_like(std))
    noise = np.random.RandomState(0).standard_normal(size=tuple(x.shape))
    means = x.abs().mean(0).clamp_min(1.0)
    return x + 1e-10 * means * torch.as_tensor(noise, dtype=dtype,
                                               device=x.device)


def _mi(c: torch.Tensor, y: torch.Tensor) -> float:
    n = c.shape[0]
    radius = torch.zeros(n, dtype=c.dtype, device=c.device)
    k_all = torch.zeros_like(radius)
    counts = torch.zeros_like(radius)
    for label in torch.unique(y):
        idx = (y == label).nonzero().flatten()
        cnt = idx.numel()
        counts[idx] = cnt
        if cnt < 2:
            continue
        k = min(N_NEIGHBORS, cnt - 1)
        cc = c[idx]
        d = (cc[:, None] - cc[None, :]).abs()
        d.fill_diagonal_(float("inf"))
        kth = torch.kthvalue(d, k, dim=1).values
        radius[idx] = torch.nextafter(kth, torch.zeros_like(kth))
        k_all[idx] = k
    keep = counts > 1
    if not bool(keep.any()):
        return 0.0
    c, radius, k_all, counts = c[keep], radius[keep], k_all[keep], counts[keep]
    m = torch.empty_like(c)
    for s in range(0, c.shape[0], 1024):
        d = (c[s:s + 1024, None] - c[None, :]).abs()
        m[s:s + 1024] = (d <= radius[s:s + 1024, None]).sum(1).to(m.dtype)
    dg = torch.special.digamma
    k_all, counts, m = (t.to(torch.float64) for t in (k_all, counts, m))
    n_eff = torch.tensor(float(c.shape[0]), dtype=torch.float64)
    mi = (dg(n_eff) + dg(k_all).mean().cpu() - dg(counts).mean().cpu()
          - dg(m).mean().cpu())
    return max(0.0, float(mi))


def mutual_info_gap(label: torch.Tensor, z_c: torch.Tensor,
                    z_s: torch.Tensor, dtype=torch.float64) -> float:
    """gMIG of the latents against the labels, the distances in ``dtype``
    (float64, as scikit-learn computes them; float32 is the control's)."""
    y = label.to(torch.int64)
    p = torch.bincount(y).to(torch.float64)
    p = p[p > 0] / y.numel()
    h = float(-(p * p.log()).sum())
    mi_c = [_mi(col, y) for col in _scaled(z_c, dtype).T]
    mi_s = [_mi(col, y) for col in _scaled(z_s, dtype).T]
    return (float(np.mean(mi_c)) - float(np.mean(mi_s))) / h
