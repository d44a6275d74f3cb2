"""MIG from the KSG kNN mutual-information estimator, and the probe's
classification metrics (counterpart of ``clearvae_tpu/ops/metrics.py``,
whose KSG follows sklearn's ``mutual_info_classif``; reference
code/src/losses.py:10-33).

Per-column std scaling (no centering) plus 1e-10-scale tie-breaking noise,
then per column: radius = distance to the k-th same-class neighbour
(k = min(n_neighbors, class_count-1)) shrunk by one ulp; m_i = number of
points (any class, self included) within that radius; samples of singleton
classes dropped; MI = ψ(N) + mean ψ(k) − mean ψ(class_count) − mean ψ(m).

Three backends: float64 numpy (``"numpy"``); float64 C++ on the host
(``"native"``, ``csrc/host_ops.cpp`` through ``native/bindings.py``, the
counterpart of the JAX package's native backend, the same preprocessing and
dither as numpy); and float32 torch on the device (``"torch"``, the
counterpart of the JAX package's jnp backend: one [N, N] distance matrix per
feature). ``"auto"`` is native where its library builds, else numpy, as in
the JAX package's trainers.
"""

from __future__ import annotations

import numpy as np
import torch
from scipy.special import digamma as np_digamma

from clearvae_torch import resolve_device
from clearvae_torch.native import bindings
from clearvae_torch.utils.logging import counter


def _mi_cd_numpy(c: np.ndarray, d: np.ndarray, n_neighbors: int) -> float:
    """Single continuous feature vs discrete labels (sklearn _compute_mi_cd)."""
    n = c.shape[0]
    radius = np.zeros(n)
    label_counts = np.zeros(n)
    k_all = np.zeros(n)
    for label in np.unique(d):
        mask = d == label
        count = int(mask.sum())
        if count > 1:
            k = min(n_neighbors, count - 1)
            cc = c[mask]
            dist = np.abs(cc[:, None] - cc[None, :])
            np.fill_diagonal(dist, np.inf)
            kth = np.partition(dist, k - 1, axis=1)[:, k - 1]
            radius[mask] = np.nextafter(kth, 0)
            k_all[mask] = k
        label_counts[mask] = count

    mask = label_counts > 1
    n_eff = int(mask.sum())
    if n_eff == 0:
        return 0.0
    c_m, radius_m = c[mask], radius[mask]
    label_counts_m, k_all_m = label_counts[mask], k_all[mask]

    # m_i = #points (self included) within radius_i, over the masked set
    m_all = np.empty(n_eff)
    chunk = 2048
    for s in range(0, n_eff, chunk):
        e = min(s + chunk, n_eff)
        dist = np.abs(c_m[s:e, None] - c_m[None, :])
        m_all[s:e] = (dist <= radius_m[s:e, None]).sum(axis=1)

    mi = (np_digamma(n_eff) + np.mean(np_digamma(k_all_m))
          - np.mean(np_digamma(label_counts_m)) - np.mean(np_digamma(m_all)))
    return max(0.0, float(mi))


def _preprocess(x, seed: int) -> np.ndarray:
    """sklearn _estimate_mi's preprocessing in float64: per-column std
    scaling (no centering), then 1e-10-scale dither of numpy's ``seed``."""
    x = np.asarray(x, dtype=np.float64)
    if x.ndim == 1:
        x = x[:, None]
    std = x.std(axis=0)
    x = x / np.where(std > 0, std, 1.0)
    rng = np.random.RandomState(seed)
    means = np.maximum(1, np.mean(np.abs(x), axis=0))
    return x + 1e-10 * means * rng.standard_normal(size=x.shape)


def mutual_info_classif_np(x: np.ndarray, y: np.ndarray, *,
                           n_neighbors: int = 3, seed: int = 0) -> np.ndarray:
    """Per-feature MI(x_col; y) with sklearn _estimate_mi preprocessing."""
    x = _preprocess(x, seed)
    y = np.asarray(y).ravel()
    return np.array([_mi_cd_numpy(x[:, j], y, n_neighbors)
                     for j in range(x.shape[1])])


def mutual_info_classif_native(x: np.ndarray, y: np.ndarray, *,
                               n_neighbors: int = 3,
                               seed: int = 0) -> np.ndarray:
    """Per-feature MI(x_col; y): the numpy backend's preprocessing, then the
    C++ KSG loop. Raises where the host library does not build."""
    return bindings.ksg_mi_cd_native(_preprocess(x, seed), np.asarray(y),
                                     n_neighbors)


BACKENDS = ("native", "numpy", "torch")


def resolve_backend(backend: str) -> str:
    """The MIG backend that ``backend`` names: ``"auto"`` is ``"native"``
    where the host library builds, else ``"numpy"``
    (``clearvae_tpu/train/trainers.py:285-288``)."""
    if backend == "auto":
        return "native" if bindings.available() else "numpy"
    if backend not in BACKENDS:
        raise ValueError(f"unknown MIG backend {backend!r}; the port has "
                         f"{', '.join(('auto',) + BACKENDS)}")
    return backend


def _mi_cd_torch(x: torch.Tensor, y: torch.Tensor, n_neighbors: int,
                 n_classes: int) -> torch.Tensor:
    """All features of a preprocessed [N, F] float32 x against labels y,
    one feature at a time (the jnp backend's ``_mi_cd_jnp``)."""
    n = x.shape[0]
    label_counts = torch.bincount(y, minlength=n_classes)[y].to(x.dtype)
    k_all = torch.clamp(label_counts - 1, max=n_neighbors)
    valid = label_counts > 1
    same = (y[:, None] == y[None, :]) & ~torch.eye(n, dtype=torch.bool,
                                                    device=x.device)
    pick = torch.clamp(k_all - 1, min=0).long()[:, None]
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    m_all = []
    for col in x.T:
        dist = (col[:, None] - col[None, :]).abs()
        dist_same = torch.where(same, dist, torch.full_like(dist, float("inf")))
        k = min(n_neighbors, n)
        kth = torch.topk(dist_same, k, dim=1, largest=False).values.gather(
            1, torch.clamp(pick, max=k - 1))[:, 0]
        radius = torch.where(torch.isfinite(kth), torch.nextafter(kth, zero),
                             zero)
        within = (dist <= radius[:, None]) & valid[None, :]
        m_all.append(within.sum(1).to(x.dtype))
    m_all = torch.stack(m_all, 1)                      # [N, F]
    vmask = valid.to(x.dtype)
    n_eff = torch.clamp(vmask.sum(), min=1)
    dg = torch.special.digamma
    mean_dg_k = (dg(torch.clamp(k_all, min=1)) * vmask).sum() / n_eff
    mean_dg_cnt = (dg(torch.clamp(label_counts, min=1)) * vmask).sum() / n_eff
    mean_dg_m = (dg(torch.clamp(m_all, min=1)) * vmask[:, None]).sum(0) / n_eff
    return torch.clamp(dg(n_eff) + mean_dg_k - mean_dg_cnt - mean_dg_m, min=0)


def mutual_info_classif_torch(x, y, *, n_neighbors: int = 3,
                              n_classes: int | None = None, seed: int = 0,
                              device=None) -> np.ndarray:
    """Per-feature MI(x_col; y) in float32 on ``device`` (default: x's
    device if x is a tensor, else ``cuda``), with the same preprocessing as
    the numpy backend; the tie-breaking noise is numpy's of ``seed``."""
    if device is None and isinstance(x, torch.Tensor):
        device = x.device
    device = resolve_device(device)
    x = torch.as_tensor(x, device=device).to(torch.float32)
    if x.dim() == 1:
        x = x[:, None]
    y = torch.as_tensor(y, device=device).to(torch.int64).flatten()
    std = x.std(0, unbiased=False)
    x = x / torch.where(std > 0, std, torch.ones_like(std))
    means = torch.clamp(x.abs().mean(0), min=1.0)
    noise = np.random.RandomState(seed).standard_normal(size=tuple(x.shape))
    x = x + 1e-10 * means * torch.as_tensor(noise, dtype=torch.float32,
                                            device=device)
    nc = n_classes or int(y.max()) + 1
    return _mi_cd_torch(x, y, n_neighbors, nc).cpu().numpy()


SYNCS = counter("host.syncs")   # device tensors to the host, by site


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _fetch(a, site: str) -> np.ndarray:
    """``_host(a)``, counted under ``site`` in ``host.syncs`` where ``a``
    is a tensor."""
    if isinstance(a, torch.Tensor):
        SYNCS[site] += 1
    return _host(a)


def mutual_info_gap(label, latent_c, latent_s, *, backend: str = "numpy",
                    n_classes: int | None = None) -> float:
    """(mean MI(z_c, y) − mean MI(z_s, y)) / H(y). ``backend`` is one of
    ``auto | native | numpy | torch``; torch runs on the latents' device."""
    backend = resolve_backend(backend)
    label = _fetch(label, "gmig.label").ravel().astype(np.int64)
    p = np.bincount(label) / len(label)
    p = p[p > 0]
    h = float(-(p * np.log(p)).sum())
    if backend == "torch":
        nc = n_classes or int(label.max()) + 1
        mi_c = mutual_info_classif_torch(latent_c, label, n_classes=nc)
        mi_s = mutual_info_classif_torch(latent_s, label, n_classes=nc)
    else:
        mi = (mutual_info_classif_native if backend == "native"
              else mutual_info_classif_np)
        mi_c = mi(_fetch(latent_c, "gmig.z_c"), label)
        mi_s = mi(_fetch(latent_s, "gmig.z_s"), label)
    return float((mi_c.mean() - mi_s.mean()) / h)


# ---------------------------------------------------------------------------
# Classification metrics (reference: code/src/losses.py:19-33)
# ---------------------------------------------------------------------------


def accuracy(logits, y) -> float:
    yh = _host(logits).argmax(axis=1).ravel()
    return float((yh == _host(y).ravel()).mean())


def _binary_average_precision(y_true: np.ndarray, score: np.ndarray) -> float:
    """sklearn average_precision_score (step interpolation, tie-grouped)."""
    order = np.argsort(-score, kind="mergesort")
    y_true, score = y_true[order], score[order]
    distinct = np.where(np.diff(score))[0]
    idx = np.r_[distinct, y_true.size - 1]
    tp = np.cumsum(y_true)[idx]
    fp = (idx + 1) - tp
    precision = tp / (tp + fp)
    n_pos = tp[-1]
    if n_pos == 0:
        return 0.0
    recall = tp / n_pos
    return float(np.sum(np.diff(np.r_[0.0, recall]) * precision))


def _binary_roc_auc(y_true: np.ndarray, score: np.ndarray) -> float:
    """Mann–Whitney U with average ranks for ties (== sklearn trapezoid)."""
    n_pos = int(y_true.sum())
    n_neg = y_true.size - n_pos
    if n_pos == 0 or n_neg == 0:
        return float("nan")
    order = np.argsort(score, kind="mergesort")
    s_sorted = score[order]
    ranks = np.empty_like(s_sorted)
    r = np.arange(1, s_sorted.size + 1, dtype=np.float64)
    boundaries = np.r_[0, np.where(np.diff(s_sorted))[0] + 1, s_sorted.size]
    for a, b in zip(boundaries[:-1], boundaries[1:]):
        ranks[a:b] = r[a:b].mean()
    rank_of = np.empty_like(ranks)
    rank_of[order] = ranks
    u = rank_of[y_true == 1].sum() - n_pos * (n_pos + 1) / 2.0
    return float(u / (n_pos * n_neg))


def _softmax_np(logits: np.ndarray) -> np.ndarray:
    z = logits - logits.max(axis=1, keepdims=True)
    e = np.exp(z)
    return e / e.sum(axis=1, keepdims=True)


def auc(logits, y) -> tuple[dict, dict]:
    """Per-class one-vs-rest AUPR/AUROC dicts, rounded to 3 (losses.py:24-33)."""
    logits = _host(logits)
    y = _host(y).ravel().astype(np.int64)
    num_classes = int(y.max()) + 1
    ph = _softmax_np(logits)
    aupr, auroc = {}, {}
    for i in range(num_classes):
        yt = (y == i).astype(np.float64)
        aupr[i] = round(_binary_average_precision(yt, ph[:, i]), 3)
        auroc[i] = round(_binary_roc_auc(yt, ph[:, i]), 3)
    return aupr, auroc
