"""MIG from the KSG kNN mutual-information estimator, float64 numpy
(counterpart of the numpy path of ``clearvae_tpu/ops/metrics.py``, which
follows sklearn's ``mutual_info_classif``; reference code/src/losses.py:10-16).

Per-column std scaling (no centering) plus 1e-10-scale tie-breaking noise,
then per column: radius = distance to the k-th same-class neighbour
(k = min(n_neighbors, class_count-1)) shrunk by one ulp; m_i = number of
points (any class, self included) within that radius; samples of singleton
classes dropped; MI = ψ(N) + mean ψ(k) − mean ψ(class_count) − mean ψ(m).
The GPU and native backends of the JAX package are not ported yet.
"""

from __future__ import annotations

import numpy as np
from scipy.special import digamma as np_digamma


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


def mutual_info_classif_np(x: np.ndarray, y: np.ndarray, *,
                           n_neighbors: int = 3, seed: int = 0) -> np.ndarray:
    """Per-feature MI(x_col; y) with sklearn _estimate_mi preprocessing."""
    x = np.asarray(x, dtype=np.float64)
    if x.ndim == 1:
        x = x[:, None]
    y = np.asarray(y).ravel()
    std = x.std(axis=0)
    x = x / np.where(std > 0, std, 1.0)
    rng = np.random.RandomState(seed)
    means = np.maximum(1, np.mean(np.abs(x), axis=0))
    x = x + 1e-10 * means * rng.standard_normal(size=x.shape)
    return np.array([_mi_cd_numpy(x[:, j], y, n_neighbors)
                     for j in range(x.shape[1])])


def mutual_info_gap(label, latent_c, latent_s, *,
                    backend: str = "numpy") -> float:
    """(mean MI(z_c, y) − mean MI(z_s, y)) / H(y)."""
    if backend != "numpy":
        raise ValueError(f"only the numpy MIG backend is ported; got {backend!r}")
    label = np.asarray(label).ravel().astype(np.int64)
    p = np.bincount(label) / len(label)
    p = p[p > 0]
    h = float(-(p * np.log(p)).sum())
    mi_c = mutual_info_classif_np(np.asarray(latent_c), label)
    mi_s = mutual_info_classif_np(np.asarray(latent_s), label)
    return float((mi_c.mean() - mi_s.mean()) / h)
