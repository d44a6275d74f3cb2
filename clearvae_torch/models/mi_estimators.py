"""Variational MI estimators (counterpart of
``clearvae_tpu/models/mi_estimators.py``; reference
code/src/models/mi_estimator.py, after the CLUB repo, arXiv:2006.12013).

Each estimator has the reference's two entry points: ``forward(x, y)``, the
MI estimate used as a penalty, and ``learning_loss(x, y)``, the negative
log-likelihood that trains it. The bounds are plain functions of the
critic's outputs, as in the JAX package.

``CLUBSample`` takes its shuffled negatives from ``perm`` (an index tensor)
or, without one, from ``torch.randperm`` on ``generator``; it is the one
estimator with ``uses_perm``.

``L1OutUB`` keeps the reference's broadcast (``reference_broadcast=True``,
the default): its [B, B, 1] diagonal mask broadcasts against the [B, B]
log-densities into a [B, B, B] tensor (mi_estimator.py:185-189), and the
net effect is mean(positive) − mean(all_probs) − log(B−1+e^−20) + log(B−1),
not the paper's leave-one-out bound, which ``reference_broadcast=False``
computes.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from clearvae_torch.models.layers import linear

Tensor = torch.Tensor


class _MuLogvarNet(nn.Module):
    """Two MLPs, p_mu and p_logvar (tanh-squashed), as in the reference."""

    def __init__(self, x_dim: int, y_dim: int, hidden_size: int):
        super().__init__()
        h = hidden_size // 2
        self.mu_l1, self.mu_l2 = linear(x_dim, h), linear(h, y_dim)
        self.lv_l1, self.lv_l2 = linear(x_dim, h), linear(h, y_dim)

    def forward(self, x):
        mu = self.mu_l2(F.relu(self.mu_l1(x)))
        logvar = torch.tanh(self.lv_l2(F.relu(self.lv_l1(x))))
        return mu, logvar


def _gaussian_loglikeli(mu, logvar, y):
    """(-(mu-y)²/exp(lv) - lv).sum(1).mean(0), the shared learning
    objective (reference mi_estimator.py:57-59)."""
    return (-((mu - y) ** 2) / torch.exp(logvar) - logvar).sum(1).mean()


def club_bound(mu, logvar, y):
    positive = -((mu - y) ** 2) / 2.0 / torch.exp(logvar)
    negative = (-((y[None, :, :] - mu[:, None, :]) ** 2).mean(1) / 2.0
                / torch.exp(logvar))
    return (positive.sum(-1) - negative.sum(-1)).mean()


def club_mean_bound(mu, y):
    positive = -((mu - y) ** 2) / 2.0
    negative = -((y[None, :, :] - mu[:, None, :]) ** 2).mean(1) / 2.0
    return (positive.sum(-1) - negative.sum(-1)).mean()


def club_sample_bound(mu, logvar, y, perm):
    positive = -((mu - y) ** 2) / torch.exp(logvar)
    negative = -((mu - y[perm]) ** 2) / torch.exp(logvar)
    return (positive.sum(-1) - negative.sum(-1)).mean() / 2.0


def l1out_bound(mu, logvar, y, reference_broadcast: bool = True):
    b = y.shape[0]
    positive = (-((mu - y) ** 2) / 2.0 / torch.exp(logvar) - logvar / 2.0).sum(-1)
    all_probs = (-((y[None, :, :] - mu[:, None, :]) ** 2) / 2.0
                 / torch.exp(logvar[:, None, :]) - logvar[:, None, :] / 2.0).sum(-1)
    if reference_broadcast:
        # both constants in float32, added in the JAX package's order
        c1 = float(np.log(np.float32(b - 1.0) + np.exp(np.float32(-20.0))))
        c2 = float(np.log(np.float32(b - 1.0)))
        return (positive[None, :] - (all_probs + c1 - c2)).mean()
    diag = torch.eye(b, dtype=mu.dtype, device=mu.device) * (-20.0)
    negative = torch.logsumexp(all_probs + diag, 0) - math.log(b - 1.0)
    return (positive - negative).mean()


def var_ub_bound(mu, logvar):
    return 0.5 * (mu ** 2 + torch.exp(logvar) - 1.0 - logvar).mean()


class _CriticEstimator(nn.Module):
    """An estimator whose critic is a ``_MuLogvarNet`` and whose learning
    loss is the Gaussian log-likelihood."""

    uses_perm = False

    def __init__(self, x_dim: int, y_dim: int, hidden_size: int):
        super().__init__()
        self.net = _MuLogvarNet(x_dim, y_dim, hidden_size)

    def learning_loss(self, x, y):
        mu, logvar = self.net(x)
        return -_gaussian_loglikeli(mu, logvar, y)


class CLUB(_CriticEstimator):
    """CLUB upper bound (reference mi_estimator.py:9-62)."""

    def forward(self, x, y):
        return club_bound(*self.net(x), y)


class CLUBSample(_CriticEstimator):
    """Sampled CLUB ('CLUB-S', the experiments'; reference
    mi_estimator.py:108-146)."""

    uses_perm = True

    def forward(self, x, y, perm: Tensor | None = None,
                generator: torch.Generator | None = None):
        if perm is None:
            perm = torch.randperm(y.shape[0], generator=generator,
                                  device=y.device)
        mu, logvar = self.net(x)
        return club_sample_bound(mu, logvar, y, perm)


class L1OutUB(_CriticEstimator):
    """Leave-one-out upper bound (reference mi_estimator.py:149-198), with
    the reference's broadcast by default (module docstring)."""

    def __init__(self, x_dim: int, y_dim: int, hidden_size: int,
                 reference_broadcast: bool = True):
        super().__init__(x_dim, y_dim, hidden_size)
        self.reference_broadcast = reference_broadcast

    def forward(self, x, y):
        mu, logvar = self.net(x)
        return l1out_bound(mu, logvar, y, self.reference_broadcast)


class VarUB(_CriticEstimator):
    """Variational upper bound (reference mi_estimator.py:201-231)."""

    def forward(self, x, y):
        return var_ub_bound(*self.net(x))


class CLUBMean(nn.Module):
    """CLUB with unit variance (reference mi_estimator.py:65-105)."""

    uses_perm = False

    def __init__(self, x_dim: int, y_dim: int, hidden_size: int | None = None):
        super().__init__()
        if hidden_size is None:
            self.mu_l1 = None
            self.mu_out = linear(x_dim, y_dim)
        else:
            self.mu_l1 = linear(x_dim, int(hidden_size))
            self.mu_out = linear(int(hidden_size), y_dim)

    def _mu(self, x):
        if self.mu_l1 is None:
            return self.mu_out(x)
        return self.mu_out(F.relu(self.mu_l1(x)))

    def forward(self, x, y):
        return club_mean_bound(self._mu(x), y)

    def learning_loss(self, x, y):
        return -(-((self._mu(x) - y) ** 2)).sum(1).mean()


class InfoNCE(nn.Module):
    """InfoNCE lower bound (reference mi_estimator.py:245-273)."""

    uses_perm = False

    def __init__(self, x_dim: int, y_dim: int, hidden_size: int):
        super().__init__()
        self.f_l1 = linear(x_dim + y_dim, hidden_size)
        self.f_l2 = linear(hidden_size, 1)

    def _f(self, xy):
        return F.softplus(self.f_l2(F.relu(self.f_l1(xy))))

    def forward(self, x, y):
        b = y.shape[0]
        t0 = self._f(torch.cat([x, y], -1))                       # [B, 1]
        x_tile = x[None, :, :].expand(b, b, x.shape[-1])
        y_tile = y[:, None, :].expand(b, b, y.shape[-1])
        t1 = self._f(torch.cat([x_tile, y_tile], -1))             # [B, B, 1]
        return t0.mean() - (torch.logsumexp(t1, 1).mean() - math.log(b))

    def learning_loss(self, x, y):
        return -self(x, y)


MI_ESTIMATORS = {
    "club": CLUB,
    "club_mean": CLUBMean,
    "club_sample": CLUBSample,
    "l1out": L1OutUB,
    "var_ub": VarUB,
    "infonce": InfoNCE,
    # reference spellings (trainer factory strings, trainer_utils.py:175)
    "CLUB": CLUB, "CLUBMean": CLUBMean, "CLUBSample": CLUBSample,
    "L1OutUB": L1OutUB, "VarUB": VarUB, "InfoNCE": InfoNCE,
}
