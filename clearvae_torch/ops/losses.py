"""Loss functions and pairwise similarities (counterpart of
``clearvae_tpu/ops/losses.py``; reference: code/src/losses.py).

Plain tensor functions. Masking uses the double-``where`` trick instead of
in-place -inf writes, so gradients are NaN-free even for rows whose positive
set is empty. These are the plain path of the CLEAR step and the reference
the fused kernels of ``ops/kernels/fused_loss.py`` are held to.
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor


# ---------------------------------------------------------------------------
# masked logsumexp
# ---------------------------------------------------------------------------


def masked_logsumexp(x: Tensor, mask: Tensor, dim: int = -1) -> Tensor:
    """logsumexp over entries where ``mask`` is True.

    Rows with an empty mask return -inf (reference losses.py:87-95), with
    NaN-free gradients.
    """
    neg_big = torch.finfo(x.dtype).min
    any_valid = mask.any(dim=dim, keepdim=True)
    x_masked = torch.where(mask, x, torch.full_like(x, neg_big))
    m = x_masked.amax(dim=dim, keepdim=True)
    # rows with no valid entry get m = finfo.min; zero it so exp() below stays
    # finite (an inf in the unselected branch would NaN the gradient)
    m_safe = torch.where(any_valid & torch.isfinite(m), m, torch.zeros_like(m))
    e = torch.where(mask, torch.exp(x_masked - m_safe), torch.zeros_like(x))
    s = e.sum(dim=dim)
    out = torch.log(torch.where(s > 0, s, torch.ones_like(s))) + m_safe.squeeze(dim)
    return torch.where(any_valid.squeeze(dim), out,
                       torch.full_like(out, float("-inf")))


# ---------------------------------------------------------------------------
# ELBO pieces
# ---------------------------------------------------------------------------


def sample_level_reduction(t: Tensor) -> Tensor:
    """Sum over non-batch dims, mean over batch (reference: losses.py:36-38)."""
    return t.sum(dim=tuple(range(1, t.ndim))).mean()


def vae_loss(x_hat: Tensor, x: Tensor, mu_c: Tensor, logvar_c: Tensor,
             mu_s: Tensor, logvar_s: Tensor) -> tuple[Tensor, Tensor, Tensor]:
    """Per-sample-summed MSE reconstruction + analytic Gaussian KL split into
    content/style halves (reference: code/src/losses.py:41-50)."""
    recon = sample_level_reduction((x_hat - x) ** 2)
    kl_c = -0.5 * sample_level_reduction(1 + logvar_c - mu_c ** 2
                                         - torch.exp(logvar_c))
    kl_s = -0.5 * sample_level_reduction(1 + logvar_s - mu_s ** 2
                                         - torch.exp(logvar_s))
    return recon, kl_c, kl_s


# ---------------------------------------------------------------------------
# Pairwise similarities (all [B, B])
# ---------------------------------------------------------------------------


def pairwise_cosine(mu: Tensor, logvar: Tensor | None = None) -> Tensor:
    """sim[i, j] = cos(mu_j, mu_i) (reference: losses.py:54-55); each norm is
    clamped at 1e-8 like torch's ``F.cosine_similarity``."""
    norm = torch.linalg.vector_norm(mu, dim=-1, keepdim=True).clamp_min(1e-8)
    mu_n = mu / norm
    return mu_n @ mu_n.T


def pairwise_l2(mu: Tensor, logvar: Tensor | None = None) -> Tensor:
    """-||mu_i - mu_j||² (reference: losses.py:58-59)."""
    sq = (mu ** 2).sum(-1)
    d2 = sq[:, None] + sq[None, :] - 2.0 * (mu @ mu.T)
    return -d2.clamp_min(0.0)


def pairwise_jeffrey(mu: Tensor, logvar: Tensor) -> Tensor:
    """-symmetric KL between diagonal Gaussians (reference: losses.py:62-72).

    Keeps the reference's indexing: term2 divides by the variance of the
    *column* index j (torch right-aligned broadcasting, losses.py:66), term3
    is var_j / (var_i + 1e-8); the result is symmetrized.
    """
    k = mu.shape[1]
    var = torch.exp(logvar)
    lv_sum = logvar.sum(-1)
    term1 = lv_sum[None, :] - lv_sum[:, None] - k
    term2 = ((mu[None, :, :] - mu[:, None, :]) ** 2 / var[None, :, :]).sum(-1)
    term3 = (var[None, :, :] / (var[:, None, :] + 1e-8)).sum(-1)
    pkl = 0.5 * (term1 + term2 + term3)
    return -0.5 * (pkl + pkl.T)


def pairwise_mahalanobis(mu: Tensor, logvar: Tensor) -> Tensor:
    """-Mahalanobis distance with averaged variances (reference: losses.py:75-78)."""
    var = 0.5 * (torch.exp(logvar)[None, :, :] + torch.exp(logvar)[:, None, :])
    return -((mu[None, :, :] - mu[:, None, :]) ** 2 / var).sum(-1)


def pairwise_modified_l2(mu: Tensor, logvar: Tensor) -> Tensor:
    """-L2 scaled by geometric-mean variance (reference: losses.py:81-84)."""
    var = torch.exp(0.5 * (logvar[None, :, :] + logvar[:, None, :]))
    return -((mu[None, :, :] - mu[:, None, :]) ** 2 / var).sum(-1)


SIM_FNS = {
    "cosine": pairwise_cosine,
    "l2": pairwise_l2,
    "modified_l2": pairwise_modified_l2,
    "jeffrey": pairwise_jeffrey,
    "mahalanobis": pairwise_mahalanobis,
}


# ---------------------------------------------------------------------------
# Contrastive losses over a [B, B] similarity matrix
# ---------------------------------------------------------------------------


def _eye(n: int, device) -> Tensor:
    return torch.eye(n, dtype=torch.bool, device=device)


def snn_loss(sim: Tensor, pair_mat: Tensor, temperature: float) -> Tensor:
    """Per-row soft-nearest-neighbour loss (reference: losses.py:129-137).

    Diagonal excluded from numerator and denominator; rows with no positive
    pair yield +inf (dropped by the caller's finite mask).
    """
    not_diag = ~_eye(sim.shape[0], sim.device)
    pos_mask = (pair_mat > 0) & not_diag
    s = sim / temperature
    num = masked_logsumexp(s, pos_mask, dim=1)
    den = masked_logsumexp(s, not_diag, dim=1)
    return -num + den


def supcon_in_loss(sim: Tensor, pair_mat: Tensor, temperature: float) -> Tensor:
    """SupCon L_in (reference: losses.py:140-153): snn + log(n_k)."""
    n_k = pair_mat.sum(1) - 1.0
    return torch.log(n_k) + snn_loss(sim, pair_mat, temperature)


def supcon_out_loss(sim: Tensor, pair_mat: Tensor, temperature: float) -> Tensor:
    """SupCon L_out (reference: losses.py:156-170).

    Keeps the reference's quirk: the diagonal is set to -999 (not -inf) and
    stays inside the denominator logsumexp. Rows without positives return
    +inf so the caller's finite mask drops them.
    """
    eye_b = _eye(sim.shape[0], sim.device)
    eye = eye_b.to(sim.dtype)
    sim_d = torch.where(eye_b, torch.full_like(sim, -999.0), sim)
    pos_mask = pair_mat * (1.0 - eye)
    masked_sim = sim_d * pos_mask
    n_k = pos_mask.sum(1)
    den = masked_logsumexp(sim_d / temperature, torch.ones_like(eye_b), dim=1)
    loss = -masked_sim.sum(1) / torch.where(n_k > 0, n_k, torch.ones_like(n_k)) + den
    return torch.where(n_k > 0, loss, torch.full_like(loss, float("inf")))


CONTRASTIVE_LOSSES = {
    "snn": snn_loss,
    "supcon_in": supcon_in_loss,
    "supcon_out": supcon_out_loss,
}


def contrastive_loss(mu: Tensor, logvar: Tensor, label: Tensor, *,
                     sim_fn: str = "cosine", temperature: float = 0.1,
                     loss_name: str = "snn", ps: bool = False) -> Tensor:
    """Mean over finite per-row losses (reference: code/src/losses.py:98-126).

    ``ps=True`` flips the pair matrix: different-label pairs are positives
    (the PS-SNN anti-contrastive mode used on the style latent).
    """
    same = label[None, :] == label[:, None]
    pair_mat = (~same if ps else same).to(mu.dtype)
    sim = SIM_FNS[sim_fn](mu, logvar)
    losses = CONTRASTIVE_LOSSES[loss_name](sim, pair_mat, temperature)
    finite = torch.isfinite(losses)
    total = torch.where(finite, losses, torch.zeros_like(losses)).sum()
    return total / finite.sum().clamp_min(1)


# ---------------------------------------------------------------------------
# LAM loss (reference: code/src/losses.py:173-187)
# ---------------------------------------------------------------------------


def lam_loss(feature_x: Tensor, feature_x_tilde: Tensor, y: Tensor,
             linear_w: Tensor) -> Tensor:
    """Mean squared difference of class-weighted feature contributions
    between an image and its stratified-shuffle partner. ``linear_w`` is the
    linear head's weight, [n_class, feat]."""
    diff = (feature_x - feature_x_tilde) * linear_w[y]
    return (diff ** 2).sum(1).mean()
