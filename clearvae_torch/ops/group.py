"""Group-evidence accumulation for GVAE / ML-VAE with static shapes
(counterpart of ``clearvae_tpu/ops/group.py``; reference
code/src/models/vae.py:159-223).

Evidence is accumulated over a fixed class count with one-hot products and
a presence mask, as in the JAX package:

- MLVAE: precision-weighted product of the members' Gaussians,
  mu_g = Σ mu·exp(-lv) · exp(-logsumexp(-lv)), logvar_g = -logsumexp(-lv);
- GVAE: mean of the mus, logvar_g = logsumexp(lv) - log(n);
- each sample draws its own eps from its group's Gaussian;
- the content KL is taken on the [n_classes, z] group params, a mean over
  the groups present.

The evidence couples every row of a batch with its class mates, so under a
data mesh it is accumulated over the batch's mu and logvar gathered from
every rank (``VAE.forward`` with a ``parallel.mesh.Shard``); the functions
here see the global batch either way.
"""

from __future__ import annotations

import torch
from torch.nn import functional as F

Tensor = torch.Tensor


def accumulate_group_evidence(mu: Tensor, logvar: Tensor, label: Tensor,
                              n_classes: int, mode: str):
    """(mu_g, logvar_g, present), shaped [n_classes, z], [n_classes, z],
    [n_classes] bool. Absent classes get zeros and present=False."""
    onehot = F.one_hot(label.long(), n_classes).to(mu.dtype)   # [B, C]
    counts = onehot.sum(0)
    present = counts > 0
    member = (onehot.T > 0)[:, :, None]                          # [C, B, 1]
    zero = torch.zeros((), dtype=mu.dtype, device=mu.device)

    def class_lse(values):  # [B, z] -> [C, z]
        big_neg = torch.finfo(values.dtype).min
        masked = torch.where(member, values[None], big_neg)
        m = masked.amax(1, keepdim=True)
        # absent classes get m = finfo.min: zero it, and use the masked
        # values inside exp, so neither forward nor backward meets an inf
        m_safe = torch.where(present[:, None, None] & torch.isfinite(m), m, zero)
        e = torch.where(member,
                        torch.exp(torch.where(member, values[None], m_safe)
                                  - m_safe), zero)
        s = e.sum(1)
        return torch.log(torch.where(s > 0, s, 1.0)) + m_safe.squeeze(1)

    if mode == "MLVAE":
        loginvvar = -logvar
        group_loginvvar = class_lse(loginvvar)
        mu_g = (onehot.T @ (mu * torch.exp(loginvvar))) * torch.exp(-group_loginvvar)
        logvar_g = -group_loginvvar
    elif mode == "GVAE":
        safe_counts = counts.clamp_min(1.0)
        mu_g = (onehot.T @ mu) / safe_counts[:, None]
        logvar_g = class_lse(logvar) - torch.log(safe_counts)[:, None]
    else:
        raise NotImplementedError("only support using MLVAE or GVAE")
    mu_g = torch.where(present[:, None], mu_g, zero)
    logvar_g = torch.where(present[:, None], logvar_g, zero)
    return mu_g, logvar_g, present


def group_reparam(mu_g: Tensor, logvar_g: Tensor, label: Tensor,
                  eps: Tensor) -> Tensor:
    """Each sample's draw from its group's Gaussian, with its own noise
    ``eps`` [B, z] (the JAX package draws it from the 'reparam' stream)."""
    label = label.long()
    return mu_g[label] + eps * torch.exp(0.5 * logvar_g[label])


def grouped_kl(mu_g: Tensor, logvar_g: Tensor, present: Tensor) -> Tensor:
    """KL of the group params, mean over the groups present."""
    kl_rows = -0.5 * (1 + logvar_g - mu_g ** 2 - torch.exp(logvar_g)).sum(-1)
    kl_rows = torch.where(present, kl_rows, torch.zeros_like(kl_rows))
    return kl_rows.sum() / present.sum().clamp_min(1)
