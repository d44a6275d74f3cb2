"""Density-ratio factor classifier of CLEAR-TC (counterpart of
``clearvae_tpu/models/factor.py``; reference
code/src/utils/trainer_utils.py:133-138): Linear(z, z) → ReLU → Linear(z, 1)
→ sigmoid, with the port's ``linear`` init."""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from clearvae_torch.models.layers import linear


class FactorCls(nn.Module):
    def __init__(self, z_dim: int):
        """``z_dim`` is the total latent width (content + style)."""
        super().__init__()
        self.z_dim = z_dim
        self.dense_0 = linear(z_dim, z_dim)
        self.dense_1 = linear(z_dim, 1)

    def forward(self, z: torch.Tensor, return_logits: bool = False):
        """Density d = sigmoid(logit), or the logit itself: the reference's
        TC penalty log(d/(1−d)) (trainer.py:664-673) is the logit exactly,
        without the 1/(1−d) gradient once the classifier saturates."""
        logit = self.dense_1(F.relu(self.dense_0(z)))
        return logit if return_logits else torch.sigmoid(logit)
