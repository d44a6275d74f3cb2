"""Downstream probe MLP (counterpart of ``clearvae_tpu/models/mlp.py``;
reference run_styledmnist_downstream_expr.py:110-115).

Trained on the frozen VAE's ``mu_c`` only (reference trainer.py:126-127):
Linear → BatchNorm → ReLU → Linear, with the port's ``linear`` init and its
flax-numerics ``BatchNorm`` (flax ``momentum=0.9`` is momentum 0.1 here;
biased running variance, eps 1e-5).
"""

from __future__ import annotations

from torch import nn
from torch.nn import functional as F

from clearvae_torch.models.layers import BatchNorm, linear


class ProbeMLP(nn.Module):
    def __init__(self, z_dim: int, n_class: int = 10, hidden: int = 256):
        super().__init__()
        self.dense_0 = linear(z_dim, hidden)
        self.bn = BatchNorm(hidden)
        self.dense_1 = linear(hidden, n_class)

    def forward(self, z, train: bool = True):
        return self.dense_1(F.relu(self.bn(self.dense_0(z), train)))
