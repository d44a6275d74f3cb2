"""CNN classifier baseline (counterpart of ``clearvae_tpu/models/cnn.py``;
reference code/src/models/cnn.py:7-31).

``SimpleCNN`` is the 28×28 one: the VAE's encoder trunk (3×3 convs,
stride 2, 32→64→128, BN+ReLU, flatten 2048 in (H, W, C) order) and a
Linear(2048→256) + BN + ReLU + Linear(256→n_class) head. Its input is NHWC,
as in the JAX package. The hidden Linear's bias sits ahead of BatchNorm, so
its gradient is zero analytically, as in the reference.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from clearvae_torch.models.layers import BatchNorm, ConvBNReluStack, linear


class SimpleCNN(nn.Module):
    enc_channels = (32, 64, 128)
    flat = 4 * 4 * 128      # 28 → 14 → 7 → 4 through the stride-2 convs

    def __init__(self, n_class: int = 10, in_channel: int = 1):
        super().__init__()
        self.n_class, self.in_channel = n_class, in_channel
        self.net = ConvBNReluStack(in_channel, self.enc_channels, 3, 2, 1)
        self.hidden = linear(self.flat, 256)
        self.hidden_bn = BatchNorm(256)
        self.out = linear(256, n_class)

    def features(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        """The flattened trunk output of an NHWC batch."""
        return self.net(x.permute(0, 3, 1, 2), train)

    def head(self, h: torch.Tensor, train: bool = True) -> torch.Tensor:
        return self.out(F.relu(self.hidden_bn(self.hidden(h), train)))

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        return self.head(self.features(x, train), train)
