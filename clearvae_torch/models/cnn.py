"""CNN classifier baselines (counterpart of ``clearvae_tpu/models/cnn.py``;
reference code/src/models/cnn.py).

``SimpleCNN`` / ``SimpleCNN64``: the VAE's encoder trunk (28×28: 3×3
convs 32→64→128; 64×64: 4×4 convs 32…512; stride 2, BN+ReLU, flatten 2048
in (H, W, C) order) and a Linear(2048→256) + BN + ReLU + Linear(256→n_class)
head. ``LAMCNN`` / ``LAMCNN64``: the same trunks with a linear head,
``cls_head``, whose weight the LAM loss reads (reference cnn.py:57-66).
Inputs are NHWC, as in the JAX package. The hidden Linear's bias sits ahead
of BatchNorm, so its gradient is zero analytically, as in the reference.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from clearvae_torch.models.layers import BatchNorm, ConvBNReluStack, linear


class SimpleCNN(nn.Module):
    """28×28 classifier (reference: cnn.py:7-31)."""

    enc_channels = (32, 64, 128)
    enc_kernel = 3
    flat = 4 * 4 * 128      # 28 → 14 → 7 → 4 through the stride-2 convs
    linear_head = False

    def __init__(self, n_class: int = 10, in_channel: int = 1):
        super().__init__()
        self.n_class, self.in_channel = n_class, in_channel
        self.net = ConvBNReluStack(in_channel, self.enc_channels,
                                   self.enc_kernel, 2, 1)
        if self.linear_head:
            self.cls_head = linear(self.flat, n_class)
        else:
            self.hidden = linear(self.flat, 256)
            self.hidden_bn = BatchNorm(256)
            self.out = linear(256, n_class)

    def features(self, x: torch.Tensor, train: bool = True,
                 update_stats: bool = True) -> torch.Tensor:
        """The flattened trunk output of an NHWC batch;
        ``update_stats=False`` normalizes a train-mode batch by its own
        statistics and leaves the running ones as they were."""
        return self.net(x.permute(0, 3, 1, 2), train, update_stats)

    def head(self, h: torch.Tensor, train: bool = True) -> torch.Tensor:
        if self.linear_head:
            return self.cls_head(h)
        return self.out(F.relu(self.hidden_bn(self.hidden(h), train)))

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        return self.head(self.features(x, train), train)


class SimpleCNN64(SimpleCNN):
    """64×64 classifier (reference: cnn.py:34-54)."""

    enc_channels = (32, 64, 128, 256, 512)
    enc_kernel = 4
    flat = 2 * 2 * 512      # 64 → 32 → 16 → 8 → 4 → 2

    def __init__(self, n_class: int = 4, in_channel: int = 3):
        super().__init__(n_class, in_channel)


class LAMCNN(SimpleCNN):
    """28×28 LAM classifier: linear head (reference: cnn.py:57-60)."""

    linear_head = True


class LAMCNN64(SimpleCNN64):
    """64×64 LAM classifier: linear head (reference: cnn.py:63-66)."""

    linear_head = True


def lam_head_weight(model: SimpleCNN) -> torch.Tensor:
    """The linear head's weight [n_class, feat] for ``lam_loss`` (the
    reference reads ``cls_head.weight``, trainer.py:281)."""
    return model.cls_head.weight
