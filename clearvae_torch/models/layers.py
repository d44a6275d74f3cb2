"""Building-block layers with flax's numerics (counterpart of
``clearvae_tpu/models/layers.py``).

The modules compute in NCHW, PyTorch's layout; the models permute at their
public boundary, which stays NHWC as in the JAX package.

- Init: every kernel is uniform with variance 1/(3·fan_in), every bias zero
  (``torch_kernel_init`` of the JAX package). A ConvTranspose's fan_in is
  k·k·in, as flax counts it, not torch's k·k·out.
- ``ConvTranspose`` with (padding p, output_padding op) equals the JAX
  package's lhs-dilated convolution with pads (k-1-p, k-1-p+op); the weight
  map between the two is flip(h, w) plus HWIO->IOHW (``bridge.py``).
- ``BatchNorm`` uses momentum 0.1 and eps 1e-5 and, like flax, updates its
  running variance with the *biased* batch variance E[x²]-E[x]²; torch's own
  BatchNorm would use the unbiased one. Train/eval is an explicit argument,
  as in the JAX package; ``update_stats=False`` normalizes a train-mode
  batch by its own statistics and leaves the running ones as they were (the
  JAX package's train-mode apply whose ``batch_stats`` update is dropped).
- A compute ``dtype`` (the JAX package's ``dtype`` field): the parameters
  stay float32 and are cast to ``dtype`` on each call, so a conv stack in
  bfloat16 computes in bfloat16 while Adam updates float32 weights.
  ``BatchNorm`` keeps its statistics in float32 whatever its input and
  returns its input's dtype, as flax's BatchNorm does for bfloat16 inputs.
- Under a data mesh (``parallel/mesh.py``) a ``BatchNorm``'s ``group`` is
  the data group, and its train-mode statistics cover the global batch.
"""

from __future__ import annotations

import math

import torch
from torch import nn
from torch.nn import functional as F


def _uniform_fan_in_(weight: torch.Tensor, fan_in: int) -> None:
    # variance 1/(3·fan_in) uniform == U(-1/sqrt(fan_in), 1/sqrt(fan_in))
    bound = 1.0 / math.sqrt(fan_in)
    with torch.no_grad():
        weight.uniform_(-bound, bound)


def conv2d(cin: int, cout: int, kernel: int, stride: int,
           padding: int) -> nn.Conv2d:
    conv = nn.Conv2d(cin, cout, kernel, stride, padding)
    _uniform_fan_in_(conv.weight, cin * kernel * kernel)
    nn.init.zeros_(conv.bias)
    return conv


def conv_transpose2d(cin: int, cout: int, kernel: int, stride: int,
                     padding: int, output_padding: int) -> nn.ConvTranspose2d:
    conv = nn.ConvTranspose2d(cin, cout, kernel, stride, padding,
                              output_padding)
    _uniform_fan_in_(conv.weight, cin * kernel * kernel)
    nn.init.zeros_(conv.bias)
    return conv


def cast_conv(conv: nn.Conv2d, x: torch.Tensor, dtype) -> torch.Tensor:
    """``conv`` on ``x`` with input, weight and bias cast to ``dtype`` (a
    no-op in float32): flax's Conv with a compute ``dtype``."""
    return F.conv2d(x.to(dtype), conv.weight.to(dtype), conv.bias.to(dtype),
                    conv.stride, conv.padding)


def cast_conv_transpose(convt: nn.ConvTranspose2d, x: torch.Tensor,
                        dtype) -> torch.Tensor:
    """``convt`` on ``x`` computed in ``dtype``, as ``cast_conv``."""
    return F.conv_transpose2d(x.to(dtype), convt.weight.to(dtype),
                              convt.bias.to(dtype), convt.stride,
                              convt.padding, convt.output_padding)


def cast_linear(lin: nn.Linear, x: torch.Tensor, dtype) -> torch.Tensor:
    """``lin`` on ``x`` computed in ``dtype``, as ``cast_conv``."""
    return F.linear(x.to(dtype), lin.weight.to(dtype), lin.bias.to(dtype))


def linear(fin: int, fout: int) -> nn.Linear:
    lin = nn.Linear(fin, fout)
    _uniform_fan_in_(lin.weight, fin)
    nn.init.zeros_(lin.bias)
    return lin


class BatchNorm(nn.Module):
    """BatchNorm over dim 1 of [N, C] or [N, C, H, W] with flax's running
    statistics (momentum 0.1, eps 1e-5, biased variance). The statistics
    and the normalization are computed in float32 and the result is cast
    to the input's dtype.

    With a process ``group`` (the data group of a mesh) the train-mode
    statistics are the global batch's: the per-channel Σx and Σx² and the
    row count, one float32 buffer, are all-reduced over the group
    (differentiably: the backward all-reduces their gradients), and the
    mean and ``E[x²] − E[x]²`` taken from the sums."""

    def __init__(self, features: int, momentum: float = 0.1, eps: float = 1e-5):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.group = None
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor, train: bool,
                update_stats: bool = True) -> torch.Tensor:
        shape = (1, -1) + (1,) * (x.ndim - 2)
        dtype, x = x.dtype, x.float()
        if train:
            dims = (0,) + tuple(range(2, x.ndim))
            if self.group is None:
                mean = x.mean(dims)
                var = ((x * x).mean(dims) - mean * mean).clamp_min(0.0)
            else:
                mean, var = self._global_stats(x, dims)
        if train and update_stats:
            with torch.no_grad():
                self.running_mean.mul_(1 - self.momentum).add_(
                    self.momentum * mean)
                self.running_var.mul_(1 - self.momentum).add_(
                    self.momentum * var)
        elif not train:
            mean, var = self.running_mean, self.running_var
        mul = self.weight * torch.rsqrt(var + self.eps)
        return ((x - mean.view(shape)) * mul.view(shape)
                + self.bias.view(shape)).to(dtype)

    def _global_stats(self, x: torch.Tensor, dims):
        from clearvae_torch.parallel.mesh import all_reduce_sum

        c = x.shape[1]
        rows = x.new_full((1,), x.numel() // c)
        sums = all_reduce_sum(torch.cat([x.sum(dims), (x * x).sum(dims), rows]),
                              self.group)
        mean = sums[:c] / sums[2 * c]
        return mean, (sums[c:2 * c] / sums[2 * c] - mean * mean).clamp_min(0.0)


class ConvBNReluStack(nn.Module):
    """[Conv -> BN -> ReLU]* trunk + flatten in (H, W, C) order, the JAX
    package's NHWC flatten (reference: vae.py:15-26), computed in
    ``dtype``."""

    def __init__(self, in_channel: int, channels, kernel: int, stride: int,
                 padding: int, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        cins = (in_channel,) + tuple(channels[:-1])
        self.convs = nn.ModuleList(conv2d(ci, co, kernel, stride, padding)
                                   for ci, co in zip(cins, channels))
        self.bns = nn.ModuleList(BatchNorm(co) for co in channels)

    def forward(self, x: torch.Tensor, train: bool,
                update_stats: bool = True) -> torch.Tensor:
        for conv, bn in zip(self.convs, self.bns):
            x = F.relu(bn(cast_conv(conv, x, self.dtype), train, update_stats))
        return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
