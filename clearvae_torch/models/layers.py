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
- A compute ``dtype`` (the JAX package's ``dtype`` field), a
  ``torch.dtype`` or its name (``compute_dtype``: "float32", "bfloat16"):
  the parameters stay float32 and are cast to ``dtype`` on each call, so a
  conv stack in bfloat16 computes in bfloat16 while Adam updates float32
  weights. ``BatchNorm`` keeps its statistics in float32 whatever its input
  and returns its input's dtype, as flax's BatchNorm does for bfloat16
  inputs.
- Every cast a model makes goes through ``cast``, which counts those that
  convert in the tracer's counter ``model.casts`` (``CASTS``: ``calls``,
  ``bytes``), and the cast of the gradient back where the backward runs
  it; on a CUDA tensor ``BatchNorm``'s own casts are folded into K6's
  kernels, run no copy and are not counted. A capture's count moves to
  its replays, as the kernels' launch counts do
  (``ops/kernels/counts.py``). A float32 model counts nothing.
- Under a data mesh (``parallel/mesh.py``) a ``BatchNorm``'s ``group`` is
  the data group, and its train-mode statistics cover the global batch.
"""

from __future__ import annotations

import math

import torch
from torch import nn
from torch.nn import functional as F

from clearvae_torch.ops.kernels import batchnorm as K6
from clearvae_torch.utils.logging import counter

# the compute dtypes that a configuration names (``VAE(dtype="bfloat16")``)
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
CASTS = counter("model.casts", ("calls", "bytes"))


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


def compute_dtype(dtype) -> torch.dtype:
    """``dtype`` as a ``torch.dtype``: one already, or its name in
    ``DTYPES``; any other name raises."""
    if isinstance(dtype, torch.dtype):
        return dtype
    if dtype not in DTYPES:
        raise ValueError(f"unknown compute dtype {dtype!r}: a torch.dtype "
                         f"or one of {sorted(DTYPES)}")
    return DTYPES[dtype]


def _count_cast(nbytes: int) -> None:
    CASTS["calls"] += 1
    CASTS["bytes"] += nbytes


def cast(t: torch.Tensor, dtype) -> torch.Tensor:
    """``t`` in ``dtype``; where that converts, counted in ``CASTS``: a call
    and ``numel`` × (the bytes of an element read and of one written), and
    as much again when the backward casts the result's gradient back (6
    bytes an element each way between float32 and bfloat16)."""
    if t.dtype == dtype:
        return t
    nbytes = t.numel() * (t.element_size() + dtype.itemsize)
    _count_cast(nbytes)
    out = t.to(dtype)
    if out.requires_grad:
        out.register_hook(lambda grad: _count_cast(nbytes))
    return out


def cast_conv(conv: nn.Conv2d, x: torch.Tensor, dtype) -> torch.Tensor:
    """``conv`` on ``x`` with input, weight and bias cast to ``dtype`` (a
    no-op in float32): flax's Conv with a compute ``dtype``."""
    return F.conv2d(cast(x, dtype), cast(conv.weight, dtype),
                    cast(conv.bias, dtype), conv.stride, conv.padding)


def cast_conv_transpose(convt: nn.ConvTranspose2d, x: torch.Tensor,
                        dtype) -> torch.Tensor:
    """``convt`` on ``x`` computed in ``dtype``, as ``cast_conv``."""
    return F.conv_transpose2d(cast(x, dtype), cast(convt.weight, dtype),
                              cast(convt.bias, dtype), convt.stride,
                              convt.padding, convt.output_padding)


def cast_linear(lin: nn.Linear, x: torch.Tensor, dtype) -> torch.Tensor:
    """``lin`` on ``x`` computed in ``dtype``, as ``cast_conv``."""
    return F.linear(cast(x, dtype), cast(lin.weight, dtype),
                    cast(lin.bias, dtype))


def linear(fin: int, fout: int) -> nn.Linear:
    lin = nn.Linear(fin, fout)
    _uniform_fan_in_(lin.weight, fin)
    nn.init.zeros_(lin.bias)
    return lin


# the activation a BatchNorm applies to its output (``BatchNorm``'s ``act``)
ACTIVATIONS = {"none": lambda t: t, "relu": F.relu, "sigmoid": torch.sigmoid}


def _global_stats(x: torch.Tensor, dims, group):
    from clearvae_torch.parallel.mesh import all_reduce_sum

    c = x.shape[1]
    rows = x.new_full((1,), x.numel() // c)
    sums = all_reduce_sum(torch.cat([x.sum(dims), (x * x).sum(dims), rows]),
                          group)
    mean = sums[:c] / sums[2 * c]
    return mean, (sums[c:2 * c] / sums[2 * c] - mean * mean).clamp_min(0.0)


def batch_norm_plain(x: torch.Tensor, weight: torch.Tensor,
                     bias: torch.Tensor, running_mean: torch.Tensor,
                     running_var: torch.Tensor, train: bool,
                     update_stats: bool = True, act: str = "none",
                     momentum: float = 0.1, eps: float = 1e-5,
                     group=None) -> torch.Tensor:
    """``BatchNorm``'s layer as torch ops, its casts through ``cast``: the
    CPU's path, a mesh's, and K6's plain twin on a card."""
    shape = (1, -1) + (1,) * (x.ndim - 2)
    dtype, x = x.dtype, cast(x, torch.float32)
    if train:
        dims = (0,) + tuple(range(2, x.ndim))
        if group is None:
            mean = x.mean(dims)
            var = ((x * x).mean(dims) - mean * mean).clamp_min(0.0)
        else:
            mean, var = _global_stats(x, dims, group)
    if train and update_stats:
        with torch.no_grad():
            running_mean.mul_(1 - momentum).add_(momentum * mean)
            running_var.mul_(1 - momentum).add_(momentum * var)
    elif not train:
        mean, var = running_mean, running_var
    mul = weight * torch.rsqrt(var + eps)
    return ACTIVATIONS[act](cast((x - mean.view(shape)) * mul.view(shape)
                                 + bias.view(shape), dtype))


class BatchNorm(nn.Module):
    """BatchNorm over dim 1 of [N, C] or [N, C, H, W] with flax's running
    statistics (momentum 0.1, eps 1e-5, biased variance), and the
    activation after it (``act``: "none", "relu", "sigmoid"). The
    statistics and the normalization are computed in float32 and the
    result is cast to the input's dtype before the activation.

    On a CUDA tensor off a mesh the layer is K6 (``ops/kernels/
    batchnorm.py``), whose kernels fold the casts and which raises on what
    they do not take; on the CPU, and with a process ``group`` (the data
    group of a mesh), it is ``batch_norm_plain``. Under a group the
    train-mode statistics are the global batch's: the per-channel Σx and
    Σx² and the row count, one float32 buffer, are all-reduced over the
    group (differentiably: the backward all-reduces their gradients), and
    the mean and ``E[x²] − E[x]²`` taken from the sums."""

    def __init__(self, features: int, momentum: float = 0.1, eps: float = 1e-5):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.group = None
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor, train: bool,
                update_stats: bool = True, act: str = "none") -> torch.Tensor:
        args = (self.weight, self.bias, self.running_mean, self.running_var,
                train, update_stats, act, self.momentum, self.eps)
        if x.is_cuda and self.group is None:
            return K6.batch_norm(K6.dense(x), *args)
        return batch_norm_plain(x, *args, group=self.group)


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
            x = bn(cast_conv(conv, x, self.dtype), train, update_stats,
                   act="relu")
        return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
