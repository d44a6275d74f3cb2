"""The parts of ``jax.random`` that the Styled-MNIST styler draws from, as
integer tensor ops (threefry2x32, with JAX's ``jax_threefry_partitionable``
semantics; jax/_src/prng.py ``threefry_seed``, ``_threefry_split_foldlike``,
``threefry_fold_in``, ``_threefry_random_bits_partitionable`` and
jax/_src/random.py ``_randint``).

A key is a pair ``(k0, k1)`` of int64 tensors of one shape, each element a
uint32 value held in int64; every function works elementwise over that shape,
so one call serves a whole batch of keys (the ``vmap`` of the JAX package).
uint32 arithmetic wraps by masking with 2^32 - 1: the operands stay below 2^32,
so no int64 intermediate overflows.
"""

from __future__ import annotations

import numpy as np
import torch

Tensor = torch.Tensor
_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: Tensor, r: int) -> Tensor:
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(k0: Tensor, k1: Tensor, x0: Tensor, x1: Tensor):
    """The Threefry-2x32 block cipher, 20 rounds (``_threefry2x32_lowering``):
    the counter pair (x0, x1) hashed under the key (k0, k1)."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def key(seed: int, shape=(), device=None):
    """``jax.random.key(seed)`` for a seed in the int32 range, broadcast to
    ``shape``: the pair (0, seed mod 2^32)."""
    if not -2 ** 31 <= seed < 2 ** 31:
        raise ValueError(f"seed must fit in int32; got {seed}")
    hi = torch.zeros(shape, dtype=torch.int64, device=device)
    return hi, hi + (seed & _M32)


def fold_in(k, data: Tensor):
    """``jax.random.fold_in(k, data)`` per element: the key hashes the
    counter (0, data mod 2^32)."""
    d = data.to(torch.int64) & _M32
    return threefry2x32(k[0], k[1], torch.zeros_like(d), d)


def split(k, num: int = 2):
    """``jax.random.split(k, num)``: key i hashes the counter (0, i)."""
    zero = torch.zeros_like(k[0])
    return [threefry2x32(k[0], k[1], zero, zero + i) for i in range(num)]


def _bits32(k) -> Tensor:
    """``random_bits(k, 32, ())``: the two words of the counter (0, 0),
    xor-ed."""
    zero = torch.zeros_like(k[0])
    b0, b1 = threefry2x32(k[0], k[1], zero, zero)
    return b0 ^ b1


def randint(k, minval: int, maxval: int) -> Tensor:
    """``jax.random.randint(k, (), minval, maxval)`` in int32 per element:
    two 32-bit draws reduced modulo the span (``_randint``), as int64."""
    if not -2 ** 31 <= minval < maxval <= 2 ** 31 - 1:
        raise ValueError("randint takes int32 bounds with minval < maxval")
    span = maxval - minval
    mult = ((2 ** 16 % span) ** 2 & _M32) % span
    k1, k2 = split(k)
    hi, lo = _bits32(k1), _bits32(k2)
    offset = ((((hi % span) * mult) & _M32) + lo % span) & _M32
    return minval + offset % span


def random_bits(k, shape) -> Tensor:
    """``random_bits(k, 32, shape)`` of one key: element i (row-major) xors
    the two words that the key hashes the counter (i >> 32, i mod 2^32)
    into, as int64."""
    n = 1
    for d in shape:
        n *= d
    i = torch.arange(n, dtype=torch.int64, device=k[0].device)
    b0, b1 = threefry2x32(k[0], k[1], i >> 32, i & _M32)
    return (b0 ^ b1).reshape(shape)


# XLA's float32 erf_inv (M. Giles' approximation; chlo.erf_inv), the
# polynomial's coefficients for w < 5 and for w >= 5
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def erfinv(x: Tensor) -> Tensor:
    """float32 erfinv as XLA computes it: w = -log1p(-x²), a degree-8
    polynomial in w - 2.5 (w < 5) or sqrt(w) - 3, times x. Its Horner
    steps are fused multiply-adds (one rounding, through float64), as XLA's
    CPU code contracts them; the steps then agree with JAX's bit for bit
    and log1p within an ulp. torch.erfinv differs from it by up to ~1e-5
    in the tails."""
    w = -torch.log1p(x * -x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0).double()
    coef = [torch.where(lt, torch.tensor(a, dtype=torch.float32, device=x.device),
                        torch.tensor(b, dtype=torch.float32, device=x.device))
            for a, b in zip(_ERFINV_LT5, _ERFINV_GE5)]
    p = coef[0]
    for c in coef[1:]:
        p = (c.double() + p.double() * w).float()
    return torch.where(x.abs() == 1, x * torch.finfo(torch.float32).max,
                       p * x)


def normal(k, shape) -> Tensor:
    """``jax.random.normal(k, shape)`` in float32 (``_normal_real``): a
    uniform in (-1, 1) as ``jax.random.uniform`` makes it (the top 23 bits
    as the mantissa of a float in [1, 2), less one, scaled by hi - lo in
    float32, shifted by lo and no lower than lo), then sqrt(2)·erfinv."""
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    mant = (random_bits(k, shape) >> 9) | 0x3F800000
    floats = mant.to(torch.int32).view(torch.float32) - 1.0
    u = torch.clamp_min(floats * float(np.float32(1.0) - lo) + float(lo),
                        float(lo))
    return erfinv(u) * np.float32(np.sqrt(2))
