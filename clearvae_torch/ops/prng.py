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

import math

import numpy as np
import torch

from clearvae_torch.ops.image import constant
from clearvae_torch.utils.logging import counter

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


def split_stacked(k, num: int = 2):
    """``jax.random.split(k, num)`` for every key as one key of shape
    ``k``'s shape + (num,): key i hashes the counter (0, i). One threefry
    pass over the ``num`` counters."""
    i = torch.arange(num, dtype=torch.int64, device=k[0].device)
    return threefry2x32(k[0][..., None], k[1][..., None],
                        torch.zeros_like(i), i)


def split(k, num: int = 2):
    """``jax.random.split(k, num)`` for every key: the ``num`` keys of
    ``split_stacked`` one by one."""
    b0, b1 = split_stacked(k, num)
    return [(b0[..., j], b1[..., j]) for j in range(num)]


def random_bits(k, shape=()) -> Tensor:
    """``random_bits(k, 32, shape)`` for every key of ``k``: element i
    (row-major) of a key's draw xors the two words that the key hashes the
    counter (i >> 32, i mod 2^32) into. int64 of shape ``k``'s shape +
    ``shape``."""
    n = 1
    for d in shape:
        n *= d
    i = torch.arange(n, dtype=torch.int64, device=k[0].device)
    b0, b1 = threefry2x32(k[0][..., None], k[1][..., None], i >> 32, i & _M32)
    return (b0 ^ b1).reshape(*k[0].shape, *shape)


def randint(k, minval: int, maxval: int, shape=()) -> Tensor:
    """``jax.random.randint(k, shape, minval, maxval)`` in int32 for every
    key: two 32-bit draws reduced modulo the span (``_randint``), as int64
    of shape ``k``'s shape + ``shape``."""
    if not -2 ** 31 <= minval < maxval <= 2 ** 31 - 1:
        raise ValueError("randint takes int32 bounds with minval < maxval")
    span = maxval - minval
    mult = ((2 ** 16 % span) ** 2 & _M32) % span
    k1, k2 = split(k)
    hi, lo = random_bits(k1, shape), random_bits(k2, shape)
    offset = ((((hi % span) * mult) & _M32) + lo % span) & _M32
    return minval + offset % span


def _f32(v) -> float:
    return float(np.float32(v))


def uniform(k, shape=(), minval=0.0, maxval=1.0) -> Tensor:
    """``jax.random.uniform(k, shape, float32, minval, maxval)`` for every
    key (``_uniform``): the top 23 bits as the mantissa of a float in
    [1, 2), less one, times maxval - minval plus minval in one fused
    multiply-add (through float64: the product is exact there), as XLA's
    CPU code contracts it, and no lower than minval."""
    lo, hi = _f32(minval), _f32(maxval)
    mant = (random_bits(k, shape) >> 9) | 0x3F800000
    floats = mant.to(torch.int32).view(torch.float32) - 1.0
    span = _f32(np.float32(hi) - np.float32(lo))
    return torch.clamp_min((floats.double() * span + lo).float(), lo)


def bernoulli(k, p: float = 0.5, shape=()) -> Tensor:
    """``jax.random.bernoulli(k, p, shape)`` for every key: uniform < p."""
    return uniform(k, shape) < _f32(p)


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
    table = constant("erfinv", x.device, lambda: np.asarray(
        [_ERFINV_LT5, _ERFINV_GE5], np.float32).astype(np.float64))
    coef = torch.where(lt[..., None], table[0], table[1])
    p = coef[..., 0]
    for i in range(1, len(_ERFINV_LT5)):
        p = (coef[..., i] + p.double() * w).float()
    return torch.where(x.abs() == 1, x * torch.finfo(torch.float32).max,
                       p * x)


def normal(k, shape=()) -> Tensor:
    """``jax.random.normal(k, shape)`` in float32 for every key
    (``_normal_real``): a uniform in (-1, 1), then sqrt(2)·erfinv."""
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    return erfinv(uniform(k, shape, lo, 1.0)) * np.float32(np.sqrt(2))


# ---------------------------------------------------------------------------
# poisson
# ---------------------------------------------------------------------------

# per device, the count of Poisson draws that were still running when their
# loop reached its cap: ``poisson`` adds to it on the device, and
# ``check_poisson`` reads it (a host sync) where its caller syncs anyway
_UNFINISHED: dict = {}
SYNCS = counter("host.syncs")   # device tensors to the host, by site
KNUTH_LIMIT = 10.0      # JAX draws lam < 10 by Knuth's product of uniforms
REJECTION_ITERS = 32


def knuth_iters(lam_max: float) -> int:
    """The loop cap of Knuth's method for rates up to ``lam_max``: a draw of
    count n needs n + 1 iterations, and P(n >= cap) < 1e-13 at the largest
    rate the method takes (lam < 10)."""
    lam = min(float(lam_max), KNUTH_LIMIT)
    return int(math.ceil(lam + 7.0 * math.sqrt(lam) + 10.0))


def _counter_key(device) -> str:
    """The counter's key for ``device``: a CUDA device without an index is
    the current one, so ``cuda`` (an entry point's device) and ``cuda:0``
    (the device of a tensor on it) name one counter."""
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return str(d)


def unfinished(device) -> Tensor:
    """The device's counter of Poisson draws cut by their loop cap (an int64
    scalar, made at the first draw on the device, before any capture)."""
    d = _counter_key(device)
    if d not in _UNFINISHED:
        _UNFINISHED[d] = torch.zeros((), dtype=torch.int64, device=device)
    return _UNFINISHED[d]


def check_poisson(device) -> None:
    """Raise if a Poisson draw on ``device`` was cut by its loop cap: its
    count may then differ from JAX's. Reads the counter, a host sync; a
    device that drew no Poisson value is not read."""
    d = _counter_key(device)
    n = 0
    if d in _UNFINISHED:
        SYNCS["check_poisson"] += 1
        n = int(_UNFINISHED[d])
    if n:
        raise RuntimeError(
            f"{n} Poisson draws on {d} did not finish within their loop cap "
            f"(Knuth {knuth_iters(KNUTH_LIMIT)} at most, rejection "
            f"{REJECTION_ITERS}); their counts are not JAX's")


def _key_chain(k, iters: int, num: int):
    """The sub-keys of ``iters`` turns of ``key, *subs = split(key, num)``:
    num - 1 pairs of [..., iters] tensors."""
    subs = []
    for _ in range(iters):
        k, *sub = split(k, num)
        subs.append(sub)
    return [(torch.stack([s[j][0] for s in subs], -1),
             torch.stack([s[j][1] for s in subs], -1)) for j in range(num - 1)]


def _poisson_knuth(k, lam: Tensor, shape, iters: int):
    """``_poisson_knuth`` to a fixed cap: at turn i every element still
    running (log product > -lam) counts one, then adds the log of its
    uniform of turn i. An element's count depends only on its own rate and
    the key's stream, so it is JAX's wherever it finished by the cap.
    Returns (counts, number still running)."""
    nb = k[0].dim()
    logs = torch.log(uniform(_key_chain(k, iters, 2)[0], shape))
    neg = -lam
    log_prod = torch.zeros_like(lam)
    count = torch.zeros(lam.shape, dtype=torch.int64, device=lam.device)
    for i in range(iters):
        count = count + (log_prod > neg)
        log_prod = log_prod + logs.select(nb, i)
    return count - 1, (log_prod > neg).sum()


# XLA's lgamma (xla/hlo/builder/lib/math.cc ``Lgamma``): Lanczos, g = 7
_LANCZOS_G = 7.0
_LANCZOS_BASE = 0.99999999999980993227684700473478
_LANCZOS = (676.520368121885098567009190444019, -1259.13921672240287047156078755283,
            771.3234287776530788486528258894, -176.61502916214059906584551354,
            12.507343278686904814458936853, -0.13857109526572011689554706,
            9.984369578019570859563e-6, 1.50563273514931155834e-7)


def lgamma(x: Tensor) -> Tensor:
    """float32 lgamma as XLA computes it, for x >= 0.5 (no reflection): the
    Lanczos sum, log t as log(g + 1/2) + log1p(z / (g + 1/2)), and
    (z + 1/2 - t / log t)·log t + log(sqrt(2 pi)) as one fused multiply-add
    (through float64), as XLA's CPU code contracts it. Its log and log1p
    differ from XLA's by an ulp in a few inputs; torch.lgamma differs from
    it by up to 2 ulps near 1e5, where the rejection sampler reads it."""
    z = x - 1.0
    acc = torch.full_like(x, _f32(_LANCZOS_BASE))
    for i, c in enumerate(_LANCZOS):
        acc = acc + _f32(c) / (z + float(i) + 1.0)
    gh = _f32(_LANCZOS_G + 0.5)
    t = gh + z
    log_t = _f32(math.log(_LANCZOS_G + 0.5)) + torch.log1p(z / gh)
    half_log_2pi = _f32((math.log(2) + math.log(math.pi)) / 2)
    y = ((z + 0.5 - t / log_t).double() * log_t.double() + half_log_2pi).float()
    return y + torch.log(acc)


def _poisson_rejection(k, lam: Tensor, shape, iters: int):
    """``_poisson_rejection`` (Hormann's transformed rejection) to a fixed
    cap. JAX overwrites an accepted element at every later accepting turn
    until its whole draw (all of ``shape``) has accepted, so a draw stops
    changing only once all its elements have: the running mask is per key.
    Returns (counts as float, number of elements never accepted)."""
    nb = k[0].dim()
    s0, s1 = _key_chain(k, iters, 3)
    us = uniform(s0, shape) - 0.5
    vs = uniform(s1, shape)
    log_lam = torch.log(lam)
    b = 0.931 + 2.53 * torch.sqrt(lam)
    a = -0.059 + 0.02483 * b
    inv_alpha = 1.1239 + 1.1328 / (b - 3.4)
    v_r = 0.9277 - 3.6224 / (b - 2)
    k_out = torch.full_like(lam, -1.0)
    accepted = torch.zeros(lam.shape, dtype=torch.bool, device=lam.device)
    flat = (*lam.shape[:nb], -1)
    for i in range(iters):
        u, v = us.select(nb, i), vs.select(nb, i)
        u_shifted = 0.5 - torch.abs(u)
        kk = torch.floor((2 * a / u_shifted + b) * u + lam + 0.43)
        s = torch.log(v * inv_alpha / (a / (u_shifted * u_shifted) + b))
        t = -lam + kk * log_lam - lgamma(kk + 1)  # read where kk >= 0
        accept1 = (u_shifted >= 0.07) & (v <= v_r)
        reject = (kk < 0) | ((u_shifted < 0.013) & (v > u_shifted))
        accept = accept1 | (~reject & (s <= t))
        running = (~accepted).reshape(flat).any(-1)
        accept = accept & running.reshape(*running.shape,
                                          *([1] * len(shape)))
        k_out = torch.where(accept, kk, k_out)
        accepted = accepted | accept
    return k_out, (~accepted).sum()


def poisson(k, lam: Tensor, lam_max: float) -> Tensor:
    """``jax.random.poisson(k, lam)`` (``_poisson``) for every key: ``lam``
    has ``k``'s shape + the draw's shape, and no rate above ``lam_max`` (a
    static bound that sizes the loops). Rates below 10 take Knuth's method,
    the others Hormann's rejection, as in JAX; where no rate reaches 10 the
    rejection loop, whose draws would all be discarded, is not run. Each
    loop runs to a fixed cap and adds the draws it cut to the device's
    ``unfinished`` counter (``check_poisson``). Returns int64 counts."""
    shape = lam.shape[k[0].dim():]
    use_knuth = torch.isnan(lam) | (lam < KNUTH_LIMIT)
    zero = torch.zeros_like(lam)
    out, cut = _poisson_knuth(k, torch.where(use_knuth, lam, zero), shape,
                              knuth_iters(lam_max))
    if lam_max >= KNUTH_LIMIT:
        rej, cut_r = _poisson_rejection(
            k, torch.where(use_knuth, zero + 1e5, lam), shape, REJECTION_ITERS)
        out = torch.where(use_knuth, out, rej.to(torch.int64))
        cut = cut + cut_r
    unfinished(lam.device).add_(cut)
    return torch.where(lam == 0, torch.zeros_like(out), out)
