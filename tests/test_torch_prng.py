"""The port's threefry2x32 (clearvae_torch.ops.prng) is bit-equal to
``jax.random`` for the draws the Styled-MNIST styler makes, and zigzag's
draws are the JAX package's (corruptions.py:511-515)."""

import jax
import numpy as np
import pytest
import torch

from clearvae_torch.ops import prng as P
from clearvae_torch.ops.corruptions import zigzag_draws

# 4096 ids: small ones, ones past 2^16, and the top of the int32 range
IDS = np.concatenate([np.arange(1024), 65530 + np.arange(1024) * 977,
                      np.arange(2 ** 31 - 2048, 2 ** 31 - 1024),
                      np.arange(2 ** 31 - 1024, 2 ** 31)]).astype(np.int32)


def _jax_pairs(keys):
    data = np.asarray(jax.vmap(jax.random.key_data)(keys)).astype(np.int64)
    return data[..., 0], data[..., 1]


def _np(pair):
    return tuple(t.numpy() for t in pair)


@pytest.fixture(scope="module")
def ids():
    return torch.as_tensor(IDS)


@pytest.mark.parametrize("seed", [0, 7, 123])
def test_key_fold_in_split_bit_equal(seed, ids):
    base = jax.random.key(seed)
    assert [int(v) for v in jax.random.key_data(base)] == [
        int(t) for t in P.key(seed)]
    jfold = jax.vmap(lambda i: jax.random.fold_in(base, i))(IDS)
    tfold = P.fold_in(P.key(seed, ids.shape), ids)
    for a, b in zip(_np(tfold), _jax_pairs(jfold)):
        np.testing.assert_array_equal(a, b)
    jsplit = jax.vmap(lambda k: jax.random.split(k, 3))(jfold)   # [N, 3]
    for i, tk in enumerate(P.split(tfold, 3)):
        for a, b in zip(_np(tk), _jax_pairs(jsplit[:, i])):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seed", [0, 7, 123])
@pytest.mark.parametrize("lo,hi", [(0, 27), (-5, 5), (0, 2 ** 31 - 1),
                                   (-2 ** 31, 7)])
def test_randint_bit_equal(seed, lo, hi, ids):
    base = jax.random.key(seed)
    jfold = jax.vmap(lambda i: jax.random.fold_in(base, i))(IDS)
    ref = np.asarray(jax.vmap(lambda k: jax.random.randint(k, (), lo, hi))(jfold))
    got = P.randint(P.fold_in(P.key(seed, ids.shape), ids), lo, hi)
    np.testing.assert_array_equal(got.numpy(), ref.astype(np.int64))


@pytest.mark.parametrize("seed", [0, 7, 123])
def test_zigzag_draws_are_jax_draws(seed, ids):
    """r0 = randint(k1, 0, 27), dr = randint(k2, -5, 5) with (k1, k2) =
    split(fold_in(key(seed), sample_id))."""

    def draws(i):
        k1, k2 = jax.random.split(jax.random.fold_in(jax.random.key(seed), i))
        return (jax.random.randint(k1, (), 0, 27),
                jax.random.randint(k2, (), -5, 5))

    jr0, jdr = jax.vmap(draws)(IDS)
    r0, dr = zigzag_draws(seed, ids)
    np.testing.assert_array_equal(r0.numpy(), np.asarray(jr0))
    np.testing.assert_array_equal(dr.numpy(), np.asarray(jdr))
    small = slice(0, 1064)               # keyed by id, not by position
    r0, dr = zigzag_draws(seed, ids[small].flip(0))
    np.testing.assert_array_equal(r0.flip(0).numpy(), np.asarray(jr0)[small])
    np.testing.assert_array_equal(dr.flip(0).numpy(), np.asarray(jdr)[small])
