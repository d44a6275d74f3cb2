"""The port's threefry2x32 (clearvae_torch.ops.prng) is bit-equal to
``jax.random`` for the draws the Styled-MNIST styler makes, and zigzag's
draws are the JAX package's (corruptions.py:511-515)."""

import jax
import numpy as np
import pytest
import torch

from clearvae_torch.ops import prng as P
from clearvae_torch.ops.corruptions import style_draws

# 4096 ids: small ones, ones past 2^16, and the top of the int32 range
IDS = np.concatenate([np.arange(1024), 65530 + np.arange(1024) * 977,
                      np.arange(2 ** 31 - 2048, 2 ** 31 - 1024),
                      np.arange(2 ** 31 - 1024, 2 ** 31)]).astype(np.int32)


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One intra-op thread: these small CPU workloads run several to a
    machine under the parallel test run, where more threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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
    r0, dr = style_draws(seed, ids)[:, :2].unbind(1)
    np.testing.assert_array_equal(r0.numpy(), np.asarray(jr0))
    np.testing.assert_array_equal(dr.numpy(), np.asarray(jdr))
    small = slice(0, 1064)               # keyed by id, not by position
    r0, dr = style_draws(seed, ids[small].flip(0))[:, :2].unbind(1)
    np.testing.assert_array_equal(r0.flip(0).numpy(), np.asarray(jr0)[small])
    np.testing.assert_array_equal(dr.flip(0).numpy(), np.asarray(jdr)[small])


def _keys(seed, n):
    ids = IDS[:n]
    base = jax.random.key(seed)
    return (jax.vmap(lambda i: jax.random.fold_in(base, i))(ids),
            P.fold_in(P.key(seed, (n,)), torch.as_tensor(ids)))


@pytest.mark.parametrize("shape,lo,hi", [((), 0.0, 1.0), ((3, 2), -2.8, 2.8),
                                         ((28, 28), -45.0, 45.0),
                                         ((16, 16), -100 / 1.7, 100 / 1.7)])
def test_uniform_bit_equal(shape, lo, hi):
    jk, tk = _keys(5, 256)
    ref = jax.vmap(lambda k: jax.random.uniform(k, shape, minval=lo,
                                                maxval=hi))(jk)
    np.testing.assert_array_equal(P.uniform(tk, shape, lo, hi).numpy(),
                                  np.asarray(ref))


@pytest.mark.parametrize("shape", [(), (2,), (1352,)])
def test_bernoulli_bit_equal(shape):
    jk, tk = _keys(6, 256)
    ref = jax.vmap(lambda k: jax.random.bernoulli(k, 0.5, shape))(jk)
    np.testing.assert_array_equal(P.bernoulli(tk, 0.5, shape).numpy(),
                                  np.asarray(ref))


@pytest.mark.parametrize("shape,lo,hi", [((2,), 0, 27), ((1352, 2), -1, 1),
                                         ((800, 2), -4, 4)])
def test_shaped_randint_bit_equal(shape, lo, hi):
    jk, tk = _keys(7, 256)
    ref = jax.vmap(lambda k: jax.random.randint(k, shape, lo, hi))(jk)
    np.testing.assert_array_equal(P.randint(tk, lo, hi, shape).numpy(),
                                  np.asarray(ref).astype(np.int64))


@pytest.mark.parametrize("num", [3, 4])
def test_split_three_and_four_bit_equal(num):
    jk, tk = _keys(8, 1024)
    ref = jax.vmap(lambda k: jax.random.split(k, num))(jk)
    for i, t in enumerate(P.split(tk, num)):
        for a, b in zip(_np(t), _jax_pairs(ref[:, i])):
            np.testing.assert_array_equal(a, b)


def test_normal_draws_jax_normals():
    """Bit-equal uniforms; erfinv's log1p is an ulp apart from XLA's in a
    few inputs, so a normal may be too (1e-6 absolute)."""
    jk, tk = _keys(9, 256)
    ref = np.asarray(jax.vmap(lambda k: jax.random.normal(k, (28, 28)))(jk))
    np.testing.assert_allclose(P.normal(tk, (28, 28)).numpy(), ref, rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("lam_max,share", [
    # Knuth only: the counts are JAX's but where an ulp of log flips the
    # log product's crossing of -lam
    (3.0, 1e-3), (9.9, 1e-3),
    # rejection too: lgamma near 1e5 (the rate of the Knuth pixels' dummy
    # draw) an ulp from XLA's flips an acceptance, which moves the end of
    # the whole draw's loop and so its later overwrites
    (12.0, 0.02), (60.0, 0.02)])
def test_poisson_counts_are_jax_counts(lam_max, share):
    jk, tk = _keys(10, 64)
    lam = (np.random.RandomState(0).rand(64, 28, 28) * lam_max).astype(np.float32)
    lam[:, :4] = 0.0
    ref = np.asarray(jax.jit(jax.vmap(jax.random.poisson))(jk, lam))
    P.unfinished("cpu").zero_()
    got = P.poisson(tk, torch.as_tensor(lam), lam_max).numpy()
    P.check_poisson("cpu")
    knuth = lam < 10
    assert (got[knuth] != ref[knuth]).mean() <= 1e-3
    assert (got != ref).mean() <= share
    assert (got[:, :4] == 0).all() and got.min() >= 0


def test_poisson_cap_is_counted_not_silent():
    """A loop cut short adds its running draws to the device's counter, and
    check_poisson raises on it."""
    jk, tk = _keys(11, 8)
    lam = torch.full((8, 28, 28), 9.5)
    counter = P.unfinished("cpu")
    counter.zero_()
    P.poisson(tk, lam, 9.5)
    P.check_poisson("cpu")                      # poisson's own cap held
    _, cut = P._poisson_knuth(tk, lam, (28, 28), 3)   # too few turns
    counter.add_(cut)
    assert int(counter) > 0.9 * 8 * 28 * 28
    with pytest.raises(RuntimeError, match="did not finish"):
        P.check_poisson("cpu")
    counter.zero_()


def test_poisson_cut_by_its_own_loop_is_counted():
    """poisson's own loop, sized for rates below the ones drawn, adds the
    draws it cut to the counter of the rates' device."""
    _, tk = _keys(12, 8)
    counter = P.unfinished("cpu")
    counter.zero_()
    P.poisson(tk, torch.full((8, 28, 28), 9.5), 0.0)     # 10 turns
    assert int(counter) > 0.2 * 8 * 28 * 28
    with pytest.raises(RuntimeError, match="did not finish"):
        P.check_poisson("cpu")
    counter.zero_()


def test_poisson_counter_of_cuda_is_that_of_the_current_card(monkeypatch):
    """An entry point names its device ``cuda``; the draws write the counter
    of their tensors' device, ``cuda:0``. Both name one counter, which
    check_poisson reads."""
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    assert P._counter_key("cuda") == P._counter_key("cuda:0") == "cuda:0"
    assert P._counter_key(torch.device("cuda")) == "cuda:0"
    assert P._counter_key("cuda:1") == "cuda:1"
    assert P._counter_key("cpu") == "cpu"
    monkeypatch.setitem(P._UNFINISHED, "cuda:0", torch.tensor(3))
    with pytest.raises(RuntimeError, match="3 Poisson draws on cuda:0"):
        P.check_poisson("cuda")
