"""Parity of the port's Styled-MNIST data (clearvae_torch.data, ops.image,
ops.corruptions) with the JAX package's: numpy parts bit-equal, the five
deterministic styles (four through K3's CPU twin) and zigzag against the JAX
styles, and the materialized datasets against JAX's."""

import gzip
import os
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clearvae_tpu.data import mnist as JM
from clearvae_tpu.data import styled as JS
from clearvae_tpu.ops import corruptions as JC
from clearvae_torch.data import mnist as TM
from clearvae_torch.data import styled as TS
from clearvae_torch.ops import corruptions as TC
from clearvae_torch.ops.kernels import style as K3


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One intra-op thread: these small CPU workloads run several to a
    machine under the parallel test run, where more threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def images():
    return JM.synthetic_mnist(24, seed=5)


def test_synthetic_mnist_bit_equal():
    for n, seed in ((17, 0), (40, 3)):
        ji, jl = JM.synthetic_mnist(n, seed=seed)
        ti, tl = TM.synthetic_mnist(n, seed=seed)
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_array_equal(tl, jl)
    ji, jl = JM.get_mnist(None, "test", n_synthetic=9, seed=2)
    ti, tl = TM.get_mnist(None, "test", n_synthetic=9, seed=2)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(tl, jl)


def test_load_mnist_idx(tmp_path):
    rs = np.random.RandomState(0)
    imgs = rs.randint(0, 256, (5, 28, 28)).astype(np.uint8)
    lbls = rs.randint(0, 10, 5).astype(np.uint8)
    raw = tmp_path / "MNIST" / "raw"
    os.makedirs(raw)
    with gzip.open(raw / "t10k-images-idx3-ubyte.gz", "wb") as f:
        f.write(struct.pack(">IIII", 2051, 5, 28, 28) + imgs.tobytes())
    with open(raw / "t10k-labels-idx1-ubyte", "wb") as f:
        f.write(struct.pack(">II", 2049, 5) + lbls.tobytes())
    for a, b in zip(TM.load_mnist(str(tmp_path), "test"),
                    JM.load_mnist(str(tmp_path), "test")):
        np.testing.assert_array_equal(a, b)


def test_style_assignment_and_splits_bit_equal(images):
    imgs, labels = images
    jd = JS.make_styled_mnist(imgs, labels, seed=4)
    td = TS.make_styled_mnist(imgs, labels, seed=4)
    np.testing.assert_array_equal(td.style_idx, jd.style_idx)
    probs = JS.random_style_distribution([n for n, _ in JC.EXPERIMENT_STYLES], 3)
    assert TS.random_style_distribution(
        [n for n, _ in TC.EXPERIMENT_STYLES], 3) == probs
    np.testing.assert_array_equal(
        TS.make_styled_mnist(imgs, labels, style_probs=probs, seed=1).style_idx,
        JS.make_styled_mnist(imgs, labels, style_probs=probs, seed=1).style_idx)
    jsd = JS.generate_style_dict(range(10), list(range(6)), 2,
                                 np.random.RandomState(7))
    tsd = TS.generate_style_dict(range(10), list(range(6)), 2,
                                 np.random.RandomState(7))
    for c in range(10):
        for part in ("train", "test"):
            np.testing.assert_array_equal(tsd[c][part], jsd[c][part])
    np.testing.assert_array_equal(
        TS.make_k_styled_mnist(imgs, labels, tsd, "test", seed=2).style_idx,
        JS.make_k_styled_mnist(imgs, labels, jsd, "test", seed=2).style_idx)
    for a, b in zip(TS.train_valid_split(td, seed=9),
                    JS.train_valid_split(jd, seed=9)):
        np.testing.assert_array_equal(a.labels, b.labels)
        np.testing.assert_array_equal(a.sample_ids, b.sample_ids)
        np.testing.assert_array_equal(a.style_idx, b.style_idx)


@pytest.mark.parametrize("name,severity,atol", [
    ("identity", None, 0.0), ("stripe", None, 0.0), ("brightness", 5, 1e-4),
    ("scale", 5, 1e-3), ("canny_edges", None, 0.0)])
def test_deterministic_styles_match_jax(images, name, severity, atol):
    imgs, _ = images
    jfn = JC.CORRUPTION_FNS[name]
    ref = np.stack([np.asarray(jfn(jnp.asarray(im)) if severity is None
                               else jfn(jnp.asarray(im), severity=severity))
                    for im in imgs])
    x = torch.as_tensor(imgs)
    if name in K3.STYLE_CODES:   # the port styles these through K3
        code = torch.full((len(imgs),), K3.STYLE_CODES[name], dtype=torch.int32)
        got = K3.style_batch_kernel(x, code, severity or 5)
    else:
        got = TC.CORRUPTION_FNS[name](x)
    np.testing.assert_allclose(got.numpy(), ref, atol=atol, rtol=0)


def test_zigzag_matches_jax_given_the_same_draws(images):
    imgs, _ = images
    keys = [jax.random.fold_in(jax.random.key(11), i) for i in range(len(imgs))]
    r0, dr, ref = [], [], []
    for im, key in zip(imgs, keys):
        k1, k2 = jax.random.split(key)  # the draws of corruptions.py:511-515
        r0.append(int(jax.random.randint(k1, (), 0, 27)))
        dr.append(int(jax.random.randint(k2, (), -5, 5)))
        ref.append(np.asarray(JC.zigzag(jnp.asarray(im), key)))
    got = TC.zigzag(torch.as_tensor(imgs), torch.as_tensor(r0),
                    torch.as_tensor(dr))
    # 0..255 scale; float rounding in the anti-aliased line's log moves a few
    # pixels by ~2e-3 (~1e-5 of the range)
    np.testing.assert_allclose(got.numpy(), np.stack(ref), atol=5e-3, rtol=0)


def test_zigzag_draws_keyed_by_seed_and_sample():
    ids = torch.arange(5000)
    r0, dr = TC.style_draws(3, ids)[:, :2].unbind(1)
    assert int(r0.min()) == 0 and int(r0.max()) == 26
    assert int(dr.min()) == -5 and int(dr.max()) == 4
    r0b, drb = TC.style_draws(3, ids[1234:1300])[:, :2].unbind(1)
    assert torch.equal(r0b, r0[1234:1300]) and torch.equal(drb, dr[1234:1300])
    r0c = TC.style_draws(4, ids)[:, 0]
    assert not torch.equal(r0c, r0)


def test_device_arrays_carry_jax_draws_of_absolute_ids(images):
    """A split half draws once for its own (non-contiguous) sample ids; row
    i of its draws is JAX's draw for sample id i of that half."""
    imgs, labels = images
    for half in TS.train_valid_split(TS.make_styled_mnist(imgs, labels, seed=8),
                                     seed=2):
        _, _, draws = half.device_arrays("cpu")
        keys = jax.vmap(lambda i: jax.random.split(
            jax.random.fold_in(jax.random.key(8), i)))(half.sample_ids)
        r0 = jax.vmap(lambda k: jax.random.randint(k, (), 0, 27))(keys[:, 0])
        dr = jax.vmap(lambda k: jax.random.randint(k, (), -5, 5))(keys[:, 1])
        np.testing.assert_array_equal(draws[:, :2].numpy(),
                                      np.stack([r0, dr], 1).astype(np.int64))
        # and each sample's own key, from which the other styles draw
        base = jax.random.key(8)
        keys = jax.vmap(lambda i: jax.random.key_data(
            jax.random.fold_in(base, i)))(half.sample_ids)
        np.testing.assert_array_equal(draws[:, 2:].numpy(),
                                      np.asarray(keys).astype(np.int64))


def test_materialize_matches_jax_outside_zigzag(images):
    """StyledDataset.materialize styles per sample on the device; all six
    styles, zigzag included (threefry-exact draws), equal the JAX path."""
    imgs, labels = images
    jd = JS.make_styled_mnist(imgs, labels, seed=6)
    td = TS.make_styled_mnist(imgs, labels, seed=6)
    got = td.materialize("cpu", device_batch=10).numpy()
    ref = jd.materialize()
    zig = td.style_idx == 2
    assert got.shape == ref.shape and zig.sum() >= 2 and (~zig).sum() > 10
    np.testing.assert_allclose(got[~zig], ref[~zig], atol=1e-5, rtol=0)
    # the 5e-3 bar on the 0..255 scale of the zigzag test above
    np.testing.assert_allclose(got[zig], ref[zig], atol=2e-5, rtol=0)
    assert got.min() >= 0.0 and got.max() <= 1.0
    assert td.materialize("cpu") is td.materialize("cpu")  # cached
