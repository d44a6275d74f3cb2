"""The port's corruption library (clearvae_torch.ops.corruptions) against
the JAX package's: every one of the 32 names of ``ALL_CORRUPTIONS`` at its
default severity, and one more severity where severity changes the code
path, on the same numpy-seeded digits under the same threefry keys
fold_in(key(seed), sample id); each row styled alone equals it styled in a
batch; the disk kernels computed without OpenCV; a MNIST-C Styled-MNIST
materialized in both packages.

Bars, on the 0..255 scale: ``atol`` for every pixel but a share ``share`` of
them, where an outcome is discrete (a threshold, a rounding, a uint8
truncation, a Poisson count) and a float rounding apart from XLA's moves a
pixel across it. Float differences come from the transcendental functions
(log, exp, sin, cos differ from XLA's CPU code by an ulp in a few inputs),
from the order of the sums in matmuls and convolutions, and from fused
multiply-adds that XLA's CPU code contracts."""

import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clearvae_torch.data import styled as TS
from clearvae_torch.data.mnist import synthetic_mnist
from clearvae_torch.ops import corruptions as TC
from clearvae_torch.ops import prng as P
from clearvae_tpu.data import styled as JS
from clearvae_tpu.ops import corruptions as JC

SEED = 9
B = 16
# (atol, share of pixels allowed beyond atol); the default (1e-3, 0)
BARS = {
    # the anti-aliased line's log: zigzag's bar in tests/test_torch_data.py
    "line": (5e-3, 0.0), "dotted_line": (5e-3, 0.0), "zigzag": (5e-3, 0.0),
    # solve and inverse of the drawn affine in closed form, not by LU
    "elastic_transform": (5e-3, 0.0),
    # the 196-term products of the noise and the matrix summed one row at
    # a time (bmm), in another order than XLA's dot
    "pessimal_noise": (5e-3, 0.0),
    # pixels moved across a discrete outcome by a float rounding
    "glass_blur": (1e-3, 0.005),        # the uint8 truncation after a blur
    "frost": (1e-3, 0.005),             # tex > 0.55
    "snow": (1e-3, 0.005),              # layer < c, round(layer·255)
    "spatter": (1e-3, 0.005),           # liquid < c, m < 0.8
    "jpeg_compression": (1e-3, 0.005),  # round(coef / table)
    "shot_noise": (1e-3, 0.002),        # Knuth: log-product vs -lam
}
# severities that take another code path than the default's
EXTRA = [("shot_noise", 1), ("defocus_blur", 5), ("glass_blur", 5),
         ("elastic_transform", 3)]
# Hormann's rejection reads lgamma near 1e5 for the pixels that Knuth
# draws (their rejection rate is 1e5); an ulp there flips an acceptance,
# which changes when a whole image's loop ends and so its late overwrites
REJECTION_BAR = (1e-3, 0.02)


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """Small CPU batches gain nothing from intra-op threads, and with
    several test workers on the machine the threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def digits():
    imgs, _ = synthetic_mnist(B, seed=1)
    return imgs.astype(np.float32)


def _keys():
    ids = np.arange(B, dtype=np.int32)
    jk = jax.vmap(lambda i: jax.random.fold_in(jax.random.key(SEED), i))(ids)
    tk = P.fold_in(P.key(SEED, (B,)), torch.as_tensor(ids))
    return jk, tk


def _jax(name, severity, imgs, jk):
    fn = JC.CORRUPTION_FNS[name]
    one = ((lambda x, k: fn(x, k)) if severity is None
           else (lambda x, k: fn(x, k, severity)))
    return np.asarray(jax.jit(jax.vmap(one))(jnp.asarray(imgs), jk))


def _port(name, severity, imgs, tk):
    fn = TC.CORRUPTION_FNS[name]
    x = torch.as_tensor(imgs)
    return (fn(x, tk) if severity is None else fn(x, tk, severity)).numpy()


def _hold(got, ref, atol, share):
    assert got.shape == ref.shape and np.isfinite(got).all()
    off = np.abs(got.astype(np.float64) - ref) > atol
    assert off.mean() <= share, (
        f"{off.mean():.5f} of pixels beyond {atol} (bar {share}); max "
        f"{np.abs(got - ref).max():.3e}")


@pytest.mark.parametrize("name", JC.ALL_CORRUPTIONS)
def test_corruption_matches_jax_at_its_default_severity(digits, name):
    jk, tk = _keys()
    got, ref = _port(name, None, digits, tk), _jax(name, None, digits, jk)
    _hold(got, ref, *BARS.get(name, (1e-3, 0.0)))
    assert got.min() >= 0.0 and got.max() <= 255.0


@pytest.mark.parametrize("name,severity", EXTRA)
def test_corruption_matches_jax_on_its_other_path(digits, name, severity):
    jk, tk = _keys()
    got, ref = (_port(name, severity, digits, tk),
                _jax(name, severity, digits, jk))
    bar = REJECTION_BAR if name == "shot_noise" else BARS.get(name, (1e-3, 0.0))
    _hold(got, ref, *bar)


@pytest.mark.parametrize("name", JC.ALL_CORRUPTIONS)
def test_a_row_does_not_depend_on_its_batch(digits, name):
    """8 images styled together equal each styled alone, bit for bit."""
    _, tk = _keys()
    batch = _port(name, None, digits[:8], (tk[0][:8], tk[1][:8]))
    for i in range(8):
        alone = _port(name, None, digits[i:i + 1], (tk[0][i:i + 1],
                                                    tk[1][i:i + 1]))
        np.testing.assert_array_equal(batch[i], alone[0], err_msg=f"row {i}")


@pytest.mark.parametrize("radius,alias_blur",
                         [(3, 0.1), (4, 0.5), (6, 0.5), (8, 0.5), (10, 0.5)])
def test_disk_kernel_without_opencv(radius, alias_blur):
    """defocus_blur's kernels (cv2's Gaussian taps, BORDER_REFLECT_101)
    against the JAX package's, which OpenCV blurs; radius 10 takes the
    other ksize and span."""
    got = TC._disk_kernel(radius, alias_blur)
    ref = JC._disk_kernel(radius, alias_blur)
    assert got.shape == ref.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-8)


# K3's styles, zigzag and canny on their draws, and random styles keyed by
# the row's key
MIXED = (("identity", None), ("stripe", None), ("zigzag", None),
         ("canny_edges", None), ("scale", 5), ("shot_noise", None),
         ("gaussian_noise", None), ("rotate", None))


def test_batched_style_matches_jax(digits):
    """batched_style keys row i by split(key, B)[i], as JAX's does: each row
    against JAX's at its style's bar."""
    idx = np.arange(B) % len(MIXED)
    ref = np.asarray(jax.jit(lambda x, i, k: JC.batched_style(x, i, k, MIXED))(
        jnp.asarray(digits), jnp.asarray(idx), jax.random.key(SEED)))
    got = TC.batched_style(torch.as_tensor(digits), torch.as_tensor(idx),
                           P.key(SEED), MIXED).numpy()
    for code, (name, _) in enumerate(MIXED):
        rows = idx == code
        _hold(got[rows], ref[rows], *BARS.get(name, (1e-3, 0.0)))


def test_registry_is_the_jax_packages():
    assert TC.ALL_CORRUPTIONS == JC.ALL_CORRUPTIONS
    assert TC.CORRUPTIONS == JC.CORRUPTIONS
    assert sorted(TC.CORRUPTION_FNS) == sorted(JC.CORRUPTION_FNS)


def test_materialize_mnist_c_matches_jax():
    """A 64-image Styled-MNIST on MNIST-C's 16 styles, materialized in
    chunks of 24 (a padded last chunk) on the CPU, against JAX's."""
    imgs, labels = synthetic_mnist(64, seed=3)
    styles = tuple((n, None) for n in TC.CORRUPTIONS)
    td = TS.make_styled_mnist(imgs, labels, styles=styles, seed=5)
    jd = JS.make_styled_mnist(imgs, labels, styles=styles, seed=5)
    np.testing.assert_array_equal(td.style_idx, jd.style_idx)
    assert len(set(td.style_idx.tolist())) >= 14
    got = td.materialize("cpu", device_batch=24).numpy()
    ref = jd.materialize()
    for code, (name, _) in enumerate(styles):
        rows = td.style_idx == code
        if rows.any():
            atol, share = BARS.get(name, (1e-3, 0.0))
            _hold(got[rows] * 255.0, ref[rows] * 255.0, atol * 1.01, share)


# ---------------------------------------------------------------------------
# the host styler (csrc/host_ops.cpp corrupt_batch)
# ---------------------------------------------------------------------------

NATIVE = ["identity", "stripe", "brightness", "inverse", "quantize",
          "contrast", "scale"]


@pytest.fixture(scope="module")
def native():
    if shutil.which("g++") is None:
        pytest.skip("no g++: the native host library cannot build")
    from clearvae_tpu.native import bindings as JN
    from clearvae_torch.native import bindings as TN

    assert TN.available() and JN.available()
    return TN, JN


@pytest.mark.parametrize("severity", [1, 2, 3, 4, 5])
def test_host_styler_is_the_jax_packages(native, severity):
    """The port's corrupt_batch gives the JAX package's bits, every style at
    every severity, and holds to the JAX functions at tests/test_native.py's
    bars (0.01, scale 0.05 on the 0..255 scale)."""
    TN, JN = native
    imgs = (np.random.RandomState(severity).rand(14, 28, 28) * 255
            ).astype(np.float32)
    idx = (np.arange(14) % len(NATIVE)).astype(np.int32)
    got = TN.corrupt_batch_native(imgs, NATIVE, idx, severity=severity)
    np.testing.assert_array_equal(
        got, JN.corrupt_batch_native(imgs, NATIVE, idx, severity=severity))
    for i, code in enumerate(idx):
        name = NATIVE[code]
        fn = JC.CORRUPTION_FNS[name]
        ref = np.asarray(fn(jnp.asarray(imgs[i]), None, severity))
        np.testing.assert_allclose(got[i], ref, rtol=0, err_msg=name,
                                   atol=0.05 if name == "scale" else 0.01)


def test_host_styler_rejects_other_styles(native):
    TN, _ = native
    with pytest.raises(KeyError):
        TN.corrupt_batch_native(np.zeros((1, 28, 28), np.float32),
                                ["fog"], np.zeros(1, np.int32))
