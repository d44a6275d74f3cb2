"""K3 (clearvae_torch.ops.kernels.style) against the JAX package's Pallas
style kernel, run in interpret mode on the CPU as tests/test_pallas.py runs
it, and the styler's K3 routing against the JAX styler."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clearvae_tpu.data.styled import style_batch as jax_style_batch
from clearvae_tpu.ops.corruptions import make_style_fn
from clearvae_tpu.ops.pallas import style_kernel as JK
from clearvae_torch.data.mnist import synthetic_mnist
from clearvae_torch.ops import corruptions as TC
from clearvae_torch.ops.kernels import style as K3

CODES = np.arange(14, dtype=np.int32) % 7      # every code, twice


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One intra-op thread: these small CPU workloads run several to a
    machine under the parallel test run, where more threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def batch():
    imgs, _ = synthetic_mnist(14, seed=3)
    noisy = np.random.RandomState(0).rand(14, 28, 28).astype(np.float32) * 255
    return np.where(np.arange(14)[:, None, None] % 2 == 0, imgs, noisy)


def test_tables_match_the_tpu_kernel():
    assert K3.STYLE_CODES == JK.STYLE_CODES
    for sev in range(1, 6):
        np.testing.assert_array_equal(
            K3._interp_matrix(28, K3._SCALE[sev - 1], 13.5),
            JK._interp_matrix(28, JK._SCALE[sev - 1], 13.5))


@pytest.mark.parametrize("severity", [1, 2, 3, 4, 5])
def test_style_plain_matches_pallas(batch, severity):
    ref = np.asarray(JK.pallas_style_batch(jnp.asarray(batch),
                                           jnp.asarray(CODES), severity))
    got = K3.style_plain(torch.as_tensor(batch), torch.as_tensor(CODES),
                         severity)
    # 0..255 scale; the two differ by float rounding only (~3e-5 measured)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-3, rtol=0)


@pytest.mark.parametrize("severity", [1, 2, 3, 4, 5])
def test_style_plain_out_leaves_negative_code_rows(batch, severity):
    """Rows of negative code keep ``out``'s prior contents bit for bit; the
    others are styled as the Pallas kernel styles them."""
    codes = np.where(np.arange(14) % 3 == 1, -1, CODES).astype(np.int32)
    prior = np.random.RandomState(severity).rand(14, 28, 28).astype(np.float32)
    out = torch.as_tensor(prior.copy())
    got = K3.style_plain(torch.as_tensor(batch), torch.as_tensor(codes),
                         severity, out=out)
    assert got is out
    mine = codes >= 0
    assert np.array_equal(out.numpy()[~mine], prior[~mine])
    ref = np.asarray(JK.pallas_style_batch(jnp.asarray(batch),
                                           jnp.asarray(CODES), severity))
    np.testing.assert_allclose(out.numpy()[mine], ref[mine], atol=1e-3,
                               rtol=0)


def test_wrapper_takes_the_twin_on_cpu_and_checks_inputs(batch):
    K3.reset_launches()
    x, c = torch.as_tensor(batch), torch.as_tensor(CODES)
    assert torch.equal(K3.style_batch_kernel(x, c, 5), K3.style_plain(x, c, 5))
    out = torch.zeros_like(x)
    assert K3.style_batch_kernel(x, c, 5, out=out) is out
    assert torch.equal(out, K3.style_plain(x, c, 5))
    assert K3.LAUNCHES["style"] == 0
    for bad in ((x.double(), c, 5), (x[:, :, :27].contiguous(), c, 5),
                (x.transpose(1, 2), c, 5), (x, c.long(), 5), (x, c[:3], 5),
                (x, c, 0), (x, c, 6), (x, c, 5, x), (x, c, 5, out[:3]),
                (x, c, 5, out.double()), (x, c, 5, out.transpose(1, 2))):
        with pytest.raises(ValueError):
            K3.style_batch_kernel(*bad)


def _jax_styled(styles, imgs, style_idx, seed):
    ids = np.arange(len(imgs), dtype=np.int32)
    return np.asarray(jax_style_batch(make_style_fn(styles), jnp.asarray(imgs),
                                      jnp.asarray(style_idx), jnp.asarray(ids),
                                      jax.random.key(seed)))


@pytest.mark.parametrize("styles", [
    TC.EXPERIMENT_STYLES,
    (("zigzag", None), ("contrast", None), ("scale", 5), ("inverse", None),
     ("quantize", 2), ("brightness", 3), ("stripe", None))])
def test_style_batch_routes_k3_and_matches_jax(batch, styles, monkeypatch):
    style_idx = np.arange(len(batch), dtype=np.int32) % len(styles)
    ref = _jax_styled(styles, batch, style_idx, 4)
    draws = TC.style_draws(4, torch.arange(len(batch)))
    calls = []

    def counting(x, code, severity, out=None):
        calls.append((tuple(x.shape), severity, out is not None))
        return K3.style_batch_kernel(x, code, severity, out=out)

    monkeypatch.setattr(TC, "style_batch_kernel", counting)
    got = TC.style_batch(torch.as_tensor(batch), torch.as_tensor(style_idx),
                         draws, styles)
    # one K3 call per severity group, each over the whole batch, in place
    groups = TC.k3_groups(styles)
    assert calls == [(batch.shape, sev, True) for sev in groups]
    zig = np.asarray([styles[i][0] == "zigzag" for i in style_idx])
    np.testing.assert_allclose(got.numpy()[~zig], ref[~zig], atol=1e-5, rtol=0)
    np.testing.assert_allclose(got.numpy()[zig], ref[zig], atol=2e-5, rtol=0)
    assert len(TC.k3_groups(styles)) == (1 if styles is TC.EXPERIMENT_STYLES
                                         else 4)
