"""The port's ``InferenceSession`` against the JAX package's on bridged
weights (encode, deterministic reconstruct, swap, interpolate on both
halves; atol 1e-5), its checkpoint and live-trainer constructors, and the
input canonicalization of tests/test_utils.py:169-238."""

import functools

import jax
import numpy as np
import pytest
import torch

from clearvae_tpu.models.vae import VAE as JVAE
from clearvae_tpu.serve import InferenceSession as JSession
from clearvae_tpu.train.steps import init_vae_state
from clearvae_torch.bridge import params_from_flax
from clearvae_torch.data.mnist import synthetic_mnist
from clearvae_torch.data.styled import make_styled_mnist
from clearvae_torch.models.vae import VAE as TVAE
from clearvae_torch.serve import InferenceSession
from clearvae_torch.train.factories import get_clearvae_trainer


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """These tiny CPU fits gain nothing from intra-op threads, and with
    several test workers on the machine the threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ATOL = 1e-5


@functools.lru_cache(maxsize=1)
def _sessions():
    """Both sessions on one random VAE whose BatchNorm running statistics
    are random too (eval mode reads them), and a batch of styled digits."""
    import optax

    jm = JVAE(total_z_dim=16)
    state = init_vae_state(jm, optax.adam(1e-3), jax.random.key(3), 28, 1)
    rs = np.random.RandomState(4)
    stats = jax.tree.map(
        lambda a: (rs.rand(*a.shape) + 0.5).astype(np.float32)
        if a.ndim else a, jax.tree.map(np.asarray, state.batch_stats))
    stats = jax.tree_util.tree_map_with_path(
        lambda p, a: a - 1.0 if str(p[-1]).find("mean") >= 0 else a, stats)
    params = jax.tree.map(np.asarray, state.params)
    jsess = JSession(jm, params, stats)
    tm = TVAE(total_z_dim=16)
    tm.load_state_dict(params_from_flax(params, stats))
    tsess = InferenceSession(tm, device="cpu")
    ds = make_styled_mnist(*synthetic_mnist(8, seed=6), seed=6)
    x = ds.materialize("cpu").numpy()[..., None]
    return jsess, tsess, x


def _close(got, want):
    np.testing.assert_allclose(got.cpu().numpy(), np.asarray(want), atol=ATOL)


def test_encode_and_reconstruct_match_jax():
    jsess, tsess, x = _sessions()
    for got, want in zip(tsess.encode(x), jsess.encode(x)):
        assert got.shape == (8, 8)
        _close(got, want)
    rec = tsess.reconstruct(x)
    assert rec.shape == (8, 28, 28, 1)
    _close(rec, jsess.reconstruct(x))
    z = np.random.RandomState(1).randn(3, 16).astype(np.float32)
    _close(tsess.decode(z), jsess.decode(z))


def test_swap_matches_jax():
    jsess, tsess, x = _sessions()
    out = tsess.swap(x[:4], x[4:])
    assert out.shape == (4, 28, 28, 1)
    _close(out, jsess.swap(x[:4], x[4:]))


@pytest.mark.parametrize("what", ["style", "content"])
def test_interpolate_matches_jax(what):
    jsess, tsess, x = _sessions()
    strip = tsess.interpolate(x[0], x[1], num_steps=5, what=what)
    assert strip.shape == (5, 28, 28, 1)
    _close(strip, jsess.interpolate(x[0], x[1], num_steps=5, what=what))


def test_interpolate_latent_matches_jax():
    from clearvae_tpu.utils.visual import interpolate_latent as jinterp
    from clearvae_torch.utils.visual import interpolate_latent

    rs = np.random.RandomState(2)
    a, b = rs.randn(8).astype(np.float32), rs.randn(8).astype(np.float32)
    got = interpolate_latent(torch.as_tensor(a), torch.as_tensor(b), 11)
    assert got.shape == (11, 8)
    _close(got, jinterp(a, b, 11))
    np.testing.assert_array_equal(got[0].numpy(), a)


def test_canonicalization_and_nchw_raises():
    _, sess, x = _sessions()
    heads = sess.encode(x)
    np.testing.assert_allclose(sess.encode(x[..., 0])[0].numpy(),
                               heads[0].numpy(), atol=1e-6)
    assert sess.encode(x[0, :, :, 0])[0].shape == (1, 8)
    assert sess.encode(x[0])[0].shape == (1, 8)
    assert sess.encode(torch.as_tensor(x[0]))[0].shape == (1, 8)
    assert sess.reconstruct(x[..., 0]).shape == (8, 28, 28, 1)
    with pytest.raises(ValueError, match="NHWC"):
        sess.encode(np.transpose(x, (0, 3, 1, 2)))  # torch-style NCHW


def test_from_checkpoint_equals_from_trainer(tmp_path):
    ds = make_styled_mnist(*synthetic_mnist(64, seed=6), seed=6)
    t = get_clearvae_trainer(beta=1 / 8, ps=True, vae_lr=5e-4, z_dim=16,
                             alpha=100.0, temperature=0.1, seed=6,
                             mig_backend="numpy", device="cpu")
    t.fit(1, ds, batch_size=32, checkpoint_dir=str(tmp_path / "ck"),
          checkpoint_every=1)
    sess = InferenceSession.from_checkpoint(TVAE(total_z_dim=16),
                                            str(tmp_path / "ck"),
                                            device="cpu")
    live = InferenceSession.from_trainer(t)
    assert not sess.model.training and not live.model.training
    x = ds.materialize("cpu").numpy()[:8, ..., None]
    rec = sess.reconstruct(x)
    assert rec.shape == (8, 28, 28, 1)
    np.testing.assert_allclose(live.reconstruct(x).numpy(), rec.numpy(),
                               atol=1e-6)
    # a snapshot: training on does not move the live session
    before = live.reconstruct(x)
    t.fit(1, ds, batch_size=32, start_epoch=1)
    assert torch.equal(live.reconstruct(x), before)
    # sampled reconstruction: its own seeded generator, repeatable
    s1 = sess.reconstruct(x, sample=True, seed=3)
    assert s1.shape == (8, 28, 28, 1)
    assert torch.equal(s1, sess.reconstruct(x, sample=True, seed=3))
    assert not torch.equal(s1, sess.reconstruct(x, sample=True, seed=4))
