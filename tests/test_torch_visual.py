"""Parity of the port's qualitative figures (clearvae_torch.utils.visual)
with the JAX package's: the swap grid and the interpolation strips, fed
one shared numpy decode function in both packages, within 1e-6;
``make_decode_fn`` on bridged VAE weights within 1e-5; ``tsne_plot`` on a
few dozen points writes its four plots. The numpy grids are
``test_torch_grids.py``'s."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clearvae_tpu.models.vae import VAE as JVAE
from clearvae_tpu.utils import visual as JV
from clearvae_torch.bridge import params_from_flax
from clearvae_torch.models.vae import VAE as TVAE
from clearvae_torch.utils import visual as TV

Z = 8           # z_c = z_s = 4 in the shared decoder
HW = 7


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for torch and one for the BLAS and OpenMP pools
    (sklearn's t-SNE): the parallel test run puts several workers on a
    machine, where more threads only contend (a 40-point t-SNE took
    minutes there with OpenMP's default, under a second with one)."""
    from threadpoolctl import threadpool_limits

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(limits=1):
        yield
    torch.set_num_threads(n)


def _imgs(n, c, seed=0):
    return np.random.RandomState(seed).rand(n, HW, HW, c).astype(np.float32)


def test_interpolate_latent_matches_jax():
    rs = np.random.RandomState(2)
    a, b = rs.randn(2, 16).astype(np.float32)
    for steps in (1, 2, 11):
        got = TV.interpolate_latent(torch.as_tensor(a), torch.as_tensor(b),
                                    steps).numpy()
        ref = np.asarray(JV.interpolate_latent(jnp.asarray(a), jnp.asarray(b),
                                               steps))
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


def _decoder(c):
    """One numpy decode function for both packages: latents [n, Z] (a jax
    or torch array) → [n, 7, 7, c] in (0, 1)."""
    w = np.random.RandomState(7).randn(Z, HW * HW * c).astype(np.float32)

    def decode(z):
        z = np.asarray(z, np.float32)
        return (1 / (1 + np.exp(-(z @ w)))).reshape(len(z), HW, HW, c)

    return decode


@pytest.mark.parametrize("c", [1, 3])
def test_feature_swapping_plot_matches_jax(c, tmp_path):
    rs = np.random.RandomState(c)
    z = rs.randn(5, Z).astype(np.float32)
    x = _imgs(5, c, seed=c)
    decode = _decoder(c)
    got = TV.feature_swapping_plot(torch.as_tensor(z[:, :Z // 2]),
                                   torch.as_tensor(z[:, Z // 2:]), x, decode,
                                   save=str(tmp_path / "swap.png"))
    ref = JV.feature_swapping_plot(z[:, :Z // 2], z[:, Z // 2:], x, decode)
    assert got.shape == ref.shape == (58, 58, 3)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    assert os.path.getsize(tmp_path / "swap.png") > 0


@pytest.mark.parametrize("c", [1, 3])
def test_interpolation_plot_and_display_util_match_jax(c, tmp_path):
    rs = np.random.RandomState(10 + c)
    z = rs.randn(12, Z).astype(np.float32)
    x = _imgs(12, c, seed=20 + c)
    decode = _decoder(c)
    prefix = str(tmp_path / "interp")
    got = TV.interpolation_plot(x, torch.as_tensor(z), decode, z_dim=Z // 2,
                                sample_size=4, inter_steps=5, seed=3,
                                save_prefix=prefix)
    ref = JV.interpolation_plot(x, z, decode, z_dim=Z // 2, sample_size=4,
                                inter_steps=5, seed=3)
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        np.testing.assert_allclose(g, r, rtol=0, atol=1e-6)
    assert all(os.path.exists(f"{prefix}-{k}.png") for k in ("style", "content"))
    got = TV.display_util(2, 9, torch.as_tensor(z), decode, z_dim=Z // 2)
    ref = JV.display_util(2, 9, z, decode, z_dim=Z // 2)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g, r, rtol=0, atol=1e-6)


def test_make_decode_fn_matches_jax_on_bridged_weights():
    jm = JVAE(total_z_dim=16)
    variables = jax.jit(lambda k: jm.init({"params": k, "reparam": k},
                                          jnp.zeros((2, 28, 28, 1))))(
        jax.random.key(4))
    # eval-mode decode reads the running statistics: make them non-trivial
    stats = jax.tree.map(lambda a: a + 0.1 * jnp.abs(jnp.sin(
        jnp.arange(a.size, dtype=a.dtype).reshape(a.shape))),
        variables["batch_stats"])
    state = type("S", (), {"params": variables["params"],
                           "batch_stats": stats})()
    tm = TVAE(total_z_dim=16)
    tm.load_state_dict(params_from_flax(jax.tree.map(np.asarray, state.params),
                                        jax.tree.map(np.asarray, stats)))
    z = np.random.RandomState(5).randn(9, 16).astype(np.float32)
    ref = np.asarray(JV.make_decode_fn(jm, state)(jnp.asarray(z)))
    decode = TV.make_decode_fn(tm)
    for arg in (z, torch.as_tensor(z)):
        got = decode(arg)
        assert isinstance(got, np.ndarray) and got.shape == (9, 28, 28, 1)
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


def test_tsne_plot_writes_four_plots(tmp_path):
    rs = np.random.RandomState(0)
    n = 40
    labels, styles = rs.randint(0, 4, n), rs.randint(0, 3, n)
    mu_c = rs.randn(n, 4).astype(np.float32) + labels[:, None]
    mu_s = torch.as_tensor(rs.randn(n, 4).astype(np.float32))
    prefix = str(tmp_path / "t")
    emb_c, emb_s = TV.tsne_plot(mu_c, mu_s, labels, styles, save_prefix=prefix)
    assert emb_c.shape == emb_s.shape == (n, 2)
    assert np.isfinite(emb_c).all() and np.isfinite(emb_s).all()
    for name in ("muc-by-class", "muc-by-style", "mus-by-style",
                 "mus-by-class"):
        assert os.path.getsize(f"{prefix}-{name}.png") > 0


def test_save_writes_exact_pixels_without_matplotlib(tmp_path, monkeypatch):
    """``_save`` writes the grid's own pixels with PIL, matplotlib or not."""
    from PIL import Image

    monkeypatch.setitem(sys.modules, "matplotlib", None)
    grid = TV.make_grid(_imgs(3, 3), nrow=2)
    TV._save(grid, str(tmp_path / "g.png"))
    back = np.asarray(Image.open(tmp_path / "g.png"), np.float32) / 255
    assert back.shape == grid.shape
    np.testing.assert_allclose(back, grid, rtol=0, atol=0.5 / 255 + 1e-7)
