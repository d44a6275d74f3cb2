"""Parity of the port's VAE (clearvae_torch.models) with the JAX package's
flax VAE through the weight bridge, in train and eval mode."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clearvae_tpu.models.vae import VAE as JVAE
from clearvae_torch.bridge import params_from_flax
from clearvae_torch.models.layers import BatchNorm
from clearvae_torch.models.vae import VAE as TVAE

ATOL = 2e-5


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One intra-op thread: these small CPU workloads run several to a
    machine under the parallel test run, where more threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_tree(t):
    return jax.tree.map(np.asarray, t)


def _pair(fused_heads=False, first_conv_pack=False, seed=0):
    jm = JVAE(total_z_dim=16, fused_heads=fused_heads,
              first_conv_pack=first_conv_pack)
    variables = jm.init({"params": jax.random.key(seed),
                         "reparam": jax.random.key(1)}, jnp.zeros((2, 28, 28, 1)))
    tm = TVAE(total_z_dim=16, fused_heads=fused_heads,
              first_conv_pack=first_conv_pack)
    tm.load_state_dict(params_from_flax(_np_tree(variables["params"]),
                                        _np_tree(variables["batch_stats"])))
    return jm, variables, tm


def _eps_of(jm, variables, x, key, train):
    """The noise flax drew inside the forward, recovered from z (the recipe
    of scripts/reference_twin.py:204-216)."""
    (x_hat, lp, z), muts = jm.apply(variables, jnp.asarray(x), explicit=True,
                                    train=train, rngs={"reparam": key},
                                    mutable=["batch_stats"] if train else [])
    z = np.asarray(z)
    zd = z.shape[1] // 2
    eps = [(z[:, h * zd:(h + 1) * zd] - np.asarray(lp[mu]))
           / np.exp(0.5 * np.asarray(lp[lv]))
           for h, (mu, lv) in enumerate((("mu_c", "logvar_c"),
                                         ("mu_s", "logvar_s")))]
    return (x_hat, lp, z), muts, [torch.as_tensor(e) for e in eps]


@pytest.mark.parametrize("fused_heads,first_conv_pack",
                         [(False, False), (True, False), (False, True)])
@pytest.mark.parametrize("train", [True, False])
def test_forward_matches_flax(fused_heads, first_conv_pack, train):
    jm, variables, tm = _pair(fused_heads, first_conv_pack)
    x = np.random.RandomState(3).rand(8, 28, 28, 1).astype(np.float32)
    (jx_hat, jlp, jz), muts, eps = _eps_of(jm, variables, x,
                                           jax.random.key(5), train)
    x_hat, lp, z = tm(torch.as_tensor(x), train=train, eps=eps)
    np.testing.assert_allclose(x_hat.detach().numpy(), np.asarray(jx_hat),
                               atol=ATOL)
    np.testing.assert_allclose(z.detach().numpy(), jz, atol=ATOL)
    for k in ("mu_c", "logvar_c", "mu_s", "logvar_s"):
        np.testing.assert_allclose(lp[k].detach().numpy(), np.asarray(jlp[k]),
                                   atol=ATOL, err_msg=k)
    if train:  # running statistics after one train forward
        sd = params_from_flax(_np_tree(variables["params"]),
                              _np_tree(muts["batch_stats"]))
        for k, v in tm.state_dict().items():
            if "running" in k:
                np.testing.assert_allclose(v.numpy(), sd[k].numpy(), atol=1e-6,
                                           rtol=1e-5, err_msg=k)


def test_encode_decode_eval_mode():
    jm, variables, tm = _pair(seed=2)
    x = np.random.RandomState(4).rand(5, 28, 28, 1).astype(np.float32)
    jheads = jm.apply(variables, jnp.asarray(x), train=False, method="encode")
    with torch.no_grad():
        theads = tm.encode(torch.as_tensor(x), train=False)
    for a, b in zip(theads, jheads):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL)
    zz = np.random.RandomState(5).randn(5, 16).astype(np.float32)
    jxh = jm.apply(variables, jnp.asarray(zz), train=False, method="decode")
    with torch.no_grad():
        txh = tm.decode(torch.as_tensor(zz), train=False)
    assert txh.shape == (5, 28, 28, 1)
    np.testing.assert_allclose(txh.numpy(), np.asarray(jxh), atol=ATOL)


def test_bridge_rejects_unmapped_params():
    _, variables, _ = _pair()
    params = _np_tree(variables["params"])
    params["extra_head"] = {"Dense_0": {"kernel": np.zeros((2, 2)),
                                        "bias": np.zeros(2)}}
    with pytest.raises(ValueError, match="unmapped"):
        params_from_flax(params, _np_tree(variables["batch_stats"]))


def test_init_follows_flax():
    """Uniform kernels with variance 1/(3·fan_in) (ConvT fan_in = k·k·in),
    zero biases."""
    torch.manual_seed(0)
    tm = TVAE(total_z_dim=16)
    for name, p in tm.named_parameters():
        if name.endswith("bias") and "bns" not in name:
            assert float(p.detach().abs().max()) == 0.0, name
    for mod, fan_in in ((tm.encoder.convs[1], 32 * 9),
                        (tm.decoder.convts[0], 128 * 9),
                        (tm.decoder.convts[2], 32 * 9),
                        (tm.mu_c_head, 2048)):
        w = mod.weight.detach()
        bound = 1.0 / np.sqrt(fan_in)
        assert float(w.abs().max()) <= bound
        np.testing.assert_allclose(float(w.std()), bound / np.sqrt(3), rtol=0.1)


def test_batchnorm_running_var_is_biased():
    """flax (and the port) update running_var with the biased batch
    variance; torch's own BatchNorm uses the unbiased one."""
    x = torch.as_tensor(np.random.RandomState(6).randn(4, 3).astype(np.float32))
    bn = BatchNorm(3)
    bn(x, train=True)
    want = 0.9 + 0.1 * x.var(0, unbiased=False)
    np.testing.assert_allclose(bn.running_var.numpy(), want.numpy(), rtol=1e-5)
    ref = torch.nn.BatchNorm1d(3)
    ref(x)
    assert not np.allclose(ref.running_var.numpy(), bn.running_var.numpy())
