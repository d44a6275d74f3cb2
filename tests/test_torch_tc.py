"""CLEAR-TC in the port against the JAX package: the factor classifier and
factor_shuffling, one TC train step (fused and unfused, from bridged
weights and the JAX step's own draws), the eval step, and the trainer's
fit result."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from clearvae_tpu.config import AnnealConfig as JAnneal
from clearvae_tpu.config import ContrastiveConfig as JContr
from clearvae_tpu.config import TCConfig as JTC
from clearvae_tpu.models.factor import FactorCls as JFactor
from clearvae_tpu.models.vae import VAE as JVAE
from clearvae_tpu.train import steps as JS
from clearvae_torch.bridge import factor_params_from_flax, params_from_flax
from clearvae_torch.config import AnnealConfig, ContrastiveConfig, TCConfig
from clearvae_torch.data.mnist import synthetic_mnist
from clearvae_torch.data.styled import make_styled_mnist
from clearvae_torch.models.factor import FactorCls
from clearvae_torch.models.vae import VAE as TVAE
from clearvae_torch.ops.kernels import fused_loss as FL
from clearvae_torch.train import steps as TS
from clearvae_torch.train.factories import get_cleartcvae_trainer

B = 16
METRICS = ("loss", "recon", "kl_c", "kl_s", "c_loss", "mi_loss",
           "factor_d_loss")


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


def _eps(jm, variables, key, n):
    """The (eps_c, eps_s) that VAE.__call__ draws from ``key``."""
    zeros = jnp.zeros((n, jm.z_dim))

    def draw(mdl):
        return mdl.sample(zeros, zeros), mdl.sample(zeros, zeros)

    return [torch.as_tensor(np.array(e)) for e in
            jm.apply(variables, method=draw, rngs={"reparam": key})]


def assert_vae_close(model, jstate):
    """Every VAE parameter and running statistic against the JAX state, at
    the bar of tests/test_torch_step.py: Adam turns the float noise of
    gradients that are zero analytically (the biases ahead of BatchNorm)
    into ±lr moves."""
    want = params_from_flax(_np_tree(jstate.params),
                            _np_tree(jstate.batch_stats))
    for k, v in model.state_dict().items():
        tol = max(1e-3 * float(want[k].abs().max()), 1.2e-3)
        assert float((v - want[k]).abs().max()) <= tol, k


def test_factor_cls_and_shuffling_match_jax():
    jf = JFactor(z_dim=16)
    params = _np_tree(jf.init(jax.random.key(2), jnp.zeros((2, 16)))["params"])
    tf = FactorCls(16)
    tf.load_state_dict(factor_params_from_flax(params))
    z = np.random.RandomState(0).randn(12, 16).astype(np.float32)
    for logits in (False, True):
        np.testing.assert_allclose(
            tf(torch.as_tensor(z), return_logits=logits).detach().numpy(),
            np.asarray(jf.apply({"params": params}, z, logits)),
            rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(
        TS.factor_shuffling(torch.as_tensor(z)).numpy(),
        np.asarray(JS.factor_shuffling(jnp.asarray(z))))
    with pytest.raises(ValueError):
        TS.factor_shuffling(torch.as_tensor(z), "full")


@functools.lru_cache(maxsize=1)
def _setup():
    jm, jf = JVAE(total_z_dim=16), JFactor(z_dim=16)
    tx, ftx = optax.adam(5e-4), optax.adam(1e-4)
    state = JS.init_vae_state(jm, tx, jax.random.key(0), 28, 1, aux_model=jf,
                              aux_tx=ftx, aux_shapes=[(2, 16)])
    rs = np.random.RandomState(0)
    x = rs.rand(B, 28, 28, 1).astype(np.float32)
    lbl = rs.randint(0, 10, B)
    key = jax.random.key(1)
    variables = {"params": state.params, "batch_stats": state.batch_stats}
    noise = tuple(_eps(jm, variables, k, B) for k in jax.random.split(key))
    return jm, jf, tx, ftx, state, x, lbl, key, noise


def _port(state):
    tm, tf = TVAE(total_z_dim=16), FactorCls(16)
    tm.load_state_dict(params_from_flax(_np_tree(state.params),
                                        _np_tree(state.batch_stats)))
    tf.load_state_dict(factor_params_from_flax(_np_tree(state.aux_params)))
    return tm, tf


@pytest.mark.parametrize("fused", [True, False])
def test_tc_step_matches_jax(fused, monkeypatch):
    jm, jf, tx, ftx, state, x, lbl, key, noise = _setup()
    jstep = JS.make_clear_tc_step(jm, jf, tx, ftx, JAnneal(beta=1 / 8),
                                  JContr(alpha=100.0, fused=fused),
                                  JTC(la=1.0))
    jstate, jmetrics = jstep(state, jnp.asarray(x), jnp.asarray(lbl), key)

    tm, tf = _port(state)
    step = TS.make_clear_tc_step(
        tm, tf, torch.optim.Adam(tm.parameters(), lr=5e-4),
        torch.optim.Adam(tf.parameters(), lr=1e-4), AnnealConfig(beta=1 / 8),
        ContrastiveConfig(alpha=100.0, fused=fused), TCConfig(la=1.0))
    calls = {"snn_fwd": 0, "snn_bwd": 0}
    for name in calls:
        orig = getattr(FL, name)

        def counted(*a, _orig=orig, _name=name):
            calls[_name] += 1
            return _orig(*a)

        monkeypatch.setattr(FL, name, counted)
    FL.reset_launches()
    metrics = step(torch.as_tensor(x), torch.as_tensor(lbl), noise)
    # the fused c_loss takes K2f's wrapper forward and K2b's backward; on a
    # CPU tensor each runs its plain twin, so nothing launches
    assert calls == ({"snn_fwd": 1, "snn_bwd": 1} if fused
                     else {"snn_fwd": 0, "snn_bwd": 0})
    assert all(v == 0 for v in FL.LAUNCHES.values())
    assert step.step == 1
    for k in METRICS:
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]),
                                   rtol=1e-4, atol=1e-5, err_msg=k)
    # BN running statistics after both forwards (phase 2's update kept)
    assert_vae_close(tm, jstate)
    want = factor_params_from_flax(_np_tree(jstate.aux_params))
    for k, v in tf.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=1e-4,
                                   atol=1e-5, err_msg=k)


def test_tc_eval_step_matches_jax():
    jm, jf, _, _, state, x, lbl, key, _ = _setup()
    jout = JS.make_clear_tc_eval_step(jm, jf, JContr(alpha=100.0))(
        state, jnp.asarray(x), jnp.asarray(lbl), key)
    variables = {"params": state.params, "batch_stats": state.batch_stats}
    tm, tf = _port(state)
    out = TS.make_clear_tc_eval_step(tm, tf, ContrastiveConfig(alpha=100.0,
                                                               fused=True))(
        torch.as_tensor(x), torch.as_tensor(lbl), _eps(jm, variables, key, B))
    for k in ("recon", "kl_c", "kl_s", "c_loss", "mi_loss"):
        np.testing.assert_allclose(float(out[k]), float(jout[k]), rtol=1e-4,
                                   atol=1e-6, err_msg=k)
    for k in ("z_c", "z_s"):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(jout[k]),
                                   atol=2e-5, err_msg=k)


def test_tc_trainer_fit_returns_factor_losses():
    imgs, labels = synthetic_mnist(96, seed=4)
    ds = make_styled_mnist(imgs, labels, seed=4)
    t = get_cleartcvae_trainer(beta=1 / 8, la=1, vae_lr=5e-4,
                               factor_cls_lr=1e-4, z_dim=16, alpha=100,
                               temperature=0.1, mig_backend="numpy",
                               hyperparameter={"fused": True}, device="cpu")
    assert t.contr_cfg.fused and t.hp["lambda"] == 1
    losses = t.fit(2, ds, batch_size=32)
    assert losses is t.factor_d_losses and len(losses) == 6
    np.testing.assert_allclose(losses, np.concatenate(
        [h["factor_d_loss"] for h in t.history]))
    assert set(t.history[0]) == set(METRICS)
    mig, mse = t.evaluate(ds, batch_size=32)
    assert np.isfinite(mig) and np.isfinite(mse)
    assert all(np.isfinite(losses))

