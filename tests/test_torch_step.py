"""One CLEAR training step of the port against the JAX package's
make_clear_vae_step, fused and unfused, from bridged weights and the noise
the JAX step drew (recovered as in scripts/reference_twin.py:204-229)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from clearvae_tpu.config import AnnealConfig as JAnneal
from clearvae_tpu.config import ContrastiveConfig as JContr
from clearvae_tpu.models.vae import VAE as JVAE
from clearvae_tpu.train.steps import init_vae_state, make_clear_vae_step
from clearvae_torch.bridge import params_from_flax
from clearvae_torch.config import AnnealConfig, ContrastiveConfig
from clearvae_torch.models.vae import VAE as TVAE
from clearvae_torch.ops.kernels import fused_loss as FL
from clearvae_torch.train import steps as TS

B = 16


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


@functools.lru_cache(maxsize=1)
def _setup():
    jm = JVAE(total_z_dim=16)
    tx = optax.adam(5e-4)
    state = init_vae_state(jm, tx, jax.random.key(0), 28, 1)
    rs = np.random.RandomState(0)
    x = rs.rand(B, 28, 28, 1).astype(np.float32)
    lbl = rs.randint(0, 10, B)
    key = jax.random.key(1)
    out, _ = jm.apply({"params": state.params, "batch_stats": state.batch_stats},
                      jnp.asarray(x), explicit=True, train=True,
                      rngs={"reparam": key}, mutable=["batch_stats"])
    _, lp, z = out
    z = np.asarray(z)
    eps = [(z[:, h * 8:(h + 1) * 8] - np.asarray(lp[m]))
           / np.exp(0.5 * np.asarray(lp[v]))
           for h, (m, v) in enumerate((("mu_c", "logvar_c"),
                                       ("mu_s", "logvar_s")))]
    return jm, tx, state, x, lbl, key, eps


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("ps", [True, False])
def test_clear_step_matches_jax(fused, ps):
    jm, tx, state, x, lbl, key, eps = _setup()
    jstep = make_clear_vae_step(jm, tx, JAnneal(beta=1 / 8),
                                JContr(alpha=100.0, ps=ps, fused=fused))
    jstate, jmetrics = jstep(state, jnp.asarray(x), jnp.asarray(lbl), key)

    tm = TVAE(total_z_dim=16)
    tm.load_state_dict(params_from_flax(_np_tree(state.params),
                                        _np_tree(state.batch_stats)))
    opt = torch.optim.Adam(tm.parameters(), lr=5e-4)
    step = TS.make_clear_vae_step(tm, opt, AnnealConfig(beta=1 / 8),
                                  ContrastiveConfig(alpha=100.0, ps=ps,
                                                    fused=fused))
    FL.reset_launches()
    metrics = step(torch.as_tensor(x), torch.as_tensor(lbl),
                   [torch.as_tensor(e) for e in eps])
    assert all(v == 0 for v in FL.LAUNCHES.values())  # CPU: plain twins
    assert step.step == 1
    for k in ("loss", "recon", "kl_c", "kl_s", "c_loss", "s_loss"):
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]),
                                   rtol=1e-4, atol=1e-6, err_msg=k)
    want = params_from_flax(_np_tree(jstate.params),
                            _np_tree(jstate.batch_stats))
    for k, v in tm.state_dict().items():
        tol = max(1e-3 * float(want[k].abs().max()), 1.2e-3)
        assert float((v - want[k]).abs().max()) <= tol, k


def test_eval_step_matches_jax():
    """The eval step (running statistics, K2f's twin when fused)."""
    from clearvae_tpu.train.steps import make_clear_vae_eval_step

    jm, _, state, x, lbl, key, _ = _setup()
    jeval = make_clear_vae_eval_step(jm, JContr(alpha=100.0, fused=True))
    jout = jeval(state, jnp.asarray(x), jnp.asarray(lbl), key)
    _, lp, z = jm.apply({"params": state.params,
                              "batch_stats": state.batch_stats},
                        jnp.asarray(x), explicit=True, train=False,
                        rngs={"reparam": key})
    z = np.asarray(z)
    eps = [torch.as_tensor((z[:, h * 8:(h + 1) * 8] - np.asarray(lp[m]))
                           / np.exp(0.5 * np.asarray(lp[v])))
           for h, (m, v) in enumerate((("mu_c", "logvar_c"),
                                       ("mu_s", "logvar_s")))]
    tm = TVAE(total_z_dim=16)
    tm.load_state_dict(params_from_flax(_np_tree(state.params),
                                        _np_tree(state.batch_stats)))
    out = TS.make_clear_vae_eval_step(tm, ContrastiveConfig(alpha=100.0,
                                                            fused=True))(
        torch.as_tensor(x), torch.as_tensor(lbl), eps)
    for k in ("recon", "kl_c", "kl_s", "c_loss", "s_loss"):
        np.testing.assert_allclose(float(out[k]), float(jout[k]), rtol=1e-4,
                                   err_msg=k)
    for k in ("z_c", "z_s", "mu_c", "mu_s"):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(jout[k]),
                                   atol=2e-5, err_msg=k)
