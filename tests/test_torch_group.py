"""GVAE / ML-VAE in the port against the JAX package: group evidence (both
modes, an absent class), group_reparam and grouped_kl with their
gradients, one hierarchical train step, both eval variants and the
trainer's evidence switch, from bridged weights and the JAX draws."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from clearvae_tpu.config import AnnealConfig as JAnneal
from clearvae_tpu.models.vae import VAE as JVAE
from clearvae_tpu.ops import group as JG
from clearvae_tpu.train import steps as JS
from clearvae_torch.bridge import params_from_flax
from clearvae_torch.config import AnnealConfig
from clearvae_torch.data.mnist import synthetic_mnist
from clearvae_torch.data.styled import make_styled_mnist
from clearvae_torch.models.vae import VAE as TVAE
from clearvae_torch.ops import group as TG
from clearvae_torch.train import steps as TS
from clearvae_torch.train.factories import get_hierarchical_vae_trainer

B = 16
rs = np.random.RandomState(42)
MU = rs.randn(8, 4).astype(np.float32)
LOGVAR = (rs.randn(8, 4) * 0.3).astype(np.float32)
LABEL = np.array([0, 1, 0, 2, 1, 0, 2, 3])
EPS = rs.randn(8, 4).astype(np.float32)


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


@pytest.mark.parametrize("mode", ["MLVAE", "GVAE"])
@pytest.mark.parametrize("n_classes", [4, 6])   # 6: classes 4 and 5 absent
def test_group_ops_and_grads_match_jax(mode, n_classes):
    """accumulate_group_evidence → group_reparam → grouped_kl, values and
    the gradients of a weighted sum of all three outputs."""
    w = np.random.RandomState(1).randn(3).astype(np.float32)

    def jax_fn(mu, lv):
        mu_g, lv_g, present = JG.accumulate_group_evidence(
            mu, lv, jnp.asarray(LABEL), n_classes, mode)
        mu_b = mu_g[jnp.asarray(LABEL)]
        z = mu_b + jnp.asarray(EPS) * jnp.exp(0.5 * lv_g[jnp.asarray(LABEL)])
        kl = JG.grouped_kl(mu_g, lv_g, present)
        return (w[0] * jnp.sum(mu_g ** 2) + w[1] * jnp.sum(z * lv_g[0]) + w[2] * kl,
                (mu_g, lv_g, present, z, kl))

    (_, (jmu, jlv, jpres, jz, jkl)), jgrads = jax.value_and_grad(
        jax_fn, argnums=(0, 1), has_aux=True)(jnp.asarray(MU),
                                              jnp.asarray(LOGVAR))
    mu = torch.as_tensor(MU).requires_grad_()
    lv = torch.as_tensor(LOGVAR).requires_grad_()
    lbl = torch.as_tensor(LABEL)
    mu_g, lv_g, present = TG.accumulate_group_evidence(mu, lv, lbl, n_classes,
                                                       mode)
    z = TG.group_reparam(mu_g, lv_g, lbl, torch.as_tensor(EPS))
    kl = TG.grouped_kl(mu_g, lv_g, present)
    total = (float(w[0]) * (mu_g ** 2).sum() + float(w[1]) * (z * lv_g[0]).sum()
             + float(w[2]) * kl)
    grads = torch.autograd.grad(total, (mu, lv))
    np.testing.assert_array_equal(present.numpy(), np.asarray(jpres))
    for got, want in ((mu_g, jmu), (lv_g, jlv), (z, jz), (kl, jkl)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-6)
    for got, want in zip(grads, jgrads):
        assert np.isfinite(got.numpy()).all()
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-6)
    if n_classes == 6:
        assert not present[4:].any() and float(mu_g[4:].detach().abs().sum()) == 0.0


def test_group_mode_guard():
    tm = TVAE(total_z_dim=16)
    with pytest.raises(ValueError, match="group_mode"):
        tm(torch.zeros(2, 28, 28, 1), label=torch.zeros(2, dtype=torch.long))
    with pytest.raises(NotImplementedError):
        TG.accumulate_group_evidence(torch.as_tensor(MU),
                                     torch.as_tensor(LOGVAR),
                                     torch.as_tensor(LABEL), 4, "VAE")


def _eps(jm, variables, key, n):
    """The (eps_c, eps_s) that VAE.__call__ draws from ``key`` (the group
    path draws z_c's noise first, at the same shape)."""
    zeros = jnp.zeros((n, jm.z_dim))

    def draw(mdl):
        return mdl.sample(zeros, zeros), mdl.sample(zeros, zeros)

    return [torch.as_tensor(np.array(e)) for e in
            jm.apply(variables, method=draw, rngs={"reparam": key})]


@functools.lru_cache(maxsize=None)
def _setup(mode):
    jm = JVAE(total_z_dim=16, group_mode=mode, n_classes=10)
    tx = optax.adam(5e-4)
    state = JS.init_vae_state(jm, tx, jax.random.key(0), 28, 1)
    r = np.random.RandomState(0)
    x = r.rand(B, 28, 28, 1).astype(np.float32)
    lbl = r.randint(0, 6, B)            # classes 6..9 absent from the batch
    tm = TVAE(total_z_dim=16, group_mode=mode, n_classes=10)
    tm.load_state_dict(params_from_flax(_np_tree(state.params),
                                        _np_tree(state.batch_stats)))
    return jm, tx, state, x, lbl, tm


@pytest.mark.parametrize("mode", ["MLVAE", "GVAE"])
def test_hierarchical_step_matches_jax(mode):
    jm, tx, state, x, lbl, tm0 = _setup(mode)
    key = jax.random.key(1)
    jstate, jmetrics = JS.make_hierarchical_step(jm, tx, JAnneal(beta=1 / 8))(
        state, jnp.asarray(x), jnp.asarray(lbl), key)
    tm = TVAE(total_z_dim=16, group_mode=mode, n_classes=10)
    tm.load_state_dict(tm0.state_dict())
    step = TS.make_hierarchical_step(tm, torch.optim.Adam(tm.parameters(),
                                                          lr=5e-4),
                                     AnnealConfig(beta=1 / 8))
    variables = {"params": state.params, "batch_stats": state.batch_stats}
    metrics = step(torch.as_tensor(x), torch.as_tensor(lbl),
                   _eps(jm, variables, key, B))
    for k in ("loss", "recon", "kl_c", "kl_s"):
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]),
                                   rtol=1e-4, atol=1e-5, err_msg=k)
    # the bar of tests/test_torch_step.py (Adam on the float noise of the
    # biases ahead of BatchNorm)
    want = params_from_flax(_np_tree(jstate.params),
                            _np_tree(jstate.batch_stats))
    for k, v in tm.state_dict().items():
        tol = max(1e-3 * float(want[k].abs().max()), 1.2e-3)
        assert float((v - want[k]).abs().max()) <= tol, k


@pytest.mark.parametrize("evidence", [False, True])
def test_hierarchical_eval_step_matches_jax(evidence):
    jm, _, state, x, lbl, tm = _setup("MLVAE")
    key = jax.random.key(2)
    jout = JS.make_hierarchical_eval_step(jm, evidence)(
        state, jnp.asarray(x), jnp.asarray(lbl), key)
    variables = {"params": state.params, "batch_stats": state.batch_stats}
    out = TS.make_hierarchical_eval_step(tm, evidence)(
        torch.as_tensor(x), torch.as_tensor(lbl), _eps(jm, variables, key, B))
    for k in ("recon", "kl_c", "kl_s"):
        np.testing.assert_allclose(float(out[k]), float(jout[k]), rtol=1e-4,
                                   atol=1e-5, err_msg=k)
    for k in ("z_c", "z_s"):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(jout[k]),
                                   atol=2e-5, err_msg=k)


def test_trainer_evidence_switch():
    imgs, labels = synthetic_mnist(80, seed=2)
    ds = make_styled_mnist(imgs, labels, seed=2)
    t = get_hierarchical_vae_trainer(beta=1 / 8, vae_lr=5e-4, z_dim=16,
                                     group_mode="GVAE", mig_backend="numpy",
                                     device="cpu")
    assert t.fit(1, ds, batch_size=32) is None
    assert set(t.history[0]) == {"loss", "recon", "kl_c", "kl_s"}
    default = t.eval_step
    results = {}
    for flag in (None, True, False):
        t.generator.manual_seed(5)
        results[flag] = (t.evaluate(ds, batch_size=32, with_evidence_acc=flag),
                         dict(t.last_eval_totals))
        assert t.eval_step is default
    assert results[None] == results[False]
    # the evidence path draws z_c from the batch's groups: another KL
    assert results[True][1]["kl_c"] != results[False][1]["kl_c"]
    assert all(np.isfinite(v) for v in results[True][0])
