"""CLEAR-MIM in the port against the JAX package: the five MI bounds, the
learning loss, the six estimator modules (L1OutUB in both modes, CLUBSample
with the JAX draw's permutation), one MIM train step (CLUBSample and
L1OutUB, fused and unfused, re-encode and ``reuse_phase1_encode``) and the
eval step, from bridged weights and the JAX step's own draws."""

import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from clearvae_tpu.config import AnnealConfig as JAnneal
from clearvae_tpu.config import ContrastiveConfig as JContr
from clearvae_tpu.config import MIMConfig as JMIM
from clearvae_tpu.models import mi_estimators as JE
from clearvae_tpu.models.vae import VAE as JVAE
from clearvae_tpu.train import steps as JS
from clearvae_torch.bridge import mi_params_from_flax, params_from_flax
from clearvae_torch.config import AnnealConfig, ContrastiveConfig, MIMConfig
from clearvae_torch.data.mnist import synthetic_mnist
from clearvae_torch.data.styled import make_styled_mnist
from clearvae_torch.models import mi_estimators as TE
from clearvae_torch.models.vae import VAE as TVAE
from clearvae_torch.ops.kernels import fused_loss as FL
from clearvae_torch.train import steps as TS
from clearvae_torch.train.factories import get_clearmimvae_trainer

B, ZH = 16, 8
TOL = dict(rtol=1e-5, atol=1e-6)


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


def _t(a):
    return torch.as_tensor(np.array(a))


def _jax_perm(est, params, key, n):
    """The permutation CLUBSample.__call__ draws from ``key``: its one
    make_rng('shuffle') call, reproduced at the same module path."""
    return np.asarray(est.apply(
        {"params": params},
        method=lambda m: jax.random.permutation(m.make_rng("shuffle"), n),
        rngs={"shuffle": key}))


@pytest.fixture(scope="module")
def critic():
    rs = np.random.RandomState(0)
    mu = rs.randn(B, ZH).astype(np.float32)
    logvar = (0.5 * rs.randn(B, ZH)).astype(np.float32)
    y = rs.randn(B, ZH).astype(np.float32)
    perm = rs.permutation(B)
    return mu, logvar, y, perm


BOUNDS = {
    "club": (lambda m, lv, y, p: JE.club_bound(m, lv, y),
             lambda m, lv, y, p: TE.club_bound(m, lv, y)),
    "club_mean": (lambda m, lv, y, p: JE.club_mean_bound(m, y),
                  lambda m, lv, y, p: TE.club_mean_bound(m, y)),
    "club_sample": (JE.club_sample_bound, TE.club_sample_bound),
    "l1out": (lambda m, lv, y, p: JE.l1out_bound(m, lv, y),
              lambda m, lv, y, p: TE.l1out_bound(m, lv, y)),
    "l1out_intended": (lambda m, lv, y, p: JE.l1out_bound(m, lv, y, False),
                       lambda m, lv, y, p: TE.l1out_bound(m, lv, y, False)),
    "var_ub": (lambda m, lv, y, p: JE.var_ub_bound(m, lv),
               lambda m, lv, y, p: TE.var_ub_bound(m, lv)),
    "loglikeli": (lambda m, lv, y, p: JE._gaussian_loglikeli(m, lv, y),
                  lambda m, lv, y, p: TE._gaussian_loglikeli(m, lv, y)),
}


@pytest.mark.parametrize("name", sorted(BOUNDS))
def test_bound_values_and_grads_match_jax(name, critic):
    mu, logvar, y, perm = critic
    jf, tf = BOUNDS[name]
    jv, jg = jax.value_and_grad(lambda m, lv: jf(m, lv, jnp.asarray(y),
                                                 jnp.asarray(perm)),
                                argnums=(0, 1))(jnp.asarray(mu),
                                                jnp.asarray(logvar))
    m, lv = _t(mu).requires_grad_(), _t(logvar).requires_grad_()
    tv = tf(m, lv, _t(y), _t(perm))
    tg = torch.autograd.grad(tv, (m, lv), allow_unused=True)
    np.testing.assert_allclose(float(tv.detach()), float(jv), **TOL)
    for a, b in zip(tg, jg):
        want = np.asarray(b)
        got = np.zeros_like(want) if a is None else a.numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


ESTIMATORS = [("CLUB", {}), ("CLUBMean", {}), ("CLUBMean", {"hidden_size": None}),
              ("CLUBSample", {}), ("L1OutUB", {}),
              ("L1OutUB", {"reference_broadcast": False}), ("VarUB", {}),
              ("InfoNCE", {})]


@pytest.mark.parametrize("name,kw", ESTIMATORS)
def test_estimator_modules_match_jax(name, kw, critic):
    _, _, y, _ = critic
    x = np.random.RandomState(1).randn(B, ZH).astype(np.float32)
    size = {"hidden_size": 16, **kw}
    je = JE.MI_ESTIMATORS[name](x_dim=ZH, y_dim=ZH, **size)
    params = _np_tree(je.init({"params": jax.random.key(3),
                               "shuffle": jax.random.key(4)},
                              jnp.zeros((2, ZH)), jnp.zeros((2, ZH)))["params"])
    te = TE.MI_ESTIMATORS[name](x_dim=ZH, y_dim=ZH, **size)
    te.load_state_dict(mi_params_from_flax(params))
    key = jax.random.key(5)
    jval = je.apply({"params": params}, jnp.asarray(x), jnp.asarray(y),
                    rngs={"shuffle": key})
    jll = je.apply({"params": params}, jnp.asarray(x), jnp.asarray(y),
                   method="learning_loss", rngs={"shuffle": key})
    kw_call = {}
    if te.uses_perm:
        kw_call["perm"] = _t(_jax_perm(je, params, key, B))
    with torch.no_grad():
        val, ll = te(_t(x), _t(y), **kw_call), te.learning_loss(_t(x), _t(y))
    np.testing.assert_allclose(float(val), float(jval), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(ll), float(jll), rtol=1e-5, atol=1e-5)


def test_club_sample_draws_from_its_generator(critic):
    _, _, y, _ = critic
    te = TE.CLUBSample(ZH, ZH, 16)
    x = torch.randn(B, ZH, generator=torch.Generator().manual_seed(0))
    perm = torch.randperm(B, generator=torch.Generator().manual_seed(9))
    with torch.no_grad():
        a = te(x, _t(y), generator=torch.Generator().manual_seed(9))
        assert float(a) == float(te(x, _t(y), perm=perm))


@functools.lru_cache(maxsize=None)
def _setup(estimator):
    jm = JVAE(total_z_dim=16)
    je = JE.MI_ESTIMATORS[estimator](x_dim=ZH, y_dim=ZH, hidden_size=16)
    tx, mtx = optax.adam(5e-4), optax.adam(2e-3)
    state = JS.init_vae_state(jm, tx, jax.random.key(0), 28, 1, aux_model=je,
                              aux_tx=mtx, aux_shapes=[(2, ZH), (2, ZH)])
    rs = np.random.RandomState(0)
    x = rs.rand(B, 28, 28, 1).astype(np.float32)
    lbl = rs.randint(0, 10, B)
    return jm, je, tx, mtx, state, x, lbl


def _eps(jm, variables, key, n):
    """The (eps_c, eps_s) that VAE.__call__ draws from ``key``."""
    zeros = jnp.zeros((n, jm.z_dim))

    def draw(mdl):
        return mdl.sample(zeros, zeros), mdl.sample(zeros, zeros)

    return [torch.as_tensor(np.array(e)) for e in
            jm.apply(variables, method=draw, rngs={"reparam": key})]


def _port(estimator, state):
    tm = TVAE(total_z_dim=16)
    tm.load_state_dict(params_from_flax(_np_tree(state.params),
                                        _np_tree(state.batch_stats)))
    te = TE.MI_ESTIMATORS[estimator](x_dim=ZH, y_dim=ZH, hidden_size=16)
    te.load_state_dict(mi_params_from_flax(_np_tree(state.aux_params)))
    return tm, te


@pytest.mark.parametrize("estimator,reuse,fused", [
    ("CLUBSample", False, True), ("CLUBSample", False, False),
    ("CLUBSample", True, True), ("L1OutUB", False, False),
    ("L1OutUB", True, True)])
def test_mim_step_matches_jax(estimator, reuse, fused):
    jm, je, tx, mtx, state, x, lbl = _setup(estimator)
    key = jax.random.key(1)
    jstep = JS.make_clear_mim_step(
        jm, je, tx, mtx, JAnneal(beta=1 / 8), JContr(alpha=100.0, fused=fused),
        JMIM(la=3.0, reuse_phase1_encode=reuse))
    jstate, jmetrics = jstep(state, jnp.asarray(x), jnp.asarray(lbl), key)

    # the JAX step's draws: its split into (k_vae, k_inner), the reparam
    # noise of k_vae, CLUBSample's permutation from fold_in(k_vae, 1), and
    # one normal per inner step
    k_vae, k_inner = jax.random.split(key)
    variables = {"params": state.params, "batch_stats": state.batch_stats}
    perm = (_t(_jax_perm(je, state.aux_params, jax.random.fold_in(k_vae, 1), B))
            if estimator == "CLUBSample" else None)
    inner = torch.stack([_t(jax.random.normal(k, (B, 2 * ZH)))
                         for k in jax.random.split(k_inner, 5)])
    noise = {"eps": _eps(jm, variables, k_vae, B), "perm": perm,
             "inner": inner}

    tm, te = _port(estimator, state)
    phase1 = copy.deepcopy(tm)
    step = TS.make_clear_mim_step(
        tm, te, torch.optim.Adam(tm.parameters(), lr=5e-4),
        torch.optim.Adam(te.parameters(), lr=2e-3), AnnealConfig(beta=1 / 8),
        ContrastiveConfig(alpha=100.0, fused=fused),
        MIMConfig(la=3.0, reuse_phase1_encode=reuse))
    FL.reset_launches()
    metrics = step(torch.as_tensor(x), torch.as_tensor(lbl), noise)
    assert all(v == 0 for v in FL.LAUNCHES.values())
    for k in ("loss", "recon", "kl_c", "kl_s", "c_loss", "mi_loss",
              "mi_learning_loss"):
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]),
                                   rtol=1e-4, atol=1e-5, err_msg=k)
    # the running statistics are exactly those of phase 1's forward: the
    # re-encode leaves them alone
    phase1(torch.as_tensor(x), train=True, eps=noise["eps"])
    for (k, v), w in zip(tm.named_buffers(), phase1.buffers()):
        assert torch.equal(v, w), k
    want = params_from_flax(_np_tree(jstate.params),
                            _np_tree(jstate.batch_stats))
    for k, v in tm.state_dict().items():
        tol = max(1e-3 * float(want[k].abs().max()), 1.2e-3)
        assert float((v - want[k]).abs().max()) <= tol, k
    want = mi_params_from_flax(_np_tree(jstate.aux_params))
    for k, v in te.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=1e-4,
                                   atol=1e-5, err_msg=k)


def test_mim_eval_step_matches_jax():
    jm, je, _, _, state, x, lbl = _setup("CLUBSample")
    key = jax.random.key(2)
    jout = JS.make_clear_mim_eval_step(jm, je, JContr(alpha=100.0))(
        state, jnp.asarray(x), jnp.asarray(lbl), key)
    variables = {"params": state.params, "batch_stats": state.batch_stats}
    tm, te = _port("CLUBSample", state)
    noise = {"eps": _eps(jm, variables, key, B),
             "perm": _t(_jax_perm(je, state.aux_params, key, B))}
    out = TS.make_clear_mim_eval_step(tm, te, ContrastiveConfig(alpha=100.0))(
        torch.as_tensor(x), torch.as_tensor(lbl), noise)
    for k in ("recon", "kl_c", "kl_s", "c_loss", "mi_loss"):
        np.testing.assert_allclose(float(out[k]), float(jout[k]), rtol=1e-4,
                                   atol=1e-5, err_msg=k)
    for k in ("z_c", "z_s"):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(jout[k]),
                                   atol=2e-5, err_msg=k)


@pytest.mark.parametrize("estimator", ["CLUBSample", "L1OutUB"])
def test_mim_trainer_fit_returns_histories(estimator):
    imgs, labels = synthetic_mnist(96, seed=4)
    ds = make_styled_mnist(imgs, labels, seed=4)
    t = get_clearmimvae_trainer(beta=1 / 8, mi_estimator=estimator, la=3,
                                vae_lr=5e-4, mi_estimator_lr=2e-3, z_dim=16,
                                alpha=100, temperature=0.1,
                                mig_backend="numpy", device="cpu")
    assert not t.contr_cfg.fused and t.mim_cfg.inner_steps == 5
    assert (t.mi_estimator.net.mu_l1.in_features,
            t.mi_estimator.net.mu_l1.out_features) == (8, 8)
    mi, mil = t.fit(2, ds, batch_size=32)
    assert (mi, mil) == (t.mi_losses, t.mi_learning_losses)
    assert len(mi) == len(mil) == 6
    np.testing.assert_allclose(mil, np.concatenate(
        [h["mi_learning_loss"] for h in t.history]))
    assert all(np.isfinite(mi + mil))
    mig, mse = t.evaluate(ds, batch_size=32)
    assert np.isfinite(mig) and np.isfinite(mse)
