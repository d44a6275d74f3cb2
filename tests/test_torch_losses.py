"""Parity of the port's plain losses (clearvae_torch.ops.losses, schedules)
with the JAX package's, values and gradients, on inputs made by numpy."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clearvae_tpu.ops import losses as JL
from clearvae_tpu.ops.schedules import logistic_anneal as j_anneal
from clearvae_torch.ops import losses as TL
from clearvae_torch.ops.schedules import logistic_anneal as t_anneal

VAL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One intra-op thread: these small CPU workloads run several to a
    machine under the parallel test run, where more threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _grad_close(got, ref):
    scale = max(float(np.nanmax(np.abs(ref))), 1.0)
    np.testing.assert_allclose(got, ref, atol=1e-5 * scale, rtol=1e-4)


def _inputs(b=24, z=5, n_cls=5, seed=0):
    rs = np.random.RandomState(seed)
    mu = rs.randn(b, z).astype(np.float32)
    lv = (rs.randn(b, z) * 0.3).astype(np.float32)
    lbl = rs.randint(0, n_cls, b)
    lbl[-1] = n_cls  # a singleton class: a row with no same-label positive
    return mu, lv, lbl


@pytest.mark.parametrize("sim_fn", sorted(JL.SIM_FNS))
@pytest.mark.parametrize("loss_name", sorted(JL.CONTRASTIVE_LOSSES))
def test_contrastive_loss_values_and_grads(sim_fn, loss_name):
    mu, lv, lbl = _inputs()
    for ps in (False, True):
        kw = dict(sim_fn=sim_fn, temperature=0.3, loss_name=loss_name, ps=ps)

        def jfn(m, v):
            return JL.contrastive_loss(m, v, jnp.asarray(lbl), **kw)

        ref = jfn(jnp.asarray(mu), jnp.asarray(lv))
        gm, gv = jax.grad(jfn, argnums=(0, 1))(jnp.asarray(mu), jnp.asarray(lv))
        tm = torch.tensor(mu, requires_grad=True)
        tv = torch.tensor(lv, requires_grad=True)
        out = TL.contrastive_loss(tm, tv, torch.as_tensor(lbl), **kw)
        out.backward()
        np.testing.assert_allclose(float(out.detach()), float(ref), **VAL)
        _grad_close(tm.grad.numpy(), np.asarray(gm))
        # a similarity that ignores logvar leaves torch's grad unset
        gv_t = np.zeros_like(lv) if tv.grad is None else tv.grad.numpy()
        _grad_close(gv_t, np.asarray(gv))


@pytest.mark.parametrize("sim_fn", sorted(JL.SIM_FNS))
def test_pairwise_similarities(sim_fn):
    mu, lv, _ = _inputs(b=9, z=4, seed=1)
    ref = JL.SIM_FNS[sim_fn](jnp.asarray(mu), jnp.asarray(lv))
    got = TL.SIM_FNS[sim_fn](torch.as_tensor(mu), torch.as_tensor(lv))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-4)


def test_singleton_rows_finite():
    """test_pallas.py:33-40's labels: singleton classes give rows with no
    positive; loss and gradients stay finite and match JAX."""
    rs = np.random.RandomState(0)
    lbl = np.asarray([0, 0, 1, 1, 2, 2, 3, 4] * 4)
    mu = rs.randn(32, 8).astype(np.float32)

    def jfn(m):
        return JL.contrastive_loss(m, m, jnp.asarray(lbl), sim_fn="cosine",
                                   temperature=0.1)

    tm = torch.tensor(mu, requires_grad=True)
    out = TL.contrastive_loss(tm, tm, torch.as_tensor(lbl), sim_fn="cosine",
                              temperature=0.1)
    out.backward()
    np.testing.assert_allclose(float(out.detach()), float(jfn(jnp.asarray(mu))),
                               **VAL)
    assert np.isfinite(tm.grad.numpy()).all()
    _grad_close(tm.grad.numpy(), np.asarray(jax.grad(jfn)(jnp.asarray(mu))))


def test_masked_logsumexp_empty_rows():
    rs = np.random.RandomState(2)
    x = rs.randn(6, 7).astype(np.float32)
    mask = rs.rand(6, 7) > 0.5
    mask[2] = False  # an empty row -> -inf, with a finite gradient

    def jfn(v):
        out = JL.masked_logsumexp(v, jnp.asarray(mask), axis=1)
        return jnp.sum(jnp.where(jnp.isfinite(out), out, 0.0)), out

    (_, ref), g = jax.value_and_grad(jfn, has_aux=True)(jnp.asarray(x))
    tx = torch.tensor(x, requires_grad=True)
    out = TL.masked_logsumexp(tx, torch.as_tensor(mask), dim=1)
    torch.where(torch.isfinite(out), out, torch.zeros_like(out)).sum().backward()
    np.testing.assert_array_equal(np.isfinite(out.detach().numpy()),
                                  np.isfinite(np.asarray(ref)))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), rtol=1e-6)
    assert np.isfinite(tx.grad.numpy()).all()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(g), atol=1e-6)


def test_vae_loss_values_and_grads():
    rs = np.random.RandomState(3)
    arrs = [rs.rand(4, 6, 6, 1).astype(np.float32),
            rs.rand(4, 6, 6, 1).astype(np.float32)]
    arrs += [(rs.randn(4, 3) * s).astype(np.float32) for s in (1, .3, 1, .3)]

    def jfn(*a):
        r, kc, ks = JL.vae_loss(*a)
        return r + 0.7 * kc + 1.3 * ks, (r, kc, ks)

    (_, ref), gref = jax.value_and_grad(jfn, argnums=tuple(range(6)),
                                        has_aux=True)(*map(jnp.asarray, arrs))
    ts = [torch.tensor(a, requires_grad=True) for a in arrs]
    r, kc, ks = TL.vae_loss(*ts)
    (r + 0.7 * kc + 1.3 * ks).backward()
    for got, want in zip((r, kc, ks), ref):
        np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-6)
    for t, g in zip(ts, gref):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), rtol=1e-5,
                                   atol=1e-7)


def test_lam_loss_and_anneal():
    rs = np.random.RandomState(4)
    fx, ft = rs.randn(2, 8, 6).astype(np.float32)
    w = rs.randn(3, 6).astype(np.float32)
    y = rs.randint(0, 3, 8)
    ref = JL.lam_loss(jnp.asarray(fx), jnp.asarray(ft), jnp.asarray(y),
                      jnp.asarray(w))
    got = TL.lam_loss(torch.as_tensor(fx), torch.as_tensor(ft),
                      torch.as_tensor(y), torch.as_tensor(w))
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-6)
    for step in (0, 1, 3, 40, 1000):
        np.testing.assert_allclose(
            float(t_anneal(step, beta=0.125, loc=2.0, scale=1.5)),
            float(j_anneal(step, beta=0.125, loc=2.0, scale=1.5)), rtol=1e-6)
