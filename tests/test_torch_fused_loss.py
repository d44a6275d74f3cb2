"""Parity of the plain twins of the port's CUDA kernels (K1 = clear latent
fwd+grad, K2f = SNN loss, K2b = SNN gradient) with the JAX package's Pallas
kernels, run in interpret mode on the CPU. CPU tensors take the plain path
and leave the launch counters at 0; the CUDA kernels themselves are held to
the same twins on the card by chip_smoke.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clearvae_tpu.ops.losses import contrastive_loss as j_contrastive
from clearvae_tpu.ops.pallas import fused_loss as JF
from clearvae_torch.ops import losses as TL
from clearvae_torch.ops.kernels import fused_loss as FL

W = (0.7, 1.3, 0.11, 0.05)


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One intra-op thread: these small CPU workloads run several to a
    machine under the parallel test run, where more threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _latents(b, z, seed):
    rs = np.random.RandomState(seed)
    mats = [(rs.randn(b, z) * s).astype(np.float32) for s in (1, .3, 1, .3)]
    return mats, rs.randint(0, 10, b)


def _grad_close(got, ref, atol):
    scale = max(float(np.abs(ref).max()), 1.0)
    np.testing.assert_allclose(got, ref, atol=atol * scale, rtol=1e-3)


@pytest.fixture(autouse=True)
def _zero_counters():
    FL.reset_launches()
    yield
    assert all(v == 0 for v in FL.LAUNCHES.values()), FL.LAUNCHES


@pytest.mark.parametrize("b,z,ps,t", [
    (128, 8, False, 0.1), (128, 8, True, 0.1),
    (64, 32, True, 0.3), (100, 7, False, 2.0)])
def test_snn_fwd_bwd_match_pallas(b, z, ps, t):
    (mu, *_), lbl = _latents(b, z, b + z)
    jmu, jl = jnp.asarray(mu), jnp.asarray(lbl)
    ref = JF._fused_snn(jmu, jl, t, ps)
    gref = jax.grad(lambda m: JF._fused_snn(m, jl, t, ps))(jmu)
    tm = torch.tensor(mu, requires_grad=True)
    out = FL.fused_contrastive_loss(tm, tm, torch.as_tensor(lbl),
                                    temperature=t, ps=ps)
    out.backward()
    np.testing.assert_allclose(float(out.detach()), float(ref), rtol=1e-5)
    _grad_close(tm.grad.numpy(), np.asarray(gref), 2e-5)
    # K2b's twin directly, against the Pallas backward with a cotangent g
    _, res = JF._fused_snn_fwd(jmu, jl, t, ps)
    jd, _ = JF._fused_snn_bwd(t, ps, res, jnp.float32(1.7))
    td = FL.snn_bwd(torch.as_tensor(mu), torch.as_tensor(lbl),
                    torch.tensor(1.7), t, ps)
    _grad_close(td.numpy(), np.asarray(jd), 2e-5)


@pytest.mark.parametrize("b,z,ps,t", [
    (128, 8, True, 0.1), (64, 32, False, 0.3), (100, 7, True, 2.0)])
def test_clear_latent_matches_pallas(b, z, ps, t):
    mats, lbl = _latents(b, z, 7 * b + z)
    jargs = [jnp.asarray(m) for m in mats]
    jl = jnp.asarray(lbl)
    # the Pallas forward's own outputs, SNN gradients included
    jterms, jres = JF._fused_clear_fwd(*jargs, jl, t, ps)
    out, dc, ds = FL.clear_latent_fwdgrad(*map(torch.as_tensor, mats),
                                          torch.as_tensor(lbl), t, ps)
    np.testing.assert_allclose(out.numpy(), np.asarray(jterms), rtol=2e-5,
                               atol=1e-6)
    _grad_close(dc.numpy(), np.asarray(jres[4]), 3e-5)
    _grad_close(ds.numpy(), np.asarray(jres[5]), 3e-5)

    # joint gradient of a weighted sum through the autograd.Function
    def jtotal(args):
        return sum(w * x for w, x in zip(W, JF.fused_clear_latent_loss(
            *args, jl, temperature=t, ps=ps)))

    gref = jax.grad(jtotal)(tuple(jargs))
    targs = [torch.tensor(m, requires_grad=True) for m in mats]
    terms = FL.fused_clear_latent_loss(*targs, torch.as_tensor(lbl),
                                       temperature=t, ps=ps)
    sum(w * x for w, x in zip(W, terms)).backward()
    for a, r in zip(targs, gref):
        _grad_close(a.grad.numpy(), np.asarray(r), 3e-5)


def test_clear_latent_matches_plain_losses():
    """K1's twin equals the unfused terms (vae_loss KL halves + cosine SNN)
    of the port's own plain path."""
    (mu_c, lv_c, mu_s, lv_s), lbl = _latents(48, 8, 3)
    ts = [torch.as_tensor(a) for a in (mu_c, lv_c, mu_s, lv_s)]
    tl = torch.as_tensor(lbl)
    out, _, _ = FL.clear_latent_fwdgrad(*ts, tl, 0.1, True)
    x = torch.zeros(48, 2, 2, 1)
    _, kl_c, kl_s = TL.vae_loss(x, x, *ts)
    c = TL.contrastive_loss(ts[0], ts[1], tl, sim_fn="cosine", temperature=0.1)
    s = TL.contrastive_loss(ts[2], ts[3], tl, sim_fn="cosine", temperature=0.1,
                            ps=True)
    np.testing.assert_allclose(out.numpy(), [float(kl_c), float(kl_s),
                                             float(c), float(s)], rtol=2e-5)


def test_singleton_rows_and_fallback():
    lbl = np.asarray([0, 0, 1, 1, 2, 2, 3, 4] * 4)
    mu = np.random.RandomState(0).randn(32, 8).astype(np.float32)
    ref = j_contrastive(jnp.asarray(mu), jnp.asarray(mu), jnp.asarray(lbl),
                        sim_fn="cosine", temperature=0.1)
    tm = torch.tensor(mu, requires_grad=True)
    out = FL.fused_contrastive_loss(tm, tm, torch.as_tensor(lbl))
    out.backward()
    np.testing.assert_allclose(float(out.detach()), float(ref), rtol=1e-5)
    assert np.isfinite(tm.grad.numpy()).all()
    # other similarity choices route to the plain path
    lv = (np.random.RandomState(1).randn(32, 8) * 0.1).astype(np.float32)
    a = FL.fused_contrastive_loss(torch.as_tensor(mu), torch.as_tensor(lv),
                                  torch.as_tensor(lbl), sim_fn="l2",
                                  temperature=0.5)
    b = j_contrastive(jnp.asarray(mu), jnp.asarray(lv), jnp.asarray(lbl),
                      sim_fn="l2", temperature=0.5)
    np.testing.assert_allclose(float(a), float(b), rtol=1e-5)


@pytest.mark.parametrize("ps", [True, False])
def test_snn_bwd_takes_int64_and_int32_labels(ps):
    (mu, *_), lbl = _latents(64, 8, 21)
    g = torch.tensor(-0.8)
    a = FL.snn_bwd(torch.as_tensor(mu), torch.as_tensor(lbl, dtype=torch.int64),
                   g, 0.1, ps)
    b = FL.snn_bwd(torch.as_tensor(mu), torch.as_tensor(lbl, dtype=torch.int32),
                   g, 0.1, ps)
    assert torch.equal(a, b)


def test_wrappers_reject_what_the_kernels_do_not_take():
    lbl = torch.zeros(4, dtype=torch.int64)
    with pytest.raises(ValueError, match="z <= 64"):
        FL.snn_fwd(torch.zeros(4, 65), lbl, 0.1, True)
    with pytest.raises(ValueError, match="unsupported device"):
        FL.snn_fwd(torch.zeros(4, 8, device="meta"), lbl.to("meta"), 0.1, True)
    with pytest.raises(ValueError, match="label"):
        FL.snn_fwd(torch.zeros(4, 8), torch.zeros(5, dtype=torch.int64), 0.1,
                   True)


def test_wrappers_reach_only_clear_latent_cu():
    """K1, K1's backward, K2f and K2b are one CUDA source's entry points;
    the old four-pass source is gone."""
    import os

    from clearvae_torch.ops.kernels import _build

    assert list(FL._SIGNATURES) == ["clear_latent"]
    assert set(FL._SIGNATURES["clear_latent"]) >= set(FL.LAUNCHES)
    assert not os.path.exists(os.path.join(_build.CSRC, "fused_loss.cu"))
    assert "fused_loss" not in _build.sources()
