"""The slice as a whole: the port's CLEAR-VAE trainer (fused latent losses,
fit + evaluate) against the JAX package's, from bridged weights, with the
JAX batch order and the per-step noise of the JAX trainer's key chain."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from clearvae_tpu.data.common import ArrayDataset
from clearvae_tpu.data.mnist import synthetic_mnist
from clearvae_tpu.data.styled import make_styled_mnist
from clearvae_tpu.models.vae import VAE as JVAE
from clearvae_tpu.train.trainers import CLEARVAETrainer as JTrainer
from clearvae_torch.bridge import params_from_flax
from clearvae_torch.train.factories import get_clearvae_trainer

HP = dict(beta=1 / 8, ps=True, alpha=100.0, temperature=0.1)
N_TRAIN, N_EVAL, BS, EPOCHS, SEED = 256, 72, 32, 2, 0


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One intra-op thread: these small CPU workloads run several to a
    machine under the parallel test run, where more threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _eps(jm, variables, key, n):
    """The (eps_c, eps_s) that VAE.__call__ draws from ``key``: its two
    make_rng('reparam') calls, reproduced on zero means and log-variances."""
    zeros = jnp.zeros((n, jm.z_dim))

    def draw(mdl):
        return mdl.sample(zeros, zeros), mdl.sample(zeros, zeros)

    return [torch.as_tensor(np.array(e)) for e in
            jm.apply(variables, method=draw, rngs={"reparam": key})]


def test_fit_and_evaluate_overlay_jax():
    imgs, labels = synthetic_mnist(N_TRAIN + N_EVAL, seed=SEED)
    styled = make_styled_mnist(imgs, labels, seed=SEED).materialize()[..., None]
    train = ArrayDataset(styled[:N_TRAIN], labels[:N_TRAIN],
                         np.zeros(N_TRAIN, np.int32))
    valid = ArrayDataset(styled[N_TRAIN:], labels[N_TRAIN:],
                         np.zeros(N_EVAL, np.int32))

    jm = JVAE(total_z_dim=16)
    jt = JTrainer(jm, optax.adam(5e-4), sim_fn="cosine",
                  hyperparameter={**HP, "loc": 0, "scale": 1, "fused": True},
                  seed=SEED, mig_backend="numpy")
    jt.state = jt._init_state()
    variables = {"params": jt.state.params, "batch_stats": jt.state.batch_stats}

    tt = get_clearvae_trainer(vae_lr=5e-4, z_dim=16, seed=SEED,
                              mig_backend="numpy",
                              hyperparameter={"fused": True}, device="cpu",
                              **HP)
    tt.model.load_state_dict(params_from_flax(
        jax.tree.map(np.asarray, variables["params"]),
        jax.tree.map(np.asarray, variables["batch_stats"])))

    # the JAX trainer's key chain: one split for init, one per epoch (split
    # again per batch, steps.py:692), one for the full eval batches and one
    # for the ragged eval tail
    rng = jax.random.key(SEED)
    rng, _ = jax.random.split(rng)
    n_b = N_TRAIN // BS
    queue = []
    for _ in range(EPOCHS):
        rng, k = jax.random.split(rng)
        queue += [_eps(jm, variables, kk, BS) for kk in jax.random.split(k, n_b)]
    rng, k = jax.random.split(rng)
    eval_eps = [_eps(jm, variables, kk, BS)
                for kk in jax.random.split(k, N_EVAL // BS)]
    rng, k = jax.random.split(rng)
    eval_eps.append(_eps(jm, variables, k, N_EVAL % BS))
    queue += eval_eps
    tt._draw_eps = lambda n, out=None: queue.pop(0)

    jhist = []
    jt._post_train_epoch = jhist.append
    jt.fit(EPOCHS, train, batch_size=BS)
    jmig, jmse = jt.evaluate(valid, batch_size=BS)

    tt.fit(EPOCHS, train, batch_size=BS)
    mig, mse = tt.evaluate(valid, batch_size=BS)
    assert not queue

    # Adam turns float noise into +-lr updates where a gradient is zero
    # analytically (the biases ahead of BatchNorm) or nearly so, so the runs
    # drift apart step by step. The total loss, recon and c_loss hold rtol
    # 1e-4; the small KL and PS-SNN terms and everything read through the
    # BN running means (eval) drift to ~1e-3, hence 3e-3 there. The JAX
    # package drifts the same way against itself: its fused and unfused
    # trainers, same keys and data, differ by up to 2e-4 on kl_c and kl_s
    # after these two epochs.
    assert len(tt.history) == EPOCHS
    for e in range(EPOCHS):
        np.testing.assert_allclose(tt.history[e]["loss"],
                                   np.asarray(jhist[e]["loss"]), rtol=1e-4,
                                   err_msg=f"epoch {e} per-step loss")
        for k in ("loss", "recon", "kl_c", "kl_s", "c_loss", "s_loss"):
            rtol = 1e-4 if k in ("loss", "recon", "c_loss") else 3e-3
            np.testing.assert_allclose(tt.history[e][k].mean(),
                                       np.asarray(jhist[e][k]).mean(),
                                       rtol=rtol, err_msg=f"epoch {e} {k}")
    np.testing.assert_allclose(mse, jmse, rtol=3e-3)
    # MIG counts kNN neighbours, so slightly different latents may flip a
    # few counts; it must be finite and close
    assert np.isfinite(mig) and abs(mig - jmig) < 0.05

    # evaluate itself, free of the training drift: JAX's trained weights
    # bridged into the port, the same eval noise
    tt.model.load_state_dict(params_from_flax(
        jax.tree.map(np.asarray, jt.state.params),
        jax.tree.map(np.asarray, jt.state.batch_stats)))
    queue += eval_eps
    mig2, mse2 = tt.evaluate(valid, batch_size=BS)
    assert not queue
    np.testing.assert_allclose(mse2, jmse, rtol=1e-4)
    for k, v in jt.last_eval_totals.items():
        np.testing.assert_allclose(tt.last_eval_totals[k], v, rtol=1e-4,
                                   atol=1e-5, err_msg=k)
    assert abs(mig2 - jmig) < 0.05
