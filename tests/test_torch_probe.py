"""The port's judges against the JAX package's: the probe MLP (bridged
weights, train and eval), its steps, the fused style→encode pass, accuracy
and AUC, and the torch MIG backend."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from clearvae_tpu.data.styled import make_styled_mnist as jax_make_styled
from clearvae_tpu.models.mlp import ProbeMLP as JProbe
from clearvae_tpu.models.vae import VAE as JVAE
from clearvae_tpu.ops import metrics as JMT
from clearvae_tpu.train import steps as JS
from clearvae_tpu.train.trainers import CLEARVAETrainer as JTrainer
from clearvae_tpu.train.trainers import DownstreamMLPTrainer as JProbeTrainer
from clearvae_torch.bridge import params_from_flax, probe_params_from_flax
from clearvae_torch.data.mnist import synthetic_mnist
from clearvae_torch.data.styled import make_styled_mnist
from clearvae_torch.models.mlp import ProbeMLP
from clearvae_torch.ops import metrics as MT
from clearvae_torch.train import steps as S
from clearvae_torch.train.factories import get_clearvae_trainer
from clearvae_torch.train.trainers import DownstreamMLPTrainer

Z, N, B = 8, 96, 32


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


@pytest.fixture(scope="module")
def flax_probe():
    """A flax ProbeMLP with random running stats, and features/labels."""
    mlp = JProbe(n_class=10)
    v = mlp.init({"params": jax.random.key(3)}, jnp.zeros((2, Z)))
    rs = np.random.RandomState(0)
    stats = {"BatchNorm_0": {"mean": rs.randn(256).astype(np.float32) * 0.1,
                             "var": rs.rand(256).astype(np.float32) + 0.5}}
    feats = rs.randn(N, Z).astype(np.float32)
    labels = rs.randint(0, 10, N).astype(np.int32)
    return mlp, _np_tree(v["params"]), stats, feats, labels


def _port_probe(params, stats):
    mlp = ProbeMLP(Z, 10)
    mlp.load_state_dict(probe_params_from_flax(params, stats))
    return mlp


def test_bridged_probe_logits_match_in_train_and_eval(flax_probe):
    jmlp, params, stats, feats, _ = flax_probe
    mlp = _port_probe(params, stats)
    ref_eval = jmlp.apply({"params": params, "batch_stats": stats}, feats,
                          train=False)
    ref_train, muts = jmlp.apply({"params": params, "batch_stats": stats},
                                 feats, train=True, mutable=["batch_stats"])
    got_eval = mlp(torch.as_tensor(feats), train=False)
    got_train = mlp(torch.as_tensor(feats), train=True)
    np.testing.assert_allclose(got_eval.detach().numpy(), ref_eval,
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got_train.detach().numpy(), ref_train,
                               rtol=1e-5, atol=1e-5)
    bn = muts["batch_stats"]["BatchNorm_0"]
    np.testing.assert_allclose(mlp.bn.running_mean.numpy(), bn["mean"],
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(mlp.bn.running_var.numpy(), bn["var"],
                               rtol=1e-5, atol=1e-6)


def _jax_state(params, stats, tx):
    return JS.TrainState(params=params, batch_stats=stats,
                         opt_state=tx.init(params),
                         step=jnp.zeros((), jnp.int32))


# dense_0's bias feeds BatchNorm, which subtracts its batch mean: its
# gradient is zero analytically, ~1e-9 of float noise in either framework,
# and Adam turns that noise into an update of about lr·sign(noise). So it,
# and the running mean that accumulates it, are held to lr per step instead;
# everything else to the stated bar.
_NOISE_DRIVEN = ("dense_0.bias", "bn.running_mean")


def _assert_probe_equal(mlp, jstate, tol, steps, lr=3e-4):
    ref = probe_params_from_flax(_np_tree(jstate.params),
                                 _np_tree(jstate.batch_stats))
    for k, v in mlp.state_dict().items():
        if k in _NOISE_DRIVEN:
            assert float((v - ref[k]).abs().max()) <= 2 * lr * steps, k
        else:
            np.testing.assert_allclose(v.numpy(), ref[k].numpy(), rtol=tol,
                                       atol=tol, err_msg=k)


def test_probe_feature_step_matches_jax(flax_probe):
    jmlp, params, stats, feats, labels = flax_probe
    tx = optax.adam(3e-4)
    jstate, jm = JS.make_probe_feature_step(jmlp, tx)(
        _jax_state(params, stats, tx), jnp.asarray(feats[:B]),
        jnp.asarray(labels[:B]))
    mlp = _port_probe(params, stats)
    step = S.make_probe_feature_step(mlp, torch.optim.Adam(mlp.parameters(),
                                                           lr=3e-4))
    m = step(torch.as_tensor(feats[:B]), torch.as_tensor(labels[:B]).long())
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5)
    _assert_probe_equal(mlp, jstate, 1e-5, steps=1)
    # the batch statistics come from the forward, before any update
    np.testing.assert_allclose(
        mlp.bn.running_mean.numpy(),
        np.asarray(jstate.batch_stats["BatchNorm_0"]["mean"]), atol=1e-5)


def test_probe_feature_epochs_match_jax(flax_probe):
    jmlp, params, stats, feats, labels = flax_probe
    nb = N // B
    bi = np.stack([np.random.RandomState(e).permutation(N)[: nb * B]
                   .reshape(nb, B) for e in range(2)])
    tx = optax.adam(3e-4)
    jstate, jm = JS.make_probe_feature_epochs_fn(jmlp, tx)(
        _jax_state(params, stats, tx), jnp.asarray(feats), jnp.asarray(labels),
        jnp.asarray(bi))
    mlp = _port_probe(params, stats)
    m = S.make_probe_feature_epochs_fn(
        mlp, torch.optim.Adam(mlp.parameters(), lr=3e-4))(
        torch.as_tensor(feats), torch.as_tensor(labels).long(),
        torch.as_tensor(bi))
    np.testing.assert_allclose(m["loss"].numpy(), np.asarray(jm["loss"]),
                               rtol=1e-4)
    _assert_probe_equal(mlp, jstate, 1e-4, steps=2 * nb)


def test_fused_style_encode_matches_jax():
    imgs, labels = synthetic_mnist(40, seed=2)
    jt = JTrainer(JVAE(total_z_dim=16), optax.adam(5e-4), sim_fn="cosine",
                  hyperparameter={"beta": 1 / 8, "alpha": 100.0,
                                  "temperature": 0.1, "ps": True},
                  seed=0, mig_backend="numpy")
    jt.state = jt._init_state()
    jfeats, jy = JProbeTrainer(jt)._encode_all(
        jax_make_styled(imgs, labels, seed=5), batch_size=16,
        style_on_device=True)
    tt = get_clearvae_trainer(beta=1 / 8, ps=True, vae_lr=5e-4, z_dim=16,
                              alpha=100, temperature=0.1, device="cpu")
    tt.model.load_state_dict(params_from_flax(_np_tree(jt.state.params),
                                              _np_tree(jt.state.batch_stats)))
    tds = make_styled_mnist(imgs, labels, seed=5)
    feats, y = DownstreamMLPTrainer(tt)._encode_all(tds, batch_size=16,
                                                    style_on_device=True)
    np.testing.assert_array_equal(y.numpy(), jy)
    np.testing.assert_allclose(feats.numpy(), jfeats, atol=1e-5, rtol=0)
    # the fused pass equals encoding the materialized dataset
    plain, _ = DownstreamMLPTrainer(tt)._encode_all(tds, batch_size=16)
    np.testing.assert_allclose(feats.numpy(), plain.numpy(), atol=1e-6, rtol=0)


def test_accuracy_and_auc_equal_jax():
    rs = np.random.RandomState(2)
    y = rs.randint(0, 10, 300)
    logits = (rs.randn(300, 10) + 1.5 * np.eye(10)[y]).astype(np.float32)
    logits[:20] = np.round(logits[:20])          # tied scores
    assert MT.accuracy(logits, y) == JMT.accuracy(logits, y)
    assert MT.auc(torch.as_tensor(logits), torch.as_tensor(y)) == \
        JMT.auc(logits, y)


def test_mig_torch_backend_close_to_numpy():
    rs = np.random.RandomState(0)
    n = 400
    y = rs.randint(0, 4, size=n)
    zc = rs.randn(n, 4) + 0.8 * y[:, None] * (np.arange(4) % 2)
    zs = rs.randn(n, 3) + 0.3 * y[:, None]
    np.testing.assert_allclose(
        MT.mutual_info_classif_torch(zc, y, device="cpu"),
        MT.mutual_info_classif_np(zc, y), rtol=0.05, atol=0.02)
    mig_np = MT.mutual_info_gap(y, zc, zs, backend="numpy")
    mig_t = MT.mutual_info_gap(torch.as_tensor(y), torch.as_tensor(zc),
                               torch.as_tensor(zs), backend="torch")
    assert abs(mig_t - mig_np) <= 0.02 + 0.05 * abs(mig_np)
    # JAX's name of its on-device backend; the port's is "torch"
    with pytest.raises(ValueError):
        MT.mutual_info_gap(y, zc, zs, backend="jnp")
