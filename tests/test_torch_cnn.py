"""The CNN baseline in the port against the JAX package: SimpleCNN's logits
in train and eval mode through the bridge, one CNN train step, and the
trainer's evaluation with styling on the device equal to the materialized
path."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from clearvae_tpu.models.cnn import SimpleCNN as JCNN
from clearvae_tpu.train import steps as JS
from clearvae_torch.bridge import cnn_params_from_flax
from clearvae_torch.data.mnist import synthetic_mnist
from clearvae_torch.data.styled import make_styled_mnist, train_valid_split
from clearvae_torch.models.cnn import SimpleCNN
from clearvae_torch.ops.kernels import style as K3
from clearvae_torch.train import steps as TS
from clearvae_torch.train.factories import get_cnn_trainer

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


def _pair():
    jm = JCNN(n_class=10)
    v = jm.init({"params": jax.random.key(0)}, jnp.zeros((2, 28, 28, 1)))
    rs = np.random.RandomState(0)
    stats = jax.tree.map(lambda a: (rs.rand(*a.shape) * 0.5 + 0.2)
                         .astype(np.float32), _np_tree(v["batch_stats"]))
    tm = SimpleCNN(n_class=10)
    tm.load_state_dict(cnn_params_from_flax(_np_tree(v["params"]), stats))
    x = rs.rand(B, 28, 28, 1).astype(np.float32)
    lbl = rs.randint(0, 10, B)
    return jm, _np_tree(v["params"]), stats, tm, x, lbl


def test_simple_cnn_logits_match_flax_in_train_and_eval():
    jm, params, stats, tm, x, _ = _pair()
    jeval = jm.apply({"params": params, "batch_stats": stats}, x, train=False)
    jtrain, muts = jm.apply({"params": params, "batch_stats": stats}, x,
                            train=True, mutable=["batch_stats"])
    with torch.no_grad():
        np.testing.assert_allclose(tm(torch.as_tensor(x), train=False).numpy(),
                                   np.asarray(jeval), rtol=1e-5, atol=2e-5)
        np.testing.assert_allclose(tm(torch.as_tensor(x), train=True).numpy(),
                                   np.asarray(jtrain), rtol=1e-5, atol=2e-5)
    want = cnn_params_from_flax(params, _np_tree(muts["batch_stats"]))
    for k, v in tm.state_dict().items():
        if "running" in k:
            np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=1e-5,
                                       atol=1e-6, err_msg=k)


def test_cnn_step_matches_jax():
    """Under SGD, whose update is linear in the gradient: Adam's first step
    is lr·g/(|g| + 1e-8), which moves a weight whose gradient is at float
    noise (hidden units that ReLU zeroes for most of the batch, the biases
    ahead of BatchNorm) by up to lr either way, in both frameworks."""
    jm, params, stats, tm, x, lbl = _pair()
    tx = optax.sgd(0.05)
    state = JS.TrainState(params=params, batch_stats=stats,
                          opt_state=tx.init(params),
                          step=jnp.zeros((), jnp.int32))
    jstate, jmetrics = JS.make_cnn_step(jm, tx)(state, jnp.asarray(x),
                                                jnp.asarray(lbl), None)
    m = TS.make_cnn_step(tm, torch.optim.SGD(tm.parameters(), lr=0.05))(
        torch.as_tensor(x), torch.as_tensor(lbl).long())
    np.testing.assert_allclose(float(m["loss"]), float(jmetrics["loss"]),
                               rtol=1e-5)
    want = cnn_params_from_flax(_np_tree(jstate.params),
                                _np_tree(jstate.batch_stats))
    for k, v in tm.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=1e-4,
                                   atol=1e-5, err_msg=k)


def test_cnn_trainer_styled_evaluate_equals_materialized():
    imgs, labels = synthetic_mnist(200, seed=6)
    train, test = train_valid_split(make_styled_mnist(imgs, labels, seed=6),
                                    0.7, seed=6)
    t = get_cnn_trainer(n_class=10, seed=1, device="cpu")
    assert t.fit(1, train, test, batch_size=32, style_on_device=True) is None
    assert list(t.history[0]) == ["loss"] and len(t.history[0]["loss"]) == 4
    assert np.isfinite(t.history[0]["loss"]).all()
    K3.reset_launches()
    styled = t.evaluate(test, batch_size=32, style_on_device=True)
    assert styled == t.evaluate(test, batch_size=32)
    assert K3.LAUNCHES["style"] == 0
    (aupr, auroc), acc = styled
    assert sorted(aupr) == list(range(10)) and 0.0 <= acc <= 1.0
