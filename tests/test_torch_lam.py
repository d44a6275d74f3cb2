"""The LAM-CNN in the port against the JAX package: ``stratified_shuffle``
with JAX's own uniforms (the same permutation, exactly), its strata, one
LAM step (losses, gradients, parameters and running statistics after
Adam) against ``make_lam_cnn_step``, and ``LAMCNNTrainer.fit`` through the
graphed step equal to the eager loop bit for bit."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from clearvae_tpu.models import cnn as JC
from clearvae_tpu.train import steps as JS
from clearvae_torch.bridge import cnn_params_from_flax
from clearvae_torch.data.common import ArrayDataset
from clearvae_torch.models import cnn as TC
from clearvae_torch.train import steps as TS
from clearvae_torch.train.factories import get_lamcnn_trainer

LAM_COEF = 0.5


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


def _jax_uniforms(key, n):
    """The (u1, u2) that JAX's ``stratified_shuffle`` draws from ``key``."""
    k1, k2 = jax.random.split(key)
    return np.stack([np.asarray(jax.random.uniform(k1, (n,))),
                     np.asarray(jax.random.uniform(k2, (n,)))])


@pytest.mark.parametrize("n,n_class,seed", [(8, 2, 0), (16, 4, 1),
                                            (33, 7, 2), (128, 4, 3)])
def test_stratified_shuffle_equals_jax_permutation(n, n_class, seed):
    label = np.random.RandomState(seed).randint(0, n_class, n)
    key = jax.random.key(seed + 10)
    jperm = np.asarray(JS.stratified_shuffle(jnp.arange(n), jnp.asarray(label),
                                             key))
    perm = TS.stratified_shuffle(torch.arange(n), torch.as_tensor(label),
                                 torch.as_tensor(_jax_uniforms(key, n)))
    np.testing.assert_array_equal(perm.numpy(), jperm)


@pytest.mark.parametrize("ties", [False, True])
def test_permutation_stays_within_each_stratum(ties):
    """A permutation of the rows that maps every row to one of its label;
    with every uniform equal (all ties) the order is by index, as
    np.lexsort's, so every row keeps its place."""
    rs = np.random.RandomState(4)
    label = torch.as_tensor(rs.randint(0, 5, 64))
    u = torch.full((2, 64), 0.5) if ties else torch.rand(
        2, 64, generator=torch.Generator().manual_seed(0))
    perm = TS.stratified_shuffle(torch.arange(64), label, u)
    assert sorted(perm.tolist()) == list(range(64))
    assert torch.equal(label[perm], label)
    if ties:
        assert torch.equal(perm, torch.arange(64))
    else:
        assert not torch.equal(perm, torch.arange(64))


def _lam_pair(name, size, n_class, b):
    in_ch = 1 if size == 28 else 3
    jm = getattr(JC, name)(n_class=n_class, in_channel=in_ch)
    v = jax.jit(jm.init)({"params": jax.random.key(0)},
                         jnp.zeros((b, size, size, in_ch)))
    rs = np.random.RandomState(1)
    stats = jax.tree.map(lambda a: (rs.rand(*a.shape) * 0.5 + 0.2)
                         .astype(np.float32), _np_tree(v["batch_stats"]))
    tm = getattr(TC, name)(n_class=n_class, in_channel=in_ch)
    tm.load_state_dict(cnn_params_from_flax(_np_tree(v["params"]), stats))
    x = rs.rand(b, size, size, in_ch).astype(np.float32)
    label = rs.randint(0, n_class, b)
    return jm, _np_tree(v["params"]), stats, tm, x, label


def _jax_step(jm, tx, params, stats, x, label, key):
    state = JS.TrainState(params=params, batch_stats=stats,
                          opt_state=tx.init(params),
                          step=jnp.zeros((), jnp.int32))
    step = JS.make_lam_cnn_step(jm, tx, LAM_COEF, JC.lam_head_weight)
    return step(state, jnp.asarray(x), jnp.asarray(label), key)


@pytest.mark.parametrize("name,size,n_class", [("LAMCNN", 28, 10),
                                               ("LAMCNN64", 64, 2)])
def test_lam_step_matches_jax(name, size, n_class):
    """One step from the same weights, batch and shuffle uniforms:
    ce_loss and lam_loss (rtol 1e-5), the gradients (JAX's through an
    identity optimizer: new params − params; rtol 1e-4, atol 1e-4 of the
    tensor's largest gradient: sums of cancelling terms), the
    running statistics (only the logits pass moves them; rtol 1e-5, atol
    1e-6), and the parameters after Adam(1e-4), the factory's optimizer:
    rtol 1e-5, atol 1e-6. The conv biases ahead of BatchNorm have a zero
    gradient analytically, float noise in both frameworks: it must stay
    below 1e-5. Adam's first step is lr·g/(|g| + 1e-8), so those biases,
    and any element whose gradient is below 1e-6, where the two gradients
    agree only to float noise, move by up to lr either way in each
    framework: they are held within 2·lr."""
    b, lr = 8, 1e-4
    jm, params, stats, tm, x, label = _lam_pair(name, size, n_class, b)
    key = jax.random.key(3)
    u = torch.as_tensor(_jax_uniforms(key, b))
    jstate, jm_out = _jax_step(jm, optax.identity(), params, stats, x, label,
                               key)
    jgrads = cnn_params_from_flax(
        jax.tree.map(lambda a, p: np.asarray(a) - p, jstate.params, params),
        _np_tree(jstate.batch_stats))
    adam_state, _ = _jax_step(jm, optax.adam(lr), params, stats, x, label, key)

    opt = torch.optim.Adam(tm.parameters(), lr=lr)
    m = TS.make_lam_cnn_step(tm, opt, LAM_COEF)(
        torch.as_tensor(x), torch.as_tensor(label), u)
    for k in ("ce_loss", "lam_loss"):
        np.testing.assert_allclose(float(m[k]), float(jm_out[k]), rtol=1e-5,
                                   err_msg=k)
    assert float(m["lam_loss"]) > 0
    noise = {f"net.convs.{i}.bias" for i in range(len(tm.net.convs))}
    for k, p in tm.named_parameters():
        want = jgrads[k].numpy()
        if k in noise:
            assert max(float(p.grad.abs().max()), np.abs(want).max()) < 1e-5
            continue
        np.testing.assert_allclose(p.grad.numpy(), want, rtol=1e-4,
                                   atol=1e-4 * np.abs(want).max(), err_msg=k)
    want = cnn_params_from_flax(_np_tree(adam_state.params),
                                _np_tree(adam_state.batch_stats))
    for k, v in tm.state_dict().items():
        atol = 1e-6
        if k in noise:
            atol = 2 * lr
        elif k in jgrads and "running" not in k:
            atol = np.where(np.abs(jgrads[k].numpy()) < 1e-6, 2 * lr, 1e-6)
        w = want[k].numpy()
        err = np.abs(v.numpy() - w) - (atol + 1e-5 * np.abs(w))
        assert (err <= 0).all(), (k, float(err.max()))


def _tiny_ds(n=64, n_class=4, seed=0):
    rs = np.random.RandomState(seed)
    return ArrayDataset(rs.rand(n, 28, 28, 1).astype(np.float32),
                        rs.randint(0, n_class, n), rs.randint(0, 3, n))


def test_lam_trainer_graphed_fit_equals_eager_bitwise():
    """``fit`` (the graphed step, its body uncaptured on the CPU) and
    ``fit(use_scan=False)``, 2 epochs from the same seed: the same history
    (ce_loss, lam_loss), weights and running statistics, bit for bit; the
    eager trainer built no graph."""
    ds = _tiny_ds()
    make = functools.partial(get_lamcnn_trainer, 4, LAM_COEF, seed=5,
                             verbose_period=10, device="cpu")
    graphed, eager = make(), make()
    graphed.fit(2, ds, batch_size=16)
    eager.fit(2, ds, batch_size=16, use_scan=False)
    assert not eager._graphs and graphed._graphs
    assert graphed.train_step.step == eager.train_step.step == 8
    for hg, he in zip(graphed.history, eager.history):
        assert list(hg) == ["ce_loss", "lam_loss"]
        for k in hg:
            np.testing.assert_array_equal(hg[k], he[k])
    for k, v in graphed.model.state_dict().items():
        assert torch.equal(v, eager.model.state_dict()[k]), k
    (aupr, auroc), acc = graphed.evaluate(ds, batch_size=16)
    assert 0.0 <= acc <= 1.0 and sorted(aupr) == [0, 1, 2, 3]
