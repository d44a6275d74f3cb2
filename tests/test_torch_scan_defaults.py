"""The JAX package's scanned defaults in the port, on the CPU (where the
captured step's body runs uncaptured): ``fit`` and ``evaluate`` default to
it and equal their eager loops bit for bit; the graphed ``evaluate`` and
the ``epochs_per_scan`` fit equal the JAX package's programs from bridged
weights and its key chain; the graphed probe equals the eager one and
JAX's. The scan knobs are ``test_torch_scan_knobs.py``'s."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from clearvae_tpu.data.common import ArrayDataset as JArrayDataset
from clearvae_tpu.data.mnist import synthetic_mnist as jax_synthetic_mnist
from clearvae_tpu.data.styled import make_styled_mnist as jax_make_styled
from clearvae_tpu.models.mlp import ProbeMLP as JProbe
from clearvae_tpu.models.vae import VAE as JVAE
from clearvae_tpu.train import steps as JS
from clearvae_tpu.train.trainers import CLEARVAETrainer as JTrainer
from clearvae_tpu.train.trainers import HierarchicalVAETrainer as JHTrainer
from clearvae_torch.bridge import params_from_flax, probe_params_from_flax
from clearvae_torch.data.mnist import synthetic_mnist
from clearvae_torch.data.styled import make_styled_mnist
from clearvae_torch.models.mlp import ProbeMLP
from clearvae_torch.train import factories as TF
from clearvae_torch.train import steps as S
from clearvae_torch.train.trainers import DownstreamMLPTrainer
from test_torch_graph_step import KINDS, _state_equal, _trainer


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


HP = dict(beta=1 / 8, ps=True, alpha=100.0, temperature=0.1)
SEED = 0


def _np_tree(t):
    return jax.tree.map(np.asarray, t)


def _eps(jm, variables, key, n):
    """The (eps_c, eps_s) that VAE.__call__ draws from ``key``, as the
    port's [2, n, z] draw."""
    zeros = jnp.zeros((n, jm.z_dim))

    def draw(mdl):
        return mdl.sample(zeros, zeros), mdl.sample(zeros, zeros)

    return torch.as_tensor(np.stack(
        jm.apply(variables, method=draw, rngs={"reparam": key})))


def _histories_equal(a, b):
    assert len(a.history) == len(b.history)
    for ha, hb in zip(a.history, b.history):
        assert list(ha) == list(hb)
        for k in ha:
            assert ha[k].dtype == hb[k].dtype
            np.testing.assert_array_equal(ha[k], hb[k], err_msg=k)


def _styled(n, seed=4):
    return make_styled_mnist(*synthetic_mnist(n, seed=seed), seed=seed)


# ---------------------------------------------------------------------------
# fit: the default is the graphed program, equal to the eager loop
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_default_fit_is_the_graph_and_equals_eager(kind):
    ds = _styled(64)
    styled = kind == "clear-styled"
    runs = {}
    for mode, kw in (("default", {}), ("scan", {"use_scan": True}),
                     ("eager", {"use_scan": False})):
        t = _trainer(kind)
        r = t.fit(2, ds, batch_size=32, style_on_device=styled, **kw)
        runs[mode] = (t, r)
    for mode in ("scan", "eager"):
        _histories_equal(runs["default"][0], runs[mode][0])
        _state_equal(runs["default"][0], runs[mode][0])
        if runs[mode][1] is not None:
            np.testing.assert_array_equal(
                np.asarray(runs["default"][1], dtype=object),
                np.asarray(runs[mode][1], dtype=object))
    assert len(runs["default"][0]._graphs) == 1
    assert len(runs["scan"][0]._graphs) == 1
    assert runs["eager"][0]._graphs == {}


# ---------------------------------------------------------------------------
# evaluate: graphed = eager, and = JAX's scanned evaluate
# ---------------------------------------------------------------------------

N_EVAL, BS = 72, 32          # two full batches and a ragged tail of 8
EVAL_CASES = ["clear", "clear-styled", "gvae-evidence", "mlvae"]


def _eval_setup(case):
    """(JAX trainer, port trainer with its weights, JAX dataset, port
    dataset, evaluate kwargs)."""
    imgs, labels = synthetic_mnist(N_EVAL, seed=1)
    jimgs, jlabels = jax_synthetic_mnist(N_EVAL, seed=1)
    np.testing.assert_array_equal(imgs, jimgs)
    if case.startswith("clear"):
        jm = JVAE(total_z_dim=16)
        jt = JTrainer(jm, optax.adam(5e-4), sim_fn="cosine",
                      hyperparameter={**HP, "fused": True}, seed=SEED,
                      mig_backend="numpy")
        tt = TF.get_clearvae_trainer(vae_lr=5e-4, z_dim=16, seed=SEED,
                                     mig_backend="numpy", device="cpu",
                                     hyperparameter={"fused": True}, **HP)
    else:
        mode = "GVAE" if case.startswith("gvae") else "MLVAE"
        jm = JVAE(total_z_dim=16, group_mode=mode, n_classes=10)
        jt = JHTrainer(jm, optax.adam(5e-4), {"beta": 1 / 8}, seed=SEED,
                       mig_backend="numpy")
        tt = TF.get_hierarchical_vae_trainer(beta=1 / 8, vae_lr=5e-4, z_dim=16,
                                             group_mode=mode, seed=SEED,
                                             mig_backend="numpy", device="cpu")
    jt.state = jt._init_state()
    tt.model.load_state_dict(params_from_flax(_np_tree(jt.state.params),
                                              _np_tree(jt.state.batch_stats)))
    kw = {}
    if case == "clear-styled":
        kw["style_on_device"] = True
    if case == "gvae-evidence":
        kw["with_evidence_acc"] = True
    if case == "clear-styled":
        jds = jax_make_styled(jimgs, jlabels, seed=3)
        tds = make_styled_mnist(imgs, labels, seed=3)
    else:     # JAX's styled pixels, materialized, for both
        jds = tds = JArrayDataset(np.asarray(jax_make_styled(
            jimgs, jlabels, seed=3).materialize())[..., None], jlabels,
            np.zeros(N_EVAL, np.int32))
    return jm, jt, tt, jds, tds, kw


@pytest.mark.parametrize("case", EVAL_CASES)
def test_graphed_evaluate_equals_eager_and_jax(case):
    jm, jt, tt, jds, tds, kw = _eval_setup(case)
    res = {}
    for use_scan in (True, False):
        tt.generator.manual_seed(7)
        res[use_scan] = (tt.evaluate(tds, batch_size=BS, use_scan=use_scan,
                                     **kw), dict(tt.last_eval_totals))
    assert res[True] == res[False]
    assert len(tt._graphs) == 1 and next(iter(tt._graphs))[0] == "eval"
    # JAX's key chain after init: one split for the full batches' scanned
    # program (split per batch), one for the ragged tail
    variables = {"params": jt.state.params, "batch_stats": jt.state.batch_stats}
    rng = jax.random.split(jax.random.key(SEED))[0]
    rng, k = jax.random.split(rng)
    queue = [_eps(jm, variables, kk, BS)
             for kk in jax.random.split(k, N_EVAL // BS)]
    rng, k = jax.random.split(rng)
    queue.append(_eps(jm, variables, k, N_EVAL % BS))
    tt._draw_eps = lambda n, out=None: queue.pop(0)
    jmig, jmse = jt.evaluate(jds, batch_size=BS, **kw)
    mig, mse = tt.evaluate(tds, batch_size=BS, **kw)
    assert not queue
    # the bars of tests/test_torch_trainer.py's bridged evaluation
    np.testing.assert_allclose(mse, jmse, rtol=1e-4)
    assert set(tt.last_eval_totals) == set(jt.last_eval_totals)
    for k, v in jt.last_eval_totals.items():
        np.testing.assert_allclose(tt.last_eval_totals[k], v, rtol=1e-4,
                                   atol=1e-5, err_msg=k)
    assert np.isfinite(mig) and abs(mig - jmig) < 0.05


def test_evaluate_reuses_its_graph_per_eval_step():
    _, _, tt, _, tds, _ = _eval_setup("gvae-evidence")
    for flag in (False, True, False, True):
        tt.evaluate(tds, batch_size=BS, with_evidence_acc=flag)
    assert sorted(k[1] == id(tt._eval_steps[True]) for k in tt._graphs) == \
        [False, True]


def test_evaluate_keeps_one_graph_across_datasets():
    """Each new dataset replaces the eval graph of the last one (with its
    resident copy), so a trainer that evaluates many keeps one; each
    answer still equals the eager loop's."""
    _, _, tt, _, _, _ = _eval_setup("clear")
    sets = [_styled(40, seed=s) for s in (1, 2, 3)]
    for ds in sets + sets[:1]:
        got = []
        for use_scan in (True, False):
            tt.generator.manual_seed(7)
            got.append((tt.evaluate(ds, batch_size=16, use_scan=use_scan),
                        dict(tt.last_eval_totals)))
        assert got[0] == got[1]
        assert len(tt._graphs) == 1
        assert next(iter(tt._graphs.values()))[0] is ds


def test_epochs_per_scan_keeps_the_last_batch_of_each_epoch():
    ds = _styled(96)
    one, two = _trainer("clear-fused"), _trainer("clear-fused")
    one.fit(3, ds, batch_size=32)
    two.fit(3, ds, batch_size=32, epochs_per_scan=2)      # blocks of 2 and 1
    _state_equal(one, two)
    assert [len(h["loss"]) for h in two.history] == [2, 1]
    last = [{k: v[-1] for k, v in h.items()} for h in one.history]
    for k in last[0]:
        np.testing.assert_array_equal(
            np.concatenate([h[k] for h in two.history]),
            np.asarray([h[k] for h in last], np.float32), err_msg=k)
    # ignored on the styled path and by the eager loop, as in JAX
    for kw in ({"style_on_device": True}, {"use_scan": False}):
        t = _trainer("clear-fused")
        t.fit(2, ds, batch_size=32, epochs_per_scan=2, **kw)
        assert [len(h["loss"]) for h in t.history] == [3, 3]


def test_epochs_per_scan_histories_equal_jax_multi_epoch_fit():
    """JAX's ``make_multi_epoch_fn`` fit (``epochs_per_scan=2``, 3 epochs:
    blocks of 2 and 1) against the port's, from bridged weights and the
    draws of JAX's key chain: one split per block, split per epoch of the
    block, split per batch."""
    n_train, bs, epochs = 128, 32, 3
    imgs, labels = jax_synthetic_mnist(n_train, seed=SEED)
    styled = np.asarray(jax_make_styled(imgs, labels, seed=SEED)
                        .materialize())[..., None]
    train = JArrayDataset(styled, labels, np.zeros(n_train, np.int32))
    jm = JVAE(total_z_dim=16)
    jt = JTrainer(jm, optax.adam(5e-4), sim_fn="cosine",
                  hyperparameter={**HP, "fused": True}, seed=SEED,
                  mig_backend="numpy")
    jt.state = jt._init_state()
    variables = {"params": jt.state.params, "batch_stats": jt.state.batch_stats}
    tt = TF.get_clearvae_trainer(vae_lr=5e-4, z_dim=16, seed=SEED,
                                 mig_backend="numpy", device="cpu",
                                 hyperparameter={"fused": True}, **HP)
    tt.model.load_state_dict(params_from_flax(_np_tree(variables["params"]),
                                              _np_tree(variables["batch_stats"])))
    rng = jax.random.split(jax.random.key(SEED))[0]
    queue = []
    for block in (2, 1):
        rng, k = jax.random.split(rng)
        for ke in jax.random.split(k, block):
            queue += [_eps(jm, variables, kk, bs)
                      for kk in jax.random.split(ke, n_train // bs)]
    tt._draw_eps = lambda n, out=None: queue.pop(0)
    jhist = []
    jt._post_train_epoch = jhist.append
    jt.fit(epochs, train, batch_size=bs, epochs_per_scan=2)
    tt.fit(epochs, train, batch_size=bs, epochs_per_scan=2)
    assert not queue
    assert len(tt.history) == len(jhist) == 2
    # single steps, not epoch means: the total loss at tests/
    # test_torch_trainer.py's per-step bar, recon and c_loss at tests/
    # test_torch_adversarial_fit.py's per-step bar of its large terms, the
    # small terms at its bar for them (Adam's moves on float noise: 1.1e-4
    # on recon and 8.4e-3 on kl_c measured)
    bars = {"loss": 1e-4, "recon": 3e-4, "c_loss": 3e-4}
    for th, jh in zip(tt.history, jhist):
        assert set(th) == set(jh)
        for k in th:
            rtol = bars.get(k, 1e-2)
            np.testing.assert_allclose(th[k], np.asarray(jh[k]), rtol=rtol,
                                       err_msg=k)


# ---------------------------------------------------------------------------
# the probe: graphed = eager, and = JAX's one-program probe
# ---------------------------------------------------------------------------


def test_graphed_probe_equals_eager_probe():
    ds = _styled(96)
    vae = _trainer("clear-fused")
    probes = [DownstreamMLPTrainer(vae, seed=1) for _ in range(2)]
    for p, use_scan in zip(probes, (True, False)):
        p.fit(3, ds, batch_size=32, use_scan=use_scan)
    for k, v in probes[0].mlp.state_dict().items():
        assert torch.equal(v, probes[1].mlp.state_dict()[k]), k
    assert probes[0].evaluate(ds, batch_size=32) == \
        probes[1].evaluate(ds, batch_size=32)


def test_graphed_probe_matches_jax():
    """``make_graphed_probe_epochs_fn`` against the JAX package's
    ``make_probe_feature_epochs_fn``, at tests/test_torch_probe.py's bars."""
    z, n, b = 8, 96, 32
    jmlp = JProbe(n_class=10)
    v = jmlp.init({"params": jax.random.key(3)}, jnp.zeros((2, z)))
    rs = np.random.RandomState(0)
    stats = {"BatchNorm_0": {"mean": rs.randn(256).astype(np.float32) * 0.1,
                             "var": rs.rand(256).astype(np.float32) + 0.5}}
    feats = rs.randn(n, z).astype(np.float32)
    labels = rs.randint(0, 10, n).astype(np.int32)
    params = _np_tree(v["params"])
    nb = n // b
    bi = np.stack([np.random.RandomState(e).permutation(n)[: nb * b]
                   .reshape(nb, b) for e in range(2)])
    tx = optax.adam(3e-4)
    jstate = JS.TrainState(params=params, batch_stats=stats,
                           opt_state=tx.init(params),
                           step=jnp.zeros((), jnp.int32))
    jstate, jm = JS.make_probe_feature_epochs_fn(jmlp, tx)(
        jstate, jnp.asarray(feats), jnp.asarray(labels), jnp.asarray(bi))
    mlp = ProbeMLP(z, 10)
    mlp.load_state_dict(probe_params_from_flax(params, stats))
    m = S.make_graphed_probe_epochs_fn(
        mlp, torch.optim.Adam(mlp.parameters(), lr=3e-4),
        torch.as_tensor(feats), torch.as_tensor(labels).long(), b)(
        torch.as_tensor(bi))
    np.testing.assert_allclose(m["loss"].numpy(), np.asarray(jm["loss"]),
                               rtol=1e-4)
    # tests/test_torch_probe.py: dense_0's bias (and the running mean that
    # accumulates it) moves by Adam on float noise, lr a step at most
    ref = probe_params_from_flax(_np_tree(jstate.params),
                                 _np_tree(jstate.batch_stats))
    for k, val in mlp.state_dict().items():
        if k in ("dense_0.bias", "bn.running_mean"):
            assert float((val - ref[k]).abs().max()) <= 2 * 3e-4 * 2 * nb, k
        else:
            np.testing.assert_allclose(val.numpy(), ref[k].numpy(), rtol=1e-4,
                                       atol=1e-4, err_msg=k)
