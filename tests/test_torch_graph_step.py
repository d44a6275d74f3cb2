"""The graphed epoch of ``fit(use_scan=True)`` on the CPU, where its
static-buffer body runs uncaptured: the same per-batch histories, update
counts and final state as the eager fit, bit for bit, for every step that a
trainer drives. The device step counter's anneal weights against the JAX
package's ``logistic_anneal``, and a restore between two graphed fits."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clearvae_tpu.ops.schedules import logistic_anneal as jax_anneal
from clearvae_torch.config import AnnealConfig, ContrastiveConfig
from clearvae_torch.data.mnist import synthetic_mnist
from clearvae_torch.data.styled import make_styled_mnist
from clearvae_torch.models.vae import VAE
from clearvae_torch.train import factories as TF
from clearvae_torch.train import steps as S


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """These tiny CPU fits gain nothing from intra-op threads, and with
    several test workers on the machine the threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


N, BS, EPOCHS = 96, 32, 2
VAE_KW = dict(beta=1 / 8, vae_lr=5e-4, z_dim=16, seed=3, verbose_period=10,
              mig_backend="numpy", device="cpu")
CLEAR_KW = dict(alpha=100.0, temperature=0.1, **VAE_KW)
KINDS = {
    "clear-fused": ("get_clearvae_trainer",
                    dict(ps=True, hyperparameter={"fused": True}, **CLEAR_KW)),
    "clear": ("get_clearvae_trainer", dict(ps=False, **CLEAR_KW)),
    "clear-styled": ("get_clearvae_trainer",
                     dict(ps=True, hyperparameter={"fused": True},
                          **CLEAR_KW)),
    "gvae": ("get_hierarchical_vae_trainer", dict(group_mode="GVAE",
                                                  **VAE_KW)),
    "tc": ("get_cleartcvae_trainer",
           dict(la=1, factor_cls_lr=1e-4, hyperparameter={"fused": True},
                **CLEAR_KW)),
    "mim": ("get_clearmimvae_trainer",
            dict(mi_estimator="CLUBSample", la=3, mi_estimator_lr=2e-3,
                 hyperparameter={"fused": True}, **CLEAR_KW)),
    "cnn": ("get_cnn_trainer", dict(n_class=10, seed=3, verbose_period=10,
                                    device="cpu")),
}


def _dataset(seed=4):
    return make_styled_mnist(*synthetic_mnist(N, seed=seed), seed=seed)


def _trainer(kind):
    name, kw = KINDS[kind]
    return getattr(TF, name)(**kw)


def _state_equal(a, b):
    """Every tensor of two trainers' state dicts equal, bit for bit."""
    def leaves(x, path=()):
        if isinstance(x, dict):
            for k, v in x.items():
                yield from leaves(v, path + (k,))
        elif isinstance(x, (list, tuple)):
            for i, v in enumerate(x):
                yield from leaves(v, path + (i,))
        else:
            yield path, x

    la, lb = list(leaves(a.state_dict())), list(leaves(b.state_dict()))
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (p, x), (_, y) in zip(la, lb):
        if isinstance(x, torch.Tensor):
            assert torch.equal(x, y), p
        else:
            assert x == y, p


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_graphed_epoch_equals_eager_fit_bitwise(kind):
    ds = _dataset()
    styled = kind == "clear-styled"
    eager, graphed = _trainer(kind), _trainer(kind)
    r_eager = eager.fit(EPOCHS, ds, batch_size=BS, use_scan=False,
                        style_on_device=styled)
    r_graphed = graphed.fit(EPOCHS, ds, batch_size=BS, use_scan=True,
                            style_on_device=styled)
    assert eager.train_step.step == graphed.train_step.step == EPOCHS * (N // BS)
    assert len(graphed.history) == EPOCHS
    for he, hg in zip(eager.history, graphed.history):
        assert list(he) == list(hg)
        for k in he:
            assert he[k].dtype == hg[k].dtype
            np.testing.assert_array_equal(he[k], hg[k], err_msg=k)
    _state_equal(eager, graphed)
    if r_eager is not None:
        np.testing.assert_array_equal(np.asarray(r_eager, dtype=object),
                                      np.asarray(r_graphed, dtype=object))
    # one graphed epoch object, reused by the second epoch; the eager
    # reference built none, so the comparison is not the graph's with itself
    assert len(graphed._graphs) == 1
    assert eager._graphs == {}


@pytest.mark.parametrize("loc,scale", [(0.0, 1.0), (5.0, 2.0)])
def test_device_counter_anneal_matches_jax(loc, scale):
    model = VAE(total_z_dim=16)
    step = S.make_clear_vae_step(model, torch.optim.Adam(model.parameters()),
                                 AnnealConfig(beta=1 / 8, loc=loc, scale=scale),
                                 ContrastiveConfig())
    assert step.count.dtype == torch.int64 and step.count.ndim == 0
    for s in range(40):
        assert step.step == s
        want = np.asarray(jax_anneal(jnp.int32(s), beta=1 / 8, loc=loc,
                                     scale=scale))
        np.testing.assert_allclose(step._anneal().numpy(), want, rtol=1e-6)
        step.count.add_(1)


def test_restore_between_graphed_fits_drops_the_graph(tmp_path):
    ds = _dataset()
    t = _trainer("clear-fused")
    t.fit(1, ds, batch_size=BS, use_scan=True,
          checkpoint_dir=str(tmp_path / "ck"))
    key = (id(ds), BS, False)
    first = t._graphs[key][1]
    t.fit(1, ds, batch_size=BS, use_scan=True, start_epoch=1)
    # the same graphed epoch served both fits
    assert t._graphs[key][1] is first
    after_epoch1 = {k: v.clone() for k, v in t.model.state_dict().items()}
    hist1 = t.history[-1]
    t.restore_checkpoint(str(tmp_path / "ck"))
    assert t._graphs == {}
    assert t.train_step.step == N // BS
    t.fit(1, ds, batch_size=BS, use_scan=True, start_epoch=1)
    assert t._graphs[key][1] is not first
    # epoch 1 again from the restored weights, moments and generator: the
    # same steps as the first time
    for k in hist1:
        np.testing.assert_array_equal(t.history[-1][k], hist1[k], err_msg=k)
    for k, v in t.model.state_dict().items():
        assert torch.equal(v, after_epoch1[k]), k


def test_graph_launches_move_the_capture_counts_to_the_replays():
    """What the wrappers count during a capture is taken off the counters
    and added back once per replay; a capture that raises leaves the
    counters as they were."""
    from clearvae_torch.ops.kernels import fused_loss as FL
    from clearvae_torch.ops.kernels import style as K3
    from clearvae_torch.ops.kernels.counts import GraphLaunches

    FL.reset_launches()
    K3.reset_launches()
    FL.LAUNCHES["snn_fwd"] = 5
    gl = GraphLaunches()
    with gl.capture():
        FL.LAUNCHES["snn_fwd"] += 2
        FL.LAUNCHES["snn_bwd"] += 1
        K3.LAUNCHES["style"] += 1
    assert FL.LAUNCHES["snn_fwd"] == 5 and FL.LAUNCHES["snn_bwd"] == 0
    assert K3.LAUNCHES["style"] == 0
    for _ in range(3):
        gl.replay()
    assert FL.LAUNCHES["snn_fwd"] == 11 and FL.LAUNCHES["snn_bwd"] == 3
    assert K3.LAUNCHES["style"] == 3
    assert FL.LAUNCHES["clear_latent_fwdgrad"] == 0
    with pytest.raises(RuntimeError):
        with GraphLaunches().capture():
            FL.LAUNCHES["clear_latent_bwd"] += 1
            raise RuntimeError("capture failed")
    assert FL.LAUNCHES["clear_latent_bwd"] == 0
    FL.reset_launches()
    K3.reset_launches()
