"""A CPU stand-in for "capturable": what a CUDA graph capture refuses, found
where there is no card. Under a ``TorchDispatchMode`` that records every
data-dependent operation (one that needs the host to read the data:
``nonzero``, ``_local_scalar_dense`` (``.item()``), ``is_nonzero``,
``masked_select``, ``equal``, boolean indexing) and every tensor made from
host data (``lift_fresh``: ``torch.tensor`` / ``torch.as_tensor`` of
Python or numpy values, a host→device copy on a card), the styler and the
bodies that the port captures must record nothing once their warm-up call
has made their constants, as the graph's warm-up steps do on the card.

Adam's update is the one part left out: on the card it is torch's fused,
capturable Adam (``trainers.adam``), whose CPU form, which these tests run,
reads its step count on the host."""

import contextlib

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from clearvae_torch.data.mnist import synthetic_mnist
from clearvae_torch.data.styled import StyledDataset, make_styled_mnist
from clearvae_torch.ops.corruptions import (ALL_CORRUPTIONS, CORRUPTIONS,
                                            EXPERIMENT_STYLES, style_batch)
from clearvae_torch.train import factories as TF
from clearvae_torch.train import steps as S
from clearvae_torch.train.trainers import DownstreamMLPTrainer

aten = torch.ops.aten
DATA_DEPENDENT = {aten.nonzero, aten._local_scalar_dense, aten.is_nonzero,
                  aten.masked_select, aten.equal, aten.lift_fresh,
                  aten.lift_fresh_copy}
INDEXING = {aten.index, aten.index_put, aten.index_put_,
            aten._index_put_impl_}


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One intra-op thread: these small CPU workloads run several to a
    machine under the parallel test run, where more threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class HostReads(TorchDispatchMode):
    """Records the data-dependent operations and host-made tensors that run
    under it, outside ``paused()``."""

    def __init__(self):
        super().__init__()
        self.seen: list = []
        self._paused = 0

    @contextlib.contextmanager
    def paused(self):
        self._paused += 1
        try:
            yield
        finally:
            self._paused -= 1

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if not self._paused:
            packet = func.overloadpacket
            if packet in DATA_DEPENDENT:
                self.seen.append(str(func))
            elif packet in INDEXING and any(
                    isinstance(i, torch.Tensor)
                    and i.dtype in (torch.bool, torch.uint8)
                    for i in args[1] if i is not None):
                self.seen.append(f"{func} by a boolean mask")
        return func(*args, **kwargs)


def _pause_optimizers(mode, *optimizers):
    for opt in optimizers:
        step = opt.step

        def paused(*a, _step=step, **k):
            with mode.paused():
                return _step(*a, **k)

        opt.step = paused


def test_the_checker_sees_what_a_capture_refuses():
    x = torch.arange(6.0)
    with HostReads() as mode:
        torch.nonzero(x > 2)
        x[x > 2]
        x.sum().item()
        torch.tensor([1.0, 2.0])
        torch.as_tensor(np.ones(3))
        bool(x.sum() > 0)
    assert len(mode.seen) == 6, mode.seen
    with HostReads() as mode:
        torch.where(x > 2, x, -x)
        x[x.long() % 3]
    assert mode.seen == []


def _all_six_styles(n=64, seed=2):
    """A StyledDataset whose every batch of 32 holds all six styles."""
    imgs, labels = synthetic_mnist(n, seed=seed)
    sidx = (np.arange(n) % len(EXPERIMENT_STYLES)).astype(np.int32)
    return StyledDataset(imgs, labels, sidx, EXPERIMENT_STYLES, seed)


@pytest.mark.parametrize("styles", [
    EXPERIMENT_STYLES, tuple((n, None) for n in CORRUPTIONS),
    tuple((n, None) for n in ALL_CORRUPTIONS)],
    ids=["experiment", "mnist_c", "all"])
def test_style_batch_reads_nothing_on_the_host(styles):
    """Every style, the random ones drawing from their keys (normal's
    erfinv, Poisson's capped loops and counter) included."""
    imgs, labels = synthetic_mnist(64, seed=2)
    sidx = (np.arange(64) % len(styles)).astype(np.int32)
    ds = StyledDataset(imgs, labels, sidx, styles, 2)
    raw, sidx, draws = ds.device_arrays("cpu")
    assert sorted(set(sidx[:32].tolist())) == list(range(len(styles)))
    first = style_batch(raw[:32], sidx[:32], draws[:32], styles)  # constants
    with HostReads() as mode:
        again = style_batch(raw[:32], sidx[:32], draws[:32], styles)
    assert mode.seen == []
    assert torch.equal(first, again)


HP = dict(beta=1 / 8, vae_lr=5e-4, z_dim=16, alpha=100.0, temperature=0.1,
          ps=True, seed=0, mig_backend="numpy", device="cpu",
          verbose_period=10, hyperparameter={"fused": True})


@pytest.mark.parametrize("styled", [False, True])
def test_graphed_train_and_eval_bodies_read_nothing_on_the_host(styled):
    ds = _all_six_styles()
    t = TF.get_clearvae_trainer(**HP)
    t.fit(1, ds, batch_size=32, style_on_device=styled)
    ep = next(iter(t._graphs.values()))[1]
    rows = torch.arange(64).view(2, 32)
    with HostReads() as mode:
        _pause_optimizers(mode, t.optimizer)
        hist = ep.run(rows)                 # staging and the body, twice
    assert mode.seen == [] and hist.shape == (2, 6)
    t.evaluate(ds, batch_size=32, style_on_device=styled)
    ge = [v[1] for k, v in t._graphs.items() if k[0] == "eval"][0]
    with HostReads() as mode:
        out = ge.run(rows)
    assert mode.seen == [] and out["z_c"].shape == (64, 8)


@pytest.mark.parametrize("kind", ["tc", "mim"])
def test_graphed_adversarial_bodies_read_nothing_on_the_host(kind):
    ds = make_styled_mnist(*synthetic_mnist(64, seed=2), seed=2)
    kw = {k: v for k, v in HP.items() if k != "ps"}
    if kind == "tc":
        t = TF.get_cleartcvae_trainer(la=1, factor_cls_lr=1e-4, **kw)
        second = t.factor_optimizer
    else:
        t = TF.get_clearmimvae_trainer(mi_estimator="CLUBSample", la=3,
                                       mi_estimator_lr=2e-3, **kw)
        second = t.mi_optimizer
    t.fit(1, ds, batch_size=32)
    ep = next(iter(t._graphs.values()))[1]
    with HostReads() as mode:
        _pause_optimizers(mode, t.optimizer, second)
        ep.run(torch.arange(64).view(2, 32))
    assert mode.seen == []


def test_graphed_probe_reads_nothing_on_the_host():
    ds = make_styled_mnist(*synthetic_mnist(64, seed=2), seed=2)
    probe = DownstreamMLPTrainer(TF.get_clearvae_trainer(**HP))
    feats, labels = probe._encode_all(ds)
    fn = S.make_graphed_probe_epochs_fn(probe.mlp, probe.optimizer, feats,
                                        labels, 32)
    bi = torch.arange(64).view(1, 2, 32)
    fn(bi)
    with HostReads() as mode:
        _pause_optimizers(mode, probe.optimizer)
        loss = fn(bi)["loss"]
    assert mode.seen == [] and loss.shape == (1,)
