"""Checkpoints of the port's trainers: the round trip of every part of the
trainer state, an exact resume (``fit(1)``, save, a fresh trainer restores
and runs ``fit(1, start_epoch=1)``: the second epoch of ``fit(2)``, bit for
bit; tests/test_utils.py:146 for the JAX package), and a JAX ``TrainState``
bridged into a port trainer, Adam's moments and count included, whose next
step makes the JAX package's update and leaves its moments; planted faults
in the bridged Adam state fail that comparison."""

import functools
import json
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from clearvae_tpu.config import AnnealConfig as JAnneal
from clearvae_tpu.config import ContrastiveConfig as JContr
from clearvae_tpu.models.vae import VAE as JVAE
from clearvae_tpu.train.steps import init_vae_state, make_clear_vae_step
from clearvae_torch.bridge import params_from_flax, trainer_state_from_flax
from clearvae_torch.data.mnist import synthetic_mnist
from clearvae_torch.data.styled import make_styled_mnist
from clearvae_torch.train import factories as TF
from clearvae_torch.utils.checkpoint import (latest_checkpoint,
                                             restore_checkpoint,
                                             save_checkpoint)


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """These tiny CPU fits gain nothing from intra-op threads, and with
    several test workers on the machine the threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


N, BS = 96, 32
VAE_KW = dict(beta=1 / 8, vae_lr=5e-4, z_dim=16, seed=5, verbose_period=10,
              mig_backend="numpy", device="cpu")
CLEAR_KW = dict(alpha=100.0, temperature=0.1, **VAE_KW)
KINDS = {
    "clear": ("get_clearvae_trainer",
              dict(ps=True, hyperparameter={"fused": True}, **CLEAR_KW)),
    "gvae": ("get_hierarchical_vae_trainer", dict(group_mode="GVAE",
                                                  **VAE_KW)),
    "tc": ("get_cleartcvae_trainer",
           dict(la=1, factor_cls_lr=1e-4, hyperparameter={"fused": True},
                **CLEAR_KW)),
    "mim": ("get_clearmimvae_trainer",
            dict(mi_estimator="CLUBSample", la=3, mi_estimator_lr=2e-3,
                 hyperparameter={"fused": True}, **CLEAR_KW)),
    "cnn": ("get_cnn_trainer", dict(n_class=10, seed=5, verbose_period=10,
                                    device="cpu")),
}


def _dataset():
    return make_styled_mnist(*synthetic_mnist(N, seed=6), seed=6)


def _trainer(kind):
    name, kw = KINDS[kind]
    return getattr(TF, name)(**kw)


def _leaves(x, path=()):
    if isinstance(x, dict):
        for k, v in x.items():
            yield from _leaves(v, path + (k,))
    elif isinstance(x, (list, tuple)):
        for i, v in enumerate(x):
            yield from _leaves(v, path + (i,))
    else:
        yield path, x


def _assert_same_state(a: dict, b: dict):
    la, lb = list(_leaves(a)), list(_leaves(b))
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (p, x), (_, y) in zip(la, lb):
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(x.cpu(), y.cpu()), p
        else:
            assert x == y, p


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_checkpoint_round_trip(kind, tmp_path):
    t = _trainer(kind)
    t.fit(1, _dataset(), batch_size=BS)
    path = t.save_checkpoint(str(tmp_path / "ck"), metadata={"epoch": 0})
    steps = N // BS
    assert os.path.basename(path) == f"step_{steps:08d}.pt"
    assert latest_checkpoint(str(tmp_path / "ck")) == path
    with open(tmp_path / "ck" / f"step_{steps:08d}.meta.json") as f:
        assert json.load(f) == {"epoch": 0}
    state = restore_checkpoint(path)
    assert set(state) == {"modules", "optimizers", "step", "generator"}
    assert set(state["modules"]) == set(t.MODULES)
    assert set(state["optimizers"]) == set(t.OPTIMIZERS)
    _assert_same_state(state, t.state_dict())
    # into a fresh trainer: every part, the generator's state included
    fresh = _trainer(kind)
    fresh.restore_checkpoint(str(tmp_path / "ck"))
    _assert_same_state(fresh.state_dict(), t.state_dict())
    assert fresh.train_step.step == steps
    assert torch.equal(torch.randn(5, generator=fresh.generator),
                       torch.randn(5, generator=t.generator))


def test_latest_checkpoint_orders_by_step(tmp_path):
    d = str(tmp_path / "ck")
    assert latest_checkpoint(d) is None
    for s in (3, 12, 7):
        save_checkpoint(d, {"step": torch.tensor(s)})
    assert latest_checkpoint(d).endswith("step_00000012.pt")
    assert int(restore_checkpoint(latest_checkpoint(d))["step"]) == 12


@pytest.mark.parametrize("kind,use_scan", [("clear", False), ("clear", True),
                                           ("gvae", False), ("tc", False),
                                           ("mim", False)])
def test_resume_reproduces_the_uninterrupted_run(kind, use_scan, tmp_path):
    ds = _dataset()
    whole = _trainer(kind)
    r_whole = whole.fit(2, ds, batch_size=BS, use_scan=use_scan)
    first = _trainer(kind)
    first.fit(1, ds, batch_size=BS, use_scan=use_scan,
              checkpoint_dir=str(tmp_path / "ck"))
    resumed = _trainer(kind)
    resumed.restore_checkpoint(str(tmp_path / "ck"))
    r_resumed = resumed.fit(1, ds, batch_size=BS, use_scan=use_scan,
                            start_epoch=1)
    for k, v in whole.history[1].items():
        np.testing.assert_array_equal(resumed.history[0][k], v, err_msg=k)
    _assert_same_state(resumed.state_dict(), whole.state_dict())
    if kind == "tc":
        assert r_resumed == r_whole[N // BS:]
    if kind == "mim":
        assert [r[N // BS:] for r in r_whole] == list(r_resumed)


def _np_tree(t):
    return jax.tree.map(np.asarray, t)


def _eps(jm, state, x, key, half=8):
    """The (eps_c, eps_s) the JAX step draws from ``key`` on ``state``
    (recovered as in tests/test_torch_step.py)."""
    out, _ = jm.apply({"params": state.params,
                       "batch_stats": state.batch_stats},
                      jnp.asarray(x), explicit=True, train=True,
                      rngs={"reparam": key}, mutable=["batch_stats"])
    _, lp, z = out
    z = np.asarray(z)
    return [torch.as_tensor((z[:, h * half:(h + 1) * half] - np.asarray(lp[m]))
                            / np.exp(0.5 * np.asarray(lp[v])))
            for h, (m, v) in enumerate((("mu_c", "logvar_c"),
                                        ("mu_s", "logvar_s")))]


@functools.lru_cache(maxsize=None)
def _jax_run(fused: bool):
    """Two JAX steps, then the third from the TrainState they leave: (that
    state, the batch and eps of the third step, the state after it, its
    metrics)."""
    jm = JVAE(total_z_dim=16)
    tx = optax.adam(5e-4)
    jstep = make_clear_vae_step(jm, tx, JAnneal(beta=1 / 8),
                                JContr(alpha=100.0, ps=True, fused=fused))
    state = init_vae_state(jm, tx, jax.random.key(0), 28, 1)
    rs = np.random.RandomState(0)
    batches = [(rs.rand(16, 28, 28, 1).astype(np.float32),
                rs.randint(0, 10, 16)) for _ in range(3)]
    keys = jax.random.split(jax.random.key(1), 3)
    for (x, lbl), k in zip(batches[:2], keys[:2]):
        state, _ = jstep(state, jnp.asarray(x), jnp.asarray(lbl), k)
    x, lbl = batches[2]
    eps = _eps(jm, state, x, keys[2])
    jnext, jmetrics = jstep(state, jnp.asarray(x), jnp.asarray(lbl), keys[2])
    return (_np_tree(state), (x, lbl, eps), _np_tree(jnext),
            {k: float(v) for k, v in jmetrics.items()})


# Biases that a train-mode BatchNorm follows: the BN takes their per-channel
# constant out again, so their gradient is zero in exact arithmetic, and what
# either framework computes for it is rounding noise that Adam scales up to
# about ±lr. No port can match that update; the moments JAX keeps for them
# stay at noise level (checked below).
_BN_FED = re.compile(r"(convs\.\d+|convts\.\d+|dense)\.bias$")


def _update_error(t, before: dict, state, jnext) -> float:
    """The largest ratio of the port's error to its bar, over every
    parameter but the BN-fed biases: the update the step made (after minus
    ``before``) against JAX's (``jnext`` minus ``state``), bar 1e-6 +
    1e-3·|JAX's update|, well below one update (lr = 5e-4); and Adam's two
    moments after the step against JAX's, bar 1e-3·|m| + 1e-5·max|m| of
    the tensor. At most 1 passes."""
    bs = state.batch_stats
    p0 = params_from_flax(state.params, bs)
    p1 = params_from_flax(jnext.params, bs)
    jadam = jnext.opt_state[0]
    moments = {"exp_avg": params_from_flax(jadam.mu, bs),
               "exp_avg_sq": params_from_flax(jadam.nu, bs)}
    adam = t.optimizer.state_dict()["state"]
    worst = 0.0
    for i, (name, p) in enumerate(t.model.named_parameters()):
        if _BN_FED.search(name):
            assert float(moments["exp_avg"][name].abs().max()) < 1e-4, name
            continue
        want = p1[name] - p0[name]
        err = (p.detach() - before[name] - want).abs()
        worst = max(worst, float((err / (1e-6 + 1e-3 * want.abs())).max()))
        for k, m in moments.items():
            m = m[name]
            bar = 1e-3 * m.abs() + 1e-5 * float(m.abs().max())
            worst = max(worst, float(((adam[i][k] - m).abs() / bar).max()))
    return worst


def _bridged_step(fused: bool, fault=None):
    """A port trainer loaded from ``_jax_run``'s TrainState, with
    ``fault(adam_state)`` applied to the bridged Adam state first, after
    one step on the third batch: (trainer, its parameters before the step,
    the step's metrics)."""
    state, (x, lbl, eps), _, _ = _jax_run(fused)
    t = TF.get_clearvae_trainer(beta=1 / 8, ps=True, vae_lr=5e-4, z_dim=16,
                                alpha=100.0, temperature=0.1, seed=0,
                                hyperparameter={"fused": fused},
                                mig_backend="numpy", device="cpu")
    bridged = trainer_state_from_flax(state, t)
    if fault is not None:
        fault(bridged["optimizers"]["optimizer"]["state"])
    t.load_state_dict(bridged)
    before = {k: v.detach().clone() for k, v in t.model.named_parameters()}
    metrics = t.train_step(torch.as_tensor(x), torch.as_tensor(lbl), eps)
    return t, before, metrics


@pytest.mark.parametrize("fused", [True, False])
def test_train_state_from_flax_continues_the_jax_run(fused):
    """Two JAX steps, the TrainState bridged (weights, Adam's moments and
    count, the update count), then one step each: the metrics at the bars
    of tests/test_torch_step.py, and the update and Adam's moments as JAX
    made them (``_update_error``)."""
    state, _, jnext, jmetrics = _jax_run(fused)
    t, before, metrics = _bridged_step(fused)
    assert t.train_step.step == 3
    adam = t.optimizer.state_dict()["state"]
    assert len(adam) == len(list(t.model.parameters()))
    assert all(float(s["step"]) == 3 for s in adam.values())
    assert t.optimizer.param_groups[0]["lr"] == 5e-4
    for k in ("loss", "recon", "kl_c", "kl_s", "c_loss", "s_loss"):
        np.testing.assert_allclose(float(metrics[k]), jmetrics[k],
                                   rtol=1e-4, atol=1e-6, err_msg=k)
    assert _update_error(t, before, state, jnext) <= 1.0


def _zero(key):
    def fault(adam):
        for s in adam.values():
            s[key] = torch.zeros_like(s[key])
    return fault


def _swap(adam):
    for s in adam.values():
        s["exp_avg"], s["exp_avg_sq"] = s["exp_avg_sq"], s["exp_avg"]


def _count_plus_one(adam):
    for s in adam.values():
        s["step"] = s["step"] + 1


ADAM_FAULTS = {"zero_exp_avg": _zero("exp_avg"),
               "zero_exp_avg_sq": _zero("exp_avg_sq"),
               "swapped_moments": _swap, "count_plus_one": _count_plus_one,
               "no_update": None}


@pytest.mark.parametrize("fault", sorted(ADAM_FAULTS))
def test_bridged_adam_state_faults_are_caught(fault):
    """Planted faults in the bridged Adam state, or the step's update taken
    back: the comparison of the JAX-continuation test must fail on each."""
    state, _, jnext, _ = _jax_run(True)
    t, before, _ = _bridged_step(True, ADAM_FAULTS[fault])
    if fault == "no_update":
        with torch.no_grad():
            for k, p in t.model.named_parameters():
                p.copy_(before[k])
    assert _update_error(t, before, state, jnext) > 10.0


@pytest.mark.parametrize("kind", ["tc", "mim"])
def test_train_state_from_flax_carries_the_second_player(kind):
    """A CLEAR-TC / CLEAR-MIM TrainState: the VAE, the second player
    (``aux_params``) and both optimizers' states land in their modules."""
    from clearvae_tpu.train import factories as JF
    from clearvae_torch.bridge import (factor_params_from_flax,
                                       mi_params_from_flax)

    name, kw = KINDS[kind]
    jkw = {k: v for k, v in kw.items()
           if k not in ("hyperparameter", "device", "verbose_period")}
    jt = getattr(JF, name)(**jkw)
    state = _np_tree(jt._init_state())
    t = _trainer(kind)
    t.load_state_dict(trainer_state_from_flax(state, t))
    second, aux_map = ((t.factor_cls, factor_params_from_flax) if kind == "tc"
                       else (t.mi_estimator, mi_params_from_flax))
    want = aux_map(state.aux_params)
    for k, v in second.state_dict().items():
        assert torch.equal(v, want[k]), k
    want = params_from_flax(state.params, state.batch_stats)
    for k, v in t.model.state_dict().items():
        assert torch.equal(v, want[k]), k
    opt = getattr(t, t.OPTIMIZERS[1]).state_dict()["state"]
    assert len(opt) == len(list(second.parameters()))
    assert all(float(s["step"]) == 0 for s in opt.values())
    assert t.train_step.step == 0
