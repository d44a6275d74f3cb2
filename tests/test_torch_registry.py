"""The port's name registries and ``trainer_from_config`` against the JAX
package's: the same names, each building its architecture as JAX's does,
and, for each kind of config (``arch="vae64"`` too), the same trainer built
through the same factory, whose first forward from bridged weights matches
JAX's."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clearvae_tpu import config as JCfg
from clearvae_tpu import registry as JR
from clearvae_tpu.train import factories as JF
from clearvae_torch import config as TCfg
from clearvae_torch import registry as TR
from clearvae_torch.bridge import (factor_params_from_flax,
                                   mi_params_from_flax, params_from_flax)
from clearvae_torch.train import factories as TF

B = 16
# the bar of the step tests (tests/test_torch_step.py, test_torch_tc.py)
STEP_TOL = dict(rtol=1e-4, atol=1e-5)
FACTORIES = ("get_clearvae_trainer", "get_cleartcvae_trainer",
             "get_clearmimvae_trainer", "get_hierarchical_vae_trainer")


def test_models_are_the_jax_names_of_the_ported_architectures():
    assert list(TR.MODELS) == list(JR.MODELS)
    for name, cls in TR.MODELS.items():
        assert cls.__name__ == JR.MODELS[name].__name__, name
    assert TF.MODELS is TR.MODELS


# the 64×64 and LAM names, which came with the 64×64 slice
NAMES_64_LAM = ("vae64", "simple_cnn64", "lam_cnn", "lam_cnn64", "VAE64",
                "SimpleCNN64Classifier", "LAMCNNClassifier",
                "LAMCNN64Classifier")


def _abstract_variables(jm, size, in_ch):
    """The flax variables' shapes, without computing them."""
    shapes = jax.eval_shape(
        lambda: jm.init({"params": jax.random.key(0),
                         "reparam": jax.random.key(1)},
                        jnp.zeros((2, size, size, in_ch))))
    return jax.tree.map(lambda a: np.zeros(a.shape, a.dtype), shapes)


@pytest.mark.parametrize("name", NAMES_64_LAM)
def test_64x64_and_lam_architectures_build_as_in_jax(name):
    """Each name builds the port's class of the JAX class's name with its
    defaults (classes, channels, image size), and the JAX module's
    variables bridge onto it: every parameter and buffer, the same
    shapes."""
    from clearvae_torch.bridge import cnn_params_from_flax

    jcls, tcls = JR.MODELS[name], TR.MODELS[name]
    assert tcls.__name__ == jcls.__name__
    if "vae" in name.lower():
        jm, tm = jcls(total_z_dim=64), tcls(total_z_dim=64)
        assert (tm.in_channel, tm.image_size, tm.z_dim) == (
            jm.in_channel, jm.image_size, jm.z_dim)
        v = _abstract_variables(jm, jm.image_size, jm.in_channel)
        sd = params_from_flax(v["params"], v["batch_stats"])
    else:
        jm, tm = jcls(), tcls()
        assert (tm.n_class, tm.in_channel) == (jm.n_class, jm.in_channel)
        assert tm.linear_head == jm.linear_head
        v = _abstract_variables(jm, jm.image_size, jm.in_channel)
        sd = cnn_params_from_flax(v["params"], v["batch_stats"])
    ours = tm.state_dict()
    assert set(sd) == set(ours)
    for k, t in sd.items():
        assert t.shape == ours[k].shape, k


def test_estimator_and_loss_registries_match_jax():
    for ours, theirs in ((TR.MI_ESTIMATORS, JR.MI_ESTIMATORS),
                         (TR.SIM_FNS, JR.SIM_FNS),
                         (TR.CONTRASTIVE_LOSSES, JR.CONTRASTIVE_LOSSES)):
        assert list(ours) == list(theirs)
        for k in ours:
            assert ours[k].__name__ == theirs[k].__name__, k
    with pytest.raises(KeyError, match="unknown architecture"):
        TR.MODELS["bogus"]


def _configs(C):
    """The plain, ps=False, TC, CLUB-S MIM and GVAE configs of one config
    module."""
    return {
        "plain": C.ClearVAEConfig(),
        "ps_false": C.ClearVAEConfig(
            contrastive=C.ContrastiveConfig(ps=False, alpha=50.0,
                                            temperature=0.2),
            train=C.TrainConfig(seed=3)),
        "tc": C.ClearVAEConfig(tc=C.TCConfig(la=2.0, factor_cls_lr=3e-4)),
        "mim": C.ClearVAEConfig(mim=C.MIMConfig(estimator="club_sample",
                                                la=3.0)),
        "gvae": C.ClearVAEConfig(model=C.ModelConfig(group_mode="GVAE"),
                                 anneal=C.AnnealConfig(beta=0.25)),
    }


def _dispatch(mod, cfg, monkeypatch, **kw):
    """(factory name, kwargs) that ``trainer_from_config`` calls."""
    for name in FACTORIES:
        monkeypatch.setattr(mod, name, lambda _n=name, **k: (_n, k))
    out = mod.trainer_from_config(cfg, **kw)
    monkeypatch.undo()
    return out


def _np_tree(t):
    return jax.tree.map(np.asarray, t)


def _eps(jm, variables, key, n):
    """The (eps_c, eps_s) that VAE.__call__ draws from ``key``."""
    zeros = jnp.zeros((n, jm.z_dim))

    def draw(mdl):
        return mdl.sample(zeros, zeros), mdl.sample(zeros, zeros)

    return [torch.as_tensor(np.array(e)) for e in
            jm.apply(variables, method=draw, rngs={"reparam": key})]


def _jax_perm(est, params, key, n):
    """The permutation CLUBSample draws from ``key`` in its eval call."""
    return torch.as_tensor(np.array(est.apply(
        {"params": params},
        method=lambda m: jax.random.permutation(m.make_rng("shuffle"), n),
        rngs={"shuffle": key})))


@pytest.mark.parametrize("kind", ["plain", "ps_false", "tc", "mim", "gvae"])
def test_trainer_from_config_matches_jax(kind, monkeypatch):
    tcfg, jcfg = _configs(TCfg)[kind], _configs(JCfg)[kind]
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    # the same factory, with the same fields; the port adds only the device
    factory, kw = _dispatch(TF, tcfg, monkeypatch, device="cpu")
    assert kw.pop("device") == "cpu"
    assert (factory, kw) == _dispatch(JF, jcfg, monkeypatch)
    # the same trainer class, its first forward matching JAX's from bridged
    # weights and the JAX eval step's own draws
    jt, tt = JF.trainer_from_config(jcfg), TF.trainer_from_config(
        tcfg, device="cpu")
    assert type(tt).__name__ == type(jt).__name__
    assert tt.model.total_z_dim == jt.model.total_z_dim
    assert tt.model.group_mode == jt.model.group_mode
    if hasattr(jt, "contr_cfg") and kind in ("plain", "ps_false"):
        assert dataclasses.asdict(tt.contr_cfg) == \
            dataclasses.asdict(jt.contr_cfg)
        assert tt.hp == jt.hp
    state = jt._init_state()
    tt.model.load_state_dict(params_from_flax(_np_tree(state.params),
                                              _np_tree(state.batch_stats)))
    rs = np.random.RandomState(0)
    x = rs.rand(B, 28, 28, 1).astype(np.float32)
    lbl = rs.randint(0, 10, B)
    key = jax.random.key(2)
    jout = jt.eval_step(state, jnp.asarray(x), jnp.asarray(lbl), key)
    variables = {"params": state.params, "batch_stats": state.batch_stats}
    noise = _eps(jt.model, variables, key, B)
    if kind == "tc":
        tt.factor_cls.load_state_dict(
            factor_params_from_flax(_np_tree(state.aux_params)))
    elif kind == "mim":
        tt.mi_estimator.load_state_dict(
            mi_params_from_flax(_np_tree(state.aux_params)))
        noise = {"eps": noise, "perm": _jax_perm(jt.mi_estimator,
                                                 state.aux_params, key, B)}
    with torch.no_grad():
        out = tt.eval_step(torch.as_tensor(x), torch.as_tensor(lbl), noise)
    terms = [k for k in jout if np.ndim(jout[k]) == 0]
    assert {"recon", "kl_c", "kl_s"} <= set(terms) and set(terms) <= set(out)
    for k in terms:
        np.testing.assert_allclose(float(out[k]), float(jout[k]), **STEP_TOL,
                                   err_msg=f"{kind} {k}")


def test_trainer_from_config_builds_vae64(monkeypatch):
    """``arch="vae64"`` (RGB, z = 64): the same factory with the same
    fields as JAX's, a CLEAR trainer on ``VAE64``."""
    tcfg, jcfg = (C.ClearVAEConfig(model=C.ModelConfig(
        arch="vae64", total_z_dim=64, in_channel=3)) for C in (TCfg, JCfg))
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    factory, kw = _dispatch(TF, tcfg, monkeypatch, device="cpu")
    assert kw.pop("device") == "cpu"
    assert (factory, kw) == _dispatch(JF, jcfg, monkeypatch)
    assert kw["vae_arch"] == "VAE64" and kw["in_channel"] == 3
    tt = TF.trainer_from_config(tcfg, device="cpu")
    assert type(tt).__name__ == "CLEARVAETrainer"
    assert type(tt.model).__name__ == "VAE64"
    assert (tt.model.total_z_dim, tt.model.in_channel) == (64, 3)
