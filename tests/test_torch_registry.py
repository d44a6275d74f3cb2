"""The port's name registries and ``trainer_from_config`` against the JAX
package's: the same names for what the port has, a clear error for what it
does not, and, for each kind of config, the same trainer built through the
same factory, whose first forward from bridged weights matches JAX's."""

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
    assert set(TR.MODELS) | set(TR.NOT_PORTED) == set(JR.MODELS)
    assert not set(TR.MODELS) & set(TR.NOT_PORTED)
    for name, cls in TR.MODELS.items():
        assert cls.__name__ == JR.MODELS[name].__name__, name
    assert TF.MODELS is TR.MODELS


@pytest.mark.parametrize("name", TR.NOT_PORTED)
def test_unported_architectures_name_the_roadmap_item(name):
    with pytest.raises(KeyError, match="ROADMAP item 15"):
        TR.MODELS[name]


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


def test_trainer_from_config_refuses_unported_architectures():
    cfg = TCfg.ClearVAEConfig(model=TCfg.ModelConfig(arch="vae64"))
    with pytest.raises(KeyError, match="ROADMAP item 15"):
        TF.trainer_from_config(cfg, device="cpu")
