"""A trainer of two players is checked by files alone: CLEAR-MIM through
``vae28-downstream-fit``'s files, with overrides that swap in
``get_clearmimvae_trainer`` (the zoo's arguments) and the reference
``clear_mim``, at a tiny size on the CPU (B = 32). A run of each estimator
the experiments use is correct; a run with a planted fault is not; the
estimator's own readings catch an estimator that never moves by
themselves. The cell's limits hold the model; the estimator's readings are
held here to the model's limits of the same names (the card's limits of
a CLEAR-MIM cell are set from the card's readings). And a one-module spec
draws the same weights as before modules were named."""

import math

import pytest
import torch

torch.set_num_threads(1)

from clearvae_torch.ops import losses as PL  # noqa: E402
from clearvae_torch.train import factories as PF  # noqa: E402
from clearvae_torch.train import steps as PS  # noqa: E402
from clearvae_torch.train import trainers as PT  # noqa: E402
from portbench import check as C  # noqa: E402
from portbench import harness as H  # noqa: E402
from portbench import run as R  # noqa: E402
from portbench.reference import clear_mim as RM  # noqa: E402
from portbench.reference import vae as RV  # noqa: E402

CELL = "vae28-downstream-fit"
SEED = 2 ** 31 + 5
ESTIMATOR = ("grad1_median_gap", "delta5_median_gap")


def _limits() -> dict:
    limits = H.load_cell(CELL).workload["limits"]
    return {**limits, **{f"{RM.EST}.{k}": limits[k] for k in ESTIMATOR}}


def _overrides(estimator: str) -> dict:
    kw = {k: v for k, v in H.load_cell(CELL).config["trainer"]["kwargs"].items()
          if k not in ("ps", "sim_fn")}
    return {"traffic": {"n_images": 400},
            "workload": {"limits": _limits()},
            "config": {"fit": {"batch_size": 32}, "reference": "clear_mim",
                       "trainer": {"factory": "get_clearmimvae_trainer",
                                   "kwargs": {**kw, "mi_estimator": estimator,
                                              "la": 3,
                                              "mi_estimator_lr": 2e-3}}}}


def _run(estimator: str = "L1OutUB") -> dict:
    return R.run(CELL, SEED, 0.0, device="cpu", overrides=_overrides(estimator))


@pytest.mark.parametrize("estimator", ["L1OutUB", "CLUBSample"])
def test_a_tiny_clear_mim_run_is_correct(estimator):
    res = _run(estimator)
    assert res["correct"], res["checks"]
    assert {f"{RM.EST}.{k}" for k in ESTIMATOR} <= set(res["checks"])
    assert res["attempted"] > 0 and res["failed"] == 0


def _estimator_still(monkeypatch):
    """The estimator's optimizer step does nothing; the VAE's is left
    alone."""
    init = PT.ClearMIMVAETrainer.__init__

    def still(self, *a, **k):
        init(self, *a, **k)
        self.mi_optimizer.step = lambda closure=None: None

    monkeypatch.setattr(PT.ClearMIMVAETrainer, "__init__", still)


def _one_inner_step_fewer(monkeypatch):
    call = PS.ClearMIMStep.__call__
    monkeypatch.setattr(PS.ClearMIMStep, "__call__", lambda self, x, label, noise:
                        call(self, x, label,
                             {**noise, "inner": noise["inner"][:-1]}))


def _penalty_dropped(monkeypatch):
    """λ·mi_loss left out of the VAE's loss."""
    call = PS.ClearMIMStep.__call__

    def dropped(self, x, label, noise):
        self.la = 0.0
        return call(self, x, label, noise)

    monkeypatch.setattr(PS.ClearMIMStep, "__call__", dropped)


def _half_batch(monkeypatch):
    whole = PL.sample_level_reduction
    monkeypatch.setattr(PL, "sample_level_reduction",
                        lambda t: whole(t[: max(1, t.shape[0] // 2)]))


FAULTS = [_estimator_still, _one_inner_step_fewer, _penalty_dropped,
          _half_batch]


@pytest.mark.parametrize("fault", FAULTS, ids=[f.__name__[1:] for f in FAULTS])
def test_a_broken_clear_mim_step_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    res = _run()
    assert not res["correct"], res["checks"]
    if fault is _estimator_still:
        own = {k: v for k, v in res["checks"].items()
               if k.startswith(f"{RM.EST}.")}
        assert not C.verdict({k: v["value"] for k, v in own.items()},
                             {k: v["limit"] for k, v in own.items()})[0], own


def test_every_module_is_loaded_under_the_strict_check():
    """The estimator's leaves are drawn after the model's and loaded with
    them; a spec without them is refused by name."""
    cfg = H.load_cell(CELL, _overrides("L1OutUB")).config
    t = cfg["trainer"]
    trainer = getattr(PF, t["factory"])(**t["kwargs"], seed=1, device="cpu")
    spec = RM.param_spec(cfg)
    assert [n for n, _, _ in spec[:len(RV.param_spec(cfg))]] == [
        n for n, _, _ in RV.param_spec(cfg)]
    weights = H.make_weights(spec, 3, "cpu")
    H.load_weights(trainer, weights)
    for name, p in H.named_parameters(trainer).items():
        assert torch.equal(p, weights[name]), name
    assert H.module_of("mi_estimator.net.mu_l1.weight", trainer.MODULES) \
        == "mi_estimator"
    with pytest.raises(RuntimeError, match="mi_estimator.net.mu_l1.weight"):
        H.load_weights(trainer, H.make_weights(RV.param_spec(cfg), 3, "cpu"))


def _one_draw(spec, seed, device):
    """The weights as one module's spec drew them before modules were
    named."""
    gen = torch.Generator(device=device).manual_seed(seed)
    sizes = [math.prod(shape) for _, shape, _ in spec]
    u = torch.rand(sum(sizes), generator=gen, device=device) * 2 - 1
    out, off = {}, 0
    for (name, shape, bound), n in zip(spec, sizes):
        v = u[off:off + n].view(shape) * bound
        if ".bns." in name and name.endswith(".weight"):
            v = v + 1
        out[name] = v
        off += n
    return out


@pytest.mark.parametrize("config", ["clear-vae28-styledmnist",
                                    "clear-vae64-celeba"])
def test_a_one_module_spec_draws_the_same_weights(config):
    spec = RV.param_spec(H.load("configs", config))
    got, want = H.make_weights(spec, SEED, "cpu"), _one_draw(spec, SEED, "cpu")
    assert list(got) == list(want)
    assert all(torch.equal(got[k], want[k]) for k in want)
