"""The port's five 64×64 runners against the JAX package's: each ``main``
hands ``run_model_zoo`` (or the sweep) the same zoo — names in order,
factories, hyperparameters (the port adds only ``device``; perf mode's
bfloat16 is torch's) — the same data splits and the same run arguments and
result paths; then each port runner runs tiny on the CPU and writes the
JAX schema, its entries in the JAX zoo's order."""

import csv
import json
import math
import os

import numpy as np
import pytest
import torch

import clearvae_tpu.utils.cache as JCACHE
import clearvae_tpu.utils.lock as JLOCK
from clearvae_tpu.experiments import camelyon17_downstream as JCAM
from clearvae_tpu.experiments import celeba_downstream as JCEL
from clearvae_tpu.experiments import chexpert_downstream as JCHX
from clearvae_tpu.experiments import downstream64 as JZ
from clearvae_tpu.experiments import mig_expr_celeba as JMIG
from clearvae_tpu.experiments import pacs_downstream as JPACS
from clearvae_torch.experiments import camelyon17_downstream as TCAM
from clearvae_torch.experiments import celeba_downstream as TCEL
from clearvae_torch.experiments import chexpert_downstream as TCHX
from clearvae_torch.experiments import downstream64 as TZ
from clearvae_torch.experiments import mig_expr_celeba as TMIG
from clearvae_torch.experiments import pacs_downstream as TPACS
from clearvae_torch.train import trainers as TT

RUNNERS = {"celeba": (JCEL, TCEL), "pacs": (JPACS, TPACS),
           "camelyon17": (JCAM, TCAM), "chexpert": (JCHX, TCHX)}
TINY = ["--n_synthetic", "64", "--epochs", "1", "--batch_size", "16",
        "--seed", "3"]
# per runner: its extra arguments, the entries run for real, and the
# number of classes in the result
ARGS = {"celeba": (["--k_max", "1"], None, 4),
        "pacs": (["--k_max", "1", "--models", "clear", "baseline"],
                 ["baseline", "clear"], 7),
        "camelyon17": (["--cnn_epochs", "1"], None, 2),
        "chexpert": (["--k_max", "1", "--models", "clear", "baseline"],
                     ["baseline", "clear"], 4)}
KINDS = {"baseline": "SimpleCNNTrainer", "gvae": "HierarchicalVAETrainer",
         "mlvae": "HierarchicalVAETrainer", "clear": "CLEARVAETrainer",
         "clear-tc": "ClearTCVAETrainer",
         "clear-mim (L1OutUB)": "ClearMIMVAETrainer",
         "clear-mim (CLUB-S)": "ClearMIMVAETrainer",
         "lam-cnn": "LAMCNNTrainer"}


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One intra-op thread: these small CPU workloads run several to a
    machine under the parallel test run, where more threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def no_jax_device_setup(monkeypatch):
    """The JAX runners' device lock and compilation cache are host-side
    set-up a test on the CPU does not want (no cache under the home
    directory)."""
    monkeypatch.setattr(JCACHE, "enable_compilation_cache", lambda *a: None)
    monkeypatch.setattr(JLOCK, "acquire_tpu_lock", lambda *a, **k: True)


def _calls(mod, argv, monkeypatch):
    """What ``mod.main(argv)`` passes to ``run_model_zoo`` and
    ``save_results``, without training."""
    seen = []
    monkeypatch.setattr(mod, "run_model_zoo",
                        lambda models, *a, **k: seen.append((models, a, k))
                        or {})
    monkeypatch.setattr(mod, "save_results", lambda r, p: seen.append(p))
    mod.main(argv)
    return seen


def _jax_kwargs(kw):
    """A JAX entry's kwargs with its bfloat16 as torch's."""
    import jax.numpy as jnp

    if "vae_kwargs" in kw:
        vk = dict(kw["vae_kwargs"])
        if vk.get("dtype") is jnp.bfloat16:
            vk["dtype"] = torch.bfloat16
        kw = {**kw, "vae_kwargs": vk}
    return kw


def _same_zoo(ours, theirs):
    assert list(ours) == list(theirs)
    for name, (factory, kw) in ours.items():
        jfactory, jkw = theirs[name]
        assert factory.__name__ == jfactory.__name__, name
        assert kw.pop("device") == torch.device("cpu"), name
        assert kw == _jax_kwargs(jkw), name


@pytest.mark.parametrize("perf", [False, True])
@pytest.mark.parametrize("runner", list(RUNNERS))
def test_main_hands_the_zoo_what_jax_does(runner, perf, tmp_path,
                                          monkeypatch, no_jax_device_setup):
    jmod, tmod = RUNNERS[runner]
    extra = ARGS[runner][0] + (["--perf_mode"] if perf else [])
    argv = TINY + extra + ["--out", str(tmp_path)]
    theirs = _calls(jmod, argv, monkeypatch)
    ours = _calls(tmod, argv + ["--device", "cpu"], monkeypatch)
    assert len(ours) == len(theirs) > 0
    for o, t in zip(ours, theirs):
        if isinstance(o, str):            # the result path
            assert o == t and o.endswith("-perf.json") == perf
            continue
        (models, a, k), (jmodels, ja, jk) = o, t
        _same_zoo(dict(models), jmodels)
        assert k == jk and a[3:] == ja[3:]
        for split, jsplit in zip(a[:3], ja[:3]):     # train, valid, test
            np.testing.assert_array_equal(split.images, jsplit.images)
            np.testing.assert_array_equal(split.labels, jsplit.labels)


@pytest.mark.parametrize("perf", [False, True])
@pytest.mark.parametrize("kw", [{}, {"lam_coef": 0.001, "tc_temperature": 0.1},
                                {"in_channel": 1}])
def test_model_zoo64_equals_jax(kw, perf):
    tkw = {"beta": 1 / 32, "vae_lr": 3e-5, "z_dim": 64, "alpha": 100.0,
           "temperature": 0.1}
    ours = TZ.model_zoo64(4, tkw, 3, perf_mode=perf, device="cpu", **kw)
    theirs = JZ.model_zoo64(4, tkw, 3, perf_mode=perf, **kw)
    for _, params in ours.values():
        params["device"] = torch.device(params["device"])
    _same_zoo(ours, theirs)
    if perf:
        assert ours["clear"][1]["vae_kwargs"] == TZ.PERF_VAE_KWARGS


def _schema_ok(res, names, n_class):
    assert list(res) == names
    for name, r in res.items():
        assert set(r) == {"acc", "pr", "roc"} and 0.0 <= r["acc"] <= 1.0, name
        for part in ("pr", "roc"):
            assert set(r[part]) == {"overall", "stratified"}
            assert set(r[part]["stratified"]) <= {str(c)
                                                  for c in range(n_class)}


@pytest.mark.parametrize("runner", list(RUNNERS))
def test_main_runs_tiny_on_the_cpu_in_the_jax_schema(runner, tmp_path,
                                                     monkeypatch):
    """The runner trains its entries for real and writes the result JSON;
    the entries are the JAX zoo's (filtered) in its order, each fit by its
    trainer class, and the LAM-CNN (Camelyon17) trains ``cnn_epochs``."""
    tmod = RUNNERS[runner][1]
    extra, names, n_class = ARGS[runner]
    fits = []
    fit = TT.TrainerCore.fit

    def spy(self, epochs, *a, **k):
        fits.append((type(self).__name__, epochs))
        return fit(self, epochs, *a, **k)

    monkeypatch.setattr(TT.TrainerCore, "fit", spy)
    tmod.main(TINY + extra + ["--device", "cpu", "--out", str(tmp_path)])
    out = os.listdir(tmp_path)
    assert len(out) == 1 and out[0].endswith("-3.json")
    with open(tmp_path / out[0]) as f:
        res = json.load(f)
    if names is None:
        names = list(res)
        zoo = {"celeba": JZ.model_zoo64(4, {"beta": 1, "vae_lr": 1,
                                            "z_dim": 64, "alpha": 1,
                                            "temperature": 1}, 3),
               "camelyon17": JZ.model_zoo64(2, {"beta": 1, "vae_lr": 1,
                                                "z_dim": 64, "alpha": 1,
                                                "temperature": 1}, 3,
                                            lam_coef=1.0)}[runner]
        assert names == list(zoo)
    _schema_ok(res, names, n_class)
    assert [k for k, _ in fits] == [KINDS[n] for n in names]
    if runner == "camelyon17":
        assert dict(zip(names, [e for _, e in fits]))["lam-cnn"] == 1


def _read_rows(path):
    with open(path, newline="") as f:
        return list(csv.reader(f))


def test_mig_expr_celeba_matches_jax(tmp_path, monkeypatch,
                                     no_jax_device_setup):
    """The sweep's zoo (names in order, factories, hyperparameters) and
    splits as JAX's ``main`` builds them, then the port's ``main`` for real
    on the CPU: the CSV's schema and rows in JAX's order, every value
    finite; a second call trains nothing."""
    argv = ["--n_synthetic", "64", "--epochs", "1", "--batch_size", "16",
            "--mig_backend", "numpy", "--out", str(tmp_path)]
    calls = {}

    def record(mod, tag):
        for name in ("get_clearvae_trainer", "get_cleartcvae_trainer",
                     "get_clearmimvae_trainer",
                     "get_hierarchical_vae_trainer"):
            monkeypatch.setattr(mod, name,
                                lambda _n=name, **k: (_n, k))

        def make_cell(epochs, train, valid, test, batch_size):
            calls[tag] = {"run": (epochs, batch_size),
                          "splits": (train, valid, test), "zoo": []}
            return lambda name, get, beta: calls[tag]["zoo"].append(
                (name, get(beta))) or (0.0, 0.0)

        monkeypatch.setattr(mod, "make_mig_cell", make_cell)

    record(JMIG, "jax")
    record(TMIG, "torch")
    JMIG.main(argv + ["--out", str(tmp_path / "jax")])
    TMIG.main(argv + ["--device", "cpu", "--out", str(tmp_path / "torch")])
    monkeypatch.undo()
    j, t = calls["jax"], calls["torch"]
    assert t["run"] == j["run"]
    for a, b in zip(t["splits"], j["splits"]):
        np.testing.assert_array_equal(a.images, b.images)
        np.testing.assert_array_equal(a.labels, b.labels)
    names = [n for n, _ in j["zoo"]]
    assert [n for n, _ in t["zoo"]] == names and len(names) == 8
    for (_, (f, kw)), (_, (jf, jkw)) in zip(t["zoo"], j["zoo"]):
        assert kw.pop("device") == torch.device("cpu")
        assert (f, kw) == (jf, jkw)
    jrows = _read_rows(tmp_path / "jax" / os.listdir(tmp_path / "jax")[0])
    TMIG.main(argv + ["--device", "cpu"])
    path = TMIG.sweep_path(TMIG.get_args(argv))
    assert os.path.basename(path) == os.listdir(tmp_path / "jax")[0]
    rows = _read_rows(path)
    assert rows[0] == jrows[0] == ["model", "beta", "mig", "elbo"]
    assert [r[0] for r in rows[1:]] == [r[0] for r in jrows[1:]] == names
    assert all(math.isfinite(float(v)) for r in rows[1:] for v in r[1:])
    fits = []
    monkeypatch.setattr(TT.TrainerCore, "fit",
                        lambda self, *a, **k: fits.append(self))
    first = _read_rows(path)
    TMIG.main(argv + ["--device", "cpu"])
    assert fits == [] and _read_rows(path) == first
