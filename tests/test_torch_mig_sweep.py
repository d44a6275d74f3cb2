"""The Styled-MNIST MIG/ELBO sweep of the port against the JAX package's:
``run_mig_sweep``'s CSV (fresh, resumed, from a headers-only manifest),
``make_mig_cell``, ``mig_expr``'s data split and eight-entry zoo, and the
runner end to end on the CPU."""

import csv
import math
import os

import numpy as np
import pytest
import torch

from clearvae_tpu.experiments import common as JC
from clearvae_tpu.experiments import mig_expr as JX
from clearvae_torch.experiments import common as TC
from clearvae_torch.experiments import mig_expr as TX
from clearvae_torch.train import trainers as TR

MODELS = ["clear-ps", "clear-neg", "bvae", "clear-tc", "clear-mim (L1OutUB)",
          "clear-mim (CLUB-S)", "mlvae", "gvae"]


# a manifest of a run cut after its first beta, written with values that
# pandas' default parser reads exactly (it reads about a quarter of all
# 17-digit floats one ulp off; see test_resume_reads_floats_exactly)
RESUMED = ("model,beta,mig,elbo\na,0.125,0.0123,101.5\n"
           "b (c),0.125,-0.004,99.25\nd,0.125,0.5,100.0\n")


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One intra-op thread: these small CPU workloads run several to a
    machine under the parallel test run, where more threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scripted_cell(calls):
    """An ``evaluate_cell`` that trains nothing: (mig, elbo) from the cell's
    name and beta, awkward floats included, and each call recorded."""

    def cell(name, get_trainer, beta):
        calls.append((name, beta))
        h = sum(map(ord, name))
        return (h / 7919.0 - 0.1 + beta / 3, 100.0 + h * 1e-7 + 1e-17 * beta)

    return cell


def _sweep(mod, path, betas, models=("a", "b (c)", "d")):
    calls = []
    mod.run_mig_sweep({m: None for m in models}, betas, str(path),
                      _scripted_cell(calls))
    with open(path, "rb") as f:
        return f.read(), calls


@pytest.mark.parametrize("start", ["fresh", "resume", "headers_only"])
def test_sweep_csv_is_byte_identical_to_jax(tmp_path, start):
    """The same scripted cells give the same CSV bytes (tolerance 0) and
    train the same cells; a resume skips exactly the cells in the CSV, and
    the same command again rewrites the same bytes."""
    betas = [1 / 8, 0.5, 2.0]
    out = {}
    for name, mod in (("jax", JC), ("port", TC)):
        path = tmp_path / name / "sweep.csv"
        os.makedirs(path.parent)
        if start == "resume":       # a run cut after its first beta
            path.write_text(RESUMED)
        elif start == "headers_only":
            path.write_text("model,beta,mig,elbo\n")
        out[name] = _sweep(mod, path, betas)
    assert out["port"] == out["jax"]
    data, calls = out["port"]
    skipped = 3 if start == "resume" else 0
    assert len(calls) == 9 - skipped
    assert data.decode().splitlines()[0] == "model,beta,mig,elbo"
    assert len(data.decode().splitlines()) == 10
    # the same command again trains nothing and rewrites the same bytes
    again, calls2 = _sweep(TC, tmp_path / "port" / "sweep.csv", betas)
    assert again == data and calls2 == []


def test_resume_reads_floats_exactly(tmp_path):
    """A resumed run reads the CSV's floats exactly and rewrites the same
    bytes, for values that pandas' default parser moves by an ulp (the JAX
    sweep writes those back moved)."""
    rs = np.random.RandomState(0)
    vals = np.concatenate([rs.randn(200), rs.randn(200) * 1e-5,
                           10.0 ** rs.uniform(-300, 300, 200)])
    path = tmp_path / "sweep.csv"
    TC._write_sweep([{"model": f"m{i}", "beta": 0.125, "mig": float(v),
                      "elbo": math.nan if i % 50 == 0 else -float(v)}
                     for i, v in enumerate(vals)], str(path))
    first = path.read_bytes()
    rows = TC._read_sweep(str(path))
    assert [r["mig"] for r in rows] == vals.tolist()
    assert sum(math.isnan(r["elbo"]) for r in rows) == 12
    again, calls = _sweep(TC, path, [0.125], models=("m0", "m1"))
    assert again == first and calls == []


def test_empty_grid_writes_headers_like_jax(tmp_path):
    got = {}
    for name, mod in (("jax", JC), ("port", TC)):
        got[name] = _sweep(mod, tmp_path / f"{name}.csv", [], models=())
    assert got["port"] == got["jax"] == (b"model,beta,mig,elbo\n", [])


def test_mig_cell_fits_then_evaluates_the_test_split(monkeypatch):
    log = []

    def fit(self, epochs, train, valid, batch_size=128):
        log.append(("fit", type(self).__name__, epochs, train, valid,
                    batch_size))

    def evaluate(self, ds, batch_size=128, **kw):
        log.append(("evaluate", type(self).__name__, ds, batch_size, kw))
        return 0.25, 7.5

    for cls in (TR.CLEARVAETrainer, TR.HierarchicalVAETrainer):
        monkeypatch.setattr(cls, "fit", fit)
        monkeypatch.setattr(cls, "evaluate", evaluate)
    cell = TC.make_mig_cell(3, "train", "valid", "test", 64)
    for cls in (TR.CLEARVAETrainer, TR.HierarchicalVAETrainer):
        assert cell("m", lambda beta, c=cls: c.__new__(c), 0.5) == (0.25, 7.5)
    assert log == [
        ("fit", "CLEARVAETrainer", 3, "train", "valid", 64),
        ("evaluate", "CLEARVAETrainer", "test", 64, {}),
        ("fit", "HierarchicalVAETrainer", 3, "train", "valid", 64),
        ("evaluate", "HierarchicalVAETrainer", "test", 64,
         {"with_evidence_acc": False})]


def test_get_data_is_bit_equal_to_jax():
    """The 40/10/10 split of --n_total 600: images, labels, style indices
    and absolute sample ids equal (tolerance 0)."""
    argv = ["--n_total", "600", "--seed", "5"]
    ours = TX.get_data(TX.get_args(argv + ["--device", "cpu"]))
    theirs = JX.get_data(JX.get_args(argv))
    assert [len(d) for d in ours] == [400, 100, 100]
    for a, b in zip(ours, theirs):
        for k in ("images", "labels", "style_idx", "sample_ids"):
            np.testing.assert_array_equal(getattr(a, k), getattr(b, k))
        assert a.seed == b.seed
        assert [n for n, _ in a.styles] == [n for n, _ in b.styles]
    assert TX.STYLE_PROBS == JX.STYLE_PROBS and TX.BETAS == JX.BETAS


def _zoo_calls(mod, args, monkeypatch):
    """(factory name, kwargs) of each zoo entry at beta 0.25, through the
    runner module's factory names."""
    seen = {}
    for name in ("get_clearvae_trainer", "get_cleartcvae_trainer",
                 "get_clearmimvae_trainer", "get_hierarchical_vae_trainer"):
        monkeypatch.setattr(mod, name,
                            lambda _n=name, **kw: (_n, kw))
    for key, make in mod.model_zoo(args).items():
        seen[key] = make(0.25)
    monkeypatch.undo()
    return seen


def test_model_zoo_matches_jax(monkeypatch):
    """The same entries in the same order, each through the same factory
    with the same hyperparameters (the port adds only ``device``) and
    building the same trainer class."""
    argv = ["--z_dim", "16", "--alpha", "50", "--temperature", "0.2",
            "--seed", "3", "--mig_backend", "numpy"]
    targs = TX.get_args(argv + ["--device", "cpu"])
    jargs = JX.get_args(argv)
    ours = _zoo_calls(TX, targs, monkeypatch)
    theirs = _zoo_calls(JX, jargs, monkeypatch)
    assert list(ours) == list(theirs) == MODELS
    for key, (factory, kw) in ours.items():
        assert kw.pop("device") == "cpu"
        assert (factory, kw) == theirs[key], key
    tzoo, jzoo = TX.model_zoo(targs), JX.model_zoo(jargs)
    for key in MODELS:
        t, j = tzoo[key](0.25), jzoo[key](0.25)
        assert type(t).__name__ == type(j).__name__, key
        assert t.mig_backend == j.mig_backend == "numpy"
        if hasattr(j, "hp"):
            assert t.hp == j.hp, key


def test_main_writes_the_reference_schema_and_resumes(tmp_path, monkeypatch):
    argv = ["--n_total", "300", "--epochs", "1", "--device", "cpu",
            "--mig_backend", "numpy", "--out", str(tmp_path)]
    TX.main(argv)
    path = TX.sweep_path(TX.get_args(argv))
    assert os.path.basename(path) == "mig_elbo_s101_a100.0_z16_t0.1.csv"
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    assert rows[0] == ["model", "beta", "mig", "elbo"]
    assert [r[0] for r in rows[1:]] == list(JX.model_zoo(JX.get_args([])))
    assert all(float(r[1]) == 0.125 and math.isfinite(float(r[2]))
               and math.isfinite(float(r[3])) for r in rows[1:])
    with open(path, "rb") as f:
        first = f.read()
    fits = []
    monkeypatch.setattr(TR.TrainerCore, "fit",
                        lambda self, *a, **k: fits.append(self))
    TX.main(argv)
    with open(path, "rb") as f:
        assert f.read() == first
    assert fits == []


def test_main_needs_cuda_or_an_explicit_cpu(tmp_path, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TX.main(["--n_total", "300", "--out", str(tmp_path)])
    assert not os.listdir(tmp_path)
