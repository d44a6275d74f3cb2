"""The port's metric logger and profiler context, and
``fit(logger=...)`` against the JAX package's on the same tiny run
(tests/test_utils.py:241): the same tags and keys per epoch, the same
update counts and epochs."""

import json

import numpy as np
import pytest
import torch

from clearvae_tpu.data.mnist import synthetic_mnist as jax_synthetic_mnist
from clearvae_tpu.data.styled import make_styled_mnist as jax_make_styled
from clearvae_tpu.train.factories import get_clearvae_trainer as jax_trainer
from clearvae_tpu.utils.logging import MetricLogger as JLogger
from clearvae_torch.data.mnist import synthetic_mnist
from clearvae_torch.data.styled import make_styled_mnist
from clearvae_torch.train.factories import get_clearvae_trainer
from clearvae_torch.utils.logging import MetricLogger, profile_trace


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """These tiny CPU fits gain nothing from intra-op threads, and with
    several test workers on the machine the threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


KW = dict(beta=1 / 8, ps=True, vae_lr=5e-4, z_dim=16, alpha=100.0,
          temperature=0.1, seed=8)


def _lines(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def test_metric_logger(tmp_path):
    p = str(tmp_path / "sub" / "m.jsonl")
    lg = MetricLogger(p)
    lg.log("train", step=1, loss=1.5)
    rec = lg.log("eval", mig=np.float32(0.25))
    lg.close()
    assert rec["mig"] == 0.25 and isinstance(rec["mig"], float)
    lines = _lines(p)
    assert lines[0]["loss"] == 1.5 and lines[0]["step"] == 1
    assert lines[1]["tag"] == "eval" and "step" not in lines[1]
    assert MetricLogger(None).log("x", a=1)["a"] == 1   # no file: records only


def test_profile_trace_writes_a_chrome_trace(tmp_path):
    with profile_trace(None) as prof:
        assert prof is None
    with profile_trace(str(tmp_path / "tr")) as prof:
        torch.ones(4).add_(1)
    with open(tmp_path / "tr" / "trace.json") as f:
        assert "traceEvents" in json.load(f)


@pytest.mark.parametrize("use_scan", [False, True])
def test_fit_logs_what_the_jax_fit_logs(tmp_path, use_scan):
    jds = jax_make_styled(*jax_synthetic_mnist(64, seed=8), seed=8)
    jlg = JLogger(str(tmp_path / "j.jsonl"))
    jax_trainer(**KW).fit(2, jds, batch_size=32, logger=jlg)
    jlg.close()
    ds = make_styled_mnist(*synthetic_mnist(64, seed=8), seed=8)
    lg = MetricLogger(str(tmp_path / "t.jsonl"))
    get_clearvae_trainer(**KW, mig_backend="numpy", device="cpu").fit(
        2, ds, batch_size=32, logger=lg, use_scan=use_scan)
    lg.close()
    jl, tl = _lines(tmp_path / "j.jsonl"), _lines(tmp_path / "t.jsonl")
    assert len(tl) == len(jl) == 2
    for j, t in zip(jl, tl):
        assert set(t) == set(j)
        assert (t["tag"], t["step"], t["epoch"]) == (j["tag"], j["step"],
                                                     j["epoch"])
        assert t["images_per_sec"] > 0
        assert all(np.isfinite(v) for k, v in t.items() if k != "tag")
