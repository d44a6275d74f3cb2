"""The port's tracer (``clearvae_torch/utils/logging.py``): the span tree a
graphed ``fit`` with validation records, nothing recorded with tracing off,
the spans in a ``torch.profiler`` trace on its clock, counters moved from a
capture to its replays, no number changed by tracing, and the aggregates
kept when the timeline is cleared. On the CPU, where the graphed steps run
their bodies uncaptured (no warm-up calls, captures or replays)."""

import collections
import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from clearvae_torch.data.mnist import synthetic_mnist
from clearvae_torch.data.styled import make_styled_mnist
from clearvae_torch.ops.kernels import fused_loss as FL
from clearvae_torch.ops.kernels.counts import GraphLaunches
from clearvae_torch.train.factories import get_clearvae_trainer
from clearvae_torch.utils import logging as L


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """These tiny CPU fits gain nothing from intra-op threads, and with
    several test workers on the machine the threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _empty_timeline():
    L.clear_timeline()
    yield
    L.clear_timeline()


N_TRAIN, N_VALID, BS, EPOCHS = 96, 40, 32, 2
KW = dict(beta=1 / 8, ps=True, vae_lr=5e-4, z_dim=16, alpha=100.0,
          temperature=0.1, seed=8, mig_backend="numpy", device="cpu",
          verbose_period=1)


def _data():
    return (make_styled_mnist(*synthetic_mnist(N_TRAIN, seed=8), seed=8),
            make_styled_mnist(*synthetic_mnist(N_VALID, seed=9), seed=9))


def _fit(trainer=None):
    train, valid = _data()
    t = trainer or get_clearvae_trainer(**KW)
    t.fit(EPOCHS, train, valid, batch_size=BS)
    return t


def _tree():
    """{(name, parent's name): records} of the timeline."""
    recs = L.snapshot()["timeline"]
    by_id = {r["id"]: r for r in recs}
    return collections.Counter(
        (r["name"], by_id[r["parent"]]["name"] if r["parent"] in by_id
         else None) for r in recs)


def test_fit_records_the_span_tree():
    with L.tracing():
        _fit()
    tree = _tree()
    steps, evals = N_TRAIN // BS, N_VALID // BS
    assert tree == {
        ("fit.epoch", None): EPOCHS,
        ("fit.shuffle", "fit.epoch"): EPOCHS,
        ("fit.steps", "fit.epoch"): EPOCHS,
        ("fit.sync", "fit.epoch"): EPOCHS,
        ("fit.log", "fit.epoch"): EPOCHS,
        ("evaluate", "fit.epoch"): EPOCHS,
        ("step", "fit.steps"): EPOCHS * steps,
        ("evaluate.batches", "evaluate"): EPOCHS,
        ("evaluate.fetch", "evaluate"): EPOCHS,
        ("evaluate.gmig", "evaluate"): EPOCHS,
        ("step", "evaluate.batches"): EPOCHS * evals,
        ("step.stage", "step"): EPOCHS * (steps + evals),
        ("step.launch", "step"): EPOCHS * (steps + evals),
    }
    recs = L.snapshot()["timeline"]
    by_id = {r["id"]: r for r in recs}
    for r in recs:
        assert r["start_ns"] <= r["end_ns"]
        if r["parent"] is not None:
            p = by_id[r["parent"]]
            assert p["start_ns"] <= r["start_ns"] <= r["end_ns"] <= p["end_ns"]


def test_tracing_off_records_no_timeline_and_no_record_function(monkeypatch):
    opened = []
    record_function = torch.autograd.profiler.record_function

    def counted(name, args=None):
        opened.append(name)
        return record_function(name, args)

    monkeypatch.setattr(torch.autograd.profiler, "record_function", counted)
    before = L.snapshot()["spans"]
    _fit()
    after = L.snapshot()
    assert after["timeline"] == []
    # torch's own (the optimizer's) open; none of the program's spans
    assert opened and not set(opened) & set(after["spans"])
    steps, evals = N_TRAIN // BS, N_VALID // BS
    calls = {n: after["spans"][n]["calls"] - before.get(n, {}).get("calls", 0)
             for n in ("fit.epoch", "step", "evaluate.gmig")}
    assert calls == {"fit.epoch": EPOCHS, "step": EPOCHS * (steps + evals),
                     "evaluate.gmig": EPOCHS}


def test_spans_lie_in_the_profilers_trace_on_its_clock():
    """Under a CPU profiler each recorded span is a host event of its name
    whose interval holds the record's, on the profiler's own clock (its
    events' Unix-epoch ns), to the clocks' conversion (50 µs)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _fit()
    recs = L.snapshot()["timeline"]
    assert len(recs) > 20
    events = collections.defaultdict(list)
    for e in prof.profiler.kineto_results.events():
        events[e.name()].append((e.start_ns(), e.end_ns()))
    records = collections.defaultdict(list)
    for r in recs:
        records[r["name"]].append((r["start_ns"], r["end_ns"]))
    tol = 50_000
    for name, rs in records.items():
        evs = sorted(events[name])
        assert len(evs) == len(rs), name
        for (rs_, re_), (es, ee) in zip(sorted(rs), evs):
            assert es - tol <= rs_ <= re_ <= ee + tol, name
            assert (ee - es) - (re_ - rs_) < 5_000_000, name


def test_a_span_open_as_the_profiler_starts_or_stops_stays_out():
    prof = profile(activities=[ProfilerActivity.CPU])
    with L.span("outer"):
        prof.start()
        with L.span("inner"):
            pass
        with L.span("cut"):
            prof.stop()
    assert [r["name"] for r in L.snapshot()["timeline"]] == ["inner"]
    assert L.snapshot()["timeline"][0]["parent"] is None


def test_graph_launches_move_a_registered_counter():
    """Any registered counter counted inside a capture moves to the
    replays, as the kernels' ``LAUNCHES`` do, and a new key with it."""
    mine = L.counter("test.moved", ("a",))
    assert L.counter("test.moved") is mine
    FL.reset_launches()
    gl = GraphLaunches()
    with gl.capture():
        mine["a"] += 2
        mine["new"] += 1
        FL.LAUNCHES["snn_fwd"] += 1
    assert (mine["a"], mine["new"], FL.LAUNCHES["snn_fwd"]) == (0, 0, 0)
    for _ in range(3):
        gl.replay()
    assert (mine["a"], mine["new"], FL.LAUNCHES["snn_fwd"]) == (6, 3, 3)
    assert L.snapshot()["counters"]["test.moved"] == {"a": 6, "new": 3}
    assert L.snapshot()["counters"]["launches.fused_loss"] == FL.LAUNCHES
    FL.reset_launches()


def test_tracing_changes_no_number():
    off = _fit()
    with L.tracing():
        on = _fit()
    for h_off, h_on in zip(off.history, on.history, strict=True):
        for k in h_off:
            np.testing.assert_array_equal(h_on[k], h_off[k], err_msg=k)
    for (k, a), b in zip(off.model.state_dict().items(),
                         on.model.state_dict().values()):
        assert torch.equal(a, b), k


def test_aggregates_survive_clearing_the_timeline(tmp_path):
    with L.tracing():
        for _ in range(3):
            with L.span("test.agg"):
                pass
    before = L.snapshot()["spans"]["test.agg"]
    assert before["calls"] >= 3
    assert 0 < before["longest_ns"] <= before["total_ns"]
    L.clear_timeline()
    snap = L.snapshot()
    assert snap["timeline"] == [] and snap["spans"]["test.agg"] == before
    # profile_trace writes the spans into the Chrome trace, and the
    # snapshot beside it
    with L.profile_trace(str(tmp_path / "tr")):
        with L.span("test.agg"):
            torch.ones(4).add_(1)
    with open(tmp_path / "tr" / "trace.json") as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    with open(tmp_path / "tr" / "program.json") as f:
        program = json.load(f)
    assert "test.agg" in names
    assert program["spans"]["test.agg"]["calls"] == before["calls"] + 1
    assert [r["name"] for r in program["timeline"]] == ["test.agg"]
