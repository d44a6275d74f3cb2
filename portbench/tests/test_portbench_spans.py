"""The per-layer readers of the program's own spans (``portbench/spans.py``):
their values on a timeline made by hand, nothing from a program without a
tracer, their values on the spans a tiny cell's program records on the CPU
under ``tracing()``, and, on the card, a traced run of each cell that
prints each of them where the program records its spans, in no other cell,
and counts no warm-up call, capture or kernel build in the traced stretch.
The card test runs with ``python -m pytest portbench/tests -m card``."""

import pytest
import torch

torch.set_num_threads(1)

from clearvae_torch.utils import logging as L  # noqa: E402
from portbench import harness as H  # noqa: E402
from portbench import run as R  # noqa: E402
from portbench import spans  # noqa: E402

NEW = ("validation.gmig_ms", "validation.batches_ms", "step.host_us",
       "fit.edge_ms", "setup.graph_ms")
MS = 1_000_000


def _rec(i, name, start_ms, end_ms, parent=None):
    return {"id": i, "name": name, "start_ns": int(start_ms * MS),
            "end_ns": int(end_ms * MS), "parent": parent}


# one epoch of two steps and a validation of one step, in ms
TIMELINE = [
    _rec(0, "fit.epoch", 0, 100),
    _rec(1, "fit.shuffle", 1, 2, 0),
    _rec(2, "fit.steps", 2, 10, 0),
    _rec(3, "step", 2, 2.5, 2),
    _rec(4, "step", 3, 3.75, 2),
    _rec(5, "fit.sync", 10, 15, 0),
    _rec(6, "evaluate", 20, 90, 0),
    _rec(7, "evaluate.batches", 20, 30, 6),
    _rec(8, "step", 21, 23, 7),
    _rec(9, "evaluate.gmig", 40, 89, 6),
]
AGGREGATES = {"step.warmup": {"calls": 4, "total_ns": 300 * MS,
                              "longest_ns": 100 * MS},
              "step.capture": {"calls": 2, "total_ns": 200 * MS,
                               "longest_ns": 150 * MS}}


def _readers():
    return {n: H.reader(n) for n in NEW}


def test_readers_on_a_timeline_made_by_hand(monkeypatch):
    monkeypatch.setattr(spans, "snapshot", lambda: {
        "timeline": TIMELINE, "spans": AGGREGATES, "counters": {}})
    got = {n: m.read(None) for n, m in _readers().items()}
    assert got == pytest.approx({
        "validation.gmig_ms": 49.0,
        "validation.batches_ms": 70.0 - 49.0,
        "step.host_us": (500 + 750) / 2,     # not the eval step
        "fit.edge_ms": 100 - 8 - 5 - 70,
        "setup.graph_ms": 500.0})
    assert all(H.reader(n).UNIT for n in NEW)


def test_readers_read_nothing_without_the_programs_spans(monkeypatch):
    """A program without a tracer (the import fails), and one whose
    stretch recorded no span: every reader gives None and raises
    nothing."""
    nothing = dict.fromkeys(NEW)
    monkeypatch.delattr(L, "snapshot")
    assert spans.snapshot() is None
    assert {n: m.read(None) for n, m in _readers().items()} == nothing
    monkeypatch.undo()
    monkeypatch.setattr(spans, "snapshot", lambda: {
        "timeline": [], "spans": {}, "counters": {}})
    assert {n: m.read(None) for n, m in _readers().items()} == nothing


def test_readers_on_a_tiny_cells_spans():
    """A tiny cell 1 on the CPU: one validation period of ``fit`` under
    ``tracing()``. The two validation readers sum to the ``evaluate``
    span; a train step and the epoch edges take host time; no warm-up
    call runs on the CPU, so ``setup.graph_ms`` reads nothing."""
    cell = H.load_cell("vae28-downstream-fit", {
        "traffic": {"n_images": 400}, "config": {"fit": {"batch_size": 32}}})
    run = H.set_up(cell, 2 ** 31 + 5, "cpu")
    L.clear_timeline()
    with L.tracing():
        run.fit(cell.round_epochs, 1)
    got = {n: m.read(H.Context(cell, run)) for n, m in _readers().items()}
    evaluate = spans.named(spans.timeline(), "evaluate")
    L.clear_timeline()
    assert len(evaluate) == 1
    assert got["validation.gmig_ms"] + got["validation.batches_ms"] == (
        pytest.approx(1e-6 * spans.ns(evaluate[0])))
    assert got["setup.graph_ms"] is None
    assert all(got[n] > 0 for n in NEW[:4]), got
    assert got["step.host_us"] < 1e6


@pytest.mark.card
@pytest.mark.parametrize("cell,where", [
    ("vae28-downstream-fit", NEW),
    ("vae64-celeba-fit", ("step.host_us", "fit.edge_ms", "setup.graph_ms")),
    ("vae28-styled6-ondevice", NEW),
    ("vae28-mnistc16-ondevice", ("step.host_us", "setup.graph_ms"))])
def test_a_traced_run_prints_the_span_metrics(cell, where, card, monkeypatch):
    """The five metrics added to the cell's own: a traced run prints those
    of ``where`` and no other, and its stretch counts no warm-up call, no
    capture and no kernel build. Where the stretch validates, gMIG and the
    rest of the validation sum to the harness's own wall of that
    ``evaluate`` call within 2 % (the call's span lies inside it). The
    timeline is the process's: an earlier test's stretch is cleared from
    it, as a run of the benchmark has one stretch a process."""
    L.clear_timeline()
    stretch, moved, walls = H.traced_stretch, {}, []
    watched = ("step.warmups", "step.captures", "kernels.builds")

    def counted(run):
        before = L.snapshot()["counters"]
        out = stretch(run)
        after = L.snapshot()["counters"]
        for n in watched:
            moved[n] = {k: v - before.get(n, {}).get(k, 0)
                        for k, v in after.get(n, {}).items()}
        walls.extend(run.observer.validation_s[-out[0]["validations"]:]
                     if out[0]["validations"] else [])
        return out

    monkeypatch.setattr(H, "traced_stretch", counted)
    per_layer = H.load_cell(cell).workload["metrics"]["per_layer"]
    result = R.run(cell, 2 ** 31 + 17, 51, trace=True, overrides={
        "workload": {"metrics": {"per_layer": per_layer + list(NEW)}}})
    assert result["correct"], result["checks"]
    m = result["metrics"]
    assert set(m) & set(NEW) == set(where), m
    assert all(not any(moved[n].values()) for n in watched), moved
    if walls:
        parts = m["validation.gmig_ms"]["value"] + m[
            "validation.batches_ms"]["value"]
        assert abs(parts / (1e3 * sum(walls) / len(walls)) - 1) < 0.02, (
            m, walls)
