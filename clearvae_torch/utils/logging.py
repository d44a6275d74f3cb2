"""Structured metric logging, the program's spans and counters, and a
profiler context (counterpart of ``clearvae_tpu/utils/logging.py``, which
has the first and the last).

``MetricLogger`` writes JSONL metric streams, one object a line with its
tag and step. ``profile_trace`` runs ``torch.profiler`` over a block and
exports a Chrome trace, the program's spans in it on the kernels' clock,
with the tracer's ``snapshot()`` beside it.

The tracer (``TRACER``; ``span``, ``counter``, ``tracing``, ``snapshot``)
is one registry a process:

- ``span(name)`` times a block of host work. It always adds to the
  name's aggregate: calls, total ns and longest ns. While a
  ``torch.profiler`` records (checked as the span opens and as it closes)
  or inside ``tracing()``, it also enters ``record_function(name)``, so
  that the span lies in the profiler's trace beside the kernels and graph
  launches it issued, and appends a record to the timeline: (id, name,
  start, end, the id of the recorded span that encloses it, or None), in
  ns on the profiler's clock (the Unix epoch's). A span open when the
  profiler starts or stops is left out of the timeline. No span is opened
  inside a captured CUDA graph's body: it would run only at the capture.
- ``counter(name, keys)`` registers a ``collections.Counter`` of counts
  under ``name`` and returns it; the kernels' launch counters are among
  them. ``ops/kernels/counts.GraphLaunches`` moves whatever any of them
  counted inside a capture to the capture's replays.
- ``snapshot()`` returns the aggregates, the counters and the timeline as
  plain data; ``clear_timeline()`` empties the timeline alone.
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import time
from typing import IO

import torch

_profiler_enabled = torch._C._autograd._profiler_enabled
# the profiler's clock (its events' Unix-epoch ns) from the monotonic one
_UNIX_OFFSET_NS = time.time_ns() - time.perf_counter_ns()


class MetricLogger:
    """Append-only JSONL metric log: ``{"ts", "tag", "step", metrics...}``
    a line."""

    def __init__(self, path: str | None):
        self.path = path
        self._fh: IO | None = None
        if path:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
            self._fh = open(path, "a")

    def log(self, tag: str, step: int | None = None, **metrics):
        rec = {"ts": time.time(), "tag": tag}
        if step is not None:
            rec["step"] = int(step)
        rec.update({k: (float(v) if hasattr(v, "__float__") else v)
                    for k, v in metrics.items()})
        if self._fh:
            self._fh.write(json.dumps(rec) + "\n")
            self._fh.flush()
        return rec

    def close(self):
        if self._fh:
            self._fh.close()
            self._fh = None


class _Span:
    __slots__ = ("tracer", "name", "t0", "fn", "id")

    def __init__(self, tracer: Tracer, name: str):
        self.tracer, self.name, self.fn = tracer, name, None

    def __enter__(self):
        tr = self.tracer
        if tr._forced or _profiler_enabled():
            self.fn = torch.autograd.profiler.record_function(self.name)
            self.fn.__enter__()
            self.id = tr._next_id
            tr._next_id += 1
            tr._open.append(self.id)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        tr, d = self.tracer, t1 - self.t0
        agg = tr.spans.get(self.name)
        if agg is None:
            tr.spans[self.name] = [1, d, d]
        else:
            agg[0] += 1
            agg[1] += d
            if d > agg[2]:
                agg[2] = d
        if self.fn is not None:
            tr._open.pop()
            self.fn.__exit__(*exc)
            if tr._forced or _profiler_enabled():
                tr.timeline.append(
                    (self.id, self.name, self.t0 + _UNIX_OFFSET_NS,
                     t1 + _UNIX_OFFSET_NS, tr._open[-1] if tr._open else None))
        return False


class Tracer:
    """The spans and counters of a process (see the module's docstring).
    ``spans``: {name: [calls, total ns, longest ns]}; ``counters``: {name:
    Counter}; ``timeline``: [(id, name, start ns, end ns, parent id)]."""

    def __init__(self):
        self.spans: dict = {}
        self.counters: dict = {}
        self.timeline: list = []
        self._forced = 0
        self._open: list = []
        self._next_id = 0

    def span(self, name: str) -> _Span:
        return _Span(self, name)

    @contextlib.contextmanager
    def tracing(self):
        """Record spans on the timeline (and as ``record_function``s)
        inside the block, with or without a profiler."""
        self._forced += 1
        try:
            yield self
        finally:
            self._forced -= 1

    def counter(self, name: str, keys=()) -> collections.Counter:
        c = self.counters.setdefault(name, collections.Counter())
        for k in keys:
            c.setdefault(k, 0)
        return c

    def snapshot(self) -> dict:
        return {"spans": {n: {"calls": c, "total_ns": t, "longest_ns": m}
                          for n, (c, t, m) in self.spans.items()},
                "counters": {n: dict(c) for n, c in self.counters.items()},
                "timeline": [{"id": i, "name": n, "start_ns": s, "end_ns": e,
                              "parent": p}
                             for i, n, s, e, p in self.timeline]}

    def clear_timeline(self) -> None:
        self.timeline.clear()


TRACER = Tracer()
span, tracing, counter = TRACER.span, TRACER.tracing, TRACER.counter
snapshot, clear_timeline = TRACER.snapshot, TRACER.clear_timeline


@contextlib.contextmanager
def profile_trace(log_dir: str | None):
    """``torch.profiler`` over the block (the CPU, and CUDA when there is a
    card), its Chrome trace written to ``log_dir/trace.json`` (the
    program's spans as host events on the kernels' clock) and the tracer's
    ``snapshot()`` to ``log_dir/program.json``; yields the profiler. A
    no-op yielding None when ``log_dir`` is None."""
    if log_dir is None:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
    with open(os.path.join(log_dir, "program.json"), "w") as f:
        json.dump(snapshot(), f)
