"""Reading a ``torch.profiler`` trace of a stretch of the run: device kernels
by name, the device's busy time, and its idle gaps labelled by what the
harness was doing. The profiler window and the event filter are
``clearvae_torch/bench.py``'s ``profile_window`` and ``device_kernels``,
copied: the window settles at both edges (kernels right after the
profiler started were missing from traces on the card), and host ranges
that the profiler mirrors onto the device timeline are neither kernels
nor busy time.

The harness marks its stretch with ``record_function`` ranges: ``STRETCH``
around the whole stretch, ``EPOCH`` around each ``fit`` call of one epoch,
``VALIDATION`` around each ``evaluate`` call. An idle gap inside a
validation is labelled "validation"; one between the first and the last
graph replay of an epoch's steps "steps"; any other "epoch boundary".
"""

from __future__ import annotations

import contextlib
import dataclasses
import time

import torch

SETTLE_S = 0.02
STRETCH, EPOCH, VALIDATION = ("portbench.stretch", "portbench.epoch",
                              "portbench.validation")
TOP = 10


@contextlib.contextmanager
def profiled():
    """``torch.profiler.profile`` of CPU and CUDA activity around a block
    that starts and ends ``SETTLE_S`` inside the window, the device idle at
    both edges."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        time.sleep(SETTLE_S)
        yield prof
        torch.cuda.synchronize()
        time.sleep(SETTLE_S)


@dataclasses.dataclass
class Trace:
    """What a profiled stretch shows: ``kernels`` {name: [launches, device
    seconds]}, ``busy_s`` (the union of the device's activity, copies
    included), ``idle`` {label: [gaps, seconds, longest gap]} and the
    stretch's span on the profiler's clock."""

    kernels: dict
    busy_s: float
    idle: dict
    span_s: float

    def top_ops(self, n: int = TOP) -> list:
        ops = sorted(self.kernels.items(), key=lambda kv: -kv[1][1])[:n]
        return [[name, sec] for name, (_, sec) in ops]

    def idle_gaps(self) -> list:
        out = []
        for label, (_, total, longest) in sorted(self.idle.items(),
                                                 key=lambda kv: -kv[1][1]):
            out += [[f"{label}: total", total], [f"{label}: longest", longest]]
        return out[:TOP]


def _merge(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def _inside(ranges, t) -> bool:
    return any(s <= t <= e for s, e in ranges)


def read(prof) -> Trace:
    """The ``Trace`` of a profile whose block holds one ``STRETCH`` range."""
    from torch.autograd import DeviceType

    events = prof.events()
    host = {e.name for e in events if e.device_type == DeviceType.CPU}
    kernels: dict = {}
    device = []
    stretch, epochs, validations, launches = None, [], [], []
    for e in events:
        tr = e.time_range
        if e.device_type == DeviceType.CPU:
            if e.name == STRETCH:
                stretch = (tr.start, tr.end)
            elif e.name == EPOCH:
                epochs.append((tr.start, tr.end))
            elif e.name == VALIDATION:
                validations.append((tr.start, tr.end))
            elif e.name.startswith("cudaGraphLaunch"):
                launches.append(tr.start)
            continue
        if (e.device_type != DeviceType.CUDA or e.is_user_annotation
                or e.name in host):
            continue
        device.append((tr.start, tr.end))
        if not e.name.startswith(("Memcpy", "Memset")):
            k = kernels.setdefault(e.name, [0, 0.0])
            k[0] += 1
            k[1] += tr.elapsed_us() * 1e-6
    if stretch is None:
        raise RuntimeError("the profile holds no stretch range: the "
                           "profiler recorded no host events")
    busy = _merge((max(s, stretch[0]), min(e, stretch[1])) for s, e in device
                  if e > stretch[0] and s < stretch[1])
    # the steps of each epoch: from its first to its last train replay
    step_spans = []
    for s, e in epochs:
        own = [t for t in launches if s <= t <= e
               and not _inside(validations, t)]
        if own:
            step_spans.append((min(own), max(own)))
    idle: dict = {}
    edges = [stretch[0]] + [t for b in busy for t in b] + [stretch[1]]
    for gs, ge in zip(edges[0::2], edges[1::2]):
        if ge <= gs:
            continue
        mid = 0.5 * (gs + ge)
        label = ("validation" if _inside(validations, mid) else
                 "steps" if _inside(step_spans, mid) else "epoch boundary")
        g = idle.setdefault(label, [0, 0.0, 0.0])
        sec = (ge - gs) * 1e-6
        g[0] += 1
        g[1] += sec
        g[2] = max(g[2], sec)
    return Trace(kernels, sum(e - s for s, e in busy) * 1e-6, idle,
                 (stretch[1] - stretch[0]) * 1e-6)
