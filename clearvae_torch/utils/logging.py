"""Structured metric logging and profiler hooks (counterpart of
``clearvae_tpu/utils/logging.py``): JSONL metric streams, one object a line
with its tag and step, and a ``torch.profiler`` context that exports a
Chrome trace."""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import IO


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


@contextlib.contextmanager
def profile_trace(log_dir: str | None):
    """``torch.profiler`` over the block (the CPU, and CUDA when there is a
    card), its Chrome trace written to ``log_dir/trace.json``; yields the
    profiler. A no-op yielding None when ``log_dir`` is None."""
    if log_dir is None:
        yield None
        return
    import torch
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


class Throughput:
    """images/sec meter around a training loop."""

    def __init__(self):
        self.images = 0
        self.t0 = None

    def start(self):
        self.t0 = time.perf_counter()
        self.images = 0

    def add(self, n: int):
        self.images += n

    @property
    def images_per_sec(self) -> float:
        dt = time.perf_counter() - self.t0
        return self.images / dt if dt > 0 else float("nan")
