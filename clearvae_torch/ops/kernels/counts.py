"""The program's counters under a captured CUDA graph.

Each kernel wrapper adds one to its counter (``fused_loss.LAUNCHES``,
``style.LAUNCHES``, ``threefry.LAUNCHES``, ``glass.LAUNCHES``) where it
launches its kernel, and the mesh's collectives to
``parallel.mesh.COLLECTIVES`` where they are issued; all are counters of
the tracer's registry (``utils/logging.py``). Under stream capture a call launches nothing: it records the kernel into the graph,
which launches it on every replay. ``GraphLaunches`` moves whatever any
registered counter counted during a capture to the replays, so the
counters keep counting launches on the card.
"""

from __future__ import annotations

import contextlib

from clearvae_torch.utils.logging import TRACER


class GraphLaunches:
    """The counts of one replay of a captured graph: {counter name: {key:
    count}}."""

    def __init__(self):
        self.per_replay: dict = {}

    @contextlib.contextmanager
    def capture(self):
        """Wrap the capture in this: what the registered counters count
        inside it is taken off them again and kept as one replay's."""
        before = {n: dict(c) for n, c in TRACER.counters.items()}
        try:
            yield self
        finally:
            for n, c in TRACER.counters.items():
                b = before.get(n, {})
                moved = {k: v - b.get(k, 0) for k, v in c.items()
                         if v != b.get(k, 0)}
                for k in moved:
                    c[k] = b.get(k, 0)
                if moved:
                    self.per_replay[n] = moved

    def replay(self) -> None:
        """Count one replay's launches."""
        for n, r in self.per_replay.items():
            c = TRACER.counters[n]
            for k, v in r.items():
                c[k] += v
