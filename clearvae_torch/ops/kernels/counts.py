"""The kernels' launch counters, for code that launches kernels through a
captured CUDA graph.

Each wrapper adds one to its counter (``fused_loss.LAUNCHES``,
``style.LAUNCHES``) where it launches its kernel, and the mesh's
collectives to ``parallel.mesh.COLLECTIVES`` where they are issued. Under stream capture the
call launches nothing: it records the kernel into the graph, which launches
it on every replay. ``GraphLaunches`` moves those counts from the capture to
the replays, so the counters keep counting launches on the card.
"""

from __future__ import annotations

import contextlib

from clearvae_torch.ops.kernels import fused_loss, style
from clearvae_torch.parallel import mesh

COUNTERS = (fused_loss.LAUNCHES, style.LAUNCHES, mesh.COLLECTIVES)


class GraphLaunches:
    """The launches of one replay of a captured graph."""

    def __init__(self):
        self.per_replay = [dict.fromkeys(c, 0) for c in COUNTERS]

    @contextlib.contextmanager
    def capture(self):
        """Wrap the capture in this: what the wrappers count inside it is
        taken off the counters again and kept as one replay's launches."""
        before = [dict(c) for c in COUNTERS]
        try:
            yield self
        finally:
            for c, b, r in zip(COUNTERS, before, self.per_replay):
                for k in c:
                    r[k] = c[k] - b[k]
                c.update(b)

    def replay(self) -> None:
        """Count one replay's launches."""
        for c, r in zip(COUNTERS, self.per_replay):
            for k, v in r.items():
                c[k] += v
