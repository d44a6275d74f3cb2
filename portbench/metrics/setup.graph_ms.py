"""setup.graph_ms (layer: captured step): the host milliseconds that the
graphed steps' eager warm-up calls and CUDA graph captures took since the
process started, train and eval graphs alike: the aggregates of the
program's ``step.warmup`` and ``step.capture`` spans, read after the traced
stretch (which runs neither: set-up made every graph). Nothing where the
program has no spans, or ran no warm-up call (on the CPU)."""

from portbench import spans

UNIT = "ms"


def read(ctx):
    agg = spans.aggregates()
    parts = [agg[n]["total_ns"] for n in ("step.warmup", "step.capture")
             if n in agg]
    return 1e-6 * sum(parts) if parts else None
