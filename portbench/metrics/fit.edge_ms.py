"""fit.edge_ms (layer: entry point): the host milliseconds of an epoch's
edge in the traced stretch: each of the program's ``fit.epoch`` spans less
its ``fit.steps``, ``fit.sync`` and ``evaluate`` children (what is left:
the shuffle and its upload, the history's bookkeeping, the logging and the
print, a checkpoint), averaged over the epochs, on the host clock. Nothing
where the stretch holds no whole epoch (a stretch of replays), or the
program no spans."""

from portbench import spans

UNIT = "ms"
INSIDE = ("fit.steps", "fit.sync", "evaluate")


def read(ctx):
    recs = spans.timeline()
    epochs = spans.named(recs, "fit.epoch")
    if not epochs:
        return None
    inner = spans.children(recs, epochs, INSIDE)
    return (1e-6 * (sum(map(spans.ns, epochs)) - sum(map(spans.ns, inner)))
            / len(epochs))
