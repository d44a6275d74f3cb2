"""validation.batches_ms (layer: validation): the host milliseconds of a
validation in the traced stretch outside gMIG: the program's ``evaluate``
spans less their ``evaluate.gmig`` children (the graph's replays and the
ragged tail, the totals fetched to the host, the Poisson check), over the
``evaluate`` spans, on the host clock. With ``validation.gmig_ms`` it sums
to the ``evaluate`` span. Nothing where the stretch holds no validation, or
the program no spans."""

from portbench import spans

UNIT = "ms"


def read(ctx):
    recs = spans.timeline()
    evals = spans.named(recs, "evaluate")
    if not evals:
        return None
    gmig = spans.children(recs, evals, ("evaluate.gmig",))
    return (1e-6 * (sum(map(spans.ns, evals)) - sum(map(spans.ns, gmig)))
            / len(evals))
