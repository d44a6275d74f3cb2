"""step.host_us (layer: captured step): the host microseconds a train step
takes to stage its batch (the index row copied, the noise drawn), launch
its graph and queue the copy of its metrics: the mean of the program's
``step`` spans in the traced stretch outside any ``evaluate`` span, on the
host clock. Where the card's queue is full the launch waits for room, and
the mean reads the card's pace; the host holds the card back where the
card idles inside these spans. Nothing where the program has no spans."""

from portbench import spans

UNIT = "us"


def read(ctx):
    recs = spans.timeline()
    steps = [r for r in spans.named(recs, "step")
             if spans.outside(recs, r, "evaluate")]
    if not steps:
        return None
    return 1e-3 * sum(map(spans.ns, steps)) / len(steps)
