"""evaluate.ms (layer: validation): the wall of one ``evaluate(valid, B,
style_on_device=<the cell's>)`` call, as ``fit``'s validation makes it, up
to a device synchronize, on the host clock: the median of three calls
after the traced stretch. Nothing where the cell does not validate."""

import statistics
import time

import torch

UNIT = "ms"
CALLS = 3
BEFORE_TRACE = True


def read(ctx):
    c, r = ctx.cell, ctx.run
    if not c.validate:
        return None
    walls = []
    for _ in range(CALLS):
        torch.cuda.synchronize(r.device)
        t0 = time.perf_counter()
        r.observer.original_evaluate(r.datasets["valid"], c.batch_size,
                                     style_on_device=c.style_on_device)
        torch.cuda.synchronize(r.device)
        walls.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(walls)
