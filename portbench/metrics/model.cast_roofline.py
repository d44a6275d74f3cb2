"""model.cast_roofline (layer: model): the share of HBM's roofline that the
model's casts between float32 and its lower compute dtype reach in the
traced stretch, in percent. One train step's cast bytes come from the
program's counter ``model.casts`` (``clearvae_torch/models/layers.py``:
each cast read and written once, and its gradient's cast back where the
backward runs it; a capture's count moves to its replays), over the train
step's warm-up calls and replays (``GraphedEpoch``'s). Over 3.35 TB/s that
is the least time a step's casts can take, which is divided by the device
seconds a step of the dtype-converting copy kernels that
``model.cast_roofline.json`` names, each kind by all the parts of its name
listed there: torch's copy to bfloat16, and its copy to float32 from
another dtype. The second kind is one kernel whatever the source dtype, so
it takes the step's few integer-to-float copies of the loss too, which the
counter does not count. Nothing where the program has no such counter or
counted no cast (a float32 model), where an evaluation's graph ran the
model too, or where no kernel matches."""

from portbench import spans
from portbench.counts import peaks

UNIT = "%"
BODIES = ("step.warmups", "step.replays")


def step_bytes(counters: dict):
    """One train step's cast bytes: the counter's total over the train
    steps that ran (``GraphedEpoch``'s warm-up calls and replays), or None
    where that cannot be told."""
    casts = counters.get("model.casts", {}).get("bytes", 0)
    bodies = sum(counters.get(n, {}).get("GraphedEpoch", 0) for n in BODIES)
    evals = sum(counters.get(n, {}).get("GraphedEval", 0) for n in BODIES)
    if not casts or not bodies or evals:
        return None
    return casts / bodies


def read(ctx):
    per_step = step_bytes((spans.snapshot() or {}).get("counters", {}))
    if per_step is None:
        return None
    kinds = ctx.data_file("model.cast_roofline.json")["kernels"]
    sec = sum(s for name, (_, s) in ctx.trace.kernels.items()
              if any(all(p in name for p in kind) for kind in kinds))
    if sec == 0:
        return None
    return (100.0 * per_step / peaks.PEAK_BYTES_PER_S
            / (sec / ctx.stretch["steps"]))
