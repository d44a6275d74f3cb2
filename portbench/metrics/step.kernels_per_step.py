"""step.kernels_per_step (layer: captured step): the device kernels in the
traced stretch over its train steps (copies and fills are not kernels;
a validation in the stretch counts with it)."""

UNIT = "kernels"


def read(ctx):
    return sum(n for n, _ in ctx.trace.kernels.values()) / ctx.stretch["steps"]
