"""device.idle_share (layer: device): the share of the traced stretch in
which no operation ran on the card, 1 − device-busy / wall, in percent.
Busy is the union of the device's kernels and copies in the profiler's
trace; the wall is the stretch's on the host clock."""

UNIT = "%"


def read(ctx):
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.stretch["wall_s"])
