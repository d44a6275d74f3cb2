"""model.conv_ms_per_step (layer: model): the device milliseconds a train
step of the convolution kernels (cuDNN's and CUTLASS's forward, data- and
weight-gradient kernels), found in the traced stretch by the name patterns
of ``model.conv_ms_per_step.json``; nothing where none matches."""

UNIT = "ms"


def read(ctx):
    pats = ctx.data_file("model.conv_ms_per_step.json")["patterns"]
    sec = sum(s for name, (_, s) in ctx.trace.kernels.items()
              if any(p in name for p in pats))
    return 1e3 * sec / ctx.stretch["steps"] if sec > 0 else None
