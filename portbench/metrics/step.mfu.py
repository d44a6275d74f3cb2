"""step.mfu (layer: captured step): the whole training step's share of the
card's peak: the frozen analytic training FLOPs an image
(``counts/flops.py``) times the images trained, over their wall and the
card's published peak for the configuration's compute type (fp32: 67
TFLOP/s), in percent. The images and the wall are those of the untraced
steps that the harness runs just before its traced stretch (the same
graphed steps, no validation among them, timed on the host clock to a
device synchronize at each end), since the profiler slows the steps it
traces. The card's power limit is printed beside every run."""

from portbench.counts import flops, peaks

UNIT = "%"
PEAK = {"fp32": peaks.PEAK_FP32_FLOPS, "bf16": peaks.PEAK_BF16_FLOPS}


def read(ctx):
    cfg, u = ctx.cell.config, ctx.stretch["untraced"]
    return (100.0 * flops.per_image(cfg) * u["images"] / u["wall_s"]
            / PEAK[cfg["compute"]])
