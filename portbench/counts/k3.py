"""The roofline bound of one call of K3, the port's deterministic styler
(``clearvae_torch/csrc/style_kernel.cu``), frozen from ``chip_smoke.py``'s
``k3_bound``, counting only the rows that the call styles: a row of code
-1 belongs to another route and K3 neither reads nor writes it.

Bytes: each styled pixel read once and written once, the batch's codes, and
the zoom matrix; operations: per styled pixel as its style needs (scale:
two passes through the zoom matrix, whose rows hold at most two nonzeros, a
multiply and an add each; a handful for the elementwise styles). The bound
is the larger of bytes over HBM bandwidth and operations over the fp32
peak."""

from __future__ import annotations

from portbench.counts.peaks import PEAK_BYTES_PER_S, PEAK_FP32_FLOPS

# K3 code -> fp32 operations a pixel: identity, stripe, brightness,
# inverse, quantize, contrast, scale
OPS_PER_PIXEL = {0: 0, 1: 1, 2: 5, 3: 1, 4: 3, 5: 8, 6: 8}


def bound_s(codes, h: int) -> float:
    """Seconds of one K3 call over a batch whose rows have the K3 ``codes``
    (-1: not K3's) on h×h images."""
    served = [int(c) for c in codes if int(c) >= 0]
    nbytes = 4 * (2 * len(served) * h * h + len(codes) + h * h)
    flops = sum(OPS_PER_PIXEL[c] for c in served) * h * h
    return max(nbytes / PEAK_BYTES_PER_S, flops / PEAK_FP32_FLOPS)
