"""styling.ms_per_batch (layer: styling): the device milliseconds of the
cell's ``ds.style(raw, style_idx, draws)`` call on a batch, on the first
``BATCHES`` batches of epoch 1: the call is captured alone in a CUDA graph
(eager, it would time launches) over static inputs that each batch is
copied into, and each replay is timed by CUDA events. It runs before the
traced stretch: once the profiler has run, replays of a graph of many
small kernels were slower (MNIST-C styling 56.9 against 45.7 ms a batch on
an H100). Nothing where the cell styles once at set-up."""

import torch

UNIT = "ms"
BATCHES = 100
BEFORE_TRACE = True


def read(ctx):
    c, r = ctx.cell, ctx.run
    if not c.style_on_device:
        return None
    ds = r.datasets["train"]
    raw, sidx, draws = ds.device_arrays(r.device)
    rows = torch.as_tensor(r.batches(1)[:BATCHES], device=r.device)
    x, s, d = raw[rows[0]], sidx[rows[0]], draws[rows[0]]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        ds.style(x, s, d)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        ds.style(x, s, d)
    ms = 0.0
    for row in rows:
        x.copy_(raw[row])
        s.copy_(sidx[row])
        d.copy_(draws[row])
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        ms += start.elapsed_time(end)
    return ms / len(rows)
