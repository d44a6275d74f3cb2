"""kernels.style_batch_roofline (layer: kernels): K3's share of its
roofline in the traced stretch: the frozen K3 bound (``counts/k3.py``:
bytes and operations of the rows each call styles, each byte read and
written once) summed over the stretch's styled batches, train and
validation, over the device time of the kernels that
``kernels.style_batch_roofline.json`` names, in percent. K3 styles the
rows of its styles one call per severity group (the file's routing of
the port's style set); nothing where the trace holds none of its
kernels."""

import numpy as np

from portbench.counts import k3

UNIT = "%"


def _groups(styles, route) -> list:
    """[K3 code of each style index, -1 outside the group] per severity
    group: a severity-dependent style joins the group of its severity (its
    default where none is given); the severity-free ones join the first."""
    codes, default = route["codes"], route["default_severity"]
    resolved = {}
    for i, (name, sev) in enumerate(styles):
        if name in default:
            resolved[i] = (codes[name], sev if sev is not None else default[name])
        elif name in codes:
            resolved[i] = (codes[name], None)
    sevs = list(dict.fromkeys(s for _, s in resolved.values() if s is not None))
    groups = {s: [-1] * len(styles) for s in sevs or [5]}
    for i, (code, s) in resolved.items():
        groups[next(iter(groups)) if s is None else s][i] = code
    return [np.asarray(g) for g in groups.values()] if resolved else []


def read(ctx):
    route = ctx.data_file("kernels.style_batch_roofline.json")
    sec = sum(s for name, (_, s) in ctx.trace.kernels.items()
              if any(p in name for p in route["kernels"]))
    if sec == 0:
        return None
    c, r = ctx.cell, ctx.run
    styles = [tuple(s) for s in c.traffic["styles"]]
    luts = _groups(styles, route)
    h = c.config["model"]["image_size"]
    train = r.datasets["train"].style_idx
    batches = [train[b] for b in ctx.stretch["batches"]]
    if ctx.stretch["validations"]:
        valid = r.datasets["valid"].style_idx
        b = c.batch_size
        batches += [valid[s:s + b] for s in range(0, len(valid), b)
                    ] * ctx.stretch["validations"]
    bound = sum(k3.bound_s(lut[sidx], h) for sidx in batches for lut in luts)
    return 100.0 * bound / sec
