"""validation.gmig_ms (layer: validation): the host milliseconds of gMIG
in a validation of the traced stretch: the program's ``evaluate.gmig``
spans (``mutual_info_gap``: the labels' round trip, the latents to the
host, the native KSG estimates on z_c and on z_s) over its ``evaluate``
spans, on the host clock. Nothing where the stretch holds no validation,
or the program no spans."""

from portbench import spans

UNIT = "ms"


def read(ctx):
    recs = spans.timeline()
    evals = spans.named(recs, "evaluate")
    if not evals:
        return None
    gmig = spans.children(recs, evals, ("evaluate.gmig",))
    return 1e-6 * sum(map(spans.ns, gmig)) / len(evals)
