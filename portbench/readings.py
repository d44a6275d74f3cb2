"""The readings that the limits of a cell's check are set from, many seeds
in one process on the card:

    python -m portbench.readings --workload <cell> --seeds 1 2 3 ...

For each seed: the cell's set-up (the program driven from the seed through
its first epoch by ``fit``, and its validation where the cell validates),
then the compared numbers of

- ``program``: the program against the reference, as a run checks them;
- ``control``: the reference in TF32 put in the program's place against
  the reference in float32 with TF32 off (the configuration's precision);
  the validation's from the same program state;
- ``half``: the reference with half of each batch left out of the
  per-sample means, put in the program's place (a planted fault).

One JSON line a seed, then one with, per number, the largest program
reading and the smallest control and fault readings. The benchmark's own
runs do not run this; ``tests/test_portbench_control.py`` keeps the
control, the fault and a stale replay as tests on the card.
"""

from __future__ import annotations

import argparse
import json
import math
import sys

import torch


def readings(workload: str, seed: int, device="cuda", overrides=None) -> dict:
    from portbench import check as C
    from portbench import harness as H

    cell = H.load_cell(workload, overrides)
    run = H.set_up(cell, seed, device)
    obs = run.observer
    snapshot = obs.validation
    history = H.release(run)
    out = {"seed": seed, "program": C.program_readings(run, history)}
    batches = C.first_batches(run)
    ref = C.reference_steps(run, batches=batches)
    for name, kw in (("control", {"tf32": True}), ("half", {"half": True})):
        alt = C.reference_steps(run, batches=batches, **kw)
        out[name] = C.step_numbers(alt["losses"], alt["grad1"], alt["params"],
                                   run.weights, ref, run.modules)
        out[name]["nonfinite_losses"] = float(
            sum(not math.isfinite(v) for v in alt["losses"]))
    if cell.validate and snapshot is not None:
        state, gen, _ = snapshot
        mig, mse = C.reference_validation(run, state, gen)
        for name, kw in (("control", {"tf32": True,
                                      "mig_dtype": torch.float32}),
                         ("half", {"half": True})):
            a_mig, a_mse = C.reference_validation(run, state, gen, **kw)
            out[name].update(mig_gap=abs(a_mig - mig),
                             mse_gap=abs(a_mse - mse) / abs(mse))
    out["worst_leaves"] = worst_leaves(run, obs, ref)
    return out


def worst_leaves(run, obs, ref, n: int = 3) -> dict:
    """The leaves of the program's largest gradient and change gaps, each
    module's among its own (``<module>.grad1`` after the model's)."""
    from portbench import check as C
    from portbench import harness as H

    out = {}
    for m in run.modules:
        keys = [k for k in run.weights if H.module_of(k, run.modules) == m]
        delta = (None if obs.params is None else
                 {k: obs.params[k] - run.weights[k] for k in keys})
        ref_delta = {k: ref["params"][k] - run.weights[k] for k in keys}
        ref_grad1 = {k: ref["grad1"][k] for k in keys}
        for name, gaps in (("grad1", C.leaf_gaps(obs.grad1, ref_grad1)),
                           ("delta5", C.leaf_gaps(delta, ref_delta,
                                                  C.moved(ref_grad1)))):
            top = sorted(gaps.items(), key=lambda kv: -kv[1])[:n]
            out[H.prefix(m) + name] = [[k, v, int(run.weights[k].numel())]
                                       for k, v in top]
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    from portbench import run as R

    R.use_cache_dirs()
    rows = []
    for seed in args.seeds:
        rows.append(readings(args.workload, seed))
        print(json.dumps(rows[-1]), flush=True)
    summary = {"workload": args.workload,
               "program_max": {k: max(r["program"][k] for r in rows)
                               for k in rows[0]["program"]},
               **{f"{kind}_min": {k: min(r[kind][k] for r in rows)
                                  for k in rows[0][kind]}
                  for kind in ("control", "half")}}
    # the second largest program reading: how far the largest stands out
    summary["program_second"] = {
        k: sorted(r["program"][k] for r in rows)[-2] if len(rows) > 1 else None
        for k in rows[0]["program"]}
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
