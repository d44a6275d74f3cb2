"""Whether the program computed what the plain reference computes.

The set-up drives the program's trainer from the seed through its first
epoch by the window's own call (``fit``'s graphed epoch); the reference
(the module that the configuration's ``"reference"`` names, under
``reference/``) follows its first ``H.CHECK_STEPS`` = 5 steps from the
same weights, inputs and noise. Steps 1–3 are ``fit``'s warm-up calls of
the step's body; step 4 captures that body in a CUDA graph and replays
it, step 5 is a replay, as is every step of the window. The numbers read:

- ``loss1_gap``: the first step's loss, relative gap (a forward alone);
- ``loss_gap``: the largest relative gap of the five steps' losses, the
  two replays' included (from ``fit``'s history);
- ``grad1_median_gap`` and ``grad1_gap``: per leaf, the gap between the
  norms of the first gradient (the program's from Adam's first moment
  after one update) and the reference's, over the reference's norm of
  that leaf or of the median leaf, whichever is larger; the median leaf's
  and the worst leaf's;
- ``delta5_median_gap`` and ``delta5_gap``: per leaf, the gap of the
  norms of the parameters' change over the five updates, the replays'
  included, as the gradient's; the median leaf's and the worst leaf's,
  leaving out the leaves whose reference gradient is under a thousandth
  of the median leaf's (a conv bias before BatchNorm: Adam moves it by
  round-off alone);
- for each module of the trainer's ``MODULES`` after ``model`` (a second
  player, such as CLEAR-MIM's ``mi_estimator``), the same four over its
  own leaves, named ``<module>.grad1_median_gap``, ``.grad1_gap``,
  ``.delta5_median_gap`` and ``.delta5_gap``: the first gradient that its
  own optimizer took, the change over the five train steps, with the
  module's own median and its own ``moved`` leaves; the four above stay
  the model's;
- where the cell validates, from the model's state and the noise
  generator's at the window's last validation, which the reference
  evaluates again: ``mse_gap`` (relative) and ``mig_gap`` (absolute);
- ``nonfinite_losses``: losses in the run's history that are not finite.

A cell compares the numbers its ``limits`` name. The others are printed:
over many seeds they have a tail (a ReLU input within float noise of zero
takes another side than in the reference, and Adam's first updates move
an element whose gradient sits at zero by ±lr), or, gMIG's, no reading
that separates a fault (PERF.md).

The reference computes in float32 with TF32 off, gMIG in float64 (the
control: TF32, and float32 distances).
"""

from __future__ import annotations

import math
import statistics

import numpy as np
import torch

from portbench import harness as H


def _tf32(on: bool) -> None:
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on


def first_batches(run: H.Run, n: int = H.CHECK_STEPS) -> list:
    """The reference's (x, label, noise) of the program's first ``n``
    steps: the rows of epoch 0, their pixels made again by the reference,
    the noise redrawn from the trainer's seed in the trainer's order."""
    mk, ref = H.maker(run.cell), H.reference(run.cell)
    rows = run.batches(0)[:n]
    labels = mk.labels(run.data, "train")
    gen = torch.Generator(device=run.device).manual_seed(run.seeds["trainer"])
    out = []
    for r in rows:
        noise = ref.train_noise(run.cell.config, gen, len(r), run.device)
        out.append((mk.reference_pixels(run.data, "train", r),
                    labels[torch.as_tensor(r, device=run.device)], noise))
    return out


def reference_steps(run: H.Run, tf32: bool = False, half: bool = False,
                    batches=None) -> dict:
    _tf32(tf32)
    try:
        return H.reference(run.cell).train(run.cell.config, run.weights,
                                           batches or first_batches(run),
                                           half)
    finally:
        _tf32(False)


def _norms(tree: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in tree.items()}


def leaf_gaps(prog: dict | None, ref: dict, keep=None) -> dict:
    """{leaf: the gap of its norms against max(the reference's norm of the
    leaf, the median leaf's)}; a missing side reads as 0."""
    r = _norms(ref)
    p = _norms(prog) if prog is not None else {k: 0.0 for k in r}
    keys = [k for k in r if keep is None or k in keep]
    med = statistics.median(r[k] for k in keys)
    return {k: abs(p.get(k, 0.0) - r[k]) / max(r[k], med) for k in keys}


def moved(ref_grad: dict) -> set:
    """The leaves whose reference gradient is at least a thousandth of the
    median leaf's."""
    g = _norms(ref_grad)
    med = statistics.median(g.values())
    return {k for k, v in g.items() if v >= 1e-3 * med}


def leaf_numbers(grad1, params, weights: dict, ref: dict) -> dict:
    """The first gradient's and the five-step change's gaps (median and
    worst leaf) over the leaves of ``weights``."""
    keys = list(weights)

    def own(tree):
        return None if tree is None else {k: tree[k] for k in keys if k in tree}

    delta = (None if params is None else
             {k: params[k] - weights[k] for k in keys})
    ref_delta = {k: ref["params"][k] - weights[k] for k in keys}
    ref_grad1 = own(ref["grad1"])
    g = leaf_gaps(own(grad1), ref_grad1).values()
    d = leaf_gaps(delta, ref_delta, moved(ref_grad1)).values()
    return {"grad1_median_gap": statistics.median(g),
            "grad1_gap": max(g),
            "delta5_median_gap": statistics.median(d),
            "delta5_gap": max(d)}


def step_numbers(prog_losses, grad1, params, weights, ref,
                 modules=("model",)) -> dict:
    """The loss gaps, then ``leaf_numbers`` of each module of ``modules``
    over its own leaves, named with the module's ``prefix``."""
    gaps = [abs(p - r) / abs(r) for p, r in zip(prog_losses, ref["losses"])]
    if len(gaps) < len(ref["losses"]):
        gaps += [math.inf] * (len(ref["losses"]) - len(gaps))
    out = {"loss1_gap": gaps[0], "loss_gap": max(gaps)}
    for m in modules:
        mine = {k: v for k, v in weights.items()
                if H.module_of(k, modules) == m}
        out.update({H.prefix(m) + k: v for k, v in
                    leaf_numbers(grad1, params, mine, ref).items()})
    return out


def reference_validation(run: H.Run, state: dict, gen_state, tf32=False,
                         mig_dtype=torch.float64, half: bool = False):
    """(gMIG, MSE) of the reference's evaluation of the valid split from the
    program's model state and noise generator state. The control computes
    the forward in TF32 and gMIG's distances in float32; ``half`` leaves
    half of each batch out of the MSE and of gMIG (a planted fault)."""
    _tf32(tf32)
    try:
        mk = H.maker(run.cell)
        labels = mk.labels(run.data, "valid")
        x = mk.reference_pixels(run.data, "valid", np.arange(len(labels)))
        gen = torch.Generator(device=run.device)
        gen.set_state(gen_state)
        return H.reference(run.cell).validate(
            run.cell.config, state, x, labels, gen, run.cell.batch_size,
            half, mig_dtype)
    finally:
        _tf32(False)


def program_readings(run: H.Run, history: list) -> dict:
    """Every compared number of a run (see the module's docstring), from
    what the observer took and the loss ``history`` of every epoch."""
    obs = run.observer
    ref = reference_steps(run)
    out = step_numbers([float(v) for v in history[0][:H.CHECK_STEPS]],
                       obs.grad1, obs.params, run.weights, ref, run.modules)
    if run.cell.validate:
        if obs.validation is None:
            out["mig_gap"] = out["mse_gap"] = math.inf
        else:
            state, gen, (mig, mse) = obs.validation
            r_mig, r_mse = reference_validation(run, state, gen)
            out["mig_gap"] = abs(float(mig) - r_mig)
            out["mse_gap"] = abs(float(mse) - r_mse) / abs(r_mse)
    losses = np.concatenate(history)
    out["nonfinite_losses"] = float(np.sum(~np.isfinite(losses)))
    return out


def verdict(readings: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}) of the numbers that the cell
    compares (those its ``limits`` name): correct when every one is finite
    and at most its limit."""
    checks = {k: {"value": readings[k], "limit": v} for k, v in limits.items()}
    ok = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
             for c in checks.values())
    return ok, checks
