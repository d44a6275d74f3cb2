"""Shared experiment plumbing (counterpart of
``clearvae_tpu/experiments/common.py``; reference
run_styledmnist_downstream_expr.py:92-225): the downstream zoo runner and
the β×model MIG/ELBO sweep."""

from __future__ import annotations

import csv
import json
import math
import os

import numpy as np

from clearvae_torch.train.trainers import (DownstreamMLPTrainer,
                                           HierarchicalVAETrainer,
                                           SimpleCNNTrainer)

SWEEP_COLUMNS = ("model", "beta", "mig", "elbo")


def experiment_helper(train_ds, valid_ds, test_ds, vae_trainer, epochs: int,
                      batch_size: int = 128, n_class: int = 10,
                      probe_lr: float = 3e-4, probe_epochs: int | None = None,
                      epochs_per_scan: int = 1, style_on_device: bool = False):
    """Train VAE → freeze → train MLP probe on mu_c → test metrics
    (reference experiment_helper, run_styledmnist_downstream_expr.py:92-127).
    The probe trains for the VAE's number of epochs unless ``probe_epochs``
    says otherwise; ``epochs_per_scan`` goes to the VAE's ``fit`` (blocks
    of that many epochs, validation at block boundaries; ignored when
    styling on the device); ``style_on_device`` carries through the VAE's
    fit, the probe and the test evaluation."""
    vae_trainer.fit(epochs, train_ds, valid_ds, batch_size=batch_size,
                    epochs_per_scan=epochs_per_scan,
                    style_on_device=style_on_device)
    probe = DownstreamMLPTrainer(vae_trainer, n_class=n_class, lr=probe_lr)
    probe.fit(probe_epochs or epochs, train_ds, valid_ds,
              batch_size=batch_size, style_on_device=style_on_device)
    (aupr, auroc), acc = probe.evaluate(test_ds, batch_size=batch_size,
                                        style_on_device=style_on_device)
    return aupr, auroc, acc


def run_model_zoo(models: dict, train_ds, valid_ds, test_ds, epochs: int,
                  batch_size: int = 128, n_class: int = 10,
                  probe_epochs: int | None = None,
                  resume_path: str | None = None,
                  epochs_per_scan: int = 1,
                  style_on_device: bool = False) -> dict:
    """Train every (factory, params) entry and collect the reference's result
    schema: {model: {acc, pr: {overall, stratified}, roc: {...}}}
    (reference run_styledmnist_downstream_expr.py:190-216).

    With ``resume_path`` the results JSON is also a manifest: models already
    in it are skipped, and each finished model is written at once. A
    ``SimpleCNNTrainer`` entry is trained and tested as a classifier; every
    other entry is a VAE judged by the probe. ``epochs_per_scan`` goes to
    every entry's ``fit``, as in ``experiment_helper``."""
    results = {}
    if resume_path and os.path.exists(resume_path):
        with open(resume_path) as f:
            results = json.load(f)
        if results:
            print(f"resuming: {sorted(results)} already done")
    for model_name, (trainer_func, params) in models.items():
        if model_name in results:
            continue
        print(f"\nTraining {model_name}:")
        trainer = trainer_func(**params)
        if isinstance(trainer, SimpleCNNTrainer):
            trainer.fit(epochs, train_ds, valid_ds, batch_size=batch_size,
                        epochs_per_scan=epochs_per_scan,
                        style_on_device=style_on_device)
            (aupr, auroc), acc = trainer.evaluate(
                test_ds, batch_size=batch_size, style_on_device=style_on_device)
        else:
            aupr, auroc, acc = experiment_helper(
                train_ds, valid_ds, test_ds, trainer, epochs,
                batch_size=batch_size, n_class=n_class,
                probe_epochs=probe_epochs, epochs_per_scan=epochs_per_scan,
                style_on_device=style_on_device)
        results[model_name] = {
            "acc": round(float(acc), 3),
            "pr": {"overall": round(float(np.mean(list(aupr.values()))), 3),
                   "stratified": {int(k): v for k, v in aupr.items()}},
            "roc": {"overall": round(float(np.mean(list(auroc.values()))), 3),
                    "stratified": {int(k): v for k, v in auroc.items()}},
        }
        if resume_path:
            save_results(results, resume_path)
    return results


def filter_models(models: dict, names) -> dict:
    """Subset a model zoo by exact or prefix name match (the runners'
    ``--models`` flag; e.g. ``--models baseline clear-mim`` keeps the
    baseline and both MIM variants). ``names`` falsy → unchanged."""
    if not names:
        return models
    keep: set = set()
    for n in names:
        exact = [k for k in models if k == n]
        matched = exact or [k for k in models if k.startswith(n)]
        if not matched:
            raise KeyError(f"unknown model selector {n!r}; "
                           f"available: {sorted(models)}")
        keep.update(matched)
    return {k: v for k, v in models.items() if k in keep}


def make_mig_cell(epochs: int, train, valid, test, batch_size: int):
    """The standard ``evaluate_cell`` of :func:`run_mig_sweep`: fit, then
    (mig, elbo) of ``evaluate`` on the test split. Hierarchical (ML-VAE,
    GVAE) trainers skip the evidence-accuracy pass: the sweep reads only
    mig and elbo."""

    def cell(name, get_trainer, beta):
        trainer = get_trainer(beta)
        trainer.fit(epochs, train, valid, batch_size=batch_size)
        if isinstance(trainer, HierarchicalVAETrainer):
            return trainer.evaluate(test, batch_size=batch_size,
                                    with_evidence_acc=False)
        return trainer.evaluate(test, batch_size=batch_size)

    return cell


def _csv_field(v) -> str:
    """A value as pandas' ``to_csv`` writes it: floats by their shortest
    repr, NaN empty."""
    if isinstance(v, (float, np.floating)):
        return "" if math.isnan(v) else repr(float(v))
    return str(v)


def _read_sweep(fpath: str) -> list[dict]:
    """The rows of a sweep CSV, each float read exactly (empty is NaN)."""
    with open(fpath, newline="") as f:
        return [{"model": r["model"],
                 **{k: float(r[k]) if r[k] else math.nan
                    for k in SWEEP_COLUMNS[1:]}}
                for r in csv.DictReader(f)]


def _write_sweep(rows: list[dict], fpath: str) -> None:
    """The sweep's CSV, written to a temporary file and renamed over the
    old one, so a crash mid-write leaves the resume manifest whole."""
    os.makedirs(os.path.dirname(os.path.abspath(fpath)), exist_ok=True)
    tmp = fpath + ".tmp"
    with open(tmp, "w", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow(SWEEP_COLUMNS)
        w.writerows([_csv_field(r[k]) for k in SWEEP_COLUMNS] for r in rows)
    os.replace(tmp, fpath)


def run_mig_sweep(models: dict, betas, fpath: str, evaluate_cell) -> list[dict]:
    """β×model MIG/ELBO sweep whose CSV (columns model, beta, mig, elbo) is
    both the output and the resume manifest: cells already in it, keyed by
    (model, round(beta, 10)), are skipped, and the CSV is rewritten after
    every new cell (the reference writes once at the end,
    run_mig_expr_mnist.py:163-198). ``evaluate_cell(name, get_trainer,
    beta)`` trains the model and returns ``(mig, elbo)``. Returns the rows.

    The CSV is what the JAX package's pandas version writes, byte for byte,
    except in the rows of a resumed run: pandas' default ``read_csv``
    parser is not round-trip exact, so the JAX sweep writes about a quarter
    of the resumed values back one ulp off. Here they are read exactly, and
    a resumed run rewrites the same bytes."""
    rows, done = [], set()
    if os.path.exists(fpath):
        rows = _read_sweep(fpath)
        done = {(r["model"], round(r["beta"], 10)) for r in rows}
        if rows:
            print(f"resuming: {len(rows)} finished cells in {fpath}")
    for beta in betas:
        print(f"==== BETA {beta} ====")
        for name, get_trainer in models.items():
            if (name, round(float(beta), 10)) in done:
                print(f"---- {name} (cached) ----")
                continue
            print(f"---- {name} ----")
            mig, elbo = evaluate_cell(name, get_trainer, beta)
            rows.append({"model": name, "beta": beta, "mig": mig,
                         "elbo": elbo})
            _write_sweep(rows, fpath)
    _write_sweep(rows, fpath)
    return rows


def save_results(results: dict, fpath: str):
    os.makedirs(os.path.dirname(os.path.abspath(fpath)), exist_ok=True)
    # written to a temporary file and renamed: it is the resume manifest
    tmp = fpath + ".tmp"
    with open(tmp, "w") as f:
        json.dump(results, f, indent=4)
    os.replace(tmp, fpath)
    print(f"wrote {fpath}")
