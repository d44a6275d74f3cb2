"""Shared experiment plumbing (counterpart of
``clearvae_tpu/experiments/common.py``; reference
run_styledmnist_downstream_expr.py:92-225). The MIG sweep helpers are not
ported yet (ROADMAP Queue 1 item 14)."""

from __future__ import annotations

import json
import os

import numpy as np

from clearvae_torch.train.trainers import DownstreamMLPTrainer, SimpleCNNTrainer


def experiment_helper(train_ds, valid_ds, test_ds, vae_trainer, epochs: int,
                      batch_size: int = 128, n_class: int = 10,
                      probe_lr: float = 3e-4, probe_epochs: int | None = None,
                      style_on_device: bool = False):
    """Train VAE → freeze → train MLP probe on mu_c → test metrics
    (reference experiment_helper, run_styledmnist_downstream_expr.py:92-127).
    The probe trains for the VAE's number of epochs unless ``probe_epochs``
    says otherwise; ``style_on_device`` carries through the VAE's fit, the
    probe and the test evaluation."""
    vae_trainer.fit(epochs, train_ds, valid_ds, batch_size=batch_size,
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
                  style_on_device: bool = False) -> dict:
    """Train every (factory, params) entry and collect the reference's result
    schema: {model: {acc, pr: {overall, stratified}, roc: {...}}}
    (reference run_styledmnist_downstream_expr.py:190-216).

    With ``resume_path`` the results JSON is also a manifest: models already
    in it are skipped, and each finished model is written at once. A
    ``SimpleCNNTrainer`` entry is trained and tested as a classifier; every
    other entry is a VAE judged by the probe."""
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
                        style_on_device=style_on_device)
            (aupr, auroc), acc = trainer.evaluate(
                test_ds, batch_size=batch_size, style_on_device=style_on_device)
        else:
            aupr, auroc, acc = experiment_helper(
                train_ds, valid_ds, test_ds, trainer, epochs,
                batch_size=batch_size, n_class=n_class,
                probe_epochs=probe_epochs, style_on_device=style_on_device)
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


def save_results(results: dict, fpath: str):
    os.makedirs(os.path.dirname(os.path.abspath(fpath)), exist_ok=True)
    # written to a temporary file and renamed: it is the resume manifest
    tmp = fpath + ".tmp"
    with open(tmp, "w") as f:
        json.dump(results, f, indent=4)
    os.replace(tmp, fpath)
    print(f"wrote {fpath}")
