"""Camelyon17 (WILDS) hospital-shift OOD downstream experiment (counterpart
of ``clearvae_tpu/experiments/camelyon17_downstream.py``; reference
code/run_camelyon17_downstream_expr.ipynb cells 4-11).

Tumor/normal content × hospital (center) ∈ 5 styles; the zoo adds the
LAM-CNN (lam_coef=0.001). The notebook's hyperparameters: β=1/32, lr 1e-4,
z=64, α=100, τ=0.3 (τ=0.1 for CLEAR-TC), epochs 7 (6 for the CNNs), batch
64, the MLP probe 1 epoch. Writes ``<out>/camelyon17-k{k}-{seed}.json``
(``-perf`` before ``.json`` with ``--perf_mode``), one model at a time: the
JSON is ``run_model_zoo``'s resume manifest.

Usage:
  python -m clearvae_torch.experiments.camelyon17_downstream \\
      [--data_root_path DIR] [--epochs N] [--cnn_epochs N] [--k K] \\
      [--models clear lam-cnn ...] [--perf_mode] [--device cuda|cpu] \\
      [--out DIR]
"""

from __future__ import annotations

import argparse

import numpy as np

from clearvae_torch import resolve_device
from clearvae_torch.data.camelyon17 import (get_camelyon17,
                                            kcamelyon_train_test_split)
from clearvae_torch.data.common import train_valid_split_array
from clearvae_torch.experiments.common import (filter_models, run_model_zoo,
                                               save_results)
from clearvae_torch.experiments.downstream64 import model_zoo64


def get_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--data_root_path", type=str, default=None)
    p.add_argument("--epochs", type=int, default=7)
    p.add_argument("--cnn_epochs", type=int, default=6)
    p.add_argument("--alpha", type=float, default=100.0)
    p.add_argument("--temperature", type=float, default=0.3)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--n_synthetic", type=int, default=2048)
    p.add_argument("--max_images", type=int, default=None)
    p.add_argument("--k", type=int, default=1)
    p.add_argument("--models", type=str, nargs="*", default=None,
                   help="run only these zoo entries (prefix match)")
    p.add_argument("--perf_mode", action="store_true",
                   help="build the VAE entries with bfloat16 conv stacks and "
                        "fused latent heads; results go to a separate "
                        "*-perf.json, not to be pooled with the default's")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; default cuda")
    p.add_argument("--out", type=str,
                   default="./expr_output/camelyon17/classification")
    return p.parse_args(argv)


def main(argv=None):
    args = get_args(argv)
    device = resolve_device(args.device)
    seed = args.seed if args.seed is not None else int(np.random.randint(0, 1000))
    data = get_camelyon17(args.data_root_path, n_synthetic=args.n_synthetic,
                          seed=seed, max_images=args.max_images)
    trainer_kwargs = {"beta": 1 / 32, "vae_lr": 1e-4, "z_dim": 64,
                      "alpha": args.alpha, "temperature": args.temperature}
    print(f"Experiment: k={args.k}, seed={seed}")
    train_full, test, _ = kcamelyon_train_test_split(data, args.k, seed)
    train, valid = train_valid_split_array(train_full, 0.85, seed)
    models = filter_models(
        model_zoo64(2, trainer_kwargs, seed, lam_coef=0.001,
                    tc_temperature=0.1, perf_mode=args.perf_mode,
                    device=device),
        args.models)
    suffix = "-perf" if args.perf_mode else ""
    fpath = f"{args.out}/camelyon17-k{args.k}-{seed}{suffix}.json"
    results = run_model_zoo(models, train, valid, test, args.epochs,
                            batch_size=args.batch_size, n_class=2,
                            probe_epochs=1, resume_path=fpath,
                            cnn_epochs=args.cnn_epochs)
    save_results(results, fpath)


if __name__ == "__main__":
    main()
