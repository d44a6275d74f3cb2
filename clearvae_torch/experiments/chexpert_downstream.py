"""CheXpert train→test style-shift OOD downstream experiment (counterpart
of ``clearvae_tpu/experiments/chexpert_downstream.py``).

The reference ships the CheXpert dataset class
(code/src/utils/data_utils.py:130-219) but no runner; this one applies the
CelebA/PACS k-style OOD protocol to it: disease outcome ∈ 4 content classes
× (sex, age-group) ∈ 6 styles; grayscale 64×64, VAE64(in_channel=1), z=64,
β=1/32, Adam 3e-5 (the reference's 64×64 defaults,
run_celeba_downstream_expr.py:225-238). Writes
``<out>/chexpert-k{k}-{seed}.json`` (``-perf`` before ``.json`` with
``--perf_mode``).

Usage:
  python -m clearvae_torch.experiments.chexpert_downstream \\
      [--data_root_path DIR --csv train.csv] [--epochs N] [--k_max K] \\
      [--models clear ...] [--perf_mode] [--device cuda|cpu] [--out DIR]
"""

from __future__ import annotations

import argparse

import numpy as np

from clearvae_torch import resolve_device
from clearvae_torch.data.chexpert import load_chexpert, synthetic_chexpert
from clearvae_torch.data.common import (kstyle_train_test_split,
                                        train_valid_split_array)
from clearvae_torch.experiments.common import (filter_models, run_model_zoo,
                                               save_results)
from clearvae_torch.experiments.downstream64 import model_zoo64


def get_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--data_root_path", type=str, default=None)
    p.add_argument("--csv", type=str, default=None,
                   help="CheXpert train.csv (with --data_root_path)")
    p.add_argument("--disease", type=str, default="Pleural Effusion")
    p.add_argument("--epochs", type=int, default=41)
    p.add_argument("--alpha", type=float, default=1e2)
    p.add_argument("--temperature", type=float, default=0.1)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--vae_lr", type=float, default=3e-5,
                   help="the reference's 64×64 default 3e-5; the synthetic "
                        "campaigns use 1e-4")
    p.add_argument("--models", type=str, nargs="*", default=None,
                   help="run only these zoo entries (prefix match)")
    p.add_argument("--batch_size", type=int, default=128)
    p.add_argument("--epochs_per_scan", type=int, default=1)
    # the campaign protocol's size: resuming into a results directory with
    # another n would pool mismatched dataset sizes
    p.add_argument("--n_synthetic", type=int, default=4096)
    p.add_argument("--max_images", type=int, default=None)
    p.add_argument("--k_max", type=int, default=3)
    p.add_argument("--perf_mode", action="store_true",
                   help="build the VAE entries with bfloat16 conv stacks and "
                        "fused latent heads; results go to a separate "
                        "*-perf.json, not to be pooled with the default's")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; default cuda")
    p.add_argument("--out", type=str,
                   default="./expr_output/chexpert/classification")
    return p.parse_args(argv)


def get_chexpert(data_root, csv, disease, n_synthetic, seed, max_images):
    """The archive with its CSV (read with pandas, imported here) when both
    are given, else the synthetic stand-in."""
    if data_root and csv:
        import pandas as pd

        return load_chexpert(data_root, pd.read_csv(csv), disease,
                             max_images=max_images)
    return synthetic_chexpert(n_synthetic, seed)


def main(argv=None):
    args = get_args(argv)
    device = resolve_device(args.device)
    seed = args.seed if args.seed is not None else int(np.random.randint(0, 1000))
    ds = get_chexpert(args.data_root_path, args.csv, args.disease,
                      args.n_synthetic, seed, args.max_images)
    trainer_kwargs = {"beta": 1 / 32, "vae_lr": args.vae_lr, "z_dim": 64,
                      "alpha": args.alpha, "temperature": args.temperature}
    classes = sorted(np.unique(ds.labels).tolist())
    styles = sorted(np.unique(ds.style_idx).tolist())
    for k in range(1, args.k_max + 1):
        print(f"Experiment: k={k}, seed={seed}")
        train_full, test, _ = kstyle_train_test_split(ds, classes, styles, k,
                                                      seed)
        train, valid = train_valid_split_array(train_full, 0.85, seed)
        models = model_zoo64(len(classes), trainer_kwargs, seed,
                             in_channel=1, perf_mode=args.perf_mode,
                             device=device)
        models = filter_models(models, args.models)
        suffix = "-perf" if args.perf_mode else ""
        fpath = f"{args.out}/chexpert-k{k}-{seed}{suffix}.json"
        results = run_model_zoo(models, train, valid, test, args.epochs,
                                batch_size=args.batch_size,
                                n_class=len(classes), resume_path=fpath,
                                epochs_per_scan=args.epochs_per_scan)
        save_results(results, fpath)


if __name__ == "__main__":
    main()
