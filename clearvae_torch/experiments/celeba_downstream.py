"""CelebA train→test style-shift OOD downstream experiment (counterpart of
``clearvae_tpu/experiments/celeba_downstream.py``; reference
code/run_celeba_downstream_expr.py).

(male, smiling) ∈ 4 content classes × hair color ∈ 4 styles; k = 1..3;
VAE64, z=64, β=1/32, Adam 3e-5, batch 128, epochs 41 (reference :225-238).
Writes ``<out>/celeba-k{k}-{seed}.json`` (``-perf`` before ``.json`` with
``--perf_mode``) with the reference's result schema.

Usage:
  python -m clearvae_torch.experiments.celeba_downstream \\
      [--data_root_path DIR] [--epochs N] [--k_max K] [--n_synthetic N] \\
      [--models clear ...] [--perf_mode] [--device cuda|cpu] [--out DIR]

Without --data_root_path (or when the archive is absent) the synthetic
64×64 stand-in of ``data/synth64.py`` is used. The JAX runner's device lock
and compilation cache have no counterpart in the port yet (ROADMAP item
18), so ``main`` makes neither call.
"""

from __future__ import annotations

import argparse

import numpy as np

from clearvae_torch import resolve_device
from clearvae_torch.data.celeba import get_celeba, kceleba_train_test_split
from clearvae_torch.data.common import train_valid_split_array
from clearvae_torch.experiments.common import (filter_models, run_model_zoo,
                                               save_results)
from clearvae_torch.experiments.downstream64 import model_zoo64


def get_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--data_root_path", type=str, default=None)
    p.add_argument("--epochs", type=int, default=41)
    p.add_argument("--alpha", type=float, default=1e2)
    p.add_argument("--temperature", type=float, default=0.1)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--vae_lr", type=float, default=3e-5,
                   help="VAE Adam lr; the reference's 3e-5 is tuned for the "
                        "~160k-image real archive, the synthetic stand-ins "
                        "need ~1e-4 in 41 epochs")
    p.add_argument("--batch_size", type=int, default=128)
    p.add_argument("--epochs_per_scan", type=int, default=1,
                   help="run this many epochs per block of graph replays "
                        "(validation prints at block boundaries)")
    p.add_argument("--n_synthetic", type=int, default=2048)
    p.add_argument("--max_images", type=int, default=None)
    p.add_argument("--k_max", type=int, default=3)
    p.add_argument("--models", type=str, nargs="*", default=None,
                   help="run only these zoo entries (prefix match)")
    p.add_argument("--perf_mode", action="store_true",
                   help="build the VAE entries with bfloat16 conv stacks and "
                        "fused latent heads; results go to a separate "
                        "*-perf.json, not to be pooled with the default's")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; default cuda")
    p.add_argument("--out", type=str,
                   default="./expr_output/celeba/classification")
    return p.parse_args(argv)


def main(argv=None):
    args = get_args(argv)
    device = resolve_device(args.device)
    seed = args.seed if args.seed is not None else int(np.random.randint(0, 1000))
    celeba = get_celeba(args.data_root_path, n_synthetic=args.n_synthetic,
                        seed=seed, max_images=args.max_images)
    trainer_kwargs = {"beta": 1 / 32, "vae_lr": args.vae_lr, "z_dim": 64,
                      "alpha": args.alpha, "temperature": args.temperature}
    for k in range(1, args.k_max + 1):
        print(f"Experiment: k={k}, seed={seed}")
        train_full, test, _ = kceleba_train_test_split(celeba, k, seed)
        train, valid = train_valid_split_array(train_full, 0.85, seed)
        models = model_zoo64(4, trainer_kwargs, seed,
                             perf_mode=args.perf_mode, device=device)
        models = filter_models(models, args.models)
        suffix = "-perf" if args.perf_mode else ""
        fpath = f"{args.out}/celeba-k{k}-{seed}{suffix}.json"
        results = run_model_zoo(models, train, valid, test, args.epochs,
                                batch_size=args.batch_size, n_class=4,
                                resume_path=fpath,
                                epochs_per_scan=args.epochs_per_scan)
        save_results(results, fpath)


if __name__ == "__main__":
    main()
