"""MIG/ELBO sweep on CelebA (counterpart of
``clearvae_tpu/experiments/mig_expr_celeba.py``; reference
code/run_mig_expr_celeba.py).

Hair color is the style; an 80/10/10 split of the filtered CelebA; the
zoo of 8 models on VAE64 (lr 3e-5, z 16 by default, α 1e2, τ 0.1, epochs
16, batch 128; reference :95-155). Writes
``<out>/mig_elbo_s{seed}_a{alpha}_z{z}_t{temp}.csv`` (model, beta, mig,
elbo), after every (beta, model) cell: the resume manifest, as in
``mig_expr``.

Usage:
  python -m clearvae_torch.experiments.mig_expr_celeba \\
      [--data_root_path DIR] [--n_synthetic N] [--epochs N] [--betas B ...] \\
      [--mig_backend auto|native|numpy|torch] [--device cuda|cpu] [--out DIR]

Without --data_root_path (or when the archive is absent) the synthetic
64×64 stand-in is used. The zoo's latent losses are unfused, as in the JAX
zoo.
"""

from __future__ import annotations

import argparse

import numpy as np

from clearvae_torch import resolve_device
from clearvae_torch.data.celeba import get_celeba
from clearvae_torch.experiments.common import make_mig_cell, run_mig_sweep
from clearvae_torch.train.factories import (get_clearmimvae_trainer,
                                            get_clearvae_trainer,
                                            get_cleartcvae_trainer,
                                            get_hierarchical_vae_trainer)

BETAS = [1 / 8]  # full sweep in the reference: [1/32 .. 8]


def get_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--data_root_path", type=str, default=None)
    p.add_argument("--seed", type=int, default=101)
    p.add_argument("--alpha", type=float, default=1e2)
    p.add_argument("--epochs", type=int, default=16)
    p.add_argument("--temperature", type=float, default=0.1)
    p.add_argument("--z_dim", type=int, default=16)
    p.add_argument("--n_synthetic", type=int, default=2048)
    p.add_argument("--max_images", type=int, default=None)
    p.add_argument("--batch_size", type=int, default=128)
    p.add_argument("--betas", type=float, nargs="*", default=None)
    p.add_argument("--mig_backend", type=str, default="auto",
                   choices=["auto", "native", "numpy", "torch"],
                   help="MIG KSG backend: 'native' C++ on the host, 'numpy', "
                        "'torch' on the device; 'auto' is native where its "
                        "library builds, else numpy")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; default cuda")
    p.add_argument("--out", type=str, default="./expr_output/celeba")
    return p.parse_args(argv)


def get_data(args):
    """(train, valid, test): the 80/10/10 split of the CelebA set by
    ``RandomState(seed).permutation``."""
    ds = get_celeba(args.data_root_path, n_synthetic=args.n_synthetic,
                    seed=args.seed, max_images=args.max_images)
    idx = np.random.RandomState(args.seed).permutation(len(ds))
    n8, n1 = int(len(ds) * 0.8), int(len(ds) * 0.1)
    return (ds.subset(idx[:n8]), ds.subset(idx[n8:n8 + n1]),
            ds.subset(idx[n8 + n1:]))


def model_zoo(args) -> dict:
    """The eight entries in the JAX order, each ``beta -> trainer`` with the
    reference hyperparameters (run_mig_expr_celeba.py:95-155)."""
    dh = {"vae_lr": 3e-5, "z_dim": args.z_dim, "alpha": args.alpha,
          "temperature": args.temperature, "vae_arch": "VAE64",
          "in_channel": 3, "seed": args.seed,
          "mig_backend": args.mig_backend, "device": args.device}
    hier = {"vae_lr": 3e-5, "z_dim": args.z_dim, "vae_arch": "VAE64",
            "in_channel": 3, "n_classes": 4, "seed": args.seed,
            "mig_backend": args.mig_backend, "device": args.device}
    return {
        "clear-ps": lambda b: get_clearvae_trainer(beta=b, ps=True, **dh),
        "clear-neg": lambda b: get_clearvae_trainer(beta=b, ps=False, **dh),
        "bvae": lambda b: get_clearvae_trainer(beta=b, ps=False,
                                               **{**dh, "alpha": 0}),
        "clear-tc": lambda b: get_cleartcvae_trainer(
            beta=b, la=1, factor_cls_lr=1e-4, **dh),
        "clear-mim (L1OutUB)": lambda b: get_clearmimvae_trainer(
            beta=b, mi_estimator="L1OutUB", la=3, mi_estimator_lr=2e-3, **dh),
        "clear-mim (CLUB-S)": lambda b: get_clearmimvae_trainer(
            beta=b, mi_estimator="CLUBSample", la=3, mi_estimator_lr=2e-3,
            **dh),
        "mlvae": lambda b: get_hierarchical_vae_trainer(
            beta=b, group_mode="MLVAE", **hier),
        "gvae": lambda b: get_hierarchical_vae_trainer(
            beta=b, group_mode="GVAE", **hier),
    }


def sweep_path(args) -> str:
    return (f"{args.out}/mig_elbo_s{args.seed}_a{args.alpha}"
            f"_z{args.z_dim}_t{args.temperature}.csv")


def main(argv=None):
    from clearvae_torch.utils.cache import enable_compilation_cache
    enable_compilation_cache()  # the GPU lock, and fp32: TF32 off
    args = get_args(argv)
    args.device = resolve_device(args.device)
    train, valid, test = get_data(args)
    fpath = sweep_path(args)
    cell = make_mig_cell(args.epochs, train, valid, test, args.batch_size)
    rows = run_mig_sweep(model_zoo(args), args.betas or BETAS, fpath, cell)
    print(f"wrote {fpath}")
    return rows


if __name__ == "__main__":
    main()
