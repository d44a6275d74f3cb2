"""MIG/ELBO sweep on Styled-MNIST (counterpart of
``clearvae_tpu/experiments/mig_expr.py``; reference
code/run_mig_expr_mnist.py).

Fixed style distribution {identity .15, stripe .2, zigzag .25, canny .1,
scale(5) .1, brightness .2} (reference :20-27), 40k/10k/10k split (:66),
the 8-model zoo with clear-ps / clear-neg / bvae (α=0) (:119-160), β sweep
(default [1/8]; the reference's full sweep is commented out, :28-29).
Writes ``<out>/mig_elbo_s{seed}_a{alpha}_z{z}_t{temp}.csv`` with columns
model,beta,mig,elbo (:185-198). The CSV is written after every (beta,
model) cell and is the resume manifest: the same command again skips the
finished cells.

Usage:
  python -m clearvae_torch.experiments.mig_expr [--data_root_path DIR] \\
      [--n_total N] [--epochs N] [--betas B ...] \\
      [--mig_backend auto|native|numpy|torch] [--device cuda|cpu] [--out DIR]

Without --data_root_path (or when the MNIST idx files are absent) the
synthetic digits are used. The zoo's latent losses are unfused, as in the
JAX zoo. ``main`` first takes the single-GPU-process lock and
sets fp32 numerics (``utils/lock.py``, ``utils/cache.py``), as the JAX
runner takes its lock and cache.
"""

from __future__ import annotations

import argparse

import numpy as np

from clearvae_torch import resolve_device
from clearvae_torch.data.mnist import get_mnist
from clearvae_torch.data.styled import StyledDataset, make_styled_mnist
from clearvae_torch.experiments.common import make_mig_cell, run_mig_sweep
from clearvae_torch.train.factories import (get_clearmimvae_trainer,
                                            get_clearvae_trainer,
                                            get_cleartcvae_trainer,
                                            get_hierarchical_vae_trainer)

STYLE_PROBS = {
    "identity": 0.15, "stripe": 0.2, "zigzag": 0.25, "canny_edges": 0.1,
    "scale": 0.1, "brightness": 0.2,
}
BETAS = [1 / 8]  # full sweep in the reference: [1/32 .. 8]


def get_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--seed", type=int, default=101)
    p.add_argument("--alpha", type=float, default=1e2)
    p.add_argument("--epochs", type=int, default=16)
    p.add_argument("--temperature", type=float, default=0.1)
    p.add_argument("--z_dim", type=int, default=16)
    p.add_argument("--data_root_path", type=str, default=None)
    p.add_argument("--n_total", type=int, default=60000)
    p.add_argument("--batch_size", type=int, default=128)
    p.add_argument("--out", type=str, default="./expr_output/styled-mnist")
    p.add_argument("--betas", type=float, nargs="*", default=None)
    p.add_argument("--mig_backend", type=str, default="auto",
                   choices=["auto", "native", "numpy", "torch"],
                   help="MIG KSG backend: 'native' C++ on the host, 'numpy', "
                        "'torch' on the device; 'auto' is native where its "
                        "library builds, else numpy")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; default cuda")
    return p.parse_args(argv)


def get_data(args):
    """(train, valid, test) StyledDatasets: the 40/10/10 split of
    ``n_total`` images by ``RandomState(seed).permutation``; each split keeps
    its absolute sample ids, so its styling is the full dataset's."""
    imgs, labels = get_mnist(args.data_root_path, "train",
                             n_synthetic=args.n_total, seed=args.seed)
    ds = make_styled_mnist(imgs, labels, style_probs=STYLE_PROBS,
                           seed=args.seed)
    n = len(ds)
    n_tr, n_va = int(n * 40 / 60), int(n * 10 / 60)
    idx = np.random.RandomState(args.seed).permutation(n)

    def sub(sel):
        return StyledDataset(ds.images[sel], ds.labels[sel], ds.style_idx[sel],
                             ds.styles, ds.seed, ds.sample_ids[sel])

    return (sub(idx[:n_tr]), sub(idx[n_tr:n_tr + n_va]),
            sub(idx[n_tr + n_va:]))


def model_zoo(args) -> dict:
    """The eight entries in the JAX order, each ``beta -> trainer`` with the
    reference hyperparameters (run_mig_expr_mnist.py:119-160)."""
    dh = {"vae_lr": 5e-4, "z_dim": args.z_dim, "alpha": args.alpha,
          "temperature": args.temperature, "vae_arch": "VAE",
          "seed": args.seed, "mig_backend": args.mig_backend,
          "device": args.device}
    hier = {"vae_lr": 5e-4, "z_dim": args.z_dim, "seed": args.seed,
            "mig_backend": args.mig_backend, "device": args.device}
    return {
        "clear-ps": lambda beta: get_clearvae_trainer(beta=beta, ps=True, **dh),
        "clear-neg": lambda beta: get_clearvae_trainer(beta=beta, ps=False, **dh),
        "bvae": lambda beta: get_clearvae_trainer(
            beta=beta, ps=False, **{**dh, "alpha": 0}),
        "clear-tc": lambda beta: get_cleartcvae_trainer(
            beta=beta, la=1, factor_cls_lr=1e-4, **dh),
        "clear-mim (L1OutUB)": lambda beta: get_clearmimvae_trainer(
            beta=beta, mi_estimator="L1OutUB", la=3, mi_estimator_lr=2e-3, **dh),
        "clear-mim (CLUB-S)": lambda beta: get_clearmimvae_trainer(
            beta=beta, mi_estimator="CLUBSample", la=3, mi_estimator_lr=2e-3,
            **dh),
        "mlvae": lambda beta: get_hierarchical_vae_trainer(
            beta=beta, group_mode="MLVAE", **hier),
        "gvae": lambda beta: get_hierarchical_vae_trainer(
            beta=beta, group_mode="GVAE", **hier),
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
