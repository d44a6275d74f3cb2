"""Styled-MNIST train→test style-shift OOD downstream experiment (counterpart
of ``clearvae_tpu/experiments/styledmnist_downstream.py``; reference
code/run_styledmnist_downstream_expr.py).

For k = k_min..k_max, each class gets k random training styles (of 6) and
the complement as test styles; the 7-model zoo {baseline CNN, GVAE, MLVAE,
CLEAR(ps), CLEAR-TC, CLEAR-MIM(L1OutUB), CLEAR-MIM(CLUB-S)} is trained, each
VAE's frozen encoder probed by an MLP on mu_c, and
``<out>/styledmnist-k{k}-{seed}.json`` written with the reference's result
schema. Defaults are the reference's (epochs 41, α=1e2, τ=0.1, β=1/8, z=16,
Adam 5e-4, batch 128; run_styledmnist_downstream_expr.py:36-53,231-238).

Usage:
  python -m clearvae_torch.experiments.styledmnist_downstream \
      [--data_root_path DIR] [--epochs N] [--n_train N] [--k_max K] \
      [--style_on_device] [--models clear] [--device cuda|cpu] [--out DIR]

Without --data_root_path (or when the MNIST idx files are absent) the
synthetic digits are used, so the run needs no download. The zoo's latent
losses are unfused, as in the JAX zoo.
"""

from __future__ import annotations

import argparse

import numpy as np

from clearvae_torch import resolve_device
from clearvae_torch.data.mnist import get_mnist
from clearvae_torch.data.styled import (generate_style_dict,
                                        make_k_styled_mnist, train_valid_split)
from clearvae_torch.experiments.common import (filter_models, run_model_zoo,
                                               save_results)
from clearvae_torch.ops.corruptions import EXPERIMENT_STYLES
from clearvae_torch.train.factories import (get_clearmimvae_trainer,
                                            get_clearvae_trainer,
                                            get_cleartcvae_trainer,
                                            get_cnn_trainer,
                                            get_hierarchical_vae_trainer)

N_STYLES = len(EXPERIMENT_STYLES)


def get_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--data_root_path", type=str, default=None,
                   help="root path of the dataset (idx files); synthetic "
                        "fallback if absent")
    p.add_argument("--epochs", type=int, default=41,
                   help="num epochs; default 41")
    p.add_argument("--alpha", type=float, default=1e2,
                   help="penalty weight for snn; default 1e2")
    p.add_argument("--temperature", type=float, default=0.1,
                   help="temperature for snn; default 0.1")
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--n_train", type=int, default=50000)
    p.add_argument("--n_test", type=int, default=10000)
    p.add_argument("--batch_size", type=int, default=128)
    p.add_argument("--epochs_per_scan", type=int, default=1,
                   help="run this many epochs per block of graph replays "
                        "(validation prints at block boundaries; ignored "
                        "with --style_on_device)")
    p.add_argument("--k_max", type=int, default=N_STYLES - 1)
    p.add_argument("--k_min", type=int, default=1,
                   help="start the k sweep here (e.g. --k_min 5 --k_max 5 "
                        "runs only the headline k=5 point)")
    p.add_argument("--style_on_device", action="store_true",
                   help="style each batch on the device inside the loop "
                        "instead of materializing the styled dataset (same "
                        "pixels; only the raw images stay resident)")
    p.add_argument("--models", type=str, nargs="*", default=None,
                   help="run only these zoo entries (prefix match)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; default cuda")
    p.add_argument("--out", type=str,
                   default="./expr_output/styled-mnist/classification")
    return p.parse_args(argv)


def get_data_splits(data_root_path, k: int, seed: int, n_train: int,
                    n_test: int):
    """Style dict + train/valid/test KStyled datasets
    (reference get_data_splits, run_styledmnist_downstream_expr.py:56-89:
    50k/10k split of the 60k train set, 85/15 train/valid)."""
    rng = np.random.RandomState(seed)
    imgs, labels = get_mnist(data_root_path, "train",
                             n_synthetic=n_train + n_test, seed=seed)
    perm = rng.permutation(len(labels))
    tr_sel = perm[:n_train]
    te_sel = perm[n_train:n_train + n_test]
    style_dict = generate_style_dict(list(range(10)), list(range(N_STYLES)),
                                     k=k, rng=rng)
    train_full = make_k_styled_mnist(imgs[tr_sel], labels[tr_sel], style_dict,
                                     "train", seed=seed)
    test = make_k_styled_mnist(imgs[te_sel], labels[te_sel], style_dict,
                               "test", seed=seed)
    train, valid = train_valid_split(train_full, 0.85, seed=seed)
    return style_dict, train, valid, test


def model_zoo(trainer_kwargs: dict, seed: int) -> dict:
    """The 7-model zoo with the reference hyperparameters
    (run_styledmnist_downstream_expr.py:137-188). ``trainer_kwargs``'s
    ``device`` reaches every entry."""
    common = dict(trainer_kwargs)
    device = {"device": common["device"]} if "device" in common else {}
    return {
        "baseline": (get_cnn_trainer, {"n_class": 10, "seed": seed, **device}),
        "gvae": (get_hierarchical_vae_trainer,
                 {"beta": common["beta"], "vae_lr": 5e-4,
                  "z_dim": common["z_dim"], "group_mode": "GVAE",
                  "seed": seed, **device}),
        "mlvae": (get_hierarchical_vae_trainer,
                  {"beta": common["beta"], "vae_lr": 5e-4,
                   "z_dim": common["z_dim"], "group_mode": "MLVAE",
                   "seed": seed, **device}),
        "clear": (get_clearvae_trainer, {"ps": True, "seed": seed, **common}),
        "clear-tc": (get_cleartcvae_trainer,
                     {"la": 1, "factor_cls_lr": 1e-4, "seed": seed, **common}),
        "clear-mim (L1OutUB)": (get_clearmimvae_trainer,
                                {"mi_estimator": "L1OutUB", "la": 3,
                                 "mi_estimator_lr": 2e-3, "seed": seed,
                                 **common}),
        "clear-mim (CLUB-S)": (get_clearmimvae_trainer,
                               {"mi_estimator": "CLUBSample", "la": 3,
                                "mi_estimator_lr": 2e-3, "seed": seed,
                                **common}),
    }


def experiment(args, k: int, seed: int, trainer_kwargs: dict) -> dict:
    print(f"Experiment: k={k}, seed={seed}")
    _, train, valid, test = get_data_splits(args.data_root_path, k, seed,
                                            args.n_train, args.n_test)
    models = filter_models(model_zoo(trainer_kwargs, seed), args.models)
    fpath = f"{args.out}/styledmnist-k{k}-{seed}.json"
    results = run_model_zoo(models, train, valid, test, args.epochs,
                            batch_size=args.batch_size, n_class=10,
                            resume_path=fpath,
                            epochs_per_scan=args.epochs_per_scan,
                            style_on_device=args.style_on_device)
    save_results(results, fpath)
    return results


def main(argv=None):
    from clearvae_torch.utils.cache import enable_compilation_cache
    enable_compilation_cache()  # the GPU lock, and fp32: TF32 off
    args = get_args(argv)
    device = resolve_device(args.device)
    seed = args.seed if args.seed is not None else int(np.random.randint(0, 1000))
    trainer_kwargs = {
        "beta": 1 / 8, "vae_lr": 5e-4, "z_dim": 16,
        "alpha": args.alpha, "temperature": args.temperature,
        "device": device,
    }
    for k in range(args.k_min, args.k_max + 1):
        experiment(args, k, seed, trainer_kwargs)


if __name__ == "__main__":
    main()
