"""End-to-end demo: train any model on Styled-MNIST, Colored-MNIST or CelebA
and produce the qualitative artifacts — t-SNE latent plots, feature-swapping
grid, style- and content-interpolation strips (counterpart of
``clearvae_tpu/experiments/demo.py``; reference demo notebooks
code/demo_{clearvae,clearmimvae,cleartcvae,gvae,mlvae}.ipynb and
code/swapping_interpolation.ipynb).

Canonical hyperparameters follow the notebooks (e.g. clearvae: z=16,
τ ∈ {0.3 cosine, 2 cosine}, α ∈ {10, 100}, β=1/8, 31–41 epochs;
swapping_interpolation trains CLEAR with τ=2, α=100). ``fit`` and
``evaluate`` run their captured graphs (the default); the Styled-MNIST
batches are styled on the device (K3 on a card). ``main`` first takes the
single-GPU-process lock and sets fp32 numerics (``utils/lock.py``,
``utils/cache.py``), as the JAX runner takes its lock and cache. Where
sklearn or matplotlib is not installed, the t-SNE plots are not made and
``main`` says so; the grids are written in any case.

Usage:
  python -m clearvae_torch.experiments.demo --model clearvae --epochs 31 \\
      [--dataset styled|colored|celeba] [--data_root_path DIR] \\
      [--device cuda|cpu] [--out DIR]
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from clearvae_torch import resolve_device
from clearvae_torch.data.mnist import get_mnist
from clearvae_torch.data.styled import make_styled_mnist, train_valid_split
from clearvae_torch.train.factories import (get_clearmimvae_trainer,
                                            get_clearvae_trainer,
                                            get_cleartcvae_trainer,
                                            get_hierarchical_vae_trainer)
from clearvae_torch.utils import visual as V


def get_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--model", type=str, default="clearvae",
                   choices=["clearvae", "clearmimvae", "cleartcvae", "gvae",
                            "mlvae", "bvae"])
    p.add_argument("--dataset", type=str, default="styled",
                   choices=["styled", "colored", "celeba"],
                   help="styled = MNIST-C styles; colored = 7-color "
                        "Colored-MNIST (reference expr_output/color-mnist); "
                        "celeba = 64×64 VAE64 on (synthetic-fallback) CelebA "
                        "(reference expr_output/celeba/celeba-swapping.png)")
    p.add_argument("--data_root_path", type=str, default=None)
    p.add_argument("--epochs", type=int, default=31)
    p.add_argument("--n_total", type=int, default=20000)
    p.add_argument("--z_dim", type=int, default=16)
    p.add_argument("--alpha", type=float, default=100.0)
    p.add_argument("--temperature", type=float, default=2.0)
    p.add_argument("--beta", type=float, default=1 / 8)
    p.add_argument("--batch_size", type=int, default=128)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--swap_n", type=int, default=8)
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: cuda)")
    p.add_argument("--out", type=str, default="./expr_output/demo")
    return p.parse_args(argv)


def build_trainer(args):
    """The trainer of ``args.model`` on ``args.dataset``, with the JAX
    demo's factories and hyperparameters, on ``args.device``."""
    in_ch = 3 if args.dataset in ("colored", "celeba") else 1
    arch = "VAE64" if args.dataset == "celeba" else "VAE"
    # CelebA runs use the reference's 64×64 defaults (lr 3e-5,
    # run_celeba_downstream_expr.py:225-234)
    lr = 3e-5 if args.dataset == "celeba" else 5e-4
    common = dict(beta=args.beta, vae_lr=lr, z_dim=args.z_dim,
                  seed=args.seed, in_channel=in_ch, vae_arch=arch,
                  device=args.device)
    if args.model == "clearvae":
        return get_clearvae_trainer(ps=True, alpha=args.alpha,
                                    temperature=args.temperature, **common)
    if args.model == "bvae":
        # β-VAE = CLEAR with the contrastive terms off (alpha=0), the same
        # construction as the MIG sweep zoo (reference run_mig_expr_mnist.py)
        return get_clearvae_trainer(ps=False, alpha=0.0,
                                    temperature=args.temperature, **common)
    if args.model == "clearmimvae":
        return get_clearmimvae_trainer(mi_estimator="CLUBSample", la=3,
                                       mi_estimator_lr=2e-3, alpha=args.alpha,
                                       temperature=args.temperature, **common)
    if args.model == "cleartcvae":
        return get_cleartcvae_trainer(la=1, factor_cls_lr=1e-4,
                                      alpha=args.alpha,
                                      temperature=args.temperature, **common)
    return get_hierarchical_vae_trainer(group_mode=args.model.upper(),
                                        **common)


def get_data(args):
    """(train, valid) of ``args.dataset``: a StyledDataset pair for
    ``styled``, ArrayDataset pairs for ``colored`` and ``celeba``."""
    if args.dataset == "celeba":
        from clearvae_torch.data.celeba import get_celeba
        from clearvae_torch.data.common import train_valid_split_array

        ds = get_celeba(args.data_root_path, n_synthetic=args.n_total,
                        seed=args.seed)
        return train_valid_split_array(ds, seed=args.seed)
    imgs, labels = get_mnist(args.data_root_path, "train",
                             n_synthetic=args.n_total, seed=args.seed)
    if args.dataset == "colored":
        from clearvae_torch.data.colored_mnist import make_colored_mnist
        from clearvae_torch.data.common import train_valid_split_array

        ds = make_colored_mnist(imgs, labels, seed=args.seed)
        return train_valid_split_array(ds, seed=args.seed)
    ds = make_styled_mnist(imgs, labels, seed=args.seed)
    return train_valid_split(ds, seed=args.seed)


def main(argv=None):
    """Train, evaluate and write the artifacts under ``--out``; returns
    {"trainer", "mig", "mse", "x", "y", "s", "z", "sel", "swap",
    "interp": (style grid, content grid), "tsne": (emb_c, emb_s) or None}."""
    from clearvae_torch.utils.cache import enable_compilation_cache
    enable_compilation_cache()  # the GPU lock, and fp32: TF32 off
    args = get_args(argv)
    args.device = resolve_device(args.device)
    os.makedirs(args.out, exist_ok=True)
    train, valid = get_data(args)

    trainer = build_trainer(args)
    trainer.fit(args.epochs, train, valid, batch_size=args.batch_size)
    mig, mse = trainer.evaluate(valid, batch_size=args.batch_size)
    print(f"final gMIG={round(mig, 3)} mse={round(mse, 3)}")

    # qualitative artifacts from a validation batch
    kw = {"device": args.device} if args.dataset == "styled" else {}
    x, y, s = next(valid.batches(256, shuffle=False, **kw))
    model = trainer.model
    decode = V.make_decode_fn(model)
    with torch.no_grad():
        xt = torch.as_tensor(x, device=args.device)
        gen = torch.Generator(device=args.device).manual_seed(1)
        _, _, z = model(xt, train=False, generator=gen)
        mu_c, _, mu_s, _ = model.encode(xt, train=False)
    zh = args.z_dim // 2

    # one example per class for the swap grid (swapping_interpolation.ipynb);
    # datasets with <swap_n classes (CelebA: 4) fill the grid with extras
    sel = [int(np.where(y == c)[0][0]) for c in range(int(np.max(y)) + 1)
           if (y == c).any()]
    sel = (sel + [i for i in range(len(y)) if i not in sel])[: args.swap_n]
    swap = V.feature_swapping_plot(z[sel, :zh], z[sel, zh:], x[sel], decode,
                                   save=f"{args.out}/{args.model}-swapping.png")
    interp = V.interpolation_plot(x, z, decode, z_dim=zh, sample_size=8,
                                  save_prefix=f"{args.out}/{args.model}-interp")
    missing = V.missing_packages("sklearn", "matplotlib")
    tsne = None
    if missing:
        print(f"tsne_plot not run: {' and '.join(missing)} not installed")
    else:
        tsne = V.tsne_plot(mu_c, mu_s, y, s,
                           save_prefix=f"{args.out}/{args.model}-tsne")
    print(f"artifacts under {args.out}/")
    return {"trainer": trainer, "mig": mig, "mse": mse, "x": x, "y": y,
            "s": s, "z": z, "sel": sel, "swap": swap, "interp": interp,
            "tsne": tsne}


if __name__ == "__main__":
    main()
