"""Styled-MNIST data-illustration grids (counterpart of
``clearvae_tpu/experiments/illustrate.py``).

Reproduces the reference's qualitative dataset figures
(code/expr_output/styled-mnist/img/{example-data,illustrate_content,
illustrate_styles}.png, made ad hoc in its notebooks) as a scripted,
reproducible runner:

- ``example-data.png``       8x8 grid of random digits under the experiment
                             style distribution (what the training data looks
                             like);
- ``illustrate_content.png`` one digit per row, rendered under every
                             experiment style (content fixed, style varies);
- ``illustrate_styles.png``  one style per row applied to ten digits
                             (style fixed, content varies).

All styling goes through ``StyledDataset.materialize`` on ``device``
(``cuda`` unless given; K3 for the deterministic styles on a card), so the
pixels are those that the training pipeline feeds the models. As in the
JAX runner, ``main`` takes no device lock.

Usage::

    python -m clearvae_torch.experiments.illustrate [--data_root_path DIR]
        [--n_synthetic N] [--seed S] [--device cuda|cpu] [--out DIR]
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from clearvae_torch import resolve_device
from clearvae_torch.data.mnist import get_mnist
from clearvae_torch.data.styled import (StyledDataset, make_styled_mnist,
                                        random_style_distribution)
from clearvae_torch.ops.corruptions import EXPERIMENT_STYLES
from clearvae_torch.utils.visual import _save, make_grid


def get_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--data_root_path", type=str, default=None)
    p.add_argument("--n_synthetic", type=int, default=4096)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default=None,
                   help="torch device to style on (default: cuda)")
    p.add_argument("--out", type=str, default="./expr_output/styled-mnist/img")
    return p.parse_args(argv)


def _styled(ds: StyledDataset, device) -> np.ndarray:
    """The dataset styled on ``device``, on the host."""
    return ds.materialize(resolve_device(device)).cpu().numpy()


def example_data_grid(images, labels, seed: int, device=None) -> np.ndarray:
    """8x8 random digits under the Dirichlet style distribution the
    downstream experiments train on (reference data_utils.py:14-26)."""
    probs = random_style_distribution(
        [s for s, _ in EXPERIMENT_STYLES], seed=seed)
    ds = make_styled_mnist(images, labels, style_probs=probs, seed=seed)
    sel = np.random.RandomState(seed).choice(len(ds), 64, replace=False)
    return make_grid(_styled(ds, device)[sel], nrow=8)


def content_grid(images, labels, seed: int, device=None) -> np.ndarray:
    """Rows = one exemplar of each digit 0..9; columns = every style."""
    n_styles = len(EXPERIMENT_STYLES)
    rng = np.random.RandomState(seed)
    rows = []
    for digit in range(10):
        cand = np.flatnonzero(labels == digit)
        if len(cand) == 0:  # tiny synthetic sets may miss a class
            continue
        rows.append(rng.choice(cand))
    picks = np.asarray(rows)
    # repeat each picked image once per style; distinct sample ids keep the
    # per-sample style draws independent, like the real pipeline
    imgs = np.repeat(images[picks], n_styles, axis=0)
    lbls = np.repeat(labels[picks], n_styles, axis=0)
    style_idx = np.tile(np.arange(n_styles, dtype=np.int32), len(picks))
    ds = StyledDataset(images=imgs, labels=lbls, style_idx=style_idx,
                       seed=seed)
    return make_grid(_styled(ds, device), nrow=n_styles)


def styles_grid(images, labels, seed: int, n_digits: int = 10,
                device=None) -> np.ndarray:
    """Rows = one experiment style applied to ``n_digits`` digits."""
    n_styles = len(EXPERIMENT_STYLES)
    rng = np.random.RandomState(seed + 1)
    picks = rng.choice(len(images), n_digits, replace=False)
    imgs = np.tile(images[picks], (n_styles, 1, 1))
    lbls = np.tile(labels[picks], n_styles)
    style_idx = np.repeat(np.arange(n_styles, dtype=np.int32), n_digits)
    ds = StyledDataset(images=imgs, labels=lbls, style_idx=style_idx,
                       seed=seed)
    return make_grid(_styled(ds, device), nrow=n_digits)


def main(argv=None):
    """Write the three grids under ``--out``; returns {name: grid}."""
    args = get_args(argv)
    device = resolve_device(args.device)
    os.makedirs(args.out, exist_ok=True)
    images, labels = get_mnist(args.data_root_path, "train",
                               n_synthetic=args.n_synthetic, seed=args.seed)
    images = np.asarray(images, np.float32)
    grids = {}
    for name, fn in [("example-data", example_data_grid),
                     ("illustrate_content", content_grid),
                     ("illustrate_styles", styles_grid)]:
        path = os.path.join(args.out, f"{name}.png")
        grids[name] = fn(images, labels, args.seed, device=device)
        _save(grids[name], path)
        print(f"wrote {path}")
    return grids


if __name__ == "__main__":
    main()
