"""Styled-MNIST datasets and the k-style OOD protocol (counterpart of
``clearvae_tpu/data/styled.py``; reference code/src/utils/data_utils.py:29-77,
code/expr/expr_utils.py:7-57).

The style of each sample is fixed at construction (numpy draws, bit-equal to
the JAX package's); the styling runs on the device, keyed by (dataset seed,
absolute sample id), so it is reproducible without storage and independent
of chunking: once for the whole dataset in ``materialize``, or per batch
from the raw images of ``device_arrays`` (``style_on_device``). Styled
images are [N, H, W] float32 in [0, 1] (the reference's ToTensor + /255,
run_styledmnist_downstream_expr.py:80).
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Sequence

import numpy as np
import torch
from torch.nn import functional as F

from clearvae_torch import resolve_device
from clearvae_torch.ops import prng as P
from clearvae_torch.ops.corruptions import (EXPERIMENT_STYLES, style_batch,
                                            style_draws)


def batch_indices(n: int, batch_size: int, shuffle: bool, seed: int = 0,
                  drop_last: bool | None = None) -> Iterator[np.ndarray]:
    """The index arrays of the host ``batches`` iterators
    (``clearvae_tpu/data/styled.py:132-155``, ``data/common.py:32-49``): in
    order, or shuffled by ``RandomState(seed)``; ``drop_last`` (default
    ``shuffle``) drops the ragged tail."""
    if drop_last is None:
        drop_last = shuffle
    idx = np.arange(n)
    if shuffle:
        np.random.RandomState(seed).shuffle(idx)
    stop = (n // batch_size) * batch_size if drop_last else n
    for s in range(0, stop, batch_size):
        yield idx[s:s + batch_size]


def random_style_distribution(styles: Sequence[str], seed: int | None = None) -> dict:
    """Dirichlet(10,...) style probabilities (reference data_utils.py:14-26)."""
    rng = np.random.RandomState(seed)
    probs = rng.dirichlet([10] * len(styles))
    return {s: p for s, p in zip(styles, probs)}


def generate_style_dict(classes: Sequence[int], styles: Sequence[int], k: int,
                        rng: np.random.RandomState) -> dict:
    """k random train styles per class, complement as test styles
    (reference expr_utils.py:7-15)."""
    if k < 1 or k >= len(styles):
        raise ValueError("k must be in [1, len(styles) - 1]")
    style_dict = {}
    for c in classes:
        train_styles = rng.choice(styles, k, replace=False)
        test_styles = np.setdiff1d(styles, train_styles)
        style_dict[c] = {"train": train_styles, "test": test_styles}
    return style_dict


@dataclasses.dataclass
class StyledDataset:
    """Raw images ([N, H, W] float32 0..255) + labels + fixed per-sample
    style indices; ``materialize`` styles them on a device."""

    images: np.ndarray
    labels: np.ndarray
    style_idx: np.ndarray
    styles: tuple = EXPERIMENT_STYLES
    seed: int = 0
    sample_ids: np.ndarray | None = None  # absolute ids keying style draws
    _cache: dict = dataclasses.field(default_factory=dict, repr=False)

    def __post_init__(self):
        if self.sample_ids is None:
            self.sample_ids = np.arange(len(self.labels), dtype=np.int32)

    def __len__(self):
        return len(self.labels)

    def device_arrays(self, device):
        """(raw images [N, H, W] float32 0..255, style_idx int64, draws
        [N, 4] int64) on ``device``, made there once: what per-batch
        styling gathers from, with no styled copy resident. The draws
        (``style_draws``) are each sample's key fold_in(key(seed), absolute
        sample id) and zigzag's two draws from it, one threefry pass over
        the dataset's ids; the other random styles draw from the key inside
        the styling call."""
        key = ("raw", str(torch.device(device)))
        if key not in self._cache:
            ids = torch.as_tensor(self.sample_ids, dtype=torch.int64,
                                  device=device)
            self._cache[key] = (
                torch.as_tensor(self.images, dtype=torch.float32, device=device),
                torch.as_tensor(self.style_idx, dtype=torch.int64, device=device),
                style_draws(self.seed, ids))
        return self._cache[key]

    def style(self, raw: torch.Tensor, style_idx: torch.Tensor,
              draws: torch.Tensor) -> torch.Tensor:
        """Style a gathered raw batch with this dataset's styles (the one
        protocol ``materialize`` and every per-batch path share)."""
        return style_batch(raw, style_idx, draws, self.styles)

    def chunked_apply(self, fn, device, device_batch: int = 512) -> torch.Tensor:
        """Run ``fn(raw, style_idx, draws)`` over the dataset in fixed-size
        chunks on ``device``, the last one zero-padded (style 0, draws 0:
        the padded rows are dropped, and no row depends on another),
        and concatenate the unpadded results there. The chunk protocol of
        ``materialize`` and the probe's fused style→encode pass
        (``clearvae_tpu/data/styled.py:101-118``)."""
        arrays = self.device_arrays(device)
        outs = []
        for s in range(0, len(self), device_batch):
            e = min(s + device_batch, len(self))
            pad = device_batch - (e - s)
            chunk = [F.pad(t[s:e], (0, 0) * (t.dim() - 1) + (0, pad))
                     for t in arrays]
            outs.append(fn(*chunk)[: e - s])
        return torch.cat(outs)

    def materialize(self, device, device_batch: int = 512) -> torch.Tensor:
        """The styled dataset, [N, H, W] float32 in [0, 1] on ``device``,
        styled there in chunks once and cached per device. Raises if a
        Poisson draw of shot_noise was cut by its loop cap
        (``prng.check_poisson``)."""
        key = ("styled", str(torch.device(device)))
        if key not in self._cache:
            self._cache[key] = self.chunked_apply(self.style, device,
                                                   device_batch)
            P.check_poisson(device)
        return self._cache[key]

    def batches(self, batch_size: int, *, shuffle: bool, seed: int = 0,
                drop_last: bool | None = None, include_style: bool = True,
                device=None) -> Iterator[tuple]:
        """Yield (x [B, H, W, 1] float32 in [0, 1], label [B], style [B])
        numpy batches of the styled dataset, in ``batch_indices``' order:
        styled once on ``device`` (``cuda`` unless given; K3 on a card) by
        ``materialize``, whose cache later calls reuse, and copied to the
        host once a call."""
        styled = self.materialize(resolve_device(device)).cpu().numpy()
        for sel in batch_indices(len(self), batch_size, shuffle, seed,
                                 drop_last):
            x = styled[sel][..., None]
            if include_style:
                yield x, self.labels[sel], self.style_idx[sel]
            else:
                yield x, self.labels[sel]


def make_styled_mnist(images: np.ndarray, labels: np.ndarray,
                      style_probs: dict[str, float] | None = None,
                      styles: tuple = EXPERIMENT_STYLES,
                      seed: int = 0) -> StyledDataset:
    """Random style per image by categorical draw (reference
    StyledMNISTGenerator, data_utils.py:29-53)."""
    rng = np.random.RandomState(seed)
    names = [n for n, _ in styles]
    if style_probs is None:
        p = np.full(len(names), 1.0 / len(names))
    else:
        p = np.asarray([style_probs[n] for n in names])
        p = p / p.sum()
    style_idx = rng.choice(len(names), size=len(labels), p=p).astype(np.int32)
    return StyledDataset(np.asarray(images, np.float32), labels, style_idx,
                         styles, seed)


def make_k_styled_mnist(images: np.ndarray, labels: np.ndarray,
                        style_dict: dict, split: str,
                        styles: tuple = EXPERIMENT_STYLES,
                        seed: int = 0) -> StyledDataset:
    """Per-class k-style split assignment (reference KStyledMNISTGenerator,
    expr_utils.py:18-36)."""
    rng = np.random.RandomState(seed)
    style_idx = np.empty(len(labels), np.int32)
    for i, y in enumerate(labels):
        style_idx[i] = rng.choice(style_dict[int(y)][split])
    return StyledDataset(np.asarray(images, np.float32), labels, style_idx,
                         styles, seed)


def train_valid_split(ds: StyledDataset, train_frac: float = 0.85,
                      seed: int = 0) -> tuple[StyledDataset, StyledDataset]:
    """85/15 random split (reference run_styledmnist_downstream_expr.py:87-88);
    the halves keep their absolute sample ids, so their styling is
    unchanged."""
    n = len(ds)
    idx = np.arange(n)
    np.random.RandomState(seed).shuffle(idx)
    cut = int(train_frac * n)

    def sub(sel):
        return StyledDataset(ds.images[sel], ds.labels[sel], ds.style_idx[sel],
                             ds.styles, ds.seed, ds.sample_ids[sel])

    return sub(idx[:cut]), sub(idx[cut:])
