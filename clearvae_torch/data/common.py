"""Shared dataset container and the k-style subset protocol of the labeled
64×64 sets (CelebA, PACS, Camelyon17, CheXpert): counterpart of
``clearvae_tpu/data/common.py``, generalizing the reference's
``kceleba_train_test_split`` (reference: code/expr/expr_utils.py:60-93)."""

from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np

from clearvae_torch.data.styled import batch_indices, generate_style_dict


@dataclasses.dataclass
class ArrayDataset:
    """Images already in final form: [N, H, W, C] float32 in [0, 1],
    content labels and style labels. The trainers keep ``images`` and
    ``labels`` resident on their device and gather batches by index;
    ``batches`` is the JAX package's host iterator, which the qualitative
    runners and ``encode_dataset`` read, with StyledDataset's interface."""

    images: np.ndarray
    labels: np.ndarray
    style_idx: np.ndarray

    def __len__(self):
        return len(self.labels)

    def subset(self, sel) -> "ArrayDataset":
        return ArrayDataset(self.images[sel], self.labels[sel],
                            self.style_idx[sel])

    def batches(self, batch_size: int, *, shuffle: bool, seed: int = 0,
                drop_last: bool | None = None,
                include_style: bool = True) -> Iterator[tuple]:
        """Yield (x, label, style) numpy batches in ``batch_indices``'
        order."""
        for sel in batch_indices(len(self), batch_size, shuffle, seed,
                                 drop_last):
            if include_style:
                yield self.images[sel], self.labels[sel], self.style_idx[sel]
            else:
                yield self.images[sel], self.labels[sel]


def kstyle_train_test_split(ds: ArrayDataset, classes, styles, k: int,
                            seed: int):
    """Per class, k random train styles and the complement as test styles;
    (train subset, test subset, style dict) by (content, style) membership
    (reference expr_utils.py:76-93)."""
    rng = np.random.RandomState(seed)
    style_dict = generate_style_dict(list(classes), list(styles), k, rng)
    train_mask = np.zeros(len(ds), bool)
    test_mask = np.zeros(len(ds), bool)
    for c in classes:
        in_c = ds.labels == c
        train_mask |= in_c & np.isin(ds.style_idx, style_dict[c]["train"])
        test_mask |= in_c & np.isin(ds.style_idx, style_dict[c]["test"])
    return ds.subset(train_mask), ds.subset(test_mask), style_dict


def train_valid_split_array(ds: ArrayDataset, frac: float = 0.85,
                            seed: int = 0):
    """(first ``frac``, rest) of ``RandomState(seed).permutation``."""
    idx = np.random.RandomState(seed).permutation(len(ds))
    cut = int(frac * len(ds))
    return ds.subset(idx[:cut]), ds.subset(idx[cut:])
