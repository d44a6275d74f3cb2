"""Colored-MNIST: grayscale digits tinted into 7 colors as styles
(counterpart of ``clearvae_tpu/data/colored_mnist.py``; reference
code/corruption_utils/corruptions.py:725-742 ``rgb_change`` and the
color-mnist qualitative artifacts under code/expr_output/color-mnist/)."""

from __future__ import annotations

import numpy as np

from clearvae_torch.data.common import ArrayDataset
from clearvae_torch.ops.corruptions import COLOR_DICT

COLOR_NAMES = list(COLOR_DICT.keys())  # red..white, style id = index


def make_colored_mnist(images: np.ndarray, labels: np.ndarray,
                       seed: int = 0,
                       color_probs: np.ndarray | None = None) -> ArrayDataset:
    """Assign each image a random color style and render RGB in [0, 1].

    ``images``: [N, 28, 28] float32 0..255 grayscale.
    """
    rng = np.random.RandomState(seed)
    k = len(COLOR_NAMES)
    p = color_probs if color_probs is not None else np.full(k, 1.0 / k)
    styles = rng.choice(k, size=len(labels), p=p / p.sum())
    x = np.asarray(images, np.float32) / 255.0
    out = np.zeros((len(labels), 28, 28, 3), np.float32)
    for s, name in enumerate(COLOR_NAMES):
        sel = styles == s
        for ch in COLOR_DICT[name]:
            out[sel, :, :, ch] = x[sel]
    return ArrayDataset(out, np.asarray(labels, np.int64),
                        styles.astype(np.int64))
