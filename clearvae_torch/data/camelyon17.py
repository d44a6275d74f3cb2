"""Camelyon17 (WILDS) adapter (counterpart of
``clearvae_tpu/data/camelyon17.py``): tumor/normal content × hospital as
style (reference: code/run_camelyon17_downstream_expr.ipynb cells 4-6 —
WILDS camelyon17, resized to 64, metadata column 0 = hospital id as style).

``load_camelyon17`` reads the WILDS on-disk layout (patches/ +
metadata.csv) directly, importing pandas and PIL when called;
``synthetic_camelyon17`` is the stand-in the runners use without it.
"""

from __future__ import annotations

import os

import numpy as np

from clearvae_torch.data.common import ArrayDataset, kstyle_train_test_split


def load_camelyon17(root: str, image_size: int = 64,
                    max_images: int | None = None) -> ArrayDataset:
    """WILDS camelyon17_v1.0 layout: metadata.csv with columns incl.
    patient/node/x/y/tumor/center; patches under patches/…"""
    import pandas as pd
    from PIL import Image

    for base in (root, os.path.join(root, "camelyon17_v1.0")):
        meta = os.path.join(base, "metadata.csv")
        if os.path.exists(meta):
            break
    else:
        raise FileNotFoundError(f"camelyon17 metadata.csv not found in {root}")

    df = pd.read_csv(meta, index_col=0, dtype={"patient": str})
    images, labels, styles = [], [], []
    for _, row in df.iterrows():
        fname = (f"patches/patient_{row['patient']}_node_{row['node']}/"
                 f"patch_patient_{row['patient']}_node_{row['node']}"
                 f"_x_{row['x_coord']}_y_{row['y_coord']}.png")
        path = os.path.join(base, fname)
        if not os.path.exists(path):
            continue
        img = Image.open(path).convert("RGB").resize(
            (image_size, image_size), Image.BILINEAR)
        images.append(np.asarray(img, np.float32) / 255.0)
        labels.append(int(row["tumor"]))
        styles.append(int(row["center"]))
        if max_images and len(images) >= max_images:
            break
    return ArrayDataset(np.stack(images), np.asarray(labels, np.int64),
                        np.asarray(styles, np.int64))


def synthetic_camelyon17(n: int, seed: int = 0,
                         image_size: int = 64) -> ArrayDataset:
    """Discriminative synthetic stand-in (VERDICT r2 item 1): content =
    histology-like nuclei maps where tumor means *clustered* large nuclei
    (density-matched scattered ones for normal, so global statistics don't
    separate the classes), style = 5 strongly-separated hospital stain
    appearances (hue matrix + darkness + scanner blur)."""
    from clearvae_torch.data.synth64 import synthetic_camelyon64

    imgs, labels, styles = synthetic_camelyon64(n, seed, image_size)
    return ArrayDataset(imgs, labels, styles)


def kcamelyon_train_test_split(ds: ArrayDataset, k: int, seed: int):
    """classes {0,1} × hospitals 0..4."""
    return kstyle_train_test_split(ds, range(2), range(5), k, seed)


def get_camelyon17(root: str | None, n_synthetic: int = 2048, seed: int = 0,
                   max_images: int | None = None) -> ArrayDataset:
    if root is not None:
        try:
            return load_camelyon17(root, max_images=max_images)
        except FileNotFoundError:
            pass
    return synthetic_camelyon17(n_synthetic, seed)
