"""CheXpert adapter (counterpart of ``clearvae_tpu/data/chexpert.py``):
disease-outcome content × (sex, age-group) style (reference:
code/src/utils/data_utils.py:130-219 — pad-to-square + resize-64 X-ray
loader; no reference runner uses it). ``load_chexpert`` imports PIL when
called; ``synthetic_chexpert`` is the stand-in the runner uses without
the archive."""

from __future__ import annotations

import numpy as np

from clearvae_torch.data.common import ArrayDataset

CHEXPERT_ATTR2STYLES = {
    (0, 0): 0, (0, 1): 1, (0, 2): 2, (1, 0): 3, (1, 1): 4, (1, 2): 5,
}
CHEXPERT_STYLES2ATTR = {
    0: ("female", "below 45"), 1: ("female", "45-64"), 2: ("female", "65+"),
    3: ("male", "below 45"), 4: ("male", "45-64"), 5: ("male", "65+"),
}
CHEXPERT_OUTCOME = {0: "negative", 1: "postive", 2: "uncertain",
                    3: "not mentioned"}


def generate_chexpert_labels(row, disease_name: str):
    """(outcome, style) from a metadata row (reference data_utils.py:216-219);
    expects Sex ∈ {0,1} and Age already bucketed ∈ {0,1,2}."""
    style = CHEXPERT_ATTR2STYLES[(int(row["Sex"]), int(row["Age"]))]
    return int(row[disease_name]), style


def _pad_to_square(img):
    """Center-pad to square with black (reference data_utils.py:153-164)."""
    from PIL import ImageOps

    w, h = img.size
    if w == h:
        return img
    m = max(w, h)
    left = (m - w) // 2
    top = (m - h) // 2
    return ImageOps.expand(img, (left, top, m - w - left, m - h - top), fill=0)


def load_chexpert(data_root: str, data_file, disease_name: str,
                  image_size: int = 64,
                  max_images: int | None = None) -> ArrayDataset:
    """``data_file``: pandas DataFrame with Path/Sex/Age/<disease> columns
    (reference CheXpert.__getitem__, data_utils.py:166-173)."""
    from PIL import Image

    images, labels, styles = [], [], []
    for _, row in data_file.iterrows():
        outcome, style = generate_chexpert_labels(row, disease_name)
        path = data_root + row["Path"].split("/", 1)[1]
        img = Image.open(path).convert("L")
        img = _pad_to_square(img).resize((image_size, image_size),
                                         Image.BILINEAR)
        images.append(np.asarray(img, np.float32)[..., None] / 255.0)
        labels.append(outcome)
        styles.append(style)
        if max_images and len(images) >= max_images:
            break
    return ArrayDataset(np.stack(images), np.asarray(labels, np.int64),
                        np.asarray(styles, np.int64))


def synthetic_chexpert(n: int, seed: int = 0,
                       image_size: int = 64) -> ArrayDataset:
    """Round-5 discriminative stand-in (synth64.synthetic_chexpert64):
    procedural chest films with radiological content cues and 6 drastic
    (sex, age) acquisition-domain styles, calibrated with the torch-CNN
    proxy (scripts/calibrate_chexpert.py — in-dist content 0.785, style
    1.000, held-one-style-out 0.60-0.70). Replaces the null-ish rounds-2..4
    generator (2.5% global brightness offsets; its campaign is archived
    under expr_output/chexpert/classification_nullgen/). Do NOT pool
    results across the two generators."""
    from clearvae_torch.data.synth64 import synthetic_chexpert64

    imgs, labels, styles = synthetic_chexpert64(n, seed, image_size)
    return ArrayDataset(imgs, labels, styles)
