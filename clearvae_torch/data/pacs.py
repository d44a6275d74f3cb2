"""PACS adapter (counterpart of ``clearvae_tpu/data/pacs.py``): 7 content
classes × 4 domains as styles (reference: code/run_pacs_downstream_expr.py:
48-98 — the HF dataset 'flwrlabs/pacs' loaded from disk, resized to 64, the
domain code as style). ``load_pacs`` imports ``datasets`` and PIL when
called; ``synthetic_pacs`` is the stand-in the runners use without it."""

from __future__ import annotations

import numpy as np

from clearvae_torch.data.common import ArrayDataset, kstyle_train_test_split

DOMAIN_CODE = {"art_painting": 0, "cartoon": 1, "photo": 2, "sketch": 3}


def load_pacs(path: str, image_size: int = 64,
              max_images: int | None = None) -> ArrayDataset:
    """Load an HF datasets save_to_disk dump of flwrlabs/pacs."""
    from datasets import load_from_disk
    from PIL import Image

    dd = load_from_disk(path)
    split = dd["train"] if hasattr(dd, "keys") and "train" in dd else dd
    images, labels, styles = [], [], []
    for ex in split:
        img = ex["image"]
        if not hasattr(img, "resize"):
            img = Image.fromarray(np.asarray(img))
        img = img.convert("RGB").resize((image_size, image_size),
                                        Image.BILINEAR)
        images.append(np.asarray(img, np.float32) / 255.0)
        labels.append(int(ex["label"]))
        d = ex["domain"]
        styles.append(DOMAIN_CODE[d] if isinstance(d, str) else int(d))
        if max_images and len(images) >= max_images:
            break
    return ArrayDataset(np.stack(images), np.asarray(labels, np.int64),
                        np.asarray(styles, np.int64))


def synthetic_pacs(n: int, seed: int = 0, image_size: int = 64) -> ArrayDataset:
    """Discriminative synthetic stand-in (VERDICT r2 item 1): content = 7
    jittered object silhouettes (four of them fine-grained quadrupeds),
    style = the 4 PACS domains as drastic renderings (art / cartoon /
    photo / sketch) so held-out-domain accuracy separates the model zoo
    instead of quantizing into ties."""
    from clearvae_torch.data.synth64 import synthetic_pacs64

    imgs, labels, styles = synthetic_pacs64(n, seed, image_size)
    return ArrayDataset(imgs, labels, styles)


def kpacs_train_test_split(ds: ArrayDataset, k: int, seed: int):
    """classes 0..6, styles 0..3 (reference run_pacs_downstream_expr.py:65-86)."""
    return kstyle_train_test_split(ds, range(7), range(4), k, seed)


def get_pacs(path: str | None, n_synthetic: int = 2048, seed: int = 0,
             max_images: int | None = None) -> ArrayDataset:
    if path is not None:
        try:
            return load_pacs(path, max_images=max_images)
        except Exception:
            pass
    return synthetic_pacs(n_synthetic, seed)
