"""MNIST ingestion (a copy of ``clearvae_tpu/data/mnist.py``: plain numpy,
bit-equal outputs, kept here so this package never imports the JAX one).

The reference pulls MNIST via torchvision with download=True
(reference: run_styledmnist_downstream_expr.py:72). Without a network the
loader supports:
  - reading the standard idx files (optionally gzipped) from a local root,
  - a deterministic synthetic fallback (:func:`synthetic_mnist`) that renders
    digit glyphs with PIL and random affine jitter — class-informative images
    so classifiers/MIG have real signal in tests and benchmarks.
"""

from __future__ import annotations

import gzip
import os
import struct

import numpy as np

_FILES = {
    "train": ("train-images-idx3-ubyte", "train-labels-idx1-ubyte"),
    "test": ("t10k-images-idx3-ubyte", "t10k-labels-idx1-ubyte"),
}


def _open_maybe_gz(path: str):
    if os.path.exists(path + ".gz"):
        return gzip.open(path + ".gz", "rb")
    return open(path, "rb")


def load_mnist(root: str, split: str = "train"):
    """Read idx files from ``root`` (searched also under root/MNIST/raw)."""
    img_name, lbl_name = _FILES[split]
    for base in (root, os.path.join(root, "MNIST", "raw")):
        ipath = os.path.join(base, img_name)
        if os.path.exists(ipath) or os.path.exists(ipath + ".gz"):
            with _open_maybe_gz(ipath) as f:
                magic, n, rows, cols = struct.unpack(">IIII", f.read(16))
                assert magic == 2051
                images = np.frombuffer(f.read(), np.uint8).reshape(n, rows, cols)
            with _open_maybe_gz(os.path.join(base, lbl_name)) as f:
                magic, n = struct.unpack(">II", f.read(8))
                assert magic == 2049
                labels = np.frombuffer(f.read(), np.uint8)
            return images.copy(), labels.astype(np.int64)
    raise FileNotFoundError(
        f"MNIST idx files not found under {root!r}; "
        "use synthetic_mnist() when no dataset is available")


def synthetic_mnist(n: int, seed: int = 0, image_size: int = 28):
    """Render ``n`` digit glyphs with PIL's bitmap font + random jitter.

    Deterministic in ``seed``. Returns (images [n, 28, 28] float32 in 0..255,
    labels [n] int64).
    """
    from PIL import Image, ImageDraw

    rng = np.random.RandomState(seed)
    labels = rng.randint(0, 10, size=n).astype(np.int64)
    images = np.zeros((n, image_size, image_size), np.float32)

    # render each glyph once at its natural bitmap size, crop to the ink
    glyphs = {}
    for d in range(10):
        tile = Image.new("L", (16, 16), 0)
        ImageDraw.Draw(tile).text((2, 2), str(d), fill=255)
        bbox = tile.getbbox()
        glyphs[d] = tile.crop(bbox)

    for i in range(n):
        g = glyphs[int(labels[i])]
        # MNIST-like: digit fills ~14-22 px of the 28 px box
        target_h = int(rng.uniform(14, 22))
        target_w = max(6, int(g.width * target_h / g.height))
        big = g.resize((target_w * 4, target_h * 4), Image.BILINEAR)
        big = big.rotate(rng.uniform(-15, 15), resample=Image.BILINEAR,
                         expand=True, fillcolor=0)
        digit = big.resize((max(1, big.width // 4), max(1, big.height // 4)),
                           Image.BILINEAR)
        canvas = Image.new("L", (image_size, image_size), 0)
        max_x = image_size - digit.width
        max_y = image_size - digit.height
        canvas.paste(digit, (rng.randint(0, max(1, max_x + 1)),
                             rng.randint(0, max(1, max_y + 1))))
        images[i] = np.clip(np.asarray(canvas, np.float32) * 1.6, 0, 255)
    return images, labels


def get_mnist(root: str | None, split: str = "train", n_synthetic: int = 4096,
              seed: int = 0):
    """Load real MNIST if available, else the synthetic fallback."""
    if root is not None:
        try:
            imgs, labels = load_mnist(root, split)
            return imgs.astype(np.float32), labels
        except FileNotFoundError:
            pass
    return synthetic_mnist(n_synthetic, seed=seed + (0 if split == "train" else 1))
