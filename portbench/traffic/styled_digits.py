"""Styled-MNIST traffic: digits drawn on the card from the seed, each given a
style by the k-style protocol of the Styled-MNIST downstream experiment
(reference run_styledmnist_downstream_expr.py:56-89) or uniformly over a
style set, then split 85/15 into train and valid.

Parameters (the traffic file): ``n_images``, ``n_classes``, ``styles``
([name, severity or null] pairs, the program's style set), ``protocol``
(``"k_style"`` with ``k`` train styles a class, or ``"uniform"``),
``train_frac``, ``style_on_device`` (style each batch inside the step, or
once at set-up) and ``validate`` (in-fit validation on the valid split).

The digits are seven-segment glyphs, 14–22 pixels high, tilted by up to
15°, at a random place in the 28×28 frame, with soft strokes 2.6–4 pixels
wide, on the 0..255 scale: MNIST's range and about its share of ink. The
work of a step does not depend on the pixel values, so a stand-in for
MNIST's digits serves; the labels still carry the content.
"""

from __future__ import annotations

import math

import numpy as np
import torch

SIZE = 28
# segments a..g of a glyph in a box 0.6 wide and 1 high, (x0, y0, x1, y1)
SEGMENTS = torch.tensor([[0, 0, .6, 0], [.6, 0, .6, .5], [.6, .5, .6, 1],
                         [0, 1, .6, 1], [0, .5, 0, 1], [0, 0, 0, .5],
                         [0, .5, .6, .5]])
DIGIT_SEGMENTS = ["abcdef", "bc", "abged", "abgcd", "fgbc", "afgcd", "afgedc",
                  "abc", "abcdefg", "abcdfg"]
CHUNK = 8192


def _glyph_mask() -> torch.Tensor:
    mask = torch.zeros(10, 7, dtype=torch.bool)
    for d, segs in enumerate(DIGIT_SEGMENTS):
        for s in segs:
            mask[d, "abcdefg".index(s)] = True
    return mask


def digits(n: int, n_classes: int, gen: torch.Generator, device):
    """(images [n, 28, 28] float32 on 0..255, labels [n] int64) on
    ``device``, drawn from ``gen``."""
    labels = torch.randint(0, n_classes, (n,), generator=gen, device=device)
    u = torch.rand((n, 6), generator=gen, device=device)
    h = 14 + 8 * u[:, 0]
    w = 0.6 * h * (0.8 + 0.4 * u[:, 1])
    theta = (u[:, 2] - 0.5) * math.radians(30)
    half = 0.5 * torch.sqrt(w * w + h * h)
    cx = half + (SIZE - 2 * half) * u[:, 3]
    cy = half + (SIZE - 2 * half) * u[:, 4]
    stroke = 0.8 + 0.7 * u[:, 5]
    seg = SEGMENTS.to(device)
    on = _glyph_mask().to(device)[labels % 10]
    grid = torch.arange(SIZE, device=device, dtype=torch.float32) + 0.5
    py, px = torch.meshgrid(grid, grid, indexing="ij")
    images = torch.empty((n, SIZE, SIZE), device=device)
    for s in range(0, n, CHUNK):
        e = min(s + CHUNK, n)
        c, sn = torch.cos(theta[s:e]), torch.sin(theta[s:e])
        dx = px[None] - cx[s:e, None, None]
        dy = py[None] - cy[s:e, None, None]
        # the pixel in the glyph's frame, in pixels from its top-left corner
        gx = (c[:, None, None] * dx + sn[:, None, None] * dy) / w[s:e, None, None] * 0.6 + 0.3
        gy = (-sn[:, None, None] * dx + c[:, None, None] * dy) / h[s:e, None, None] + 0.5
        p = torch.stack([gx * w[s:e, None, None] / 0.6,
                         gy * h[s:e, None, None]], -1)[:, None]     # [b,1,H,W,2]
        a = seg[None, :, None, None, :2] * torch.stack(
            [w[s:e] / 0.6, h[s:e]], -1)[:, None, None, None]        # [b,7,1,1,2]
        b = seg[None, :, None, None, 2:] * torch.stack(
            [w[s:e] / 0.6, h[s:e]], -1)[:, None, None, None]
        ab = b - a
        t = (((p - a) * ab).sum(-1) / (ab * ab).sum(-1).clamp_min(1e-6)
             ).clamp(0, 1)
        dist = torch.linalg.vector_norm(p - (a + t[..., None] * ab), dim=-1)
        dist = torch.where(on[s:e, :, None, None], dist,
                           torch.full_like(dist, float("inf"))).amin(1)
        images[s:e] = (stroke[s:e, None, None] + 0.5 - dist).clamp(0, 1) * 255
    return images, labels


def make(params: dict, seed: int, device) -> dict:
    """The traffic of ``params`` from ``seed``: raw digits and labels on
    ``device``; per sample its style index and absolute id; the train and
    valid rows; the dataset's styling seed."""
    gen = torch.Generator(device=device).manual_seed(seed)
    n, n_classes = params["n_images"], params["n_classes"]
    images, labels = digits(n, n_classes, gen, device)
    rng = np.random.RandomState(seed % 2 ** 32)
    n_styles = len(params["styles"])
    y = labels.cpu().numpy()
    if params["protocol"] == "k_style":
        train_styles = np.stack([rng.choice(n_styles, params["k"], replace=False)
                                 for _ in range(n_classes)])
        style_idx = train_styles[y, rng.randint(0, params["k"], size=n)]
    else:
        style_idx = rng.randint(0, n_styles, size=n)
    perm = rng.permutation(n)
    cut = int(params["train_frac"] * n)
    return {"params": params, "images": images, "labels": labels,
            "style_idx": style_idx.astype(np.int32),
            "rows": {"train": np.sort(perm[:cut]), "valid": np.sort(perm[cut:])},
            "style_seed": int(seed % 2 ** 31)}


def styles(data: dict) -> tuple:
    return tuple((name, sev) for name, sev in data["params"]["styles"])


def program_datasets(data: dict) -> dict:
    """{"train", "valid"}: the program's ``StyledDataset`` of each split,
    holding the raw digits, labels, style indices and absolute sample ids
    (which key each sample's styling draws)."""
    from clearvae_torch.data.styled import StyledDataset

    images = data["images"].cpu().numpy()
    labels = data["labels"].cpu().numpy()
    return {split: StyledDataset(images[rows], labels[rows],
                                 data["style_idx"][rows], styles(data),
                                 data["style_seed"], rows.astype(np.int32))
            for split, rows in data["rows"].items()}


def labels(data: dict, split: str) -> torch.Tensor:
    rows = torch.as_tensor(data["rows"][split], device=data["labels"].device)
    return data["labels"][rows]


def reference_pixels(data: dict, split: str, rows) -> torch.Tensor:
    """The styled pixels [len(rows), 28, 28, 1] in [0, 1] of a split's rows,
    styled by the reference's copy of the styling code."""
    from portbench.reference.styling import corruptions as RC

    dev = data["images"].device
    ids = torch.as_tensor(data["rows"][split][np.asarray(rows)], device=dev)
    sidx = torch.as_tensor(data["style_idx"], device=dev)[ids].long()
    draws = RC.style_draws(data["style_seed"], ids)
    out = [RC.style_batch(data["images"][ids[s:s + 512]], sidx[s:s + 512],
                          draws[s:s + 512], styles(data))
           for s in range(0, len(ids), 512)]
    return torch.cat(out)[..., None]
