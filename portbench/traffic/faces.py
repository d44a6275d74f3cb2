"""CelebA-like traffic: 64×64×3 face-like images drawn on the card from the
seed, content = 4 (male, smiling) classes, style = 4 hair colours, as the
CelebA downstream experiment labels them (reference data_utils.py:80-127;
``clearvae_torch/data/celeba.py``).

Parameters (the traffic file): ``n_train``, ``n_classes`` (4), ``n_styles``
(4), ``validate`` (false: the cell trains without a valid split).

Each image: a background of one random colour, an elliptic face of a
random skin tone at a jittered place and size, hair of the style's colour
over its top (longer at the sides when not male), two eyes, a mouth bent
up when smiling and straight otherwise, a darker jaw when male, and a
little pixel noise; values in [0, 1]. The work of a step does not depend on
the pixel values, so a stand-in for the CelebA photographs serves.
"""

from __future__ import annotations

import torch

SIZE = 64
CHUNK = 4096
# black, blond, brown, gray (the order of the CelebA hair attributes)
HAIR = torch.tensor([[0.10, 0.08, 0.06], [0.90, 0.80, 0.50],
                     [0.45, 0.30, 0.15], [0.70, 0.70, 0.72]])


def _ellipse(px, py, cx, cy, rx, ry, soft: float = 1.5):
    """A soft mask in [0, 1] of the ellipse; centres and radii [b, 1, 1]."""
    r = torch.sqrt(((px - cx) / rx) ** 2 + ((py - cy) / ry) ** 2)
    return ((1 - r) * torch.minimum(rx, ry) / soft + 0.5).clamp(0, 1)


def faces(n: int, n_classes: int, n_styles: int, gen: torch.Generator, device):
    """(images [n, 64, 64, 3] float32 in [0, 1], labels [n], styles [n]) on
    ``device``, drawn from ``gen``."""
    labels = torch.randint(0, n_classes, (n,), generator=gen, device=device)
    hair = torch.randint(0, n_styles, (n,), generator=gen, device=device)
    u = torch.rand((n, 12), generator=gen, device=device)
    grid = torch.arange(SIZE, device=device, dtype=torch.float32) + 0.5
    py, px = torch.meshgrid(grid, grid, indexing="ij")
    px, py = px[None], py[None]
    images = torch.empty((n, SIZE, SIZE, 3), device=device)
    colours = HAIR.to(device)
    for s in range(0, n, CHUNK):
        e = min(s + CHUNK, n)
        v = u[s:e, :, None, None]
        male = (labels[s:e] < 2)[:, None, None].float()
        smiling = (labels[s:e] % 2 == 0)[:, None, None].float()
        cx, cy = 32 + 6 * (v[:, 0] - 0.5), 34 + 6 * (v[:, 1] - 0.5)
        rx, ry = 15 + 4 * v[:, 2], 19 + 4 * v[:, 3]
        face = _ellipse(px, py, cx, cy, rx, ry)
        top = _ellipse(px, py, cx, cy - 0.35 * ry, rx * 1.15, ry * 0.75)
        sides = _ellipse(px, py, cx, cy + 0.3 * ry, rx * 1.25, ry * 1.1)
        hair_mask = torch.maximum(top * (py < cy - 0.25 * ry).float(),
                                  (1 - male) * sides * (1 - face))
        eyes = torch.maximum(
            _ellipse(px, py, cx - 0.4 * rx, cy - 0.15 * ry, 0 * rx + 2, 0 * ry + 1.6),
            _ellipse(px, py, cx + 0.4 * rx, cy - 0.15 * ry, 0 * rx + 2, 0 * ry + 1.6))
        mx = (px - cx) / (0.45 * rx)
        mouth_y = cy + 0.45 * ry - smiling * 4 * (1 - mx * mx).clamp_min(0)
        mouth = ((1.2 - (py - mouth_y).abs()).clamp(0, 1)
                 * (mx.abs() < 1).float())
        jaw = male * _ellipse(px, py, cx, cy + 0.55 * ry, rx * 0.8, ry * 0.4)
        skin = torch.stack([0.55 + 0.4 * v[:, 4], 0.4 + 0.35 * v[:, 4],
                            0.3 + 0.3 * v[:, 4]], -1)              # [b,1,1,3]
        bg = torch.stack([v[:, 5], v[:, 6], v[:, 7]], -1)
        img = bg * (1 - face[..., None]) + skin * face[..., None]
        img = img * (1 - 0.35 * jaw[..., None] * face[..., None])
        img = img * (1 - eyes[..., None]) + 0.05 * eyes[..., None]
        img = img * (1 - mouth[..., None]) + torch.tensor(
            [0.6, 0.15, 0.15], device=device) * mouth[..., None]
        hm = hair_mask[..., None]
        img = img * (1 - hm) + colours[hair[s:e]][:, None, None] * hm
        noise = torch.rand((e - s, SIZE, SIZE, 3), generator=gen, device=device)
        images[s:e] = (img + 0.04 * (noise - 0.5)).clamp(0, 1)
    return images, labels, hair


def make(params: dict, seed: int, device) -> dict:
    gen = torch.Generator(device=device).manual_seed(seed)
    images, labels, hair = faces(params["n_train"], params["n_classes"],
                                 params["n_styles"], gen, device)
    return {"params": params, "images": images, "labels": labels,
            "styles": hair}


def program_datasets(data: dict) -> dict:
    """{"train"}: the program's ``ArrayDataset`` of the images."""
    from clearvae_torch.data.common import ArrayDataset

    return {"train": ArrayDataset(data["images"].cpu().numpy(),
                                  data["labels"].cpu().numpy(),
                                  data["styles"].cpu().numpy())}


def labels(data: dict, split: str) -> torch.Tensor:
    return data["labels"]


def reference_pixels(data: dict, split: str, rows) -> torch.Tensor:
    """The images of the rows: they are trained as they are made."""
    idx = torch.as_tensor(rows, device=data["images"].device)
    return data["images"][idx]
