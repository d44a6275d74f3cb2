"""Frozen copy of the port's ``clearvae_torch/ops/image.py`` for the
benchmark's reference, its imports rewritten to the copies beside it.
The original's description follows.

Image primitives of the corruption library (counterpart of
``clearvae_tpu/ops/image.py``).

Batched: images are [B, H, W] tensors and per-sample scalars are [B]
tensors, so one call styles a whole batch on the device; every reduction
(a map's min and max) is per image. Gaussian filtering and 'same'
convolutions follow scipy/skimage border modes, sampling and warps
skimage's ``warp``. Nothing here reads a tensor on the host.

Every constant tensor (border indices) is made once per (shape, device)
by ``constant`` and kept, and filter taps are host numbers passed as the
kernels' arguments, so that a styling call copies nothing from the host
once its constants exist: it can run inside a captured CUDA graph, whose
warm-up call makes them.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
from torch.nn import functional as F

_CONSTANTS: dict = {}


def constant(key, device, make) -> torch.Tensor:
    """The tensor ``make()`` returns (a numpy array or a CPU tensor), on
    ``device``, made at the first call for (``key``, device) and kept."""
    k = (key, str(torch.device(device)))
    if k not in _CONSTANTS:
        _CONSTANTS[k] = torch.as_tensor(make(), device=device)
    return _CONSTANTS[k]


# scipy/skimage border-mode names mapped to index rules:
#   'nearest'     -> edge replicate            (skimage gaussian default)
#   'reflect'     -> symmetric (edge included) (scipy 'reflect')
#   'reflect_101' -> mirror (edge excluded)    (cv2 BORDER_REFLECT_101)


def _border_idx(n: int, pad: int, mode: str) -> np.ndarray:
    i = np.arange(-pad, n + pad)
    if mode in ("nearest", "edge"):
        return np.clip(i, 0, n - 1)
    if mode == "reflect":  # symmetric, supports pad >= n
        period = 2 * n
        j = np.mod(i, period)
        return np.where(j >= n, period - 1 - j, j)
    if mode == "reflect_101":  # mirror
        if n == 1:
            return np.zeros_like(i)
        period = 2 * (n - 1)
        j = np.mod(i, period)
        return np.where(j >= n, period - j, j)
    raise ValueError(mode)


def _pad2d(x: torch.Tensor, ph: int, pw: int, mode: str) -> torch.Tensor:
    """Pad the last two dims of [..., H, W]."""
    if mode == "constant":
        return F.pad(x, (pw, pw, ph, ph))
    h, w = x.shape[-2:]
    ri = constant(("border", h, ph, mode), x.device,
                  lambda: _border_idx(h, ph, mode))
    ci = constant(("border", w, pw, mode), x.device,
                  lambda: _border_idx(w, pw, mode))
    return x[..., ri, :][..., ci]


def _correlate(x: torch.Tensor, kernel: np.ndarray) -> torch.Tensor:
    """'valid' 2-D cross-correlation of [B, H, W] with one [kh, kw] host
    kernel: a sum over its nonzero taps in row-major order, each tap one
    scaled add of a shifted view. Every pixel's sum is the same at any
    batch size (a convolution library picks its algorithm, and so its order
    of sums, by shape)."""
    kh, kw = kernel.shape
    h, w = x.shape[-2] - kh + 1, x.shape[-1] - kw + 1
    out = None
    for (i, j), t in np.ndenumerate(kernel):
        if t == 0:
            continue
        term = x[..., i:i + h, j:j + w] * float(t)
        out = term if out is None else out + term
    return torch.zeros_like(x[..., :h, :w]) if out is None else out


def conv2d_same(x: torch.Tensor, kernel: np.ndarray,
                mode: str = "reflect_101") -> torch.Tensor:
    """2-D correlation with 'same' output of a [B, H, W] batch and a host
    [kh, kw] kernel."""
    kernel = np.asarray(kernel, np.float32)
    kh, kw = kernel.shape
    return _correlate(_pad2d(x, kh // 2, kw // 2, mode), kernel)


@functools.lru_cache(maxsize=None)
def gaussian_kernel_1d(sigma: float, truncate: float = 4.0) -> np.ndarray:
    """scipy.ndimage-compatible 1-D Gaussian (radius = int(truncate*sigma+0.5))."""
    radius = int(truncate * sigma + 0.5)
    xs = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (xs / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def gaussian_filter(x: torch.Tensor, sigma: float, mode: str = "nearest",
                    truncate: float = 4.0) -> torch.Tensor:
    """Separable Gaussian blur of [B, H, W]: rows first, then columns
    (skimage.filters.gaussian defaults: mode='nearest', truncate=4)."""
    if sigma <= 0:
        return x
    k = gaussian_kernel_1d(sigma, truncate)
    r = k.shape[0] // 2
    xp = _pad2d(x, r, r, mode)
    return _correlate(_correlate(xp, k[:, None]), k[None, :])


def line_from_points(c0, r0, c1, r1, size: int = 28) -> torch.Tensor:
    """Soft anti-aliased line from (c0, r0) to (c1, r1), one per sample:
    the coordinates are [B] float tensors; returns [B, size, size]. A line
    with c1 == c0 is all zeros, as in the reference."""
    c0, r0, c1, r1 = (t.to(torch.float32)[:, None, None] for t in (c0, r0, c1, r1))
    dev = c0.device
    cc = torch.arange(size, dtype=torch.float32, device=dev)[None, None, :]
    rr = torch.arange(size, dtype=torch.float32, device=dev)[None, :, None]
    vertical = c1 == c0
    denom = torch.where(vertical, torch.ones_like(c1), c1 - c0)
    m = (r1 - r0) / denom
    dist = torch.clamp(torch.abs(rr - (m * (cc - c0) + r0)), 0.0,
                       float(np.float32(2.3 - 1e-10)))
    corr = torch.clamp(torch.log(torch.clamp_min(1.0 - dist / 2.3, 1e-30)) + 1.0,
                       0.0, 1.0)
    colmask = (cc >= torch.floor(c0)) & (cc < torch.ceil(c1))
    corr = torch.where(colmask, corr, torch.zeros_like(corr))
    return torch.where(vertical, torch.zeros_like(corr), corr.clamp(0.0, 1.0))


# ---------------------------------------------------------------------------
# sampling / warps
# ---------------------------------------------------------------------------


def bilinear_sample(img: torch.Tensor, rr: torch.Tensor, cc: torch.Tensor,
                    cval: float = 0.0, mode: str = "constant") -> torch.Tensor:
    """Sample each image of a [B, H, W] batch at float coordinates (rr, cc)
    (each [B, h, w], or [h, w] shared by every image) with bilinear
    weights. mode='constant': out-of-bounds corners contribute ``cval``
    (skimage warp order=1 semantics); mode='edge': clamp."""
    b, h, w = img.shape
    rr, cc = torch.broadcast_tensors(rr, cc)
    rr, cc = rr.expand(b, *rr.shape[-2:]), cc.expand(b, *cc.shape[-2:])
    flat = img.reshape(b, h * w)
    r0, c0 = torch.floor(rr), torch.floor(cc)
    dr, dc = rr - r0, cc - c0
    out = torch.zeros_like(rr)
    for ri, ci, wgt in ((r0, c0, (1 - dr) * (1 - dc)),
                        (r0, c0 + 1, (1 - dr) * dc),
                        (r0 + 1, c0, dr * (1 - dc)),
                        (r0 + 1, c0 + 1, dr * dc)):
        ric = torch.clamp(ri, 0, h - 1).long()
        cic = torch.clamp(ci, 0, w - 1).long()
        vals = flat.gather(1, (ric * w + cic).reshape(b, -1)).reshape(rr.shape)
        if mode == "constant":
            inb = (ri >= 0) & (ri <= h - 1) & (ci >= 0) & (ci <= w - 1)
            vals = torch.where(inb, vals, cval)
        out = out + wgt * vals
    return out


def affine_warp(img: torch.Tensor, matrix: torch.Tensor,
                cval: float = 0.0) -> torch.Tensor:
    """skimage ``transform.warp(img, inverse_map=AffineTransform(matrix))``
    per image: ``matrix`` [B, 3, 3] homogeneous on (col, row) coordinates;
    the output pixel at (r, c) samples the input at (col', row') =
    M @ (c, r, 1)."""
    _, h, w = img.shape
    rows = torch.arange(h, dtype=torch.float32, device=img.device)[:, None]
    cols = torch.arange(w, dtype=torch.float32, device=img.device)[None, :]
    m = matrix[:, :2, :, None, None]                # [B, 2, 3, 1, 1]
    src_c = m[:, 0, 0] * cols + m[:, 0, 1] * rows + m[:, 0, 2]
    src_r = m[:, 1, 0] * cols + m[:, 1, 1] * rows + m[:, 1, 2]
    return bilinear_sample(img, src_r, src_c, cval=cval, mode="constant")


def center_affine(a1, a2, b1, b2, center: float = 13.5) -> torch.Tensor:
    """The center-preserving 3×3 (col, row) matrices the reference uses, one
    per sample: each argument a [B] float32 tensor or a number (at least one
    a tensor); the translation keeps the image center fixed
    (reference corruptions.py:569-574)."""
    ref = next(t for t in (a1, a2, b1, b2) if isinstance(t, torch.Tensor))
    a3 = center * (1.0 - a1 - a2)
    b3 = center * (1.0 - b1 - b2)
    zero = torch.zeros_like(ref)
    rows = [[a1, a2, a3], [b1, b2, b3], [0.0, 0.0, 1.0]]
    return torch.stack([torch.stack([zero + v for v in r], -1) for r in rows],
                       -2)


def resize_bilinear(img: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """scipy.ndimage.zoom(order=1)-equivalent bilinear resize of [B, H, W]:
    output index i samples input coordinate i·(in−1)/(out−1), the
    align-corners convention (used by clipped_zoom)."""
    _, h, w = img.shape
    dev = img.device
    ones = torch.ones((out_h, out_w), dtype=torch.float32, device=dev)
    rr = (torch.arange(out_h, dtype=torch.float32, device=dev)[:, None]
          * ((h - 1) / max(out_h - 1, 1))) * ones
    cc = (torch.arange(out_w, dtype=torch.float32, device=dev)[None, :]
          * ((w - 1) / max(out_w - 1, 1))) * ones
    return bilinear_sample(img, rr, cc, mode="edge")


def _area_weights(n_out: int, n_in: int, device) -> torch.Tensor:
    """[n_out, n_in] overlap of output bin i with input pixel j, over the
    bin's width (float32, as the JAX package computes it)."""
    scale = n_in / n_out
    i = torch.arange(n_out, dtype=torch.float32, device=device)[:, None]
    lo, hi = i * scale, (i + 1) * scale
    j = torch.arange(n_in, dtype=torch.float32, device=device)[None, :]
    ov = torch.clamp(torch.minimum(hi, j + 1) - torch.maximum(lo, j), 0.0, 1.0)
    return ov / scale


def resize_area(img: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """PIL BOX-filter resize (area averaging) of [B, H, W], used by
    ``pixelate``."""
    _, h, w = img.shape
    wr = _area_weights(out_h, h, img.device)
    wc = _area_weights(out_w, w, img.device)
    return torch.matmul(torch.matmul(wr, img), wc.T)


def clipped_zoom(img: torch.Tensor, zoom_factor: float) -> torch.Tensor:
    """Center-crop then bilinear zoom back to the original size, per image
    of [B, H, H] (reference corruptions.py:187-199)."""
    h = img.shape[-1]
    ch = int(math.ceil(h / float(zoom_factor)))
    top = (h - ch) // 2
    crop = img[:, top:top + ch, top:top + ch]
    zh = int(round(ch * zoom_factor))
    zoomed = resize_bilinear(crop, zh, zh)
    trim = min(max((zh - h) // 2, 0), zh - h)
    return zoomed[:, trim:trim + h, trim:trim + h]


# ---------------------------------------------------------------------------
# plasma fractal (diamond-square) for fog
# ---------------------------------------------------------------------------


def plasma_fractal(keys, mapsize: int = 256,
                   wibbledecay: float = 3.0) -> torch.Tensor:
    """Diamond-square heightmaps in [0, 1], one [mapsize, mapsize] map per
    key of ``keys`` (a pair of [B] tensors, ``ops/prng.py``), as the JAX
    package draws them: 8 levels for 256, each ``split(key, 4)`` and three
    uniforms; min/max normalised over each whole map
    (reference corruptions.py:131-184)."""
    from portbench.reference.styling import prng as P

    assert mapsize & (mapsize - 1) == 0
    b = keys[0].shape[0]
    maparray = torch.zeros((b, mapsize, mapsize), dtype=torch.float32,
                           device=keys[0].device)
    stepsize = mapsize
    wibble = 100.0
    key = keys

    def wibbled_mean(array, k, wibble):
        u = P.uniform(k, array.shape[1:], -wibble, wibble)
        return array / 4.0 + float(np.float32(wibble)) * u

    while stepsize >= 2:
        key, k1, k2, k3 = P.split(key, 4)
        half = stepsize // 2
        # fillsquares
        corner = maparray[:, 0::stepsize, 0::stepsize]
        sq = corner + torch.roll(corner, -1, 1)
        sq = sq + torch.roll(sq, -1, 2)
        maparray[:, half::stepsize, half::stepsize] = wibbled_mean(sq, k1, wibble)
        # filldiamonds
        dr = maparray[:, half::stepsize, half::stepsize]
        ul = maparray[:, 0::stepsize, 0::stepsize]
        ldr = dr + torch.roll(dr, 1, 1)
        lul = ul + torch.roll(ul, -1, 2)
        maparray[:, 0::stepsize, half::stepsize] = wibbled_mean(ldr + lul, k2,
                                                                wibble)
        tdr = dr + torch.roll(dr, 1, 2)
        tul = ul + torch.roll(ul, -1, 1)
        maparray[:, half::stepsize, 0::stepsize] = wibbled_mean(tdr + tul, k3,
                                                                wibble)
        stepsize //= 2
        wibble /= wibbledecay
    maparray = maparray - maparray.amin((1, 2), keepdim=True)
    return maparray / maparray.amax((1, 2), keepdim=True)


# ---------------------------------------------------------------------------
# colorspace (for saturate; skimage formulas)
# ---------------------------------------------------------------------------


def hsv_to_rgb(h: torch.Tensor, s: torch.Tensor, v: torch.Tensor):
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - f * s)
    t = v * (1.0 - (1.0 - f) * s)
    i = i.to(torch.int32) % 6

    def select(*vals):
        out = vals[-1]
        for j in range(4, -1, -1):
            out = torch.where(i == j, vals[j], out)
        return out

    return (select(v, q, p, p, t, v), select(t, v, v, q, p, p),
            select(p, p, t, v, v, q))


def rgb_to_gray(r: torch.Tensor, g: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """skimage rgb2gray luma weights."""
    return 0.2125 * r + 0.7154 * g + 0.0721 * b
