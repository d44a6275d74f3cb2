"""Image primitives for the Styled-MNIST styles (counterpart of the parts of
``clearvae_tpu/ops/image.py`` that the six experiment styles use).

Batched: images are [B, H, W] tensors and per-sample scalars are [B]
tensors, so one call styles a whole batch on the device. Gaussian filtering
and 'same' convolutions follow scipy/skimage border modes. (Scale's zoom is
K3's interpolation matrix, ``ops/kernels/style.py``.)

Every constant tensor (border indices, filter taps) is made once per
(shape, device) by ``constant`` and kept, so that a styling call copies
nothing from the host once its constants exist: it can run inside a
captured CUDA graph, whose warm-up call makes them.
"""

from __future__ import annotations

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


def _correlate(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """'valid' 2-D cross-correlation of [B, H, W] with one [kh, kw] kernel."""
    return F.conv2d(x[:, None], kernel[None, None])[:, 0]


def conv2d_same(x: torch.Tensor, kernel, mode: str = "reflect_101") -> torch.Tensor:
    """2-D correlation with 'same' output of a [B, H, W] batch. A kernel
    tensor of x's dtype on x's device is used as it is (no copy)."""
    kernel = torch.as_tensor(kernel, dtype=x.dtype, device=x.device)
    kh, kw = kernel.shape
    return _correlate(_pad2d(x, kh // 2, kw // 2, mode), kernel)


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
    k = constant(("gaussian", sigma, truncate), x.device,
                 lambda: gaussian_kernel_1d(sigma, truncate))
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
