"""The six Styled-MNIST styles, batched on the device (counterpart of the
``EXPERIMENT_STYLES`` part of ``clearvae_tpu/ops/corruptions.py``; reference
code/corruption_utils/corruptions.py).

Every style maps a [B, 28, 28] float32 batch in 0..255 to the same shape
and range. ``style_batch`` dispatches per sample by style index, in place of
the JAX package's ``make_style_fn`` + ``vmap``.

Randomness: only zigzag draws (r0 in [0, 27), dr in [-5, 5)). The draws come
from a counter-based 32-bit hash of (dataset seed, sample id), computed with
integer tensor ops on the device: deterministic and independent of batching,
but not the JAX package's threefry bits, so zigzag samples differ from the
JAX ones. The other five styles are deterministic.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.nn import functional as F

from clearvae_torch.ops.image import (affine_warp, center_affine, conv2d_same,
                                      gaussian_filter, line_from_points)

# The 6 styles used by the Styled-MNIST experiments
# (reference run_styledmnist_downstream_expr.py:22-29)
EXPERIMENT_STYLES = (
    ("identity", None),
    ("stripe", None),
    ("zigzag", None),
    ("canny_edges", None),
    ("scale", 5),
    ("brightness", None),
)


def _as01(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float32) / 255.0


def _to255(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(x, 0.0, 1.0) * 255.0


def identity(x, severity=None):
    return x.to(torch.float32)


def stripe(x, severity=None):
    """Invert columns < 7 and >= 21."""
    x = x.to(torch.float32)
    cols = np.arange(x.shape[-1])
    flip = torch.as_tensor((cols < 7) | (cols >= 21), dtype=torch.float32,
                           device=x.device)[None, None, :]
    return flip * (255.0 - x) + (1 - flip) * x


def brightness(x, severity=5):
    """For grayscale input the reference's gray→HSV→(v+c)→gray round-trip is
    exactly clip(x + c)."""
    c = [0.1, 0.2, 0.3, 0.4, 0.5][severity - 1]
    return _to255(_as01(x) + c)


def scale(x, severity=3):
    c = [1 / 0.9, 1 / 0.8, 1 / 0.7, 1 / 0.6, 1 / 0.5][severity - 1]
    return _to255(affine_warp(_as01(x), center_affine(c, 0.0, 0.0, c)))


# ---------------------------------------------------------------------------
# zigzag and its draws
# ---------------------------------------------------------------------------

_M32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for x in [0, 2^32) held in int64, without overflow."""
    lo = (x & 0xFFFF) * c
    hi = (((x >> 16) * c) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _hash32(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit integer mix (lowbias32) on int64 tensors."""
    x = x & _M32
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def zigzag_draws(seed: int, sample_ids: torch.Tensor):
    """(r0 in [0, 27), dr in [-5, 5)) per sample, as int64 tensors."""
    ids = sample_ids.to(torch.int64)
    key = _hash32(_hash32(torch.full_like(ids, seed & _M32) ^ 0x9E3779B9) ^ ids)
    r0 = _hash32(key ^ 0x85EBCA6B) % 27
    dr = _hash32(key ^ 0xC2B2AE35) % 10 - 5
    return r0, dr


def zigzag(x, r0: torch.Tensor, dr: torch.Tensor, severity=None):
    """Zigzag stroke (reference corruptions.py:665-704) with the draws given.

    With c0=2, c1=25 and |r1-r0| <= 5 the reference's endpoint count is
    always 8 (6 zigzag vertices + origin + tail), so the geometry unrolls.
    """
    x = _as01(x)
    dev = x.device
    a = b = 2.0
    c0, c1 = 2.0, 25.0
    r0 = r0.to(device=dev, dtype=torch.float32)
    r1 = r0 + dr.to(device=dev, dtype=torch.float32)
    theta = torch.atan((r1 - r0) / (c1 - c0))
    d = (c1 - c0) / torch.cos(theta)
    zero = torch.zeros_like(d)
    cs, rs = [zero], [zero]
    r_i = 0.0
    for i in range(6):
        r_i = (-1.0) ** i * b
        cs.append(zero + (2 * i + 1) * a)
        rs.append(zero + r_i)
    max_c = (2 * a) * torch.div(d, 2 * a, rounding_mode="floor")
    cs.append(d)
    rs.append(r_i / (2 * (d - max_c)))
    cs, rs = torch.stack(cs, 1), torch.stack(rs, 1)   # [B, 8]
    cos_t, sin_t = torch.cos(theta)[:, None], torch.sin(theta)[:, None]
    cs_rot = cos_t * cs - sin_t * rs + c0
    rs_rot = sin_t * cs + cos_t * rs + r0[:, None]
    for i in range(1, 8):
        x = torch.clamp(x + line_from_points(cs_rot[:, i - 1], rs_rot[:, i - 1],
                                             cs_rot[:, i], rs_rot[:, i]), 0.0, 1.0)
    return x * 255.0


# ---------------------------------------------------------------------------
# canny (reference uses skimage.feature.canny, corruptions.py:719-722)
# ---------------------------------------------------------------------------


def canny_edges(x, severity=None, sigma: float = 1.0, low_threshold: float = 0.1,
                high_threshold: float = 0.2):
    """Canny edges: Gaussian smooth, Sobel, interpolated non-maximum
    suppression, double threshold + hysteresis by h+w iterated dilations
    (skimage defaults: sigma=1, low=0.1, high=0.2)."""
    img = _as01(x)
    _, h, w = img.shape
    # skimage smooths with a boundary mask: blur image and mask, divide
    smoothed = gaussian_filter(img, sigma, mode="constant")
    msum = gaussian_filter(torch.ones_like(img[:1]), sigma, mode="constant")
    smoothed = smoothed / torch.clamp_min(msum, 1e-12)
    eroded = torch.zeros((h, w), dtype=torch.bool, device=img.device)
    eroded[1:-1, 1:-1] = True

    sob = torch.tensor([[1.0, 0.0, -1.0], [2.0, 0.0, -2.0], [1.0, 0.0, -1.0]])
    gx = conv2d_same(smoothed, sob.T, mode="constant") / 4.0
    gy = conv2d_same(smoothed, sob, mode="constant") / 4.0
    mag = torch.hypot(gx, gy)

    # interpolated NMS (skimage _get_local_maxima logic, vectorized)
    ax, ay = gx.abs(), gy.abs()
    pad = F.pad(mag, (1, 1, 1, 1))

    def sl(dr, dc):
        return pad[:, 1 + dr:1 + dr + h, 1 + dc:1 + dc + w]

    same_sign = (gx * gy) >= 0
    is_h = ax >= ay
    wgt = torch.where(is_h, ay / torch.clamp_min(ax, 1e-12),
                      ax / torch.clamp_min(ay, 1e-12))

    def pair(d_main, d_diag):
        return (1 - wgt) * d_main + wgt * d_diag

    diag1 = torch.where(same_sign, sl(1, 1), sl(-1, 1))
    diag2 = torch.where(same_sign, sl(-1, -1), sl(1, -1))
    n1h, n2h = pair(sl(0, 1), diag1), pair(sl(0, -1), diag2)
    diag1v = torch.where(same_sign, sl(1, 1), sl(1, -1))
    diag2v = torch.where(same_sign, sl(-1, -1), sl(-1, 1))
    n1v, n2v = pair(sl(1, 0), diag1v), pair(sl(-1, 0), diag2v)
    n1 = torch.where(is_h, n1h, n1v)
    n2 = torch.where(is_h, n2h, n2v)
    local_max = (mag >= n1) & (mag >= n2) & (mag > 0) & eroded

    weak = local_max & (mag > low_threshold)
    strong = (local_max & (mag > high_threshold)).to(torch.float32)
    # hysteresis: propagate strong labels through weak pixels (8-connected)
    weak_f = weak.to(torch.float32)
    for _ in range(h + w):
        strong = F.max_pool2d(strong[:, None], 3, 1, 1)[:, 0] * weak_f
    return strong * 255.0


# ---------------------------------------------------------------------------
# per-sample dispatch
# ---------------------------------------------------------------------------

STYLE_FNS = {"identity": identity, "stripe": stripe, "zigzag": zigzag,
             "canny_edges": canny_edges, "scale": scale,
             "brightness": brightness}


def style_batch(x: torch.Tensor, style_idx: torch.Tensor,
                sample_ids: torch.Tensor, seed: int,
                styles=EXPERIMENT_STYLES) -> torch.Tensor:
    """Style each sample of a [B, H, W] 0..255 batch by its style index and
    apply the reference's /255 (run_styledmnist_downstream_expr.py:80).
    Zigzag's draws are keyed by (``seed``, sample id)."""
    out = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    for code, (name, severity) in enumerate(styles):
        sel = torch.nonzero(style_idx == code).flatten()
        if sel.numel() == 0:
            continue
        xs = x[sel]
        if name == "zigzag":
            y = zigzag(xs, *zigzag_draws(seed, sample_ids[sel]))
        elif severity is None:
            y = STYLE_FNS[name](xs)
        else:
            y = STYLE_FNS[name](xs, severity)
        out[sel] = y
    return out / 255.0
