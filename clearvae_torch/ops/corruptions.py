"""The six Styled-MNIST styles, batched on the device (counterpart of the
``EXPERIMENT_STYLES`` part of ``clearvae_tpu/ops/corruptions.py``; reference
code/corruption_utils/corruptions.py).

Every style maps a [B, 28, 28] float32 batch in 0..255 to the same shape
and range. ``style_batch`` dispatches per sample by style index, as the JAX
package's ``make_style_fn`` + ``vmap(lax.switch)`` does: the styles that K3
(the fused deterministic styler, ``ops/kernels/style.py``) expresses go
through it, one call per severity; zigzag and canny are torch ops computed
for the whole batch, their rows selected by ``torch.where``. Nothing in it
depends on the data on the host (no ``nonzero``, no count of rows), and its
constants are made once per device, so a styled step can be captured in a
CUDA graph.

Randomness: only zigzag draws (r0 in [0, 27), dr in [-5, 5)), from the
threefry2x32 key fold_in(key(dataset seed), sample id) exactly as the JAX
package draws them (``ops/prng.py``), so zigzag samples equal the JAX ones.
The other five styles are deterministic.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.nn import functional as F

from clearvae_torch.ops import prng as P
from clearvae_torch.ops.image import (conv2d_same, constant,
                                      gaussian_filter, line_from_points)
from clearvae_torch.ops.kernels.style import (DEFAULT_SEVERITY, STYLE_CODES,
                                              style_batch_kernel)

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


# ---------------------------------------------------------------------------
# zigzag and its draws
# ---------------------------------------------------------------------------


def zigzag_draws(seed: int, sample_ids: torch.Tensor):
    """(r0 in [0, 27), dr in [-5, 5)) per sample, as int64 tensors: the
    draws of the JAX package's zigzag (corruptions.py:511-515) under the key
    fold_in(key(seed), sample id). Eager torch runs this threefry chain as
    ~1,100 small kernels, so a dataset draws once for all its sample ids
    (``StyledDataset.device_arrays``) and batches gather from that."""
    ids = sample_ids.to(torch.int64)
    k1, k2 = P.split(P.fold_in(P.key(seed, ids.shape, ids.device), ids))
    return P.randint(k1, 0, 27), P.randint(k2, -5, 5)


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


_SOBEL = np.array([[1.0, 0.0, -1.0], [2.0, 0.0, -2.0], [1.0, 0.0, -1.0]],
                  np.float32)


def _eroded(h: int, w: int) -> np.ndarray:
    """The boundary mask of canny: every pixel but the outer ring."""
    m = np.zeros((h, w), bool)
    m[1:-1, 1:-1] = True
    return m


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
    eroded = constant(("eroded", h, w), img.device, lambda: _eroded(h, w))
    sob = constant("sobel", img.device, lambda: _SOBEL)
    sob_t = constant("sobel_t", img.device, lambda: _SOBEL.T.copy())
    gx = conv2d_same(smoothed, sob_t, mode="constant") / 4.0
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

# the styles K3 does not express
STYLE_FNS = {"zigzag": zigzag, "canny_edges": canny_edges}


# ---------------------------------------------------------------------------
# Colored-MNIST (reference corruptions.py:725-742)
# ---------------------------------------------------------------------------

COLOR_DICT = {
    "red": [0], "green": [1], "blue": [2], "yellow": [0, 1],
    "cyan": [1, 2], "magenta": [0, 2], "white": [0, 1, 2],
}


def rgb_change(x, color: str) -> torch.Tensor:
    """A grayscale [..., H, W] image (or batch) in 0..255 tinted into
    ``color``: [..., H, W, 3] in 0..255, the channels of ``COLOR_DICT``
    carrying the image and the others zero (``clearvae_tpu/ops/
    corruptions.py:640-645``, one image there)."""
    x = torch.as_tensor(x, dtype=torch.float32) / 255.0
    rgb = torch.zeros((*x.shape, 3), dtype=torch.float32, device=x.device)
    for ch in COLOR_DICT[color]:
        rgb[..., ch] = x
    return rgb * 255.0


def k3_groups(styles=EXPERIMENT_STYLES) -> dict:
    """{severity: [K3 code of each style index, -1 outside the group]} for
    the styles K3 expresses. A severity-dependent style joins the group of
    its resolved severity; the severity-free ones (identity, stripe,
    inverse) join the first group. ``EXPERIMENT_STYLES`` makes one group, so
    one K3 call a batch."""
    resolved = {}   # style index -> (K3 code, severity, None if it has none)
    for i, (name, severity) in enumerate(styles):
        if name in DEFAULT_SEVERITY:
            resolved[i] = (STYLE_CODES[name], severity if severity is not None
                           else DEFAULT_SEVERITY[name])
        elif name in STYLE_CODES:
            resolved[i] = (STYLE_CODES[name], None)
    sevs = list(dict.fromkeys(s for _, s in resolved.values() if s is not None))
    groups = {s: [-1] * len(styles) for s in sevs or [5]}
    for i, (code, s) in resolved.items():
        groups[next(iter(groups)) if s is None else s][i] = code
    return groups if resolved else {}


_K3_PLANS: dict = {}


def _k3_plan(styles, device):
    """(style indices K3 takes, [(severity, K3 code of each style index as
    an int32 tensor on ``device``)]), made once per (styles, device)."""
    key = (tuple(styles), str(device))
    if key not in _K3_PLANS:
        groups = k3_groups(styles)
        _K3_PLANS[key] = (
            {i for lut in groups.values() for i, c in enumerate(lut) if c >= 0},
            [(sev, torch.tensor(lut, dtype=torch.int32, device=device))
             for sev, lut in groups.items()])
    return _K3_PLANS[key]


def style_batch(x: torch.Tensor, style_idx: torch.Tensor, draws: torch.Tensor,
                styles=EXPERIMENT_STYLES) -> torch.Tensor:
    """Style each sample of a [B, H, W] 0..255 batch by its style index and
    apply the reference's /255 (run_styledmnist_downstream_expr.py:80).

    The samples whose style K3 expresses go through ``style_batch_kernel``,
    one call per severity group over the whole batch, writing their rows of
    the output in place (code -1 marks the other rows, which K3 leaves); a
    CUDA batch launches the kernel or raises. Zigzag and canny are torch ops
    over the whole batch, each style's rows taken by ``torch.where``, as the
    JAX package's ``vmap(lax.switch)`` computes every branch and selects:
    each style acts on each image on its own, so a row's pixels do not
    depend on the rest of the batch. ``draws`` [B, 2] holds each sample's
    zigzag draws (r0, dr), from ``zigzag_draws``."""
    x = x.to(torch.float32).contiguous()
    out = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    routed, luts = _k3_plan(styles, x.device)
    for severity, lut in luts:
        style_batch_kernel(x, lut[style_idx.long()], severity, out=out)
    for code, (name, severity) in enumerate(styles):
        if code in routed:
            continue
        if name == "zigzag":
            styled = zigzag(x, *draws.unbind(1))
        else:
            styled = STYLE_FNS[name](x, severity)
        out = torch.where((style_idx == code)[:, None, None], styled, out)
    return out / 255.0
