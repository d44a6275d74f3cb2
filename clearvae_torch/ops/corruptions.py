"""The MNIST-C corruption library, batched on the device (counterpart of
``clearvae_tpu/ops/corruptions.py``; reference
code/corruption_utils/corruptions.py).

Every corruption maps a [B, 28, 28] float32 batch in 0..255 to the same
shape and range: ``fn(x, keys, severity)``, where ``keys`` is a pair of [B]
threefry key tensors (``ops/prng.py``), one per image, and the deterministic
styles ignore it. Each row is what the JAX function computes for that image
under that image's key: every draw is ``jax.random``'s, and every reduction
(fog's max, frost's and the plasma map's min and max, pessimal noise's norm)
is over the row's own pixels, so a row does not depend on the rest of the
batch. Nothing reads a tensor on the host, and constants are made once per
device, so styling can be captured in a CUDA graph.

``style_batch`` dispatches per sample by style index, as the JAX package's
``make_style_fn`` + ``vmap(lax.switch)`` does: the styles that K3 (the fused
deterministic styler, ``ops/kernels/style.py``) expresses go through it, one
call per severity; every other style is computed for the whole batch and its
rows selected by ``torch.where``. Each sample's draws come from the
threefry key fold_in(key(dataset seed), sample id), exactly as the JAX
package keys them; zigzag's two draws are made once per dataset, the other
styles draw from the key inside the styling call.
"""

from __future__ import annotations

import functools
import math
import os

import numpy as np
import torch
from torch.nn import functional as F

from clearvae_torch.ops import prng as P
from clearvae_torch.ops.image import (affine_warp, bilinear_sample,
                                      center_affine, clipped_zoom, constant,
                                      conv2d_same, gaussian_filter,
                                      hsv_to_rgb, line_from_points,
                                      plasma_fractal, resize_area,
                                      rgb_to_gray)
from clearvae_torch.ops.kernels.glass import glass_swaps
from clearvae_torch.ops.kernels.style import (DEFAULT_SEVERITY, STYLE_CODES,
                                              style_batch_kernel)

# Names in reference order (corruptions.py:40-92)
CORRUPTIONS = [
    "identity", "shot_noise", "impulse_noise", "glass_blur", "motion_blur",
    "shear", "scale", "rotate", "brightness", "translate", "stripe", "fog",
    "spatter", "dotted_line", "zigzag", "canny_edges",
]

ALL_CORRUPTIONS = [
    "identity", "gaussian_noise", "shot_noise", "impulse_noise",
    "speckle_noise", "pessimal_noise", "gaussian_blur", "glass_blur",
    "defocus_blur", "motion_blur", "zoom_blur", "fog", "frost", "snow",
    "spatter", "contrast", "brightness", "saturate", "jpeg_compression",
    "pixelate", "elastic_transform", "quantize", "shear", "rotate", "scale",
    "translate", "line", "dotted_line", "zigzag", "inverse", "stripe",
    "canny_edges",
]

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

_ASSET_DIR = os.path.join(os.path.dirname(__file__), "..", "data_assets")


def _pessimal_matrix() -> np.ndarray:
    return np.load(os.path.join(_ASSET_DIR, "pessimal_noise_matrix.npy")
                   ).astype(np.float32)


def _as01(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float32) / 255.0


def _to255(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(x, 0.0, 1.0) * 255.0


# ---------------------------------------------------------------------------
# noises
# ---------------------------------------------------------------------------


def gaussian_noise(x, keys, severity=5):
    c = [0.08, 0.12, 0.18, 0.26, 0.38][severity - 1]
    x = _as01(x)
    return _to255(x + P.normal(keys, x.shape[1:]) * c)


def shot_noise(x, keys, severity=5):
    """Poisson counts at rate x·c, over c. Severities 4 and 5 (c = 5, 3)
    take only Knuth's method; 1 to 3 also Hormann's rejection, whose
    acceptance reads lgamma (``prng.poisson``)."""
    c = [60, 25, 12, 5, 3][severity - 1]
    x = _as01(x)
    return _to255(P.poisson(keys, x * c, float(c)).to(torch.float32) / float(c))


def impulse_noise(x, keys, severity=4):
    """Salt & pepper on fraction c of pixels (sk.util.random_noise 's&p')."""
    c = [0.03, 0.06, 0.09, 0.17, 0.27][severity - 1]
    x = _as01(x)
    u = P.uniform(keys, x.shape[1:])
    x = torch.where(u < c / 2, 1.0, x)                     # salt
    x = torch.where((u >= c / 2) & (u < c), 0.0, x)        # pepper
    return _to255(x)


def speckle_noise(x, keys, severity=5):
    c = [0.15, 0.2, 0.35, 0.45, 0.6][severity - 1]
    x = _as01(x)
    return _to255(x + x * P.normal(keys, x.shape[1:]) * c)


def pessimal_noise(x, keys, severity=1):
    """Adversarially-correlated tiled noise (reference corruptions.py:266-273),
    each row's noise normalised by its own norm."""
    c = 10.63
    x = _as01(x)
    mat = constant("pessimal", x.device, _pessimal_matrix)
    draw = P.normal(keys, (196,))
    # one [1, 196] @ [196, 196] product a row: the same sums at any B
    noise = torch.bmm(draw[:, None, :], mat.expand(draw.shape[0], -1, -1))[:, 0]
    scaled = noise / torch.linalg.vector_norm(noise, dim=1, keepdim=True) * c / 4.0
    return _to255(x + scaled.reshape(-1, 14, 14).repeat(1, 2, 2))


# ---------------------------------------------------------------------------
# blurs
# ---------------------------------------------------------------------------


def gaussian_blur(x, keys=None, severity=2):
    c = [1, 2, 3, 4, 6][severity - 1]
    return _to255(gaussian_filter(_as01(x), float(c)))


def _glass_swap_coords(max_delta: int, iterations: int, size: int = 28):
    coords = []
    for _ in range(iterations):
        for h in range(size - max_delta, max_delta, -1):
            for w in range(size - max_delta, max_delta, -1):
                coords.append((h, w))
    return np.asarray(coords, np.int64)


def glass_blur(x, keys, severity=1):
    """Gaussian blur + local random pixel swaps + blur (reference
    corruptions.py:284-301). The swaps run in the reference's raster order,
    one step per coordinate (1,352 at severity 1), sequential as JAX's
    lax.scan: ``glass_swaps``, one K5 launch for the batch on a card."""
    sigma, max_delta, iterations = \
        [(0.7, 1, 2), (0.9, 2, 1), (1, 2, 3), (1.1, 3, 2), (1.5, 4, 2)][severity - 1]
    x = gaussian_filter(_as01(x), float(sigma))
    b, h, w = x.shape
    # the reference's uint8 round trip truncates
    img = torch.floor(torch.clamp(x * 255.0, 0, 255)).contiguous()
    coords = _glass_swap_coords(max_delta, iterations, h)
    n = len(coords)
    k1, k2 = P.split(keys)
    do_swap = P.bernoulli(k1, 0.5, (n,))
    deltas = P.randint(k2, -max_delta, max_delta, (n, 2))   # (dx, dy)
    base = constant(("glass", max_delta, iterations, h), x.device,
                    lambda: coords[:, 0] * w + coords[:, 1])
    glass_swaps(img, deltas, do_swap, base)
    return _to255(gaussian_filter(img / 255.0, float(sigma)))


def _cv2_gaussian_blur(img: np.ndarray, ksize: int, sigma: float) -> np.ndarray:
    """``cv2.GaussianBlur(img, (ksize, ksize), sigma)`` of a float32 image:
    cv2's Gaussian taps (exp(-x²/2σ²) over x = -(k-1)/2..(k-1)/2, summed to
    one, as float32) along rows, then columns, border BORDER_REFLECT_101."""
    xs = np.arange(ksize) - (ksize - 1) / 2.0
    taps = np.exp(-(xs ** 2) / (2.0 * sigma * sigma))
    taps = (taps / taps.sum()).astype(np.float32).astype(np.float64)
    r = ksize // 2
    out = img.astype(np.float64)
    for axis in (1, 0):
        n = out.shape[axis]
        idx = np.arange(-r, n + r)
        idx = np.where(idx < 0, -idx, idx)
        idx = np.where(idx >= n, 2 * (n - 1) - idx, idx)
        padded = np.take(out, idx, axis=axis)
        out = sum(t * np.take(padded, np.arange(i, i + n), axis=axis)
                  for i, t in enumerate(taps))
    return out.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _disk_kernel(radius: int, alias_blur: float) -> np.ndarray:
    """Anti-aliased disk kernel (reference corruptions.py:100-112), the JAX
    package's ``_disk_kernel`` computed without OpenCV."""
    if radius <= 8:
        L = np.arange(-8, 8 + 1)
        ksize = 3
    else:
        L = np.arange(-radius, radius + 1)
        ksize = 5
    X, Y = np.meshgrid(L, L)
    disk = np.asarray((X ** 2 + Y ** 2) <= radius ** 2, np.float32)
    disk /= disk.sum()
    return _cv2_gaussian_blur(disk, ksize, alias_blur)


def defocus_blur(x, keys=None, severity=1):
    c = [(3, 0.1), (4, 0.5), (6, 0.5), (8, 0.5), (10, 0.5)][severity - 1]
    return _to255(conv2d_same(_as01(x), _disk_kernel(*c), mode="reflect_101"))


def _motion_taps(n: int, sigma: float) -> torch.Tensor:
    i = torch.arange(n, dtype=torch.float32)
    w = torch.exp(-(i ** 2) / (2.0 * sigma ** 2))
    return w / torch.sum(w)


def _directional_blur(x01: torch.Tensor, radius: float, sigma: float,
                      angle_deg: torch.Tensor) -> torch.Tensor:
    """Directional (motion) blur: one-sided Gaussian line sampling along
    each row's angle ([B] degrees), edge-clamped, the taps summed in order
    (the JAX package's replacement for ImageMagick's MotionBlurImage,
    reference corruptions.py:116-127, 315-326)."""
    n = int(math.ceil(radius)) + 1
    w = constant(("motion", n, sigma), x01.device, lambda: _motion_taps(n, sigma))
    theta = angle_deg * (math.pi / 180.0)
    dx = torch.cos(theta)[:, None, None]
    dy = torch.sin(theta)[:, None, None]
    _, h, wid = x01.shape
    rows = torch.arange(h, dtype=torch.float32, device=x01.device)[:, None]
    cols = torch.arange(wid, dtype=torch.float32, device=x01.device)[None, :]
    out = torch.zeros_like(x01)
    for i in range(n):
        out = out + w[i] * bilinear_sample(x01, rows - float(i) * dy,
                                           cols + float(i) * dx, mode="edge")
    return out


def motion_blur(x, keys, severity=1):
    c = [(10, 3), (15, 5), (15, 8), (15, 12), (20, 15)][severity - 1]
    angle = P.uniform(keys, (), -45.0, 45.0)
    return _to255(_directional_blur(_as01(x), float(c[0]), float(c[1]), angle))


def zoom_blur(x, keys=None, severity=5):
    cs = [np.arange(1, 1.11, 0.01), np.arange(1, 1.16, 0.01),
          np.arange(1, 1.21, 0.02), np.arange(1, 1.26, 0.02),
          np.arange(1, 1.31, 0.03)][severity - 1]
    x = _as01(x)
    out = torch.zeros_like(x)
    for z in cs:
        out = out + clipped_zoom(x, float(z))
    return _to255((x + out) / (len(cs) + 1))


# ---------------------------------------------------------------------------
# weather
# ---------------------------------------------------------------------------


def fog(x, keys, severity=5):
    """A 256×256 plasma map per image (min/max normalised over the whole
    map), its 28×28 corner added, scaled by the image's own max."""
    c = [(1.5, 2), (2.0, 2), (2.5, 1.7), (2.5, 1.5), (3.0, 1.4)][severity - 1]
    x = _as01(x)
    max_val = x.amax((1, 2), keepdim=True)
    fog_map = plasma_fractal(keys, mapsize=256, wibbledecay=c[1])[:, :28, :28]
    x = x + c[0] * fog_map
    return _to255(x * max_val / (max_val + c[0]))


def frost(x, keys, severity=5):
    """Procedural frost overlay, the JAX package's stand-in for the
    reference's frost PNGs (which its repo does not ship): band-passed
    noise, normalised by each image's own min and max."""
    c = [(1, 0.4), (0.8, 0.6), (0.7, 0.7), (0.65, 0.7), (0.6, 0.75)][severity - 1]
    k1, _ = P.split(keys)
    tex = gaussian_filter(P.uniform(k1, (28, 28)), 1.5, mode="reflect")
    lo = tex.amin((1, 2), keepdim=True)
    tex = (tex - lo) / (tex.amax((1, 2), keepdim=True) - lo + 1e-8)
    crystals = torch.where(tex > 0.55, tex, 0.3 * tex)
    frost_img = 255.0 * crystals
    x = x.to(torch.float32)
    return torch.clamp(c[0] * x + c[1] * frost_img, 0, 255)


def snow(x, keys, severity=5):
    c = [(0.1, 0.3, 3, 0.5, 10, 4, 0.8), (0.2, 0.3, 2, 0.5, 12, 4, 0.7),
         (0.55, 0.3, 4, 0.9, 12, 8, 0.7), (0.55, 0.3, 4.5, 0.85, 12, 8, 0.65),
         (0.55, 0.3, 2.5, 0.85, 12, 12, 0.55)][severity - 1]
    k1, k2 = P.split(keys)
    x = _as01(x)
    layer = P.normal(k1, x.shape[1:]) * c[1] + c[0]
    layer = clipped_zoom(layer, float(c[2]))
    layer = torch.where(layer < c[3], 0.0, layer)
    layer = torch.clamp(layer, 0.0, 1.0)
    # uint8 PNG round-trip in the reference quantizes the layer
    layer = torch.round(layer * 255.0) / 255.0
    angle = P.uniform(k2, (), -135.0, -45.0)
    layer = _directional_blur(layer, float(c[4]), float(c[5]), angle)
    x = c[6] * x + (1 - c[6]) * torch.maximum(x, x * 1.5 + 0.5)
    return _to255(x + layer + torch.rot90(layer, 2, (1, 2)))


def spatter(x, keys, severity=4):
    c = [(0.65, 0.3, 4, 0.69, 0.6, 0), (0.65, 0.3, 3, 0.68, 0.6, 0),
         (0.65, 0.3, 2, 0.68, 0.5, 0), (0.65, 0.3, 1, 0.65, 1.5, 1),
         (0.67, 0.4, 1, 0.65, 1.5, 1)][severity - 1]
    x = _as01(x)
    liquid = P.normal(keys, x.shape[1:]) * c[1] + c[0]
    liquid = gaussian_filter(liquid, float(c[2]))
    liquid = torch.where(liquid < c[3], 0.0, liquid)
    m = torch.where(liquid > c[3], 1.0, 0.0)
    m = gaussian_filter(m, float(c[4]))
    m = torch.where(m < 0.8, 0.0, m)
    return _to255(x * (1 - m) + 63.0 / 255.0 * m)


# ---------------------------------------------------------------------------
# photometric
# ---------------------------------------------------------------------------


def saturate(x, keys=None, severity=5):
    """Grayscale HSV round-trip with the clip applied to all hsv channels
    (reference corruptions.py:469-480), then luma-weighted gray."""
    c = [(0.3, 0), (0.1, 0), (2, 0), (5, 0.1), (20, 0.2)][severity - 1]
    x = _as01(x)
    hs = torch.clamp(torch.zeros_like(x) * c[0] + c[1], 0, 1)
    v = torch.clamp(x * c[0] + c[1], 0, 1)
    return _to255(rgb_to_gray(*hsv_to_rgb(hs, hs, v)))


# ---------------------------------------------------------------------------
# digital
# ---------------------------------------------------------------------------

_JPEG_LUMA_Q = np.array([
    [16, 11, 10, 16, 24, 40, 51, 61], [12, 12, 14, 19, 26, 58, 60, 55],
    [14, 13, 16, 24, 40, 57, 69, 56], [14, 17, 22, 29, 51, 87, 80, 62],
    [18, 22, 37, 56, 68, 109, 103, 77], [24, 35, 55, 64, 81, 104, 113, 92],
    [49, 64, 78, 87, 103, 121, 120, 101], [72, 92, 95, 98, 112, 100, 103, 99],
], np.float32)


def _dct_matrix(n: int = 8) -> np.ndarray:
    m = np.zeros((n, n), np.float32)
    for k in range(n):
        for i in range(n):
            m[k, i] = math.cos(math.pi * k * (2 * i + 1) / (2 * n))
    m *= math.sqrt(2.0 / n)
    m[0] /= math.sqrt(2.0)
    return m


def _jpeg_table(q: int) -> np.ndarray:
    scale = 5000 / q if q < 50 else 200 - 2 * q
    return np.clip(np.floor((_JPEG_LUMA_Q * scale + 50) / 100), 1, 255)


def jpeg_compression(x, keys=None, severity=5):
    """8×8 DCT quantization round trip with the libjpeg quality→table
    scaling, the JAX package's stand-in for PIL's JPEG encode
    (corruptions.py:483-490): edge-padded to 32×32, coefficients
    D·block·Dᵀ rounded half to even onto the table, D ᵀ·coef·D back."""
    q = [25, 18, 15, 10, 7][severity - 1]
    dev = x.device
    d = constant("dct8", dev, _dct_matrix)
    t = constant(("jpeg", q), dev, lambda: _jpeg_table(q))
    edge = constant("jpeg_edge", dev, lambda: np.minimum(np.arange(32), 27))
    b = x.shape[0]
    xp = x.to(torch.float32)[:, edge][:, :, edge] - 128.0
    blocks = xp.reshape(b, 4, 8, 4, 8).transpose(2, 3)        # [B,4,4,8,8]
    coef = torch.matmul(torch.matmul(d, blocks), d.T)
    coef = torch.round(coef / t) * t
    rec = torch.matmul(torch.matmul(d.T, coef), d)
    out = rec.transpose(2, 3).reshape(b, 32, 32) + 128.0
    return torch.clamp(out[:, :28, :28], 0, 255)


def pixelate(x, keys=None, severity=3):
    c = [0.6, 0.5, 0.4, 0.3, 0.25][severity - 1]
    small = resize_area(x.to(torch.float32), int(28 * c), int(28 * c))
    return resize_area(small, 28, 28)


# the 3 source points of elastic_transform's affine (cv2.getAffineTransform,
# reference corruptions.py:516-527) with a column of ones, and its inverse
_ELASTIC_PTS = np.array([[23.0, 23.0], [23.0, 5.0], [5.0, 5.0]], np.float32)


def _elastic_solver() -> np.ndarray:
    a = np.concatenate([_ELASTIC_PTS, np.ones((3, 1), np.float32)], 1)
    return np.linalg.inv(a.astype(np.float64)).astype(np.float32)


def elastic_transform(x, keys, severity=1):
    """A random affine from 3 point correspondences, then a smoothed random
    displacement field, both bilinear with zeros outside. The affine is
    solved and inverted in closed form per image (the 3×3 of the source
    points is a constant; the drawn map's inverse by cofactors), so nothing
    checks a matrix on the host."""
    c = [(28 * 2, 28 * 0.7, 28 * 0.1), (28 * 2, 28 * 0.08, 28 * 0.2),
         (28 * 0.05, 28 * 0.01, 28 * 0.02), (28 * 0.07, 28 * 0.01, 28 * 0.02),
         (28 * 0.12, 28 * 0.01, 28 * 0.02)][severity - 1]
    k1, k2, k3 = P.split(keys, 3)
    img = _as01(x)
    _, h, w = img.shape
    dev = img.device
    pts1 = constant("elastic_pts", dev, lambda: _ELASTIC_PTS)
    pts2 = pts1 + P.uniform(k1, (3, 2), -c[2], c[2])          # [B, 3, 2]
    sol = torch.matmul(constant("elastic_solver", dev, _elastic_solver), pts2)
    (a, bb, cc), (d, e, f) = sol[:, :, 0].unbind(1), sol[:, :, 1].unbind(1)
    det = a * e - bb * d
    inv = [[e / det, -bb / det, (bb * f - cc * e) / det],
           [-d / det, a / det, (cc * d - a * f) / det]]
    rows = torch.arange(h, dtype=torch.float32, device=dev)[:, None]
    cols = torch.arange(w, dtype=torch.float32, device=dev)[None, :]
    m = [[t[:, None, None] for t in r] for r in inv]
    src_c = m[0][0] * cols + m[0][1] * rows + m[0][2]
    src_r = m[1][0] * cols + m[1][1] * rows + m[1][2]
    img = bilinear_sample(img, src_r, src_c, cval=0.0, mode="constant")
    dx = gaussian_filter(P.uniform(k2, (h, w), -1, 1), c[1], mode="reflect",
                         truncate=3.0) * c[0]
    dy = gaussian_filter(P.uniform(k3, (h, w), -1, 1), c[1], mode="reflect",
                         truncate=3.0) * c[0]
    out = bilinear_sample(img, rows + dy, cols + dx, cval=0.0, mode="constant")
    return _to255(out)


# ---------------------------------------------------------------------------
# affine family (center-preserving, reference corruptions.py:561-635)
# ---------------------------------------------------------------------------


def _sign(keys, shape=()) -> torch.Tensor:
    return torch.where(P.bernoulli(keys, 0.5, shape), 1.0, -1.0)


def shear(x, keys, severity=2):
    c = [0.2, 0.4, 0.6, 0.8, 1.0][severity - 1]
    cc = c * _sign(keys)
    # skimage AffineTransform(shear=c): [[1, -sin(c)], [0, cos(c)]]
    m = center_affine(1.0, -torch.sin(cc), 0.0, torch.cos(cc))
    return _to255(affine_warp(_as01(x), m))


def rotate(x, keys, severity=2):
    c = [0.2, 0.4, 0.6, 0.8, 1.0][severity - 1]
    cc = c * _sign(keys)
    m = center_affine(torch.cos(cc), -torch.sin(cc), torch.sin(cc), torch.cos(cc))
    return _to255(affine_warp(_as01(x), m))


def translate(x, keys, severity=3):
    c = [1, 2, 3, 4, 5][severity - 1]
    shift = c * _sign(keys, (2,))
    one, zero = torch.ones_like(shift[:, 0]), torch.zeros_like(shift[:, 0])
    m = torch.stack([torch.stack([one, zero, shift[:, 0]], -1),
                     torch.stack([zero, one, shift[:, 1]], -1),
                     torch.stack([zero, zero, one], -1)], -2)
    return _to255(affine_warp(_as01(x), m))


# ---------------------------------------------------------------------------
# drawing (reference corruptions.py:638-722)
# ---------------------------------------------------------------------------


def line(x, keys, severity=None):
    k1, k2, k3 = P.split(keys, 3)
    r = P.randint(k3, 0, 27, (2,))
    corr = line_from_points(P.randint(k1, 0, 5), r[:, 0], P.randint(k2, 22, 27),
                            r[:, 1])
    return _to255(_as01(x) + corr)


def _dotted_keep() -> np.ndarray:
    """Alternating 2-column bands, the first zeroed (reference :654-659)."""
    return ((np.arange(28) // 2) % 2 == 1).astype(np.float32)


def dotted_line(x, keys, severity=None):
    r = P.randint(keys, 0, 27, (2,))
    zero = torch.zeros_like(r[:, 0])
    corr = line_from_points(zero, r[:, 0], zero + 27, r[:, 1])
    corr = corr * constant("dotted_keep", x.device, _dotted_keep)
    return _to255(_as01(x) + corr)


# ---------------------------------------------------------------------------
# zigzag and its draws
# ---------------------------------------------------------------------------


def key_draws(keys) -> torch.Tensor:
    """[B, 4] int64 per key: zigzag's draws (r0 in [0, 27), dr in [-5, 5);
    the JAX package's corruptions.py:511-515) and the key itself (k0, k1),
    from which the other styles draw inside the styling call. Zigzag's
    draws are seven threefry passes and randint's arithmetic, so a dataset
    draws once for all its sample ids (``StyledDataset.device_arrays``)
    and batches gather from that."""
    k1, k2 = P.split(keys)
    return torch.stack([P.randint(k1, 0, 27), P.randint(k2, -5, 5),
                        keys[0], keys[1]], 1)


def style_draws(seed: int, sample_ids: torch.Tensor) -> torch.Tensor:
    """``key_draws`` of the keys fold_in(key(seed), sample id): the draws of
    a Styled-MNIST dataset's samples, as the JAX package keys them
    (``clearvae_tpu/data/styled.py:40-45``)."""
    ids = sample_ids.to(torch.int64)
    return key_draws(P.fold_in(P.key(seed, ids.shape, ids.device), ids))


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




def _zigzag_keyed(x, keys, severity=None):
    """zigzag with its draws made from ``keys``."""
    return zigzag(x, *key_draws(keys)[:, :2].unbind(1))


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


def canny_edges(x, keys=None, severity=None, sigma: float = 1.0, low_threshold: float = 0.1,
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
    gx = conv2d_same(smoothed, _SOBEL.T, mode="constant") / 4.0
    gy = conv2d_same(smoothed, _SOBEL, mode="constant") / 4.0
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
# registry + per-sample dispatch
# ---------------------------------------------------------------------------


def _k3_style(name: str):
    """The batched function of a style K3 expresses: one K3 call with every
    row's code ``name``'s (a CUDA batch launches the kernel or raises)."""
    code = STYLE_CODES[name]

    def fn(x, keys=None, severity=None):
        if severity is None:
            severity = DEFAULT_SEVERITY.get(name, 5)
        codes = torch.full((x.shape[0],), code, dtype=torch.int32,
                           device=x.device)
        return style_batch_kernel(x.to(torch.float32).contiguous(), codes,
                                  severity)

    fn.__name__ = name
    return fn


CORRUPTION_FNS = {
    "identity": _k3_style("identity"), "gaussian_noise": gaussian_noise,
    "shot_noise": shot_noise, "impulse_noise": impulse_noise,
    "speckle_noise": speckle_noise, "pessimal_noise": pessimal_noise,
    "gaussian_blur": gaussian_blur, "glass_blur": glass_blur,
    "defocus_blur": defocus_blur, "motion_blur": motion_blur,
    "zoom_blur": zoom_blur, "fog": fog, "frost": frost, "snow": snow,
    "spatter": spatter, "contrast": _k3_style("contrast"),
    "brightness": _k3_style("brightness"), "saturate": saturate,
    "jpeg_compression": jpeg_compression, "pixelate": pixelate,
    "elastic_transform": elastic_transform, "quantize": _k3_style("quantize"),
    "shear": shear, "rotate": rotate, "scale": _k3_style("scale"),
    "translate": translate, "line": line, "dotted_line": dotted_line,
    "zigzag": _zigzag_keyed, "inverse": _k3_style("inverse"),
    "stripe": _k3_style("stripe"), "canny_edges": canny_edges,
}


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


def _style_rows(x: torch.Tensor, style_idx: torch.Tensor, draws: torch.Tensor,
                styles) -> torch.Tensor:
    """Each row of x styled by its style index, on the 0..255 scale."""
    x = x.to(torch.float32).contiguous()
    out = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    routed, luts = _k3_plan(styles, x.device)
    for severity, lut in luts:
        style_batch_kernel(x, lut[style_idx.long()], severity, out=out)
    keys = (draws[:, 2], draws[:, 3])
    for code, (name, severity) in enumerate(styles):
        if code in routed:
            continue
        if name == "zigzag":
            styled = zigzag(x, draws[:, 0], draws[:, 1])
        else:
            fn = CORRUPTION_FNS[name]
            styled = fn(x, keys) if severity is None else fn(x, keys, severity)
        out = torch.where((style_idx == code)[:, None, None], styled, out)
    return out


def style_batch(x: torch.Tensor, style_idx: torch.Tensor, draws: torch.Tensor,
                styles=EXPERIMENT_STYLES) -> torch.Tensor:
    """Style each sample of a [B, H, W] 0..255 batch by its style index and
    apply the reference's /255 (run_styledmnist_downstream_expr.py:80).

    The samples whose style K3 expresses go through ``style_batch_kernel``,
    one call per severity group over the whole batch, writing their rows of
    the output in place (code -1 marks the other rows, which K3 leaves); a
    CUDA batch launches the kernel or raises. Every other style is computed
    over the whole batch, its rows taken by ``torch.where``, as the JAX
    package's ``vmap(lax.switch)`` computes every branch and selects: each
    style acts on each image on its own, so a row's pixels do not depend on
    the rest of the batch. ``draws`` [B, 4] holds each sample's
    ``key_draws``: zigzag's (r0, dr) and the key the other random styles
    draw from (``style_draws`` of a dataset's seed and sample ids)."""
    return _style_rows(x, style_idx, draws, styles) / 255.0


def batched_style(x_batch: torch.Tensor, style_idx: torch.Tensor, key,
                  styles=EXPERIMENT_STYLES) -> torch.Tensor:
    """Per-sample styles of a [B, H, W] batch on the 0..255 scale, the row
    keys ``split(key, B)`` of one key (a pair of 0-d tensors), as the JAX
    package's ``batched_style`` keys them."""
    keys = P.split_stacked(key, x_batch.shape[0])
    return _style_rows(x_batch, style_idx, key_draws(keys), styles)
