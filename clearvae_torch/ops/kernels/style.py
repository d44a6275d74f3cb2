"""K3, the fused deterministic styler: a CUDA kernel for Hopper, with its
plain twin.

Counterpart of ``clearvae_tpu/ops/pallas/style_kernel.py``
(``_style_kernel`` / ``pallas_style_batch``). ``style_batch_kernel`` styles
a [B, H, W] float32 batch on the 0..255 scale, H == W, selecting per sample
by a code of ``STYLE_CODES``, all at one severity:

  0 identity; 1 stripe (255 - x on columns < 7 and >= 21); 2 brightness
  clip(x/255 + c)·255; 3 inverse 255 - x; 4 quantize round(x·L/255)·255/L
  with L = 2^bits - 1; 5 contrast clip((x01 - mean)·c + mean)·255 around the
  image's mean; 6 scale clip(A·x01·Aᵀ)·255, A the bilinear zoom matrix.

A code above 6 leaves its sample as it is, as the TPU kernel does. A
negative code marks a row that is not K3's: with ``out=`` given, that row of
``out`` is neither read nor written, so a caller styles a whole batch into
its own output in one call and fills the other rows by other routes. The
kernel (``clearvae_torch/csrc/style_kernel.cu``) launches for CUDA tensors,
or the wrapper raises; ``style_plain`` repeats its arithmetic in torch ops
and is what a CPU tensor takes. ``LAUNCHES["style"]`` counts the launches.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from clearvae_torch.utils.logging import counter

Tensor = torch.Tensor

STYLE_CODES = {"identity": 0, "stripe": 1, "brightness": 2, "inverse": 3,
               "quantize": 4, "contrast": 5, "scale": 6}
_BRIGHT = (0.1, 0.2, 0.3, 0.4, 0.5)
_QBITS = (5, 4, 3, 2, 1)
_CONTR = (0.4, 0.3, 0.2, 0.1, 0.05)
_SCALE = (1 / 0.9, 1 / 0.8, 1 / 0.7, 1 / 0.6, 1 / 0.5)
# the severity a style takes when none is given (the per-style defaults of
# the JAX package's corruptions); the others do not depend on severity
DEFAULT_SEVERITY = {"brightness": 5, "quantize": 5, "contrast": 4, "scale": 3}
H_MAX = 64   # the kernel takes rows of up to 64 pixels, one block an image

LAUNCHES = counter("launches.style", ("style",))


def reset_launches() -> None:
    LAUNCHES["style"] = 0


@functools.lru_cache(maxsize=None)
def _interp_matrix(size: int, factor: float, center: float) -> np.ndarray:
    """A[i, j] = bilinear weight of source pixel j for output pixel i along
    one axis of the centre-preserving zoom (out-of-range rows → 0, skimage
    constant mode)."""
    a = np.zeros((size, size), np.float32)
    for i in range(size):
        src = factor * i + center * (1 - factor)
        j0 = int(np.floor(src))
        f = src - j0
        if 0 <= j0 < size:
            a[i, j0] += 1 - f
        if 0 <= j0 + 1 < size:
            a[i, j0 + 1] += f
    return a


@functools.lru_cache(maxsize=None)
def _zoom_taps(size: int, factor: float, center: float):
    """The nonzeros of ``_interp_matrix``'s rows as taps: (idx [size, 2]
    int32, w [size, 2] float32), output pixel i = w[i, 0]·src[idx[i, 0]] +
    w[i, 1]·src[idx[i, 1]]. idx[i] is (j0, j0 + 1) with j0 = floor(src);
    a tap outside the image gets weight 0 and its index clamped into it."""
    idx = np.zeros((size, 2), np.int32)
    w = np.zeros((size, 2), np.float32)
    for i in range(size):
        src = factor * i + center * (1 - factor)
        j0 = int(np.floor(src))
        f = src - j0
        for t, (j, wt) in enumerate(((j0, 1 - f), (j0 + 1, f))):
            idx[i, t] = min(max(j, 0), size - 1)
            w[i, t] = np.float32(wt) if 0 <= j < size else 0.0
    return idx, w


_A_CACHE: dict = {}


def _zoom(h: int, severity: int, device) -> Tensor:
    """The [H, H] zoom matrix of ``severity`` on ``device``, made once."""
    k = (h, severity, str(device))
    if k not in _A_CACHE:
        _A_CACHE[k] = torch.as_tensor(
            _interp_matrix(h, _SCALE[severity - 1], (h - 1) / 2), device=device)
    return _A_CACHE[k]


_TAP_CACHE: dict = {}


def _taps(h: int, severity: int, device) -> Tensor:
    """The kernel's zoom tap table of ``severity`` on ``device``, made once:
    int32 [H, 4] rows (first index, second index, first weight's bits,
    second weight's bits)."""
    k = (h, severity, str(device))
    if k not in _TAP_CACHE:
        idx, w = _zoom_taps(h, _SCALE[severity - 1], (h - 1) / 2)
        _TAP_CACHE[k] = torch.as_tensor(
            np.concatenate([idx, w.view(np.int32)], 1), device=device)
    return _TAP_CACHE[k]


def _constants(severity: int):
    """(brightness shift, quantize multiplier, quantize step, contrast
    factor) of a severity, as Python floats; each is rounded once to
    float32 where it meets the data, as JAX's weak typing does."""
    s = severity - 1
    levels = float((1 << _QBITS[s]) - 1)
    return _BRIGHT[s], levels / 255.0, 255.0 / levels, _CONTR[s]


_SCALAR_CACHE: dict = {}


def _scalars(severity: int, device) -> tuple:
    """``_constants(severity)`` as float32 0-d tensors on ``device``, made
    once (the plain twin's; a call then copies nothing from the host)."""
    k = (severity, str(device))
    if k not in _SCALAR_CACHE:
        _SCALAR_CACHE[k] = tuple(
            torch.tensor(v, dtype=torch.float32, device=device)
            for v in _constants(severity))
    return _SCALAR_CACHE[k]


def _check(x: Tensor, code: Tensor, severity: int, out=None) -> None:
    if x.dim() != 3 or x.shape[1] != x.shape[2] or x.shape[1] > H_MAX:
        raise ValueError(f"x must be [B, H, H] with H <= {H_MAX}; got "
                         f"{tuple(x.shape)}")
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError("x must be contiguous float32")
    if code.shape != (x.shape[0],) or code.dtype != torch.int32 \
            or not code.is_contiguous():
        raise ValueError(f"code must be contiguous int32 [B]={x.shape[0]}; "
                         f"got {code.dtype} {tuple(code.shape)}")
    if code.device != x.device or x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"x and code must share a CUDA or CPU device; got "
                         f"{x.device} and {code.device}")
    if severity not in (1, 2, 3, 4, 5):
        raise ValueError(f"severity must be 1..5; got {severity}")
    if out is not None and (out.shape != x.shape or out.dtype != x.dtype
                            or out.device != x.device
                            or not out.is_contiguous()
                            or out.data_ptr() == x.data_ptr()):
        raise ValueError("out must be a contiguous float32 tensor of x's "
                         "shape and device, apart from x")


def style_plain(x: Tensor, code: Tensor, severity: int,
                out: Tensor | None = None) -> Tensor:
    """Plain twin of K3: every candidate style for every pixel, selected per
    sample, as the TPU kernel computes it. With ``out``, the rows of
    non-negative code are written there and the others left as they are."""
    _check(x, code, severity, out)
    b, h, w = x.shape
    bright, q_mul, q_div, contr = _scalars(severity, x.device)
    a = _zoom(h, severity, x.device)
    x01 = x / 255.0
    cols = torch.arange(w, device=x.device)
    stripe = torch.where((cols < 7) | (cols >= 21), 255.0 - x, x)
    brightened = torch.clamp(x01 + bright, 0.0, 1.0) * 255.0
    inverse = 255.0 - x
    quant = torch.round(x * q_mul) * q_div
    mean = x01.mean(dim=(1, 2), keepdim=True)
    contrasted = torch.clamp((x01 - mean) * contr + mean, 0.0, 1.0) * 255.0
    scaled = torch.clamp(a @ x01 @ a.T, 0.0, 1.0) * 255.0
    c = code.view(b, 1, 1)
    res = x
    for val, styled in ((1, stripe), (2, brightened), (3, inverse), (4, quant),
                        (5, contrasted), (6, scaled)):
        res = torch.where(c == val, styled, res)
    if out is None:
        return res
    return out.copy_(torch.where(c >= 0, res, out))


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _lib():
    from clearvae_torch.ops.kernels import _build

    lib = _build.load("style_kernel")
    if not getattr(lib, "_typed", False):
        lib.style_batch.argtypes = [_P, _P, _P, _I, _I, _I, _F, _F, _F, _F, _P,
                                    _P]
        lib.style_batch.restype = ctypes.c_int
        lib._typed = True
    return lib


def style_batch_kernel(x: Tensor, code: Tensor, severity: int,
                       out: Tensor | None = None) -> Tensor:
    """K3: style a [B, H, H] float32 0..255 batch by per-sample ``code``
    (int32 [B]) at ``severity`` into ``out`` (a new tensor if None) and
    return it; rows of negative code are left as ``out`` has them. A CUDA
    batch launches the kernel (or this raises); a CPU batch takes
    ``style_plain``."""
    _check(x, code, severity, out)
    if x.device.type == "cpu":
        return style_plain(x, code, severity, out)
    b, h, w = x.shape
    if out is None:
        out = torch.empty_like(x)
    if b == 0:
        return out
    taps = _taps(h, severity, x.device)
    err = _lib().style_batch(x.data_ptr(), code.data_ptr(), taps.data_ptr(),
                             b, h, w, *_constants(severity), out.data_ptr(),
                             torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"CUDA kernel style_batch failed to launch: "
                           f"cudaError {err}")
    LAUNCHES["style"] += 1
    return out
