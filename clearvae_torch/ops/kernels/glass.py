"""K5, glass_blur's pixel swaps: a CUDA kernel for Hopper, with its plain
twin.

``glass_swaps(img, deltas, do_swap, base)`` runs the swaps of
``ops/corruptions.glass_blur`` over a [B, H, W] float32 batch, in place (or
into ``out=``): for every image, in order j = 0..n-1, pixel p = base[j] (a
flat index r * W + c) and pixel q = p + dy * W + dx, (dx, dy) = deltas[b, j],
exchange where do_swap[b, j] is set. Swap j reads both pixels before it
writes either, so the swaps chain: the reference's raster order (JAX's
``lax.scan``) is kept.

A CUDA tensor launches one kernel a call (``clearvae_torch/csrc/
glass_swap.cu``, one block an image) or the wrapper raises. A CPU tensor
takes the plain twin ``glass_swaps_plain``: the loop of torch ops over the
batch's flat rows, one step a coordinate, ~5 kernels a step on a card.
Every swap only moves pixels, so the two agree bit for bit.
``LAUNCHES["glass"]`` counts the launches.
"""

from __future__ import annotations

import ctypes

import torch

from clearvae_torch.utils.logging import counter

Tensor = torch.Tensor
MAX_PIXELS = 2 ** 16          # the kernel packs p and q into 16 bits each
SMEM_BYTES = 48 * 1024        # its pixels and swap words, 4 bytes each

LAUNCHES = counter("launches.glass", ("glass",))


def reset_launches() -> None:
    LAUNCHES["glass"] = 0


def glass_swaps_plain(img: Tensor, deltas: Tensor, do_swap: Tensor,
                      base: Tensor, out: Tensor | None = None) -> Tensor:
    """The swaps as a loop over the coordinates, each a gather and two
    writes over the batch's flat rows, in place in ``out`` (``img``
    itself by default)."""
    if out is None:
        out = img
    elif out is not img:
        out.copy_(img)
    b, h, w = out.shape
    flat = out.view(b, h * w)
    partner = base + deltas[..., 1] * w + deltas[..., 0]    # [B, n]
    for j, p in enumerate(base.tolist()):
        q = partner[:, j:j + 1]
        a, bv = flat[:, p:p + 1], flat.gather(1, q)
        s = do_swap[:, j:j + 1]
        new_p, new_q = torch.where(s, bv, a), torch.where(s, a, bv)
        flat[:, p:p + 1] = new_p
        flat.scatter_(1, q, new_q)
    return out


def _check(img: Tensor, deltas: Tensor, do_swap: Tensor, base: Tensor,
           out: Tensor | None) -> None:
    tensors = [img, deltas, do_swap, base] + ([out] if out is not None
                                              else [])
    devices = {t.device for t in tensors}
    if len(devices) != 1 or img.device.type not in ("cuda", "cpu"):
        raise ValueError(f"glass_swaps' tensors must share a CUDA or CPU "
                         f"device; got {sorted(map(str, devices))}")
    if img.dim() != 3 or img.dtype != torch.float32:
        raise ValueError(f"the images must be [B, H, W] float32; got "
                         f"{tuple(img.shape)} {img.dtype}")
    b, h, w = img.shape
    n = base.shape[0] if base.dim() == 1 else -1
    if base.dim() != 1 or base.dtype != torch.int64:
        raise ValueError(f"base must be [n] int64; got {tuple(base.shape)} "
                         f"{base.dtype}")
    if deltas.shape != (b, n, 2) or deltas.dtype != torch.int64:
        raise ValueError(f"deltas must be [{b}, {n}, 2] int64; got "
                         f"{tuple(deltas.shape)} {deltas.dtype}")
    if do_swap.shape != (b, n) or do_swap.dtype != torch.bool:
        raise ValueError(f"do_swap must be [{b}, {n}] bool; got "
                         f"{tuple(do_swap.shape)} {do_swap.dtype}")
    if out is not None and (out.shape != img.shape
                            or out.dtype != img.dtype):
        raise ValueError(f"out must be {tuple(img.shape)} {img.dtype}; got "
                         f"{tuple(out.shape)} {out.dtype}")
    if not img.is_contiguous() or (out is not None
                                   and not out.is_contiguous()):
        raise ValueError("the images (and out) must be contiguous: the "
                         "swaps write them in place")
    if h * w > MAX_PIXELS or 4 * (h * w + n) > SMEM_BYTES:
        raise ValueError(f"glass_swaps takes at most {MAX_PIXELS} pixels an "
                         f"image and 4 * (pixels + swaps) <= {SMEM_BYTES} "
                         f"bytes; got {h * w} pixels and {n} swaps")


_P, _LL = ctypes.c_void_p, ctypes.c_longlong
# glass_swaps(x, out, deltas, flag, base, batch, hw, width, n, stream)
ARGTYPES = [_P, _P, _P, _P, _P, _LL, _LL, _LL, _LL, _P]


def _lib():
    from clearvae_torch.ops.kernels import _build

    lib = _build.load("glass_swap")
    if not getattr(lib, "_typed", False):
        lib.glass_swaps.argtypes = ARGTYPES
        lib.glass_swaps.restype = ctypes.c_int
        lib._typed = True
    return lib


def glass_swaps(img: Tensor, deltas: Tensor, do_swap: Tensor, base: Tensor,
                out: Tensor | None = None) -> Tensor:
    """Every image's swaps in order, in place in ``img`` or into ``out``;
    returns the swapped images. A swap whose q falls outside its image is
    the plain twin's error and the kernel's no-op."""
    _check(img, deltas, do_swap, base, out)
    if img.device.type == "cpu":
        return glass_swaps_plain(img, deltas, do_swap, base, out)
    if out is None:
        out = img
    b, h, w = img.shape
    n = base.shape[0]
    if b == 0 or n == 0:
        return out if out is img else out.copy_(img)
    deltas, do_swap, base = (t.contiguous() for t in (deltas, do_swap, base))
    err = _lib().glass_swaps(
        img.data_ptr(), out.data_ptr(), deltas.data_ptr(), do_swap.data_ptr(),
        base.data_ptr(), b, h * w, w, n,
        torch.cuda.current_stream(img.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"CUDA kernel glass_swaps failed to launch: "
                           f"cudaError {err}")
    LAUNCHES["glass"] += 1
    return out
