"""K6, BatchNorm with its casts and the activation after it: a CUDA kernel
pair for Hopper each way.

``batch_norm(x, weight, bias, running_mean, running_var, train,
update_stats, act, momentum, eps)`` is ``models/layers.BatchNorm``'s layer
on a CUDA tensor: x ([N, C] or [N, C, H, W], float32 or bfloat16) cast to
float32, normalised by its batch statistics (train) or the running ones
(eval), the running statistics moved (train with ``update_stats``: momentum
``momentum``, the biased variance, as flax), scaled and shifted, cast back
to x's dtype, then ``act`` ("none", "relu", "sigmoid") on that. It is one
``torch.autograd.Function`` whose forward is two launches (``stats``, the
per-channel sums and their finalisation, skipped in eval; ``apply``) and
whose backward is two (``grad_reduce``: dbias and dweight; ``grad_apply``:
dx), of ``clearvae_torch/csrc/batchnorm.cu``. Its casts are folded into
the kernels and run no copy, so ``model.casts`` does not count them. It
raises on any tensor it does not take.

Its plain twin is ``models/layers.batch_norm_plain``, the layer as torch
ops (~35 kernels a layer each way on a card), which the layer runs on the
CPU and under a data mesh. The two agree to float32 rounding (the sums are
taken in another order) and, in bfloat16, to where that rounding flips a
bf16 value.

``LAUNCHES`` (``launches.batchnorm``) counts the launches by stage: 4 a
layer a train step, 1 an eval forward.
"""

from __future__ import annotations

import ctypes
import math

import torch

from clearvae_torch.utils.logging import counter

Tensor = torch.Tensor
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
ACTS = {"none": 0, "relu": 1, "sigmoid": 2}
STAGES = ("stats", "apply", "grad_reduce", "grad_apply")

# the kernels' layout (csrc/batchnorm.cu): threads a block; planes below
# ROWS_HW elements take the rows path; the reductions aim at TARGET_BLOCKS
# blocks (one an SM of an H100: fewer, fuller blocks measured faster than
# two an SM) and keep chunks × channels partials at most
# MAX_PARTIALS, which the last block sums
THREADS = 256
ROWS_HW = 32
TARGET_BLOCKS = 132
MAX_PARTIALS = 16384
MAX_ELEMENTS = 2 ** 31 - 1

LAUNCHES = counter("launches.batchnorm", STAGES)


def reset_launches() -> None:
    for k in STAGES:
        LAUNCHES[k] = 0


def _channels_last(x: Tensor) -> bool:
    """A 4-D tensor dense in channels-last order and not in NCHW order (a
    tensor dense in both has both orders' memory)."""
    return (x.dim() == 4 and not x.is_contiguous()
            and x.is_contiguous(memory_format=torch.channels_last))


def dense(x: Tensor) -> Tensor:
    """``x`` itself where it is dense in NCHW or channels-last order (the
    port's conv stacks run channels-last: the models permute NHWC inputs),
    else a contiguous copy."""
    return x if x.is_contiguous() or _channels_last(x) else x.contiguous()


def dims(x: Tensor) -> tuple:
    """A dense x as the kernels view its memory, (n, c, hw): [N, C, H·W]
    in NCHW order, [N·H·W, C, 1] in channels-last order, [N, C, 1] 2-D."""
    c = x.shape[1]
    if _channels_last(x):
        return x.numel() // c, c, 1
    return x.shape[0], c, x.numel() // (x.shape[0] * c)


def layout(n: int, c: int, hw: int, itemsize: int) -> dict:
    """The kernels' grid for x as [n, c, hw]: ``cpt`` channels a tile (1
    on the planes path, hw >= ROWS_HW; on the rows path at most what
    THREADS threads cover ``vec`` elements at a time), ``tiles``, ``rows``
    a chunk and ``chunks``; ``vec``, the elements a thread of a reduction
    loads at once, and ``ew_vec``, of an elementwise stage (before the
    pointers' alignment)."""
    full = 16 // itemsize
    if hw >= ROWS_HW:
        vec, cpt = (full if hw % full == 0 else 1), 1
    else:
        # tiles of a multiple of ``step`` channels (whole vectors), few
        # enough to fill THREADS, many enough for TARGET_BLOCKS blocks
        vec = full if c * hw % full == 0 else 1
        step = vec // math.gcd(vec, hw)
        most = max(1, min(n, MAX_PARTIALS // c))
        cpt = c // -(-TARGET_BLOCKS // most) // step * step
        cpt = min(c, THREADS * vec // hw // step * step, max(step, cpt))
    tiles = -(-c // cpt)
    chunks = max(1, min(n, -(-TARGET_BLOCKS // tiles), MAX_PARTIALS // c))
    # rows a chunk rounded down (at least the chunks asked for) unless that
    # passes MAX_PARTIALS
    rows = max(1, n // chunks)
    if -(-n // rows) * c > MAX_PARTIALS:
        rows = -(-n // chunks)
    ew = full if hw % full == 0 or (hw == 1 and c % full == 0) else 1
    return {"cpt": cpt, "tiles": tiles, "rows": rows,
            "chunks": -(-n // rows), "vec": vec, "ew_vec": ew}


def _check(x: Tensor, weight: Tensor, bias: Tensor, running_mean: Tensor,
           running_var: Tensor, act: str) -> None:
    if act not in ACTS:
        raise ValueError(f"unknown activation {act!r}: one of {sorted(ACTS)}")
    if x.dim() not in (2, 4):
        raise ValueError(f"batch_norm takes [N, C] or [N, C, H, W]; got "
                         f"{tuple(x.shape)}")
    if x.dtype not in DTYPES:
        raise ValueError(f"batch_norm takes {sorted(map(str, DTYPES))}; got "
                         f"{x.dtype}")
    if not (x.is_contiguous() or _channels_last(x)):
        raise ValueError("batch_norm's input must be contiguous, in NCHW "
                         "or channels-last order")
    if not 0 < x.numel() <= MAX_ELEMENTS:
        raise ValueError(f"batch_norm takes 1 to {MAX_ELEMENTS} elements; "
                         f"got {x.numel()}")
    c = x.shape[1]
    for name, t in (("weight", weight), ("bias", bias),
                    ("running_mean", running_mean),
                    ("running_var", running_var)):
        if (t.shape != (c,) or t.dtype != torch.float32
                or not t.is_contiguous() or t.device != x.device):
            raise ValueError(f"{name} must be [{c}] float32, contiguous, on "
                             f"{x.device}; got {tuple(t.shape)} {t.dtype} "
                             f"on {t.device}")
    if not x.is_cuda:
        raise ValueError(f"batch_norm's kernels run on a CUDA device; got "
                         f"{x.device}")


_P, _LL, _I, _F = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_float)
# bn_launch(stage, dtype, act, train, x, dy, out, mean, var, weight, bias,
#           sums, partial, result, running_mean, running_var, n, c, hw,
#           rows, cpt, vec, eps, momentum, keep, stream)
ARGTYPES = [_I, _I, _I, _I] + [_P] * 12 + [_LL] * 5 + [_I, _F, _F, _F, _P]


def _lib():
    from clearvae_torch.ops.kernels import _build

    lib = _build.load("batchnorm")
    if not getattr(lib, "_typed", False):
        lib.bn_launch.argtypes = ARGTYPES
        lib.bn_launch.restype = ctypes.c_int
        lib._typed = True
    return lib


def _ptr(t: Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


def _launch(stage: str, x: Tensor, *, dy=None, out=None, mean=None,
            var=None, weight=None, bias=None, sums=None, result=None,
            running_mean=None, running_var=None, act: str = "none",
            train: bool = True, eps: float = 1e-5,
            momentum: float = 0.1) -> None:
    n, c, hw = dims(x)
    lay = layout(n, c, hw, x.element_size())
    vec = lay["vec" if stage in ("stats", "grad_reduce") else "ew_vec"]
    if any(t is not None and t.data_ptr() % 16 for t in (x, dy, out)):
        vec = 1
    partial = (x.new_empty((lay["chunks"], 2, c), dtype=torch.float32)
               if stage in ("stats", "grad_reduce") else None)
    err = _lib().bn_launch(
        STAGES.index(stage), DTYPES[x.dtype], ACTS[act], int(train),
        _ptr(x), _ptr(dy), _ptr(out), _ptr(mean), _ptr(var), _ptr(weight),
        _ptr(bias), _ptr(sums), _ptr(partial), _ptr(result),
        _ptr(running_mean), _ptr(running_var), n, c, hw, lay["rows"],
        lay["cpt"], vec, eps, momentum, 1 - momentum,
        torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"CUDA kernel batchnorm {stage} failed to launch: "
                           f"cudaError {err}")
    LAUNCHES[stage] += 1


def run_stats(x: Tensor, running_mean: Tensor | None, running_var: Tensor | None,
          momentum: float) -> Tensor:
    """[2, C] float32: the batch's mean and unclamped variance; the running
    statistics moved where given."""
    result = x.new_empty((2, x.shape[1]), dtype=torch.float32)
    _launch("stats", x, result=result, running_mean=running_mean,
            running_var=running_var, momentum=momentum)
    return result


def run_apply(x: Tensor, mean: Tensor, var: Tensor, weight: Tensor,
          bias: Tensor, act: str, eps: float) -> Tensor:
    """The layer's output in x's dtype."""
    out = torch.empty_like(x)
    _launch("apply", x, out=out, mean=mean, var=var, weight=weight,
            bias=bias, act=act, eps=eps)
    return out


def run_grad_reduce(dy: Tensor, x: Tensor, mean: Tensor, var: Tensor,
                weight: Tensor, bias: Tensor, act: str, eps: float) -> Tensor:
    """[2, C] float32: Σg (dbias) and Σg·x̂ (dweight), g being dy through
    the activation."""
    result = x.new_empty((2, x.shape[1]), dtype=torch.float32)
    _launch("grad_reduce", x, dy=dy, mean=mean, var=var, weight=weight,
            bias=bias, result=result, act=act, eps=eps)
    return result


def run_grad_apply(dy: Tensor, x: Tensor, mean: Tensor, var: Tensor,
               weight: Tensor, bias: Tensor, sums: Tensor, act: str,
               eps: float, train: bool) -> Tensor:
    """dx in x's dtype."""
    out = torch.empty_like(x)
    _launch("grad_apply", x, dy=dy, out=out, mean=mean, var=var,
            weight=weight, bias=bias, sums=sums, act=act, eps=eps,
            train=train)
    return out


class BatchNormAct(torch.autograd.Function):
    """The layer as K6's four stages (``run_stats``, ``run_apply``;
    ``run_grad_reduce``, ``run_grad_apply``)."""

    @staticmethod
    def forward(ctx, x, weight, bias, running_mean, running_var, train,
                update_stats, act, momentum, eps):
        if train:
            moved = ((running_mean, running_var) if update_stats
                     else (None, None))
            mean, var = run_stats(x, *moved, momentum)
        elif any(ctx.needs_input_grad[:3]):
            # the backward's statistics, safe from a later train step
            mean, var = running_mean.clone(), running_var.clone()
        else:
            mean, var = running_mean, running_var
        ctx.save_for_backward(x, weight, bias, mean, var)
        ctx.act, ctx.eps, ctx.train = act, eps, train
        return run_apply(x, mean, var, weight, bias, act, eps)

    @staticmethod
    def backward(ctx, dy):
        x, weight, bias, mean, var = ctx.saved_tensors
        dy = dy.contiguous(memory_format=torch.channels_last
                           if _channels_last(x) else torch.contiguous_format)
        sums = run_grad_reduce(dy, x, mean, var, weight, bias, ctx.act,
                               ctx.eps)
        dx = (run_grad_apply(dy, x, mean, var, weight, bias, sums, ctx.act,
                             ctx.eps, ctx.train)
              if ctx.needs_input_grad[0] else None)
        return dx, sums[1], sums[0], *(None,) * 7


def batch_norm(x: Tensor, weight: Tensor, bias: Tensor, running_mean: Tensor,
               running_var: Tensor, train: bool, update_stats: bool = True,
               act: str = "none", momentum: float = 0.1,
               eps: float = 1e-5) -> Tensor:
    """The layer through K6's kernels; raises on what they do not take."""
    _check(x, weight, bias, running_mean, running_var, act)
    return BatchNormAct.apply(x, weight, bias, running_mean, running_var,
                              bool(train), bool(update_stats), act,
                              float(momentum), float(eps))

