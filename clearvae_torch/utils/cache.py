"""The runners' device set-up (counterpart of ``clearvae_tpu/utils/cache.py``).

The JAX package enables XLA's persistent compilation cache here. The port's
compiled artifacts are its kernels, which ``ops/kernels`` already caches
in ``clearvae_torch/_build/`` at their first build, so there is no cache to
enable; the name is kept from the JAX package. What stays is its two other
jobs, done once before a process touches the card: it takes the
single-GPU-process lock (``utils/lock.py``), and it sets the numerics that
the JAX reference computes, fp32 matmuls and convolutions (TF32 off for
cuBLAS and cuDNN). Every runner's ``main``, ``chip_smoke.py`` and the
trainers' ``fit`` call it; a second call in the same process changes
nothing.
"""

from __future__ import annotations

import torch


def enable_compilation_cache(device=None) -> None:
    """Take the lock of the card that ``device`` names (default: the
    current card) and turn TF32 off for cuDNN and cuBLAS."""
    from clearvae_torch.utils.lock import acquire_gpu_lock

    acquire_gpu_lock(device=device)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
