"""clearvae_torch: the PyTorch/CUDA port of the CLEAR-VAE stack.

Counterpart of ``clearvae_tpu`` with the same module layout. It imports
``torch``, numpy and scipy only — never JAX, flax, optax or
``clearvae_tpu``. Entry points run on ``cuda`` unless the caller passes
``device="cpu"``; see :func:`resolve_device`.
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` when none is given.

    Raises when CUDA is asked for (explicitly or by default) and there is no
    card; it never falls back to the CPU quietly.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "clearvae_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run on the CPU")
    return dev
