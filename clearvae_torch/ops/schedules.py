"""KL-annealing schedules as pure functions of the step counter
(counterpart of ``clearvae_tpu/ops/schedules.py``)."""

from __future__ import annotations

import torch


def logistic_anneal(step, *, beta: float, loc: float = 0.0,
                    scale: float = 1.0) -> torch.Tensor:
    """beta / (1 + exp(-(step - loc)/scale)) in float32 — reference
    trainer.py:32-34. ``step`` is an int or a tensor; for a train step's
    counter (a 0-d tensor on the model's device) the weight is computed
    there, without a host sync."""
    step = torch.as_tensor(step, dtype=torch.float32)
    return beta / (1.0 + torch.exp(-(step - loc) / scale))
