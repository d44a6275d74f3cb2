"""Latent-space helpers of the qualitative figures (counterpart of
``clearvae_tpu/utils/visual.py``; only ``interpolate_latent`` so far)."""

from __future__ import annotations

import torch


def interpolate_latent(latent1: torch.Tensor, latent2: torch.Tensor,
                       num_steps: int) -> torch.Tensor:
    """Linear interpolation matrix [num_steps, z] (reference
    display_utils.py:11-21: p runs 1→0 so row 0 is latent1)."""
    p = torch.linspace(1.0, 0.0, num_steps, dtype=latent1.dtype,
                       device=latent1.device)[:, None]
    return p * latent1[None, :] + (1 - p) * latent2[None, :]
