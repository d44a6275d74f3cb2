"""Trainer factories (counterpart of ``clearvae_tpu/train/factories.py``;
reference code/src/utils/trainer_utils.py:87-116), with the JAX signature
plus ``device``."""

from __future__ import annotations

import functools

import torch

from clearvae_torch.models.vae import VAE
from clearvae_torch.train.trainers import CLEARVAETrainer

MODELS = {"VAE": VAE}


def get_clearvae_trainer(beta, ps, vae_lr, z_dim, alpha, temperature,
                         vae_arch: str = "VAE", in_channel: int = 1,
                         verbose_period: int = 5, seed: int = 0,
                         sim_fn: str = "cosine",
                         vae_kwargs: dict | None = None,
                         mig_backend: str = "auto",
                         hyperparameter: dict | None = None,
                         device=None, **_) -> CLEARVAETrainer:
    """CLEAR-VAE trainer with Adam(``vae_lr``), on ``device`` (default
    ``cuda``). ``hyperparameter`` adds keys to the trainer's dict, e.g.
    ``{"fused": True}``. The model's init is seeded with ``seed``; the
    global generator's state is left as it was."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        vae = MODELS[vae_arch](total_z_dim=z_dim, in_channel=in_channel,
                               **(vae_kwargs or {}))
    hp = {"temperature": temperature, "alpha": alpha, "beta": beta, "ps": ps,
          "loc": 0, "scale": 1, **(hyperparameter or {})}
    return CLEARVAETrainer(
        vae, functools.partial(torch.optim.Adam, lr=vae_lr), sim_fn=sim_fn,
        hyperparameter=hp, verbose_period=verbose_period, seed=seed,
        mig_backend=mig_backend, device=device)
