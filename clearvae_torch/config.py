"""Typed configuration objects (the same dataclasses and defaults as
``clearvae_tpu/config.py``, kept as a copy so this package never imports
the JAX one).

The reference passes hyperparameters as stringly-keyed dicts and resolves
architectures with ``eval`` (reference: code/src/utils/trainer_utils.py:28,45,
69,99,132,174-175). Here every knob is a typed dataclass field carrying the
reference default values (reference: code/run_styledmnist_downstream_expr.py:231-238).
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class AnnealConfig:
    """Logistic KL-annealing schedule (reference: code/src/trainer.py:22-38).

    weight(step) = beta / (1 + exp(-(step - loc) / scale)), stepped per batch.
    """

    beta: float = 1.0 / 8
    loc: float = 0.0
    scale: float = 1.0


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """VAE architecture knobs (reference: code/src/models/vae.py:7-156).

    ``arch``: "vae28" (28x28, reference ``VAE``) or "vae64" (64x64, ``VAE64``).
    ``total_z_dim`` is split in half: content z_c and style z_s.
    """

    arch: str = "vae28"
    total_z_dim: int = 16
    in_channel: int = 1
    group_mode: Optional[str] = None  # None | "GVAE" | "MLVAE"

    @property
    def z_dim(self) -> int:
        return self.total_z_dim // 2

    @property
    def image_size(self) -> int:
        return {"vae28": 28, "vae64": 64}[self.arch]


@dataclasses.dataclass(frozen=True)
class ContrastiveConfig:
    """CLEAR contrastive/anti-contrastive regularizer knobs
    (reference: code/src/trainer.py:441-480)."""

    alpha: float = 1e2
    temperature: float = 0.1
    sim_fn: str = "cosine"  # cosine | l2 | modified_l2 | jeffrey | mahalanobis
    loss_name: str = "snn"  # snn | supcon_in | supcon_out
    ps: bool = True  # True: PS-SNN anti-contrastive on z_s; False: negated SNN
    # Use the hand-written CUDA kernels of ops/kernels/fused_loss.py
    # (cosine/snn only). Default stays False, as in the JAX package; whether
    # the port should flip it is for an H100 measurement to decide.
    fused: bool = False


@dataclasses.dataclass(frozen=True)
class TCConfig:
    """CLEAR-TC density-ratio TC penalty (reference: code/src/trainer.py:590-709)."""

    la: float = 1.0  # lambda weight on the TC term
    factor_cls_lr: float = 1e-4
    shuffle_strategy: str = "permute_1"


@dataclasses.dataclass(frozen=True)
class MIMConfig:
    """CLEAR-MIM MI-upper-bound penalty (reference: code/src/trainer.py:781-897)."""

    estimator: str = "club_sample"  # club | club_mean | club_sample | l1out | var_ub | infonce
    la: float = 3.0
    mi_estimator_lr: float = 2e-3
    inner_steps: int = 5  # estimator updates per batch (reference: trainer.py:874)
    # opt-in perf deviation: train the estimator on the phase-1 (pre-VAE-
    # update) latents instead of re-encoding with updated params — saves one
    # encoder forward per step at one-step-stale estimator targets
    # (reference re-encodes: trainer.py:874-888). A/B in BASELINE.md.
    reuse_phase1_encode: bool = False


@dataclasses.dataclass(frozen=True)
class OptimConfig:
    lr: float = 5e-4  # Adam (reference: trainer_utils.py:100)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    batch_size: int = 128
    epochs: int = 41
    seed: int = 0
    verbose_period: int = 5
    n_classes: int = 10


@dataclasses.dataclass(frozen=True)
class ClearVAEConfig:
    """Everything needed to build a CLEAR-VAE trainer with reference defaults."""

    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    anneal: AnnealConfig = dataclasses.field(default_factory=AnnealConfig)
    contrastive: ContrastiveConfig = dataclasses.field(default_factory=ContrastiveConfig)
    optim: OptimConfig = dataclasses.field(default_factory=OptimConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    tc: Optional[TCConfig] = None
    mim: Optional[MIMConfig] = None
