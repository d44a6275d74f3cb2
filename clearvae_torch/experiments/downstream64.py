"""The 64×64 model zoo of the CelebA, PACS, Camelyon17 and CheXpert
downstream experiments (counterpart of
``clearvae_tpu/experiments/downstream64.py``; reference
run_celeba_downstream_expr.py:120-181, run_pacs_downstream_expr.py:150-220,
run_camelyon17_downstream_expr.ipynb)."""

from __future__ import annotations

import torch

from clearvae_torch.train.factories import (get_clearmimvae_trainer,
                                            get_clearvae_trainer,
                                            get_cleartcvae_trainer,
                                            get_cnn_trainer,
                                            get_hierarchical_vae_trainer,
                                            get_lamcnn_trainer)

# the perf mode's VAE variant: bfloat16 conv stacks and fused latent heads
PERF_VAE_KWARGS = {"dtype": torch.bfloat16, "fused_heads": True}


def model_zoo64(n_class: int, trainer_kwargs: dict, seed: int,
                lam_coef: float | None = None,
                tc_temperature: float | None = None,
                in_channel: int = 3, perf_mode: bool = False,
                device=None) -> dict:
    """The 7-model zoo on VAE64 / SimpleCNN64 with the JAX entries' names,
    factories and kwargs; ``lam_coef`` adds the LAM-CNN entry (Camelyon17
    only), ``tc_temperature`` overrides τ for CLEAR-TC (the Camelyon17
    notebook's 0.1 against 0.3 elsewhere), ``in_channel`` = 1 for the
    grayscale pipeline (CheXpert). ``device`` reaches every entry (None:
    the factories' default, ``cuda``).

    ``perf_mode`` builds the VAE entries with ``PERF_VAE_KWARGS``: the same
    math with a different parameter layout and bfloat16 rounding, so the
    runners write its results to a separate ``*-perf`` file, never pooled
    with the default mode's."""
    dev = {} if device is None else {"device": device}
    common = dict(trainer_kwargs, **dev)
    if perf_mode:
        common["vae_kwargs"] = dict(PERF_VAE_KWARGS)
    hier = {"beta": common["beta"], "vae_lr": common["vae_lr"],
            "z_dim": common["z_dim"], "vae_arch": "VAE64",
            "in_channel": in_channel, "n_classes": n_class, "seed": seed,
            **({"vae_kwargs": common["vae_kwargs"]} if perf_mode else {}),
            **dev}
    tc_kwargs = dict(common)
    if tc_temperature is not None:
        tc_kwargs["temperature"] = tc_temperature
    zoo = {
        "baseline": (get_cnn_trainer,
                     {"n_class": n_class, "cnn_arch": "SimpleCNN64Classifier",
                      "in_channel": in_channel, "seed": seed, **dev}),
        "gvae": (get_hierarchical_vae_trainer, {**hier, "group_mode": "GVAE"}),
        "mlvae": (get_hierarchical_vae_trainer,
                  {**hier, "group_mode": "MLVAE"}),
        "clear": (get_clearvae_trainer,
                  {"ps": True, "vae_arch": "VAE64", "in_channel": in_channel,
                   "seed": seed, **common}),
        "clear-tc": (get_cleartcvae_trainer,
                     {"la": 1, "factor_cls_lr": 1e-4, "vae_arch": "VAE64",
                      "in_channel": in_channel, "seed": seed, **tc_kwargs}),
        "clear-mim (L1OutUB)": (get_clearmimvae_trainer,
                                {"mi_estimator": "L1OutUB", "la": 3,
                                 "mi_estimator_lr": 2e-3, "vae_arch": "VAE64",
                                 "in_channel": in_channel, "seed": seed,
                                 **common}),
        "clear-mim (CLUB-S)": (get_clearmimvae_trainer,
                               {"mi_estimator": "CLUBSample", "la": 3,
                                "mi_estimator_lr": 2e-3, "vae_arch": "VAE64",
                                "in_channel": in_channel, "seed": seed,
                                **common}),
    }
    if lam_coef is not None:
        zoo["lam-cnn"] = (get_lamcnn_trainer,
                          {"n_class": n_class, "lam_coef": lam_coef,
                           "cnn_arch": "LAMCNN64Classifier",
                           "in_channel": in_channel, "seed": seed, **dev})
    return zoo
