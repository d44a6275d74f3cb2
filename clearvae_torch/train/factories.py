"""Trainer factories (counterpart of ``clearvae_tpu/train/factories.py``;
reference code/src/utils/trainer_utils.py:21-201), with the JAX signatures
plus ``device`` (default ``cuda``). Each seeds its models' init with
``seed`` and leaves the global generator's state as it was.

The CLEAR, CLEAR-TC and CLEAR-MIM factories also take ``hyperparameter``,
keys added to the trainer's dict; ``{"fused": True}`` routes the latent
losses through the CUDA kernels (K1 for CLEAR; K2f forward and K2b backward
of c_loss for CLEAR-TC and CLEAR-MIM). ``trainer_from_config`` builds one
of them from a typed ``config.ClearVAEConfig``. ``vae_arch`` / ``cnn_arch``
name any architecture of ``registry.MODELS`` (``"VAE64"``,
``"SimpleCNN64Classifier"``, ``"LAMCNN64Classifier"`` for the 64×64
pipelines, with ``in_channel``), and ``vae_kwargs`` goes to the VAE, e.g.
the perf mode's ``{"dtype": torch.bfloat16, "fused_heads": True}``.

Adam is ``trainers.adam``: ``fused`` and ``capturable`` on a CUDA device,
so that one optimizer serves the eager step and the captured one (``fit``'s
default) with the same kernels; torch's default Adam on the CPU.

``mesh`` (``parallel.mesh.make_mesh`` or ``parallel.tp.make_mesh2d``)
goes to every trainer, as in the JAX factories, whatever the architecture;
the device is then the rank's (``parallel.mesh.mesh_device``) unless
``device`` is given.
"""

from __future__ import annotations


import torch

from clearvae_torch import resolve_device
from clearvae_torch.models.factor import FactorCls
from clearvae_torch.models.mi_estimators import MI_ESTIMATORS
from clearvae_torch.registry import MODELS
from clearvae_torch.train.trainers import (CLEARVAETrainer, ClearMIMVAETrainer,
                                           ClearTCVAETrainer,
                                           HierarchicalVAETrainer,
                                           LAMCNNTrainer, SimpleCNNTrainer,
                                           adam)


def _seeded(seed: int, build):
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        return build()


def _adam(lr: float, device, mesh=None):
    if device is None and mesh is not None:
        from clearvae_torch.parallel.mesh import mesh_device

        device = mesh_device(mesh)
    return adam(lr, resolve_device(device))


def get_cnn_trainer(n_class, cnn_arch: str = "SimpleCNNClassifier",
                    in_channel: int = 1, verbose_period: int = 5,
                    seed: int = 0, device=None, mesh=None,
                    **_) -> SimpleCNNTrainer:
    """reference trainer_utils.py:21-34 (Adam lr 1e-4)."""
    cnn = _seeded(seed, lambda: MODELS[cnn_arch](n_class=n_class,
                                                 in_channel=in_channel))
    return SimpleCNNTrainer(cnn, _adam(1e-4, device, mesh), verbose_period,
                            seed, device, mesh)


def get_lamcnn_trainer(n_class, lam_coef, cnn_arch: str = "LAMCNNClassifier",
                       in_channel: int = 1, verbose_period: int = 5,
                       seed: int = 0, device=None, mesh=None,
                       **_) -> LAMCNNTrainer:
    """reference trainer_utils.py:37-56 (Adam lr 1e-4)."""
    cnn = _seeded(seed, lambda: MODELS[cnn_arch](n_class=n_class,
                                                 in_channel=in_channel))
    return LAMCNNTrainer(cnn, _adam(1e-4, device, mesh),
                         {"lam_coef": lam_coef}, verbose_period, seed, device,
                         mesh)


def get_hierarchical_vae_trainer(beta, vae_lr, z_dim, group_mode,
                                 vae_arch: str = "VAE", in_channel: int = 1,
                                 verbose_period: int = 5, seed: int = 0,
                                 n_classes: int = 10,
                                 vae_kwargs: dict | None = None,
                                 mig_backend: str = "auto", device=None,
                                 mesh=None, **_) -> HierarchicalVAETrainer:
    """reference trainer_utils.py:59-84."""
    vae = _seeded(seed, lambda: MODELS[vae_arch](
        total_z_dim=z_dim, in_channel=in_channel, group_mode=group_mode,
        n_classes=n_classes, **(vae_kwargs or {})))
    return HierarchicalVAETrainer(
        vae, _adam(vae_lr, device, mesh),
        hyperparameter={"beta": beta, "scale": 1, "loc": 0},
        verbose_period=verbose_period, seed=seed, mig_backend=mig_backend,
        device=device, mesh=mesh)


def get_clearvae_trainer(beta, ps, vae_lr, z_dim, alpha, temperature,
                         vae_arch: str = "VAE", in_channel: int = 1,
                         verbose_period: int = 5, seed: int = 0,
                         sim_fn: str = "cosine",
                         vae_kwargs: dict | None = None,
                         mig_backend: str = "auto",
                         hyperparameter: dict | None = None,
                         device=None, mesh=None, **_) -> CLEARVAETrainer:
    """reference trainer_utils.py:87-116, Adam(``vae_lr``)."""
    vae = _seeded(seed, lambda: MODELS[vae_arch](
        total_z_dim=z_dim, in_channel=in_channel, **(vae_kwargs or {})))
    hp = {"temperature": temperature, "alpha": alpha, "beta": beta, "ps": ps,
          "loc": 0, "scale": 1, **(hyperparameter or {})}
    return CLEARVAETrainer(
        vae, _adam(vae_lr, device, mesh), sim_fn=sim_fn, hyperparameter=hp,
        verbose_period=verbose_period, seed=seed, mig_backend=mig_backend,
        device=device, mesh=mesh)


def get_cleartcvae_trainer(beta, la, vae_lr, factor_cls_lr, z_dim, alpha,
                           temperature, vae_arch: str = "VAE",
                           in_channel: int = 1, verbose_period: int = 5,
                           seed: int = 0, vae_kwargs: dict | None = None,
                           mig_backend: str = "auto",
                           hyperparameter: dict | None = None,
                           device=None, mesh=None, **_) -> ClearTCVAETrainer:
    """reference trainer_utils.py:119-157."""
    vae, factor_cls = _seeded(seed, lambda: (
        MODELS[vae_arch](total_z_dim=z_dim, in_channel=in_channel,
                         **(vae_kwargs or {})),
        FactorCls(z_dim=z_dim)))
    hp = {"temperature": temperature, "alpha": alpha, "beta": beta, "loc": 0,
          "scale": 1, "lambda": la, **(hyperparameter or {})}
    return ClearTCVAETrainer(
        vae, factor_cls,
        optimizers={"vae_optim": _adam(vae_lr, device, mesh),
                    "factor_optim": _adam(factor_cls_lr, device, mesh)},
        sim_fn="cosine", hyperparameter=hp, verbose_period=verbose_period,
        seed=seed, mig_backend=mig_backend, device=device, mesh=mesh)


def get_clearmimvae_trainer(beta, mi_estimator: str, la, vae_lr,
                            mi_estimator_lr, z_dim, alpha, temperature,
                            vae_arch: str = "VAE", in_channel: int = 1,
                            verbose_period: int = 5, seed: int = 0,
                            vae_kwargs: dict | None = None,
                            mig_backend: str = "auto",
                            hyperparameter: dict | None = None,
                            device=None, mesh=None,
                            **_) -> ClearMIMVAETrainer:
    """reference trainer_utils.py:160-201 (estimator sized
    x_dim=y_dim=z_dim//2, hidden=z_dim)."""
    vae, est = _seeded(seed, lambda: (
        MODELS[vae_arch](total_z_dim=z_dim, in_channel=in_channel,
                         **(vae_kwargs or {})),
        MI_ESTIMATORS[mi_estimator](x_dim=z_dim // 2, y_dim=z_dim // 2,
                                    hidden_size=z_dim)))
    hp = {"temperature": temperature, "beta": beta, "loc": 0, "scale": 1,
          "alpha": alpha, "lambda": la, **(hyperparameter or {})}
    return ClearMIMVAETrainer(
        vae, est,
        optimizers={"vae_optim": _adam(vae_lr, device, mesh),
                    "mi_estimator_optim": _adam(mi_estimator_lr, device, mesh)},
        sim_fn="cosine", hyperparameter=hp, verbose_period=verbose_period,
        seed=seed, mig_backend=mig_backend, device=device, mesh=mesh)


def trainer_from_config(cfg, device=None):
    """A trainer from a typed ``ClearVAEConfig``
    (``clearvae_tpu/train/factories.py:122-151``), dispatched on its
    sections in the JAX order: ``model.group_mode`` → GVAE/ML-VAE, ``tc`` →
    CLEAR-TC, ``mim`` → CLEAR-MIM, else plain CLEAR. Like the JAX function
    it does not pass ``contrastive.fused`` on: the trainer is unfused."""
    common = dict(
        beta=cfg.anneal.beta, vae_lr=cfg.optim.lr,
        z_dim=cfg.model.total_z_dim, alpha=cfg.contrastive.alpha,
        temperature=cfg.contrastive.temperature,
        vae_arch="VAE" if cfg.model.arch == "vae28" else "VAE64",
        in_channel=cfg.model.in_channel, seed=cfg.train.seed,
        verbose_period=cfg.train.verbose_period,
        sim_fn=cfg.contrastive.sim_fn, device=device,
    )
    if cfg.model.group_mode:
        for k in ("alpha", "temperature", "sim_fn"):
            common.pop(k)
        return get_hierarchical_vae_trainer(group_mode=cfg.model.group_mode,
                                            n_classes=cfg.train.n_classes,
                                            **common)
    if cfg.tc is not None:
        common.pop("sim_fn")
        return get_cleartcvae_trainer(la=cfg.tc.la,
                                      factor_cls_lr=cfg.tc.factor_cls_lr,
                                      **common)
    if cfg.mim is not None:
        common.pop("sim_fn")
        return get_clearmimvae_trainer(mi_estimator=cfg.mim.estimator,
                                       la=cfg.mim.la,
                                       mi_estimator_lr=cfg.mim.mi_estimator_lr,
                                       **common)
    return get_clearvae_trainer(ps=cfg.contrastive.ps, **common)
