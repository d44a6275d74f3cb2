"""Trainers (counterpart of ``clearvae_tpu/train/trainers.py``; reference
code/src/trainer.py:41-570).

The dataset stays resident on the trainer's device; each batch is gathered
by index, in the JAX package's order: epoch e is shuffled by
``np.random.RandomState(seed + e)`` and its ragged tail dropped
(trainers.py:199-202). With ``style_on_device`` only the raw images stay
resident and each batch is styled on the device inside the loop (K3 for the
deterministic styles). Every random draw of a step (reparameterization
noise, CLUBSample's permutation, the MIM estimator's inner noise) comes from
one ``torch.Generator`` seeded from ``seed``. ``fit`` returns the loss
histories where the JAX package's does (CLEAR-TC: ``factor_d_losses``;
CLEAR-MIM: ``(mi_losses, mi_learning_losses)``). ``fit(use_scan=True)``
replays the train step as one captured CUDA graph a batch; checkpoints hold
the whole trainer state, the noise generator's included, so that a resumed
``fit(start_epoch=k)`` reproduces the uninterrupted run. Meshes are not
ported.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from clearvae_torch import config as C
from clearvae_torch import resolve_device
from clearvae_torch.models.factor import FactorCls
from clearvae_torch.models.mlp import ProbeMLP
from clearvae_torch.ops import metrics as MT
from clearvae_torch.train import steps as S


class TrainerCore:
    """Device, noise generator, checkpoints and the fit loop shared by every
    trainer (reference Trainer base, trainer.py:41-75).

    ``MODULES`` and ``OPTIMIZERS`` name the attributes that a checkpoint
    holds beside the train step's counter and the noise generator."""

    MODULES = ("model",)
    OPTIMIZERS = ("optimizer",)

    def __init__(self, model, verbose_period: int = 5, seed: int = 0,
                 device=None):
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.verbose_period = verbose_period
        self.seed = seed
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        # one entry per epoch: {metric: np.ndarray [n_batches]}
        self.history: list[dict] = []
        # captured train steps, keyed by (dataset, batch size, styled)
        self._graphs: dict = {}

    def _randn(self, shape, out=None):
        if out is None:
            return torch.randn(shape, generator=self.generator,
                               device=self.device)
        return torch.randn(shape, generator=self.generator, out=out)

    def _draw_eps(self, n: int, out=None):
        """[eps_c, eps_s] for a batch of n, one [2, n, z] draw (z_c's noise
        first); into ``out`` when given."""
        return self._randn((2, n, self.model.z_dim), out)

    def _train_noise(self, n: int, out=None):
        """The draws one train step of a batch of n takes; into the tensors
        of ``out`` (what an earlier call returned) when given. A replaced
        ``_draw_eps`` may take ``n`` alone, so ``out`` goes only where
        given."""
        return self._draw_eps(n) if out is None else self._draw_eps(n, out)

    def _eval_noise(self, n: int):
        """The draws one eval step of a batch of n takes."""
        return self._draw_eps(n)

    def _device_data(self, ds):
        """(x [N, H, W, C] float32 in [0, 1], labels int64), on the device."""
        if hasattr(ds, "materialize"):  # StyledDataset: styled on the device
            x = ds.materialize(self.device)[..., None]
        else:
            x = torch.as_tensor(np.asarray(ds.images), dtype=torch.float32,
                                device=self.device)
        labels = torch.as_tensor(np.asarray(ds.labels), dtype=torch.int64,
                                 device=self.device)
        return x, labels

    def _labels(self, ds) -> torch.Tensor:
        return torch.as_tensor(np.asarray(ds.labels), dtype=torch.int64,
                               device=self.device)

    def _style_arrays(self, ds):
        """(raw images, style_idx, draws) of a StyledDataset on the device."""
        if not hasattr(ds, "device_arrays"):
            raise ValueError("style_on_device requires a StyledDataset "
                             f"(raw images + style_idx); got "
                             f"{type(ds).__name__}")
        return ds.device_arrays(self.device)

    def _epoch_runner(self, ds, step, style_on_device: bool, draw_noise):
        """``run(batch_idx [n, B]) -> [n per-batch outputs]`` of ``step`` over
        ``ds`` on the device, each batch with the draws of ``draw_noise``:
        gathered from the materialized dataset, or, with ``style_on_device``
        (StyledDataset only), from the raw images and styled per batch."""
        labels = self._labels(ds)
        if style_on_device:
            raw, sidx, draws = self._style_arrays(ds)
            fn = S.make_styled_epoch_fn(step, ds.style)
            return lambda bi: fn(raw, labels, sidx, draws, bi, draw_noise)
        data, _ = self._device_data(ds)
        fn = S.make_epoch_fn(step)
        return lambda bi: fn(data, labels, bi, draw_noise)

    def _graphed_runner(self, ds, batch_size: int, style_on_device: bool):
        """``run(batch_idx [n, B]) -> {metric: [n]}`` through the captured
        train step of ``S.make_graphed_epoch_fn``, one per (dataset, B,
        styling), made at first use. The entry keeps the dataset and its
        resident arrays alive, so the key cannot name another one."""
        key = (id(ds), batch_size, style_on_device)
        if key not in self._graphs:
            labels = self._labels(ds)
            if style_on_device:
                ep = S.make_graphed_epoch_fn(
                    self.train_step, None, labels, batch_size,
                    self._train_noise, styler=ds.style,
                    style_arrays=self._style_arrays(ds))
            else:
                data, _ = self._device_data(ds)
                ep = S.make_graphed_epoch_fn(self.train_step, data, labels,
                                             batch_size, self._train_noise)
            self._graphs[key] = (ds, ep)
        ep = self._graphs[key][1]

        def run(batch_idx):
            hist = ep.run(batch_idx).cpu().numpy()
            return {k: hist[:, j] for j, k in enumerate(ep.keys)}

        return run

    def fit(self, epochs: int, train_ds, valid_ds=None, batch_size: int = 128,
            use_scan: bool = False, checkpoint_dir: str | None = None,
            checkpoint_every: int = 10, logger=None,
            style_on_device: bool = False, start_epoch: int = 0):
        """Train for ``epochs`` epochs from ``start_epoch``, which keys the
        shuffles. Per-epoch metric arrays are appended to ``self.history``.

        ``use_scan=True`` runs each batch as one replay of the train step
        captured in a CUDA graph (``S.make_graphed_epoch_fn``): the same
        updates from the same noise, one dispatch a step. The default is
        the eager loop, where the JAX package turns its scan on by default:
        moving it would move the downstream runner and the sweep onto the
        graph too, a change of its own.

        With ``checkpoint_dir`` the trainer state is saved every
        ``checkpoint_every`` epochs and at the end; with ``logger``
        (``utils.logging.MetricLogger``) each epoch's last metrics and its
        images/sec are logged under the tag "train". A checkpoint holds the
        noise generator's state, so ``restore_checkpoint`` and then
        ``fit(start_epoch=k)`` reproduce the run that saved it.

        ``style_on_device`` (StyledDataset only) keeps only the raw images
        on the device and styles each batch there, keyed by (dataset seed,
        absolute sample id): the same pixels as the materialized path.
        In-fit validation then styles its batches the same way. Returns
        ``_fit_result()``: None here, the loss histories in CLEAR-TC and
        CLEAR-MIM."""
        n = len(train_ds)
        batch_size = min(batch_size, n)  # tiny split: shrink, don't drop all
        n_batches = n // batch_size
        if use_scan:
            run = self._graphed_runner(train_ds, batch_size, style_on_device)
        else:
            eager = self._epoch_runner(train_ds, self.train_step,
                                       style_on_device, self._train_noise)

            def run(batch_idx):
                ms = eager(batch_idx)
                return {k: torch.stack([m[k] for m in ms]).cpu().numpy()
                        for k in ms[0]}

        end_epoch = start_epoch + epochs
        for epoch in range(start_epoch, end_epoch):
            t0 = time.perf_counter()
            perm = np.random.RandomState(self.seed + epoch).permutation(n)
            self.history.append(run(torch.as_tensor(
                perm[: n_batches * batch_size].reshape(n_batches, batch_size),
                device=self.device)))
            self._post_train_epoch(self.history[-1])
            if logger is not None:
                dt = time.perf_counter() - t0
                logger.log("train", step=self.train_step.step, epoch=epoch,
                           images_per_sec=n / dt if dt > 0 else 0,
                           **{k: float(v[-1])
                              for k, v in self.history[-1].items()})
            if epoch % self.verbose_period == 0:
                last = {k: round(float(v[-1]), 3)
                        for k, v in self.history[-1].items()}
                print(f"epoch {epoch}: {last}")
                if valid_ds is not None:
                    self._verbose_valid(
                        valid_ds, batch_size,
                        style_on_device=(style_on_device
                                         and hasattr(valid_ds, "device_arrays")))
            if checkpoint_dir and ((epoch + 1) % checkpoint_every == 0
                                   or epoch + 1 == end_epoch):
                self.save_checkpoint(checkpoint_dir, {"epoch": epoch})
        return self._fit_result()

    # -- checkpoints ---------------------------------------------------------

    def state_dict(self) -> dict:
        """The whole trainer state: each module's and optimizer's state
        dict, the train step's update count and the noise generator's
        state."""
        return {"modules": {m: getattr(self, m).state_dict()
                            for m in self.MODULES},
                "optimizers": {o: getattr(self, o).state_dict()
                               for o in self.OPTIMIZERS},
                "step": self.train_step.count.detach().cpu().clone(),
                "generator": self.generator.get_state()}

    def load_state_dict(self, state: dict) -> None:
        """Load ``state_dict()``'s dict into this trainer. Parameters,
        buffers and the update count are copied in place; the optimizers'
        state tensors are replaced, so the captured train steps, which point
        at them, are dropped and the next graphed ``fit`` captures anew."""
        for m in self.MODULES:
            getattr(self, m).load_state_dict(state["modules"][m])
        for o in self.OPTIMIZERS:
            getattr(self, o).load_state_dict(state["optimizers"][o])
        self.train_step.count.copy_(state["step"])
        self.generator.set_state(state["generator"])
        self._graphs.clear()

    def save_checkpoint(self, directory: str, metadata: dict | None = None):
        """``utils.checkpoint.save_checkpoint`` of ``state_dict()`` at the
        current update count; returns its path."""
        from clearvae_torch.utils.checkpoint import save_checkpoint

        return save_checkpoint(directory, self.state_dict(),
                               step=self.train_step.step, metadata=metadata)

    def restore_checkpoint(self, directory_or_path: str) -> dict:
        """Load the latest checkpoint of a directory (or the given one)."""
        from clearvae_torch.utils.checkpoint import (latest_checkpoint,
                                                     restore_checkpoint)

        path = directory_or_path
        if os.path.isdir(path):
            path = latest_checkpoint(path)
        state = restore_checkpoint(path)
        self.load_state_dict(state)
        return state

    def _post_train_epoch(self, history: dict):
        """Called with each epoch's {metric: [n_batches]} arrays."""

    def _fit_result(self):
        return None

    def _verbose_valid(self, valid_ds, batch_size, style_on_device=False):
        raise NotImplementedError


class VAETrainerBase(TrainerCore):
    """gMIG/MSE evaluation on sampled latents (reference VAETrainer,
    trainer.py:78-92)."""

    def __init__(self, model, verbose_period: int = 5, seed: int = 0,
                 mig_backend: str = "auto", device=None):
        super().__init__(model, verbose_period, seed, device)
        self.mig_backend = MT.resolve_backend(mig_backend)

    def _verbose_valid(self, valid_ds, batch_size, style_on_device=False):
        mig, mse = self.evaluate(valid_ds, batch_size=batch_size,
                                 style_on_device=style_on_device)
        print(f"gMIG: {round(mig, 3)}; mse: {round(float(mse), 3)}")

    @torch.no_grad()
    def evaluate(self, ds, batch_size: int = 128, style_on_device: bool = False):
        """(gMIG, reconstruction MSE) over the dataset in eval mode
        (reference evaluate, trainer.py:495-570): the full batches, then the
        ragged tail by one direct call; MSE is the mean of the per-batch
        means. ``style_on_device`` styles each batch on the device from the
        raw images, as ``fit`` does."""
        run = self._epoch_runner(ds, self.eval_step, style_on_device,
                                 self._eval_noise)
        n = len(ds)
        bs = min(batch_size, n)
        nb = n // bs
        outs = run(torch.arange(nb * bs, device=self.device).view(nb, bs))
        if n > nb * bs:
            outs += run(torch.arange(nb * bs, n, device=self.device)[None])
        totals = {k: sum(o[k] for o in outs) for k, v in outs[0].items()
                  if v.ndim == 0}
        self.last_eval_totals = {k: float(v) / len(outs)
                                 for k, v in totals.items()}
        z_c = torch.cat([o["z_c"] for o in outs])
        z_s = torch.cat([o["z_s"] for o in outs])
        mig = MT.mutual_info_gap(self._labels(ds), z_c, z_s,
                                 backend=self.mig_backend)
        return mig, self.last_eval_totals["recon"]


def _anneal_cfg(hp: dict) -> C.AnnealConfig:
    return C.AnnealConfig(beta=hp["beta"], loc=hp.get("loc", 0.0),
                          scale=hp.get("scale", 1.0))


def _adversarial_contrastive_cfg(hp: dict, sim_fn: str) -> C.ContrastiveConfig:
    """The TC/MIM trainers' c_loss config: the JAX package's (sim_fn, α, τ;
    unfused), with ``hp["fused"]`` choosing the K2f/K2b route."""
    return C.ContrastiveConfig(alpha=hp["alpha"], temperature=hp["temperature"],
                               sim_fn=sim_fn, fused=hp.get("fused", False))


class CLEARVAETrainer(VAETrainerBase):
    """The core method (reference CLEARVAETrainer, trainer.py:415-570).

    ``optimizer`` builds the optimizer from the model's parameters, e.g.
    ``functools.partial(torch.optim.Adam, lr=5e-4)`` (torch's Adam update
    equals optax.adam's). ``hyperparameter={"fused": True}`` routes the
    latent losses through the CUDA kernels.
    """

    def __init__(self, model, optimizer, sim_fn: str, hyperparameter: dict,
                 verbose_period: int = 5, seed: int = 0,
                 mig_backend: str = "auto", device=None):
        super().__init__(model, verbose_period, seed, mig_backend, device)
        self.optimizer = optimizer(self.model.parameters())
        self.hp = hyperparameter
        anneal = _anneal_cfg(hyperparameter)
        contr = C.ContrastiveConfig(
            alpha=hyperparameter["alpha"],
            temperature=hyperparameter["temperature"],
            sim_fn=sim_fn, ps=hyperparameter.get("ps", True),
            loss_name=hyperparameter.get("loss_name", "snn"),
            fused=hyperparameter.get("fused", False))
        self.anneal_cfg, self.contr_cfg = anneal, contr
        self.train_step = S.make_clear_vae_step(self.model, self.optimizer,
                                                anneal, contr)
        self.eval_step = S.make_clear_vae_eval_step(self.model, contr)


class HierarchicalVAETrainer(VAETrainerBase):
    """GVAE / ML-VAE (reference HierarchicalVAETrainer, trainer.py:291-412).
    ``evaluate(with_evidence_acc=True)`` evaluates on the batch's group
    evidence."""

    def __init__(self, model, optimizer, hyperparameter: dict,
                 verbose_period: int = 5, seed: int = 0,
                 mig_backend: str = "auto", device=None):
        super().__init__(model, verbose_period, seed, mig_backend, device)
        self.optimizer = optimizer(self.model.parameters())
        self.train_step = S.make_hierarchical_step(
            self.model, self.optimizer, _anneal_cfg(hyperparameter))
        self._eval_steps = {flag: S.make_hierarchical_eval_step(self.model, flag)
                            for flag in (False, True)}
        self.eval_step = self._eval_steps[False]

    def evaluate(self, ds, batch_size: int = 128,
                 with_evidence_acc: bool | None = None,
                 style_on_device: bool = False):
        """(reference evaluate(..., with_evidence_acc), trainer.py:366-412).
        ``None`` keeps the trainer's eval step, plain by default."""
        prev = self.eval_step
        if with_evidence_acc is not None:
            self.eval_step = self._eval_steps[with_evidence_acc]
        try:
            return super().evaluate(ds, batch_size,
                                    style_on_device=style_on_device)
        finally:
            self.eval_step = prev


class ClearTCVAETrainer(VAETrainerBase):
    """CLEAR-TC (reference ClearTCVAETrainer, trainer.py:590-778).
    ``optimizers`` = {"vae_optim", "factor_optim"}, each building an
    optimizer from its module's parameters. ``fit`` returns
    ``factor_d_losses``, one per train step since construction."""

    MODULES = ("model", "factor_cls")
    OPTIMIZERS = ("optimizer", "factor_optimizer")

    def __init__(self, model, factor_cls: FactorCls, optimizers: dict,
                 sim_fn: str, hyperparameter: dict, verbose_period: int = 5,
                 seed: int = 0, mig_backend: str = "auto", device=None):
        super().__init__(model, verbose_period, seed, mig_backend, device)
        self.factor_cls = factor_cls.to(self.device)
        self.optimizer = optimizers["vae_optim"](self.model.parameters())
        self.factor_optimizer = optimizers["factor_optim"](
            self.factor_cls.parameters())
        self.hp = hyperparameter
        contr = _adversarial_contrastive_cfg(hyperparameter, sim_fn)
        self.contr_cfg = contr
        self.train_step = S.make_clear_tc_step(
            self.model, self.factor_cls, self.optimizer, self.factor_optimizer,
            _anneal_cfg(hyperparameter), contr,
            C.TCConfig(la=hyperparameter["lambda"]))
        self.eval_step = S.make_clear_tc_eval_step(self.model, self.factor_cls,
                                                   contr)
        self.factor_d_losses: list = []

    def _train_noise(self, n: int, out=None):
        if out is None:
            return self._draw_eps(n), self._draw_eps(n)
        return self._draw_eps(n, out[0]), self._draw_eps(n, out[1])

    def _post_train_epoch(self, history: dict):
        self.factor_d_losses.extend(history["factor_d_loss"].tolist())

    def _fit_result(self):
        return self.factor_d_losses


class ClearMIMVAETrainer(VAETrainerBase):
    """CLEAR-MIM (reference ClearMIMVAETrainer, trainer.py:781-965).
    ``optimizers`` = {"vae_optim", "mi_estimator_optim"}. ``fit`` returns
    ``(mi_losses, mi_learning_losses)``."""

    MODULES = ("model", "mi_estimator")
    OPTIMIZERS = ("optimizer", "mi_optimizer")

    def __init__(self, model, mi_estimator, optimizers: dict, sim_fn: str,
                 hyperparameter: dict, verbose_period: int = 5, seed: int = 0,
                 mig_backend: str = "auto", device=None):
        super().__init__(model, verbose_period, seed, mig_backend, device)
        self.mi_estimator = mi_estimator.to(self.device)
        self.optimizer = optimizers["vae_optim"](self.model.parameters())
        self.mi_optimizer = optimizers["mi_estimator_optim"](
            self.mi_estimator.parameters())
        self.hp = hyperparameter
        contr = _adversarial_contrastive_cfg(hyperparameter, sim_fn)
        self.contr_cfg = contr
        self.mim_cfg = C.MIMConfig(
            la=hyperparameter["lambda"],
            reuse_phase1_encode=bool(
                hyperparameter.get("reuse_phase1_encode", False)))
        self.train_step = S.make_clear_mim_step(
            self.model, self.mi_estimator, self.optimizer, self.mi_optimizer,
            _anneal_cfg(hyperparameter), contr, self.mim_cfg)
        self.eval_step = S.make_clear_mim_eval_step(self.model,
                                                    self.mi_estimator, contr)
        self.mi_losses: list = []
        self.mi_learning_losses: list = []

    def _draw_perm(self, n: int, out=None):
        if not self.mi_estimator.uses_perm:
            return None
        if out is None:
            return torch.randperm(n, generator=self.generator,
                                  device=self.device)
        return torch.randperm(n, generator=self.generator, out=out)

    def _train_noise(self, n: int, out=None):
        if out is None:
            out = {"eps": None, "perm": None, "inner": None}
        inner = self._randn((self.mim_cfg.inner_steps, n,
                             self.model.total_z_dim), out["inner"])
        eps = (self._draw_eps(n) if out["eps"] is None
               else self._draw_eps(n, out["eps"]))
        return {"eps": eps, "perm": self._draw_perm(n, out["perm"]),
                "inner": inner}

    def _eval_noise(self, n: int):
        return {"eps": self._draw_eps(n), "perm": self._draw_perm(n)}

    def _post_train_epoch(self, history: dict):
        self.mi_losses.extend(history["mi_loss"].tolist())
        self.mi_learning_losses.extend(history["mi_learning_loss"].tolist())

    def _fit_result(self):
        return self.mi_losses, self.mi_learning_losses


class SimpleCNNTrainer(TrainerCore):
    """Plain cross-entropy classifier baseline (reference SimpleCNNTrainer,
    trainer.py:168-232). ``evaluate(style_on_device=True)`` styles each
    chunk on the device and classifies it in one pass (the probe's fused
    style→encode pattern)."""

    def __init__(self, model, optimizer, verbose_period: int = 5,
                 seed: int = 0, device=None):
        super().__init__(model, verbose_period, seed, device)
        self.optimizer = optimizer(self.model.parameters())
        self.train_step = S.make_cnn_step(self.model, self.optimizer)
        self.logits_fn = S.make_cnn_logits_fn(self.model)

    def _train_noise(self, n: int, out=None):
        return None

    def _verbose_valid(self, valid_ds, batch_size, style_on_device=False):
        (aupr, auroc), acc = self.evaluate(valid_ds, batch_size,
                                           style_on_device=style_on_device)
        print("val_aupr:", aupr, "val_auroc:", auroc, "val_acc:",
              round(acc, 3))

    def evaluate(self, ds, batch_size: int = 128,
                 style_on_device: bool = False):
        """((per-class AUPR, per-class AUROC), accuracy) — reference
        trainer.py:215-232."""
        y = self._labels(ds)
        if style_on_device:
            if not hasattr(ds, "chunked_apply"):
                raise ValueError(
                    "style_on_device requires a StyledDataset carrying raw "
                    f"images + style indices; got {type(ds).__name__}")
            logits = ds.chunked_apply(
                lambda raw, sidx, draws: self.logits_fn(
                    ds.style(raw, sidx, draws)[..., None]),
                self.device, batch_size)
        else:
            data, _ = self._device_data(ds)
            logits = torch.cat([self.logits_fn(data[s:s + batch_size])
                                for s in range(0, len(ds), batch_size)])
        return MT.auc(logits, y), MT.accuracy(logits, y)


class DownstreamMLPTrainer:
    """MLP probe on the frozen VAE's mu_c (reference DownstreamMLPTrainer,
    trainer.py:95-165; the JAX package's trainers.py:659-824), on the VAE
    trainer's device. The probe's init is seeded with ``seed``."""

    def __init__(self, vae_trainer: VAETrainerBase, n_class: int = 10,
                 lr: float = 3e-4, verbose_period: int = 10, seed: int = 0):
        self.vae_trainer = vae_trainer
        self.vae_model = vae_trainer.model
        self.device = vae_trainer.device
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            self.mlp = ProbeMLP(self.vae_model.z_dim, n_class).to(self.device)
        self.optimizer = torch.optim.Adam(self.mlp.parameters(), lr=lr)
        self.verbose_period = verbose_period
        self.train_step = S.make_probe_step(self.vae_model, self.mlp,
                                            self.optimizer)
        self.logits_fn = S.make_probe_logits_fn(self.vae_model, self.mlp)
        self._feat_epochs_fn = S.make_probe_feature_epochs_fn(self.mlp,
                                                              self.optimizer)
        self._feat_logits_fn = S.make_probe_feature_logits_fn(self.mlp)

    @torch.no_grad()
    def _encode(self, x):
        return self.vae_model.encode(x, train=False)[0]

    def _encode_all(self, ds, batch_size: int = 512,
                    style_on_device: bool = False):
        """(mu_c [N, z_c], labels [N]) on the device from one pass of the
        frozen eval-mode encoder. Eval-mode encode is deterministic, so this
        equals the reference's re-encoding of every batch every epoch
        (trainer.py:126).

        With ``style_on_device`` (StyledDataset only) each fixed-size chunk
        is styled on the device and encoded in one pass (fused style→encode),
        with the keys of ``materialize``: the same features, and no styled
        copy of the dataset."""
        labels = self.vae_trainer._labels(ds)
        if style_on_device:
            if not hasattr(ds, "chunked_apply"):
                raise ValueError(
                    "style_on_device requires a StyledDataset carrying raw "
                    f"images + style indices; got {type(ds).__name__}")
            feats = ds.chunked_apply(
                lambda raw, sidx, draws: self._encode(
                    ds.style(raw, sidx, draws)[..., None]),
                self.device, batch_size)
            return feats, labels
        data, _ = self.vae_trainer._device_data(ds)
        return torch.cat([self._encode(data[s:s + batch_size])
                          for s in range(0, len(ds), batch_size)]), labels

    def fit(self, epochs: int, train_ds, valid_ds=None, batch_size: int = 128,
            cache_features: bool = True, style_on_device: bool = False):
        """Train the probe. With ``cache_features`` (the default) the frozen
        encoder runs once and the probe trains on the cached mu_c; epoch e
        is shuffled by ``RandomState(e)``. Validation runs after epoch 0 and
        after every ``verbose_period``-th epoch."""
        if style_on_device and not cache_features:
            raise ValueError("style_on_device probe training requires "
                             "cache_features=True (the cached-feature path "
                             "is where the fused style+encode pass runs)")
        if cache_features:
            feats, labels = self._encode_all(train_ds,
                                             style_on_device=style_on_device)
            n = len(labels)
            bs = min(batch_size, n)
            nb = n // bs

            def _perm(epoch):
                return (np.random.RandomState(epoch).permutation(n)
                        [: nb * bs].reshape(nb, bs))

            # the first block is one epoch, so the evaluation points are the
            # per-epoch path's: after epoch 0, then every verbose_period-th
            block = (epochs if valid_ds is None
                     else max(1, int(self.verbose_period)))
            epoch = 0
            while epoch < epochs:
                e = 1 if (valid_ds is not None and epoch == 0) \
                    else min(block, epochs - epoch)
                bi = torch.as_tensor(np.stack([_perm(epoch + i)
                                               for i in range(e)]),
                                     device=self.device)
                self._feat_epochs_fn(feats, labels, bi)
                epoch += e
                if valid_ds is not None and (epoch - 1) % block == 0:
                    _, acc = self.evaluate(valid_ds, batch_size,
                                           style_on_device=style_on_device)
                    print(f"probe epoch {epoch - 1}: acc={round(acc, 3)}")
            return
        data, labels = self.vae_trainer._device_data(train_ds)
        n = len(train_ds)
        nb = n // batch_size
        for epoch in range(epochs):
            perm = np.random.RandomState(epoch).permutation(n)
            for idx in torch.as_tensor(perm[: nb * batch_size].reshape(
                    nb, batch_size), device=self.device):
                self.train_step(data[idx], labels[idx])
            if valid_ds is not None and (epoch % self.verbose_period) == 0:
                _, acc = self.evaluate(valid_ds, batch_size)
                print(f"probe epoch {epoch}: acc={round(acc, 3)}")

    def evaluate(self, ds, batch_size: int = 128,
                 style_on_device: bool = False):
        """((per-class AUPR, per-class AUROC), accuracy) of the probe on
        ``ds``."""
        if style_on_device:
            feats, y = self._encode_all(ds, style_on_device=True)
            logits = self._feat_logits_fn(feats)
        else:
            data, y = self.vae_trainer._device_data(ds)
            logits = torch.cat([self.logits_fn(data[s:s + batch_size])
                                for s in range(0, len(ds), batch_size)])
        return MT.auc(logits, y), MT.accuracy(logits, y)
