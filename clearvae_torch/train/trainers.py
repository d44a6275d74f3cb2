"""Trainers (counterpart of ``clearvae_tpu/train/trainers.py``; reference
code/src/trainer.py:41-570).

The dataset stays resident on the trainer's device; each batch is gathered
by index, in the JAX package's order: epoch e is shuffled by
``np.random.RandomState(seed + e)`` and its ragged tail dropped
(trainers.py:199-202). Reparameterization noise comes from one
``torch.Generator`` seeded from ``seed``. Checkpoints, the metric logger,
device-side styling inside the step, multi-epoch dispatch and meshes are not
ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from clearvae_torch import config as C
from clearvae_torch import resolve_device
from clearvae_torch.ops import metrics as MT
from clearvae_torch.train import steps as S


class TrainerCore:
    """Device, noise generator and the fit loop shared by every trainer
    (reference Trainer base, trainer.py:41-75)."""

    def __init__(self, model, verbose_period: int = 5, seed: int = 0,
                 device=None):
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.verbose_period = verbose_period
        self.seed = seed
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        # one entry per epoch: {metric: np.ndarray [n_batches]}
        self.history: list[dict] = []

    def _draw_eps(self, n: int):
        """(eps_c, eps_s) for a batch of n: z_c's noise first."""
        return torch.randn((2, n, self.model.z_dim), generator=self.generator,
                           device=self.device).unbind(0)

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

    def fit(self, epochs: int, train_ds, valid_ds=None, batch_size: int = 128,
            start_epoch: int = 0):
        """Train for ``epochs`` epochs from ``start_epoch`` (which keys the
        shuffles; the noise generator continues from its current state).
        Per-epoch metric arrays are appended to ``self.history``."""
        data, labels = self._device_data(train_ds)
        n = len(train_ds)
        batch_size = min(batch_size, n)  # tiny split: shrink, don't drop all
        n_batches = n // batch_size
        for epoch in range(start_epoch, start_epoch + epochs):
            perm = np.random.RandomState(self.seed + epoch).permutation(n)
            batch_idx = torch.as_tensor(
                perm[: n_batches * batch_size].reshape(n_batches, batch_size),
                device=self.device)
            ms = [self.train_step(data[idx], labels[idx],
                                  self._draw_eps(batch_size))
                  for idx in batch_idx]
            self.history.append({k: torch.stack([m[k] for m in ms]).cpu().numpy()
                                 for k in ms[0]})
            if epoch % self.verbose_period == 0:
                last = {k: round(float(v[-1]), 3)
                        for k, v in self.history[-1].items()}
                print(f"epoch {epoch}: {last}")
                if valid_ds is not None:
                    mig, mse = self.evaluate(valid_ds, batch_size=batch_size)
                    print(f"gMIG: {round(mig, 3)}; mse: {round(float(mse), 3)}")


class VAETrainerBase(TrainerCore):
    """gMIG/MSE evaluation on sampled latents (reference VAETrainer,
    trainer.py:78-92)."""

    def __init__(self, model, verbose_period: int = 5, seed: int = 0,
                 mig_backend: str = "auto", device=None):
        super().__init__(model, verbose_period, seed, device)
        self.mig_backend = "numpy" if mig_backend == "auto" else mig_backend

    @torch.no_grad()
    def evaluate(self, ds, batch_size: int = 128):
        """(gMIG, reconstruction MSE) over the dataset in eval mode
        (reference evaluate, trainer.py:495-570). The ragged tail is kept;
        MSE is the mean of the per-batch means."""
        data, labels = self._device_data(ds)
        n = len(ds)
        bs = min(batch_size, n)
        totals: dict = {}
        z_cs, z_ss = [], []
        n_batches = 0
        for s in range(0, n, bs):
            out = self.eval_step(data[s:s + bs], labels[s:s + bs],
                                 self._draw_eps(min(bs, n - s)))
            n_batches += 1
            for k, v in out.items():
                if v.ndim == 0:
                    totals[k] = totals.get(k, 0.0) + v
            z_cs.append(out["z_c"])
            z_ss.append(out["z_s"])
        z_c = torch.cat(z_cs).cpu().numpy()
        z_s = torch.cat(z_ss).cpu().numpy()
        self.last_eval_totals = {k: float(v) / n_batches
                                 for k, v in totals.items()}
        mig = MT.mutual_info_gap(labels.cpu().numpy(), z_c, z_s,
                                 backend=self.mig_backend)
        return mig, self.last_eval_totals["recon"]


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
        anneal = C.AnnealConfig(beta=hyperparameter["beta"],
                                loc=hyperparameter.get("loc", 0.0),
                                scale=hyperparameter.get("scale", 1.0))
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
