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
CLEAR-MIM: ``(mi_losses, mi_learning_losses)``). As in the JAX package,
``fit`` and ``evaluate`` default to their scanned program
(``use_scan=True``): on a card each batch is one replay of the step
captured in a CUDA graph, styling included; on the CPU the same body runs
uncaptured. ``use_scan=False`` is the eager loop, the reference that the
graph is held to. Checkpoints hold the whole trainer state, the noise
generator's included, so that a resumed ``fit(start_epoch=k)`` reproduces
the uninterrupted run. Meshes are not ported.
"""

from __future__ import annotations

import functools
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


def adam(lr: float, device):
    """Adam at ``lr`` for modules on ``device``: on a CUDA device ``fused``
    and ``capturable`` (one update kernel for all of a module's
    parameters, its count on the device), so that one optimizer serves the
    eager step and the captured one with the same kernels; on the CPU
    torch's default Adam, which the JAX package's optax.adam is checked
    against."""
    cuda = torch.device(device).type == "cuda"
    return functools.partial(torch.optim.Adam, lr=lr, fused=cuda or None,
                             capturable=cuda)


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
        # captured steps: the train step's keyed by (dataset, batch size,
        # styled), the eval steps' by ("eval", eval step, batch size,
        # styled), which holds the last dataset evaluated
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

    def _eval_noise(self, n: int, out=None):
        """The draws one eval step of a batch of n takes; into ``out`` when
        given, as ``_train_noise``."""
        return self._draw_eps(n) if out is None else self._draw_eps(n, out)

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

    def _graphed(self, key, make, ds, style_on_device: bool, step,
                 batch_size: int, draw_noise):
        """The captured step of ``make`` (``S.make_graphed_epoch_fn`` or
        ``S.GraphedEval``) under ``key``, made over ``ds``'s resident
        arrays at first use, and made anew (the old one dropped with its
        resident copy and memory pool) when ``key`` comes with another
        dataset. The entry keeps its dataset alive, so an id in the key
        cannot name another one."""
        if key not in self._graphs or self._graphs[key][0] is not ds:
            self._graphs.pop(key, None)
            labels = self._labels(ds)
            if style_on_device:
                fn = make(step, None, labels, batch_size, draw_noise,
                          styler=ds.style,
                          style_arrays=self._style_arrays(ds))
            else:
                fn = make(step, self._device_data(ds)[0], labels, batch_size,
                          draw_noise)
            self._graphs[key] = (ds, fn)
        return self._graphs[key][1]

    def _graphed_runner(self, ds, batch_size: int, style_on_device: bool):
        """``run(batch_idx [n, B]) -> ([n, k] device tensor, keys)``
        through the captured train step of ``S.make_graphed_epoch_fn``, one
        per (dataset, B, styling)."""
        ep = self._graphed((id(ds), batch_size, style_on_device),
                           S.make_graphed_epoch_fn, ds, style_on_device,
                           self.train_step, batch_size, self._train_noise)
        return lambda batch_idx: (ep.run(batch_idx), ep.keys)

    def _eager_runner(self, ds, style_on_device: bool):
        """``run(batch_idx [n, B]) -> ([n, k] device tensor, keys)``
        through the eager loop."""
        eager = self._epoch_runner(ds, self.train_step, style_on_device,
                                   self._train_noise)

        def run(batch_idx):
            ms = eager(batch_idx)
            return torch.stack([torch.stack(list(m.values())) for m in ms]), \
                tuple(ms[0])

        return run

    def fit(self, epochs: int, train_ds, valid_ds=None, batch_size: int = 128,
            use_scan: bool = True, checkpoint_dir: str | None = None,
            checkpoint_every: int = 10, logger=None, epochs_per_scan: int = 1,
            style_on_device: bool = False, scan_unroll: int = 1,
            scan_gather: str = "take", start_epoch: int = 0):
        """Train for ``epochs`` epochs from ``start_epoch``, which keys the
        shuffles (the JAX package's ``fit``, trainers.py:93-260).

        ``use_scan`` (default on) runs the train step as replays of a CUDA
        graph that holds the whole step, gather and styling included
        (``S.make_graphed_epoch_fn``): the same updates from the same noise
        as the eager loop of ``use_scan=False``, one dispatch a step. On
        the CPU the graph's body runs uncaptured. With it:

        - ``epochs_per_scan`` = E runs E epochs a block, with no host
          synchronisation between them; ``self.history`` then holds one
          entry per block, {metric: [E]}, the last batch of each epoch,
          and the verbose, validation, logging and checkpoint hooks fire
          at block boundaries. Ignored on the styled path, as in JAX.
        - ``scan_unroll`` and ``scan_gather`` are checked as JAX checks
          them (a negative unroll, an unknown gather mode, and a gather
          other than ``"take"`` on the styled path raise its errors) and
          change nothing else: every step replays the one-step graph,
          which gathers its batch inside the graph. Grouping the same
          kernels differently gives the same numbers, and several steps
          a graph measured no faster on an H100 (PERF.md).

        Otherwise ``self.history`` gets one entry per epoch: {metric:
        [n_batches]}.

        With ``checkpoint_dir`` the trainer state is saved every
        ``checkpoint_every`` epochs and at the end; with ``logger``
        (``utils.logging.MetricLogger``) each block's last metrics and its
        images/sec are logged under the tag "train". A checkpoint holds the
        noise generator's state, so ``restore_checkpoint`` and then
        ``fit(start_epoch=k)`` reproduce the run that saved it.

        ``style_on_device`` (StyledDataset only) keeps only the raw images
        on the device and styles each batch there, keyed by (dataset seed,
        absolute sample id): the same pixels as the materialized path,
        inside the graph with ``use_scan``. In-fit validation then styles
        its batches the same way. Returns ``_fit_result()``: None here,
        the loss histories in CLEAR-TC and CLEAR-MIM."""
        if use_scan:
            if scan_unroll < 0:
                raise ValueError("`unroll` must be a `bool` or a "
                                 "non-negative `int`.")
            if style_on_device and scan_gather != "take":
                raise ValueError("scan_gather is not supported on the "
                                 "style_on_device path (styling keys off "
                                 "per-batch sample ids)")
            if scan_gather not in ("take", "permute_slice"):
                raise ValueError(f"unknown gather mode: {scan_gather!r}")
        n = len(train_ds)
        batch_size = min(batch_size, n)  # tiny split: shrink, don't drop all
        n_batches = n // batch_size
        run = (self._graphed_runner(train_ds, batch_size, style_on_device)
               if use_scan else self._eager_runner(train_ds, style_on_device))
        per_block = (max(1, int(epochs_per_scan))
                     if use_scan and not style_on_device else 1)

        def perm(epoch):
            p = np.random.RandomState(self.seed + epoch).permutation(n)
            return p[: n_batches * batch_size].reshape(n_batches, batch_size)

        end_epoch = start_epoch + epochs
        epoch = start_epoch
        while epoch < end_epoch:
            block = min(per_block, end_epoch - epoch)
            end = epoch + block          # the first epoch after this block
            t0 = time.perf_counter()
            idx = torch.as_tensor(np.stack([perm(e) for e in range(epoch, end)]),
                                  device=self.device)
            hists = [run(bi) for bi in idx]
            keys = hists[0][1]
            if per_block > 1:            # the last batch of each epoch
                hist = torch.stack([h[-1] for h, _ in hists]).cpu().numpy()
            else:
                hist = hists[0][0].cpu().numpy()
            self.history.append({k: hist[:, j] for j, k in enumerate(keys)})
            self._post_train_epoch(self.history[-1])
            last = {k: v[-1] for k, v in self.history[-1].items()}
            if logger is not None:
                dt = time.perf_counter() - t0
                logger.log("train", step=self.train_step.step, epoch=end - 1,
                           images_per_sec=block * n / dt if dt > 0 else 0,
                           **{k: float(v) for k, v in last.items()})
            if any(e % self.verbose_period == 0 for e in range(epoch, end)):
                print(f"epoch {end - 1}: "
                      f"{ {k: round(float(v), 3) for k, v in last.items()} }")
                if valid_ds is not None:
                    self._verbose_valid(
                        valid_ds, batch_size,
                        style_on_device=(style_on_device
                                         and hasattr(valid_ds, "device_arrays")),
                        use_scan=use_scan)
            if checkpoint_dir and (any((e + 1) % checkpoint_every == 0
                                       for e in range(epoch, end))
                                   or end == end_epoch):
                self.save_checkpoint(checkpoint_dir, {"epoch": end - 1})
            epoch = end
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

    def _verbose_valid(self, valid_ds, batch_size, style_on_device=False,
                       use_scan=True):
        raise NotImplementedError


class VAETrainerBase(TrainerCore):
    """gMIG/MSE evaluation on sampled latents (reference VAETrainer,
    trainer.py:78-92)."""

    def __init__(self, model, verbose_period: int = 5, seed: int = 0,
                 mig_backend: str = "auto", device=None):
        super().__init__(model, verbose_period, seed, device)
        self.mig_backend = MT.resolve_backend(mig_backend)

    def _verbose_valid(self, valid_ds, batch_size, style_on_device=False,
                       use_scan=True):
        mig, mse = self.evaluate(valid_ds, batch_size=batch_size,
                                 style_on_device=style_on_device,
                                 use_scan=use_scan)
        print(f"gMIG: {round(mig, 3)}; mse: {round(float(mse), 3)}")

    @torch.no_grad()
    def evaluate(self, ds, batch_size: int = 128, use_scan: bool = True,
                 style_on_device: bool = False):
        """(gMIG, reconstruction MSE) over the dataset in eval mode
        (reference evaluate, trainer.py:495-570; the JAX package's,
        trainers.py:304-399): the full batches, then the ragged tail by one
        direct call; MSE is the mean of the per-batch means, which
        ``last_eval_totals`` holds for every scalar of the eval step.

        ``use_scan`` (default on) runs the full batches as replays of the
        eval step captured in a CUDA graph (``S.GraphedEval``, one per eval
        step, batch size and styling, made anew for another dataset); on
        the CPU its body runs uncaptured. ``use_scan=False`` is the eager
        loop: the same numbers. ``style_on_device`` styles each batch on the device from
        the raw images, as ``fit`` does, inside the graph with
        ``use_scan``."""
        n = len(ds)
        bs = min(batch_size, n)
        nb = n // bs
        full = torch.arange(nb * bs, device=self.device).view(nb, bs)
        eager = self._epoch_runner(ds, self.eval_step, style_on_device,
                                   self._eval_noise)
        if use_scan:
            ge = self._graphed(("eval", id(self.eval_step), bs,
                                style_on_device), S.GraphedEval, ds,
                               style_on_device, self.eval_step, bs,
                               self._eval_noise)
            outs = ge.run(full)
        else:
            ms = eager(full)
            outs = {k: (torch.cat([m[k] for m in ms]) if k in S.GraphedEval.LATENTS
                        else torch.stack([m[k] for m in ms]))
                    for k, v in ms[0].items()
                    if v.ndim == 0 or k in S.GraphedEval.LATENTS}
        tail = (eager(torch.arange(nb * bs, n, device=self.device)[None])[0]
                if n > nb * bs else None)
        # JAX's reduction: a float32 sum of the full batches' means, plus
        # the tail's, over the number of batches
        n_batches = nb + (tail is not None)
        self.last_eval_totals = {
            k: (float(v.cpu().numpy().sum())
                + (float(tail[k]) if tail is not None else 0.0)) / n_batches
            for k, v in outs.items() if k not in S.GraphedEval.LATENTS}
        z_c, z_s = outs["z_c"], outs["z_s"]
        if tail is not None:
            z_c = torch.cat([z_c, tail["z_c"]])
            z_s = torch.cat([z_s, tail["z_s"]])
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
                 style_on_device: bool = False, use_scan: bool = True):
        """(reference evaluate(..., with_evidence_acc), trainer.py:366-412).
        ``None`` keeps the trainer's eval step, plain by default; each eval
        step has its own graph."""
        prev = self.eval_step
        if with_evidence_acc is not None:
            self.eval_step = self._eval_steps[with_evidence_acc]
        try:
            return super().evaluate(ds, batch_size, use_scan=use_scan,
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

    def _eval_noise(self, n: int, out=None):
        if out is None:
            return {"eps": self._draw_eps(n), "perm": self._draw_perm(n)}
        return {"eps": self._draw_eps(n, out["eps"]),
                "perm": self._draw_perm(n, out["perm"])}

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

    def _verbose_valid(self, valid_ds, batch_size, style_on_device=False,
                       use_scan=True):
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


class LAMCNNTrainer(SimpleCNNTrainer):
    """Cross-entropy + the LAM regularizer (reference LAMCNNTrainer,
    trainer.py:235-288): ``hyperparameter["lam_coef"]`` weighs it. Each
    step's stratified shuffle takes two uniform [B] draws from the
    trainer's generator, made outside the captured step as the VAEs' noise
    is. The history holds ``ce_loss`` and ``lam_loss``."""

    def __init__(self, model, optimizer, hyperparameter: dict,
                 verbose_period: int = 5, seed: int = 0, device=None):
        super().__init__(model, optimizer, verbose_period, seed, device)
        self.train_step = S.make_lam_cnn_step(self.model, self.optimizer,
                                              hyperparameter["lam_coef"])

    def _train_noise(self, n: int, out=None):
        if out is None:
            return torch.rand((2, n), generator=self.generator,
                              device=self.device)
        return torch.rand((2, n), generator=self.generator, out=out)


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
        self.optimizer = adam(lr, self.device)(self.mlp.parameters())
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
            cache_features: bool = True, style_on_device: bool = False,
            use_scan: bool = True):
        """Train the probe. With ``cache_features`` (the default) the frozen
        encoder runs once and the probe trains on the cached mu_c; epoch e
        is shuffled by ``RandomState(e)``. Validation runs after epoch 0 and
        after every ``verbose_period``-th epoch. On cached features
        ``use_scan`` (default on) replays the probe step captured in a CUDA
        graph (``S.make_graphed_probe_epochs_fn``; its body uncaptured on
        the CPU), the JAX package's one program for all the epochs;
        ``use_scan=False`` steps eagerly, with the same numbers."""
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
            epochs_fn = (S.make_graphed_probe_epochs_fn(
                self.mlp, self.optimizer, feats, labels, bs) if use_scan
                else functools.partial(self._feat_epochs_fn, feats, labels))

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
                epochs_fn(bi)
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
