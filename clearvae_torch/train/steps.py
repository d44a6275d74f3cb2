"""Training and eval steps (counterpart of ``clearvae_tpu/train/steps.py``).

A step factory closes over the model, the optimizer and the static
configuration and returns a callable ``step(x, label, noise)`` that updates
them in place. A train step counts its updates in ``count``, an int64 0-d
tensor on the model's device that it increments in place, and computes the
anneal weight from it there (the JAX package's ``state.step``); ``step``
reads it as an int, a host sync that nothing inside a step makes. Metrics
come back as 0-d tensors on the device, so a step forces no host
synchronisation either.

Epoch runners loop over the batches of an epoch, which stay on the device:
``make_epoch_fn`` eagerly, ``make_graphed_epoch_fn`` through a captured
CUDA graph of the whole step, styling included (the counterpart of the JAX
package's scanned epoch program, one dispatch a step, or a block of
steps, instead of one a kernel); ``GraphedEval`` and
``make_graphed_probe_epochs_fn`` do the same for the eval step and the
probe.

``noise`` holds every random draw of the step, made by the trainer (or
injected by a test): the reparameterization's (eps_c, eps_s) for the CLEAR,
hierarchical and eval steps; a pair of them for CLEAR-TC (its two
forwards); a dict for CLEAR-MIM (``eps``, ``perm`` for CLUBSample's
negatives, ``inner``, one [B, z] normal per estimator update); the two
uniform [B] draws of the LAM-CNN step's stratified shuffle. The CNN step
draws nothing.
"""

from __future__ import annotations

import torch
from torch.nn import functional as F

from clearvae_torch.models.cnn import lam_head_weight
from clearvae_torch.ops import losses as L
from clearvae_torch.ops.group import grouped_kl
from clearvae_torch.ops.kernels.counts import GraphLaunches
from clearvae_torch.ops.kernels.fused_loss import (fused_clear_latent_loss,
                                                   fused_contrastive_loss)
from clearvae_torch.ops.schedules import logistic_anneal


def _contrastive(cc, mu, logvar, label, ps):
    """Route to the fused kernels (cosine/snn) or the plain path."""
    fn = fused_contrastive_loss if cc.fused else L.contrastive_loss
    return fn(mu, logvar, label, sim_fn=cc.sim_fn, temperature=cc.temperature,
              loss_name=cc.loss_name, ps=ps)


class _Counted:
    """A train step's update counter: ``count`` on the model's device,
    incremented in place, so that a captured step increments it on every
    replay; ``step`` reads it (a host sync)."""

    def _init_count(self, model):
        self.count = torch.zeros((), dtype=torch.int64,
                                 device=next(model.parameters()).device)

    @property
    def step(self) -> int:
        return int(self.count)

    def _anneal(self):
        a = self.anneal_cfg
        return logistic_anneal(self.count, beta=a.beta, loc=a.loc,
                               scale=a.scale)


def _clear_terms(lp, label, cc):
    """The two CLEAR regularizers (reference trainer.py:456-472)."""
    c_loss = _contrastive(cc, lp["mu_c"], lp["logvar_c"], label, False)
    s_loss = _contrastive(cc, lp["mu_s"], lp["logvar_s"], label, bool(cc.ps))
    return c_loss, (s_loss if cc.ps else -s_loss)


class ClearVAEStep(_Counted):
    """One CLEAR-VAE training step (reference CLEARVAETrainer._train,
    trainer.py:435-493), routed as ``make_clear_vae_step`` of the JAX
    package. The anneal weight uses the count before the increment."""

    def __init__(self, model, optimizer, anneal_cfg, contrastive_cfg):
        cc = contrastive_cfg
        self.model, self.optimizer = model, optimizer
        self.anneal_cfg, self.cc = anneal_cfg, cc
        self.use_fused = cc.fused and cc.sim_fn == "cosine" and cc.loss_name == "snn"
        self._init_count(model)

    def loss(self, x, label, eps):
        """(loss, metrics) of one train-mode forward; updates BN stats."""
        cc = self.cc
        x_hat, lp, _ = self.model(x, train=True, eps=eps)
        if self.use_fused:
            # one K1 call for KL(c) + KL(s) + SNN + PS-SNN and their grads
            recon = L.sample_level_reduction((x_hat - x) ** 2)
            kl_c, kl_s, c_loss, s_loss = fused_clear_latent_loss(
                lp["mu_c"], lp["logvar_c"], lp["mu_s"], lp["logvar_s"], label,
                temperature=cc.temperature, ps=bool(cc.ps))
            if not cc.ps:
                s_loss = -s_loss
        else:
            recon, kl_c, kl_s = L.vae_loss(x_hat, x, lp["mu_c"], lp["logvar_c"],
                                           lp["mu_s"], lp["logvar_s"])
            c_loss, s_loss = _clear_terms(lp, label, cc)
        w = self._anneal()
        loss = recon + w * kl_c + w * kl_s + cc.alpha * (c_loss + s_loss)
        metrics = {"loss": loss, "recon": recon, "kl_c": kl_c, "kl_s": kl_s,
                   "c_loss": c_loss, "s_loss": s_loss}
        return loss, {k: v.detach() for k, v in metrics.items()}

    def __call__(self, x, label, eps):
        self.optimizer.zero_grad(set_to_none=True)
        loss, metrics = self.loss(x, label, eps)
        loss.backward()
        self.optimizer.step()
        self.count.add_(1)
        return metrics


def make_clear_vae_step(model, optimizer, anneal_cfg,
                        contrastive_cfg) -> ClearVAEStep:
    return ClearVAEStep(model, optimizer, anneal_cfg, contrastive_cfg)


def make_clear_vae_eval_step(model, contrastive_cfg):
    """Eval-mode forward returning per-batch losses and sampled latents
    (reference CLEARVAETrainer.evaluate, trainer.py:495-570: MIG uses the
    *sampled* z halves, in running-stats mode). With ``fused`` the
    contrastive terms go through K2f."""

    @torch.no_grad()
    def eval_fn(x, label, eps):
        x_hat, lp, z = model(x, train=False, eps=eps)
        recon, kl_c, kl_s = L.vae_loss(x_hat, x, lp["mu_c"], lp["logvar_c"],
                                       lp["mu_s"], lp["logvar_s"])
        c_loss, s_loss = _clear_terms(lp, label, contrastive_cfg)
        zd = lp["mu_c"].shape[-1]
        return {"recon": recon, "kl_c": kl_c, "kl_s": kl_s,
                "c_loss": c_loss, "s_loss": s_loss,
                "z_c": z[:, :zd], "z_s": z[:, zd:],
                "mu_c": lp["mu_c"], "mu_s": lp["mu_s"]}

    return eval_fn


def _kl(mu, logvar):
    return -0.5 * L.sample_level_reduction(1 + logvar - mu ** 2
                                           - torch.exp(logvar))


# ---------------------------------------------------------------------------
# GVAE / ML-VAE (reference HierarchicalVAETrainer, trainer.py:291-412)
# ---------------------------------------------------------------------------


class HierarchicalStep(_Counted):
    """One GVAE/ML-VAE step (``make_hierarchical_step``): the content KL on
    the group params, recon and the style KL scaled by B/m, m the number of
    groups present (trainer.py:322-324,345-348)."""

    def __init__(self, model, optimizer, anneal_cfg):
        self.model, self.optimizer, self.anneal_cfg = model, optimizer, anneal_cfg
        self._init_count(model)

    def __call__(self, x, label, eps):
        self.optimizer.zero_grad(set_to_none=True)
        x_hat, lp, _ = self.model(x, train=True, eps=eps, label=label)
        recon = L.sample_level_reduction((x_hat - x) ** 2)
        kl_c = grouped_kl(lp["mu_c"], lp["logvar_c"], lp["present"])
        adj = x.shape[0] / lp["present"].sum().clamp_min(1)
        recon, kl_s = recon * adj, _kl(lp["mu_s"], lp["logvar_s"]) * adj
        w = self._anneal()
        loss = recon + w * kl_c + w * kl_s
        loss.backward()
        self.optimizer.step()
        self.count.add_(1)
        return {k: v.detach() for k, v in (("loss", loss), ("recon", recon),
                                           ("kl_c", kl_c), ("kl_s", kl_s))}


def make_hierarchical_step(model, optimizer, anneal_cfg) -> HierarchicalStep:
    return HierarchicalStep(model, optimizer, anneal_cfg)


def make_hierarchical_eval_step(model, with_evidence_acc: bool = False):
    """Eval-mode forward; with ``with_evidence_acc`` the content posterior
    is the batch's group evidence and its KL the grouped one."""

    @torch.no_grad()
    def eval_fn(x, label, eps):
        x_hat, lp, z = model(x, train=False, eps=eps,
                             label=label if with_evidence_acc else None)
        if with_evidence_acc:
            kl_c = grouped_kl(lp["mu_c"], lp["logvar_c"], lp["present"])
        else:
            kl_c = _kl(lp["mu_c"], lp["logvar_c"])
        zd = z.shape[-1] // 2
        return {"recon": L.sample_level_reduction((x_hat - x) ** 2),
                "kl_c": kl_c, "kl_s": _kl(lp["mu_s"], lp["logvar_s"]),
                "z_c": z[:, :zd], "z_s": z[:, zd:]}

    return eval_fn


# ---------------------------------------------------------------------------
# CLEAR-TC (reference ClearTCVAETrainer, trainer.py:590-709) and CLEAR-MIM
# (reference ClearMIMVAETrainer, trainer.py:781-897): two players per step
# ---------------------------------------------------------------------------


def factor_shuffling(z: torch.Tensor, strategy: str = "permute_1") -> torch.Tensor:
    """'Marginal' samples: z_s rolled up by one row (reference
    trainer.py:573-587; its 'full' branch is dead code there)."""
    if strategy != "permute_1":
        raise ValueError("this strategy is not implemented yet")
    zd = z.shape[1] // 2
    return torch.cat([z[:, :zd], torch.roll(z[:, zd:], -1, 0)], 1)


class _TwoPlayerStep(_Counted):
    """Phase 1 of CLEAR-TC and CLEAR-MIM: the VAE update with the second
    player frozen. The VAE loss is recon + w·KL + α·c_loss + λ·mi_loss, and
    its backward reaches the VAE's parameters only (the JAX step
    differentiates with respect to them alone), so nothing reaches the
    second player's optimizer. c_loss goes through ``_contrastive``: K2f
    forward and K2b backward when fused."""

    def __init__(self, model, optimizer, anneal_cfg, contrastive_cfg, la):
        self.model, self.optimizer = model, optimizer
        self.anneal_cfg, self.cc, self.la = anneal_cfg, contrastive_cfg, la
        self.vae_params = list(model.parameters())
        self._init_count(model)

    def _vae_update(self, x, label, eps, mi_loss_fn):
        """(metrics, latent_params) of the update; ``mi_loss_fn(z)`` is the
        second player's penalty on the sampled latents."""
        cc = self.cc
        self.optimizer.zero_grad(set_to_none=True)
        x_hat, lp, z = self.model(x, train=True, eps=eps)
        recon, kl_c, kl_s = L.vae_loss(x_hat, x, lp["mu_c"], lp["logvar_c"],
                                       lp["mu_s"], lp["logvar_s"])
        c_loss = _contrastive(cc, lp["mu_c"], lp["logvar_c"], label, False)
        mi_loss = mi_loss_fn(z)
        w = self._anneal()
        loss = (recon + w * kl_c + w * kl_s + cc.alpha * c_loss
                + self.la * mi_loss)
        loss.backward(inputs=self.vae_params)
        self.optimizer.step()
        metrics = {"loss": loss, "recon": recon, "kl_c": kl_c, "kl_s": kl_s,
                   "c_loss": c_loss, "mi_loss": mi_loss}
        return {k: v.detach() for k, v in metrics.items()}, lp


class ClearTCStep(_TwoPlayerStep):
    """One CLEAR-TC step (``make_clear_tc_step``); ``noise`` = (eps of the
    VAE forward, eps of the classifier's forward). The penalty is
    mean(relu(logit)), the reference's relu(log(d/(1−d))). Phase 2 runs a
    no-grad train-mode forward with the UPDATED VAE (its BatchNorm running
    statistics move, as in the JAX step) and takes one Adam step of the
    factor classifier on joint vs shuffled latents, a mean BCE over 2B
    logits."""

    def __init__(self, model, factor_cls, optimizer, factor_optimizer,
                 anneal_cfg, contrastive_cfg, tc_cfg):
        super().__init__(model, optimizer, anneal_cfg, contrastive_cfg,
                         tc_cfg.la)
        self.factor_cls, self.factor_optimizer = factor_cls, factor_optimizer
        self.shuffle_strategy = tc_cfg.shuffle_strategy

    def __call__(self, x, label, noise):
        eps_vae, eps_disc = noise
        metrics, _ = self._vae_update(
            x, label, eps_vae,
            lambda z: F.relu(self.factor_cls(z, return_logits=True)).mean())
        with torch.no_grad():
            z2 = self.model(x, train=True, eps=eps_disc)[2]
        self.factor_optimizer.zero_grad(set_to_none=True)
        l_joint = self.factor_cls(z2, return_logits=True)
        l_marg = self.factor_cls(factor_shuffling(z2, self.shuffle_strategy),
                                 return_logits=True)
        logits = torch.cat([l_joint, l_marg])
        target = torch.cat([torch.ones_like(l_joint), torch.zeros_like(l_marg)])
        d_loss = F.binary_cross_entropy_with_logits(logits, target)
        d_loss.backward()
        self.factor_optimizer.step()
        self.count.add_(1)
        metrics["factor_d_loss"] = d_loss.detach()
        return metrics


def make_clear_tc_step(model, factor_cls, optimizer, factor_optimizer,
                       anneal_cfg, contrastive_cfg, tc_cfg) -> ClearTCStep:
    return ClearTCStep(model, factor_cls, optimizer, factor_optimizer,
                       anneal_cfg, contrastive_cfg, tc_cfg)


def make_clear_tc_eval_step(model, factor_cls, contrastive_cfg):
    """Eval-mode forward; c_loss takes the plain path even when training is
    fused, as in the JAX package."""

    @torch.no_grad()
    def eval_fn(x, label, eps):
        x_hat, lp, z = model(x, train=False, eps=eps)
        recon, kl_c, kl_s = L.vae_loss(x_hat, x, lp["mu_c"], lp["logvar_c"],
                                       lp["mu_s"], lp["logvar_s"])
        c_loss = L.contrastive_loss(lp["mu_c"], lp["logvar_c"], label,
                                    sim_fn=contrastive_cfg.sim_fn,
                                    temperature=contrastive_cfg.temperature)
        mi_loss = F.relu(factor_cls(z, return_logits=True)).mean()
        zd = z.shape[-1] // 2
        return {"recon": recon, "kl_c": kl_c, "kl_s": kl_s, "c_loss": c_loss,
                "mi_loss": mi_loss, "z_c": z[:, :zd], "z_s": z[:, zd:]}

    return eval_fn


def _mi_estimate(estimator, x, y, perm):
    return estimator(x, y, perm=perm) if estimator.uses_perm else estimator(x, y)


class ClearMIMStep(_TwoPlayerStep):
    """One CLEAR-MIM step (``make_clear_mim_step``); ``noise`` is a dict of
    ``eps``, ``perm`` (CLUBSample's negatives, else None) and ``inner``
    [inner_steps, B, z]. Phase 2 re-encodes x once in train mode with the
    UPDATED VAE, leaving the running statistics as phase 1 left them (the
    JAX step drops that update), or takes the phase-1 latents with
    ``reuse_phase1_encode``; then ``inner_steps`` sequential Adam steps of
    the estimator's learning loss, each on detached latents with fresh
    noise. ``mi_learning_loss`` is the last inner loss."""

    def __init__(self, model, mi_estimator, optimizer, mi_optimizer,
                 anneal_cfg, contrastive_cfg, mim_cfg):
        super().__init__(model, optimizer, anneal_cfg, contrastive_cfg,
                         mim_cfg.la)
        self.mi_estimator, self.mi_optimizer = mi_estimator, mi_optimizer
        self.reuse_phase1_encode = mim_cfg.reuse_phase1_encode

    def __call__(self, x, label, noise):
        zd = self.model.z_dim
        metrics, lp = self._vae_update(
            x, label, noise["eps"],
            lambda z: _mi_estimate(self.mi_estimator, z[:, :zd], z[:, zd:],
                                   noise["perm"]))
        with torch.no_grad():
            if self.reuse_phase1_encode:
                heads = (lp["mu_c"], lp["logvar_c"], lp["mu_s"], lp["logvar_s"])
            else:
                heads = self.model.encode(x, train=True, update_stats=False)
            mu = torch.cat([heads[0], heads[2]], -1)
            std = torch.exp(0.5 * torch.cat([heads[1], heads[3]], -1))
        for eps in noise["inner"]:
            z = mu + eps * std
            self.mi_optimizer.zero_grad(set_to_none=True)
            inner_loss = self.mi_estimator.learning_loss(z[:, :zd], z[:, zd:])
            inner_loss.backward()
            self.mi_optimizer.step()
        self.count.add_(1)
        metrics["mi_learning_loss"] = inner_loss.detach()
        return metrics


def make_clear_mim_step(model, mi_estimator, optimizer, mi_optimizer,
                        anneal_cfg, contrastive_cfg, mim_cfg) -> ClearMIMStep:
    return ClearMIMStep(model, mi_estimator, optimizer, mi_optimizer,
                        anneal_cfg, contrastive_cfg, mim_cfg)


def make_clear_mim_eval_step(model, mi_estimator, contrastive_cfg):
    """Eval-mode forward; ``noise`` is a dict of ``eps`` and ``perm``.
    c_loss takes the plain path, as in the JAX package."""

    @torch.no_grad()
    def eval_fn(x, label, noise):
        x_hat, lp, z = model(x, train=False, eps=noise["eps"])
        recon, kl_c, kl_s = L.vae_loss(x_hat, x, lp["mu_c"], lp["logvar_c"],
                                       lp["mu_s"], lp["logvar_s"])
        c_loss = L.contrastive_loss(lp["mu_c"], lp["logvar_c"], label,
                                    sim_fn=contrastive_cfg.sim_fn,
                                    temperature=contrastive_cfg.temperature)
        zd = z.shape[-1] // 2
        mi_loss = _mi_estimate(mi_estimator, z[:, :zd], z[:, zd:],
                               noise["perm"])
        return {"recon": recon, "kl_c": kl_c, "kl_s": kl_s, "c_loss": c_loss,
                "mi_loss": mi_loss, "z_c": z[:, :zd], "z_s": z[:, zd:]}

    return eval_fn


# ---------------------------------------------------------------------------
# CNN classifier (reference SimpleCNNTrainer, trainer.py:168-232)
# ---------------------------------------------------------------------------


class CNNStep(_Counted):
    """``step(x, label, noise)``: one Adam step of the cross-entropy, BN in
    train mode; ``noise`` is unused (None)."""

    def __init__(self, model, optimizer):
        self.model, self.optimizer = model, optimizer
        self._init_count(model)

    def __call__(self, x, label, noise=None):
        self.optimizer.zero_grad(set_to_none=True)
        loss = _ce(self.model(x, train=True), label)
        loss.backward()
        self.optimizer.step()
        self.count.add_(1)
        return {"loss": loss.detach()}


def make_cnn_step(model, optimizer) -> CNNStep:
    return CNNStep(model, optimizer)


def stratified_shuffle(x: torch.Tensor, label: torch.Tensor,
                       u: torch.Tensor) -> torch.Tensor:
    """ss_pairing: x with its rows shuffled within each label stratum
    (reference LAMCNNTrainer.ss_pairing, trainer.py:249-257), by the JAX
    package's double sort (steps.py:490-501): with ``u`` = (u1, u2), two
    uniform [B] draws, s1 and s2 order the rows by (label, u1) and (label,
    u2), each by two stable sorts (np.lexsort's order, ties by index), and
    row s1[i] takes row s2[i]. No host synchronisation: capturable."""

    def by_label_then(key):
        o = torch.sort(key, stable=True).indices
        return o[torch.sort(label[o], stable=True).indices]

    s1, s2 = by_label_then(u[0]), by_label_then(u[1])
    perm = torch.empty_like(s2)
    perm[s1] = s2
    return x[perm]


class LAMCNNStep(_Counted):
    """One LAM-CNN step (``make_lam_cnn_step``): cross-entropy of the
    logits plus ``lam_coef`` × the LAM loss between the features of x and
    of its stratified shuffle x̃, weighted by the linear head's rows of
    each label. ``noise`` = the shuffle's uniforms [2, B]. As in the JAX
    step only the logits pass moves the BatchNorm running statistics: the
    features of x are that pass's trunk output (the JAX step computes them
    again, with the same values), and x̃'s pass normalizes by its own batch
    statistics with ``update_stats=False``."""

    def __init__(self, model, optimizer, lam_coef: float):
        self.model, self.optimizer, self.lam_coef = model, optimizer, lam_coef
        self._init_count(model)

    def __call__(self, x, label, noise):
        self.optimizer.zero_grad(set_to_none=True)
        x_tilde = stratified_shuffle(x, label, noise)
        feats = self.model.features(x, train=True)
        feats_t = self.model.features(x_tilde, train=True, update_stats=False)
        ce = _ce(self.model.head(feats, train=True), label)
        lam = L.lam_loss(feats, feats_t, label, lam_head_weight(self.model))
        (ce + self.lam_coef * lam).backward()
        self.optimizer.step()
        self.count.add_(1)
        return {"ce_loss": ce.detach(), "lam_loss": lam.detach()}


def make_lam_cnn_step(model, optimizer, lam_coef: float) -> LAMCNNStep:
    return LAMCNNStep(model, optimizer, lam_coef)


def make_cnn_logits_fn(model):
    """``logits(x)`` in eval mode."""

    @torch.no_grad()
    def logits_fn(x):
        return model(x, train=False)

    return logits_fn


# ---------------------------------------------------------------------------
# Epoch runners: an eager loop over batches gathered by index on the device
# (the JAX package's scanned epoch programs, steps.py:630-706,823-918)
# ---------------------------------------------------------------------------


def make_epoch_fn(step):
    """``epoch_fn(data, labels, batch_idx, draw_noise)``: one ``step`` per
    row of ``batch_idx`` [n_batches, B] on the gathered batch, with the
    noise ``draw_noise(B)`` makes; returns the per-step outputs. A train
    step or an eval step (``make_eval_epoch_fn`` of the JAX package)."""

    def epoch_fn(data, labels, batch_idx, draw_noise):
        return [step(data[idx], labels[idx], draw_noise(idx.numel()))
                for idx in batch_idx]

    return epoch_fn


def make_styled_epoch_fn(step, styler):
    """Counterpart of ``make_styled_epoch_fn``: each batch is gathered from
    the RAW images (0..255, [N, H, W]) by index, styled on the device by
    ``styler(raw, style_idx, draws)`` (the dataset's one protocol,
    ``StyledDataset.style``), given its channel dimension and stepped. Only
    the raw images stay resident; the pixels equal the materialized
    path's. With an eval step it is ``make_styled_eval_epoch_fn``."""

    def epoch_fn(raw, labels, style_idx, draws, batch_idx, draw_noise):
        return [step(styler(raw[idx], style_idx[idx], draws[idx])[..., None],
                     labels[idx], draw_noise(idx.numel()))
                for idx in batch_idx]

    return epoch_fn


def _into(static, fresh):
    """The static noise of a graphed step after a draw: ``fresh`` (a tensor,
    or a tuple, list or dict of tensors and None) copied into ``static``
    where it holds other tensors, so that a captured graph reads it; at the
    first draw (``static`` None) a copy of ``fresh`` that the graph owns."""
    if static is None:
        return None if fresh is None else _clone(fresh)
    if isinstance(static, torch.Tensor):
        if fresh is not static:
            static.copy_(fresh)
    elif isinstance(static, dict):
        for k, v in static.items():
            _into(v, fresh[k])
    else:
        for v, f in zip(static, fresh):
            _into(v, f)
    return static


def _clone(tree):
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_clone(v) for v in tree)
    return tree


class _GraphedStep:
    """A step over static buffers, captured in a CUDA graph and replayed.

    ``idx`` [B] holds the sample indices of the batch and ``noise`` its
    draws; ``_stage`` copies an index row and draws the noise into them,
    outside the graph. Inside it, the batch is gathered from the resident
    ``data`` and ``labels`` by ``idx``; with a ``styler`` (the dataset's
    ``style``) ``data`` is None and ``style_arrays`` = (raw [N, H, W],
    style_idx, draws): the batch's raw rows, style indices and zigzag draws
    are gathered and styled there (K3, zigzag and canny), then given their
    channel dimension. ``_body()`` is what a subclass captures: the step on
    the staged batch.

    On a CUDA device the first ``WARMUP`` calls run as real calls on a side
    stream (lazy state such as Adam's moments, cuDNN's plans and the
    styles' constant tensors is made there, never in a capture); the next
    call captures the body in a graph and replays it, like every later
    call. A capture failure raises; there is no eager fallback.
    ``GraphLaunches`` moves the launches that the kernels' wrappers count
    during the capture to the replays. On the CPU (tests) the same body
    runs uncaptured on every call. The graph holds pointers to the
    parameters, the BatchNorm buffers and the optimizer's state, so whoever
    replaces one of them (``optimizer.load_state_dict``) drops this
    object."""

    WARMUP = 3

    def __init__(self, step, data, labels, batch_size: int, draw_noise,
                 styler=None, style_arrays=None):
        self.step, self.data, self.labels = step, data, labels
        self.draw_noise, self.batch_size = draw_noise, batch_size
        self.styler, self.style_arrays = styler, style_arrays
        dev = labels.device
        self.cuda = dev.type == "cuda"
        self.idx = torch.zeros(batch_size, dtype=torch.int64, device=dev)
        self.noise = None
        self.graph = None     # (CUDAGraph, its output, GraphLaunches)
        self.warm = 0

    def _batch(self):
        """The staged batch, (x [B, H, W, C], labels [B])."""
        idx = self.idx
        if self.styler is None:
            return self.data[idx], self.labels[idx]
        raw, sidx, draws = self.style_arrays
        return (self.styler(raw[idx], sidx[idx], draws[idx])[..., None],
                self.labels[idx])

    def _stage(self, row):
        """Copy the index row [B] into ``idx`` and draw the batch's noise
        into its static tensors: the draws of the eager loop, from the same
        generator."""
        self.idx.copy_(row)
        self.noise = _into(self.noise,
                           self.draw_noise(self.batch_size, self.noise))

    def _body(self):
        raise NotImplementedError

    def _call(self):
        """The body on the staged batch: run, warm-up, or replay."""
        if not self.cuda:
            return self._body()
        if self.warm < self.WARMUP:
            return self._warm_up()
        if self.graph is None:
            self._capture()
        graph, out, launches = self.graph
        graph.replay()
        launches.replay()
        return out

    def _warm_up(self):
        side, main = torch.cuda.Stream(), torch.cuda.current_stream()
        side.wait_stream(main)
        with torch.cuda.stream(side):
            out = self._body()
        main.wait_stream(side)
        for t in (out.values() if isinstance(out, dict) else (out,)):
            t.record_stream(main)
        self.warm += 1
        return out

    def _capture(self):
        graph, launches = torch.cuda.CUDAGraph(), GraphLaunches()
        name = type(self.step).__name__
        try:
            with launches.capture(), torch.cuda.graph(graph):
                out = self._body()
        except Exception as exc:
            raise RuntimeError(f"capturing the step {name} in a CUDA graph "
                               f"failed: {exc}") from exc
        self.graph = (graph, out, launches)


class GraphedEpoch(_GraphedStep):
    """The train step of ``make_graphed_epoch_fn`` over static buffers.

    ``run(batch_idx)`` takes one step per row of ``batch_idx`` [n, B] on
    the device and returns the metrics as a [n, k] tensor there, columns in
    the order of ``keys``; nothing in it waits for the device. Per row,
    outside the graph: the row is copied into the static index buffer and
    the step's noise is drawn into its static tensors with
    ``draw_noise(B, out)`` (the draws of the eager step, in its order, so
    both consume one random stream alike); after the replay the metrics are
    copied into the history. Inside the graph: the gather (and styling) of
    the batch, then the whole step (forward, the fused-loss kernels,
    backward and every optimizer update)."""

    def __init__(self, step, data, labels, batch_size: int, draw_noise,
                 styler=None, style_arrays=None):
        super().__init__(step, data, labels, batch_size, draw_noise, styler,
                         style_arrays)
        self.keys = None

    def _body(self):
        x, label = self._batch()
        m = self.step(x, label, self.noise)
        if self.keys is None:
            self.keys = tuple(m)
        return torch.stack([m[k] for k in self.keys])

    def run(self, batch_idx) -> torch.Tensor:
        hist = None
        for i, row in enumerate(batch_idx):
            self._stage(row)
            out = self._call()
            if hist is None:
                hist = torch.empty((len(batch_idx), len(out)),
                                   dtype=out.dtype, device=out.device)
            hist[i].copy_(out)
        return hist


def make_graphed_epoch_fn(step, data, labels, batch_size: int, draw_noise,
                          styler=None, style_arrays=None) -> GraphedEpoch:
    """The counterpart of the JAX package's scanned ``make_epoch_fn``
    (steps.py:630) and, with ``styler``, ``make_styled_epoch_fn``
    (steps.py:823): the train ``step`` captured in a CUDA graph over static
    buffers and replayed, one dispatch a step. ``data`` [N, H, W, C] and
    ``labels`` [N] stay resident; with ``styler`` (the dataset's ``style``)
    ``data`` is None and ``style_arrays`` = (raw [N, H, W], style_idx,
    draws): each batch is styled inside the graph. ``draw_noise(B, out)``
    draws a step's noise, into ``out`` when given. See ``GraphedEpoch``."""
    return GraphedEpoch(step, data, labels, batch_size, draw_noise, styler,
                        style_arrays)


class GraphedEval(_GraphedStep):
    """The counterpart of the JAX package's ``make_eval_epoch_fn`` and, with
    a ``styler``, ``make_styled_eval_epoch_fn`` (steps.py:863-918): the
    eval step captured in a CUDA graph over static index and noise buffers
    and replayed per full batch; arguments as ``make_graphed_epoch_fn``'s.

    ``run(batch_idx)`` evaluates one batch per row of ``batch_idx`` [n, B]
    and returns {metric: [n]} for the step's scalars and {"z_c", "z_s":
    [n·B, z]}, preallocated on the device, which each replay's outputs are
    copied into. It holds no optimizer state, so it captures after one
    warm-up call."""

    WARMUP = 1
    LATENTS = ("z_c", "z_s")

    def _body(self):
        x, label = self._batch()
        out = self.step(x, label, self.noise)
        return {k: v for k, v in out.items()
                if v.ndim == 0 or k in self.LATENTS}

    def run(self, batch_idx) -> dict:
        n, b = batch_idx.shape
        res = None
        for i in range(n):
            self._stage(batch_idx[i])
            out = self._call()
            if res is None:
                res = {k: v.new_empty((n * b, *v.shape[1:]) if v.ndim
                                      else (n,)) for k, v in out.items()}
            for k, v in out.items():
                (res[k][i * b:(i + 1) * b] if v.ndim else res[k][i]).copy_(v)
        return res


# ---------------------------------------------------------------------------
# Downstream probe (reference DownstreamMLPTrainer, trainer.py:95-165)
# ---------------------------------------------------------------------------


def _ce(logits, label):
    return F.cross_entropy(logits, label)


def _probe_feature_core(mlp, optimizer, mu_c, label):
    """One Adam step of the probe on features: train-mode forward (updates
    its BN stats), cross-entropy, backward."""
    optimizer.zero_grad(set_to_none=True)
    loss = _ce(mlp(mu_c, train=True), label)
    loss.backward()
    optimizer.step()
    return {"loss": loss.detach()}


def make_probe_feature_step(mlp, optimizer):
    """Probe step on pre-encoded features: ``step(mu_c, label)``."""

    def step_fn(mu_c, label):
        return _probe_feature_core(mlp, optimizer, mu_c, label)

    return step_fn


def make_probe_step(vae_model, mlp, optimizer):
    """Train the probe on the frozen VAE's mu_c (trainer.py:126-127):
    ``step(x, label)``. The VAE runs in eval mode (running BN stats) and
    gets no gradient, as the reference's ``vae.eval()`` sets
    (run_styledmnist_downstream_expr.py:101)."""

    def step_fn(x, label):
        with torch.no_grad():
            mu_c = vae_model.encode(x, train=False)[0]
        return _probe_feature_core(mlp, optimizer, mu_c, label)

    return step_fn


def make_probe_logits_fn(vae_model, mlp):
    """``logits(x)``: eval-mode encode, then the eval-mode probe."""

    @torch.no_grad()
    def logits_fn(x):
        return mlp(vae_model.encode(x, train=False)[0], train=False)

    return logits_fn


def make_probe_feature_logits_fn(mlp):
    """Probe logits from pre-computed mu_c features (the style-on-device
    path, whose features come from the fused style→encode pass)."""

    @torch.no_grad()
    def logits_fn(feats):
        return mlp(feats, train=False)

    return logits_fn


def _no_noise(n, out=None):
    return None


def make_graphed_probe_epochs_fn(mlp, optimizer, feats, labels,
                                 batch_size: int):
    """The counterpart of the JAX package's ``make_probe_feature_epochs_fn``
    (steps.py:768-793), the whole probe training as replays: one probe step
    on cached features (``feats`` [N, z], ``labels`` [N], resident)
    captured in a CUDA graph (``GraphedEpoch``) and replayed a batch.
    ``epochs_fn(batch_idx)`` with ``batch_idx`` [n_epochs, n_batches, B]
    returns ``{"loss": [n_epochs]}``, each epoch's last loss, on the
    device."""

    def step(x, label, noise):
        return _probe_feature_core(mlp, optimizer, x, label)

    ep = GraphedEpoch(step, feats, labels, batch_size, _no_noise)

    def epochs_fn(batch_idx):
        return {"loss": torch.stack([ep.run(bi)[-1, 0] for bi in batch_idx])}

    return epochs_fn


def make_probe_feature_epochs_fn(mlp, optimizer):
    """``epochs_fn(feats, labels, batch_idx)`` with ``batch_idx`` [n_epochs,
    n_batches, B]: the whole probe training on cached features, one step a
    batch; returns ``{"loss": [n_epochs]}``, each epoch's last loss."""

    def epochs_fn(feats, labels, batch_idx):
        losses = []
        for bi in batch_idx:
            for idx in bi:
                m = _probe_feature_core(mlp, optimizer, feats[idx], labels[idx])
            losses.append(m["loss"])
        return {"loss": torch.stack(losses)}

    return epochs_fn
