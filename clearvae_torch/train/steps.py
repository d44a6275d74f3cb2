"""Training and eval steps (counterpart of ``clearvae_tpu/train/steps.py``).

A step factory closes over the model, the optimizer and the static
configuration and returns a callable that updates them in place. PyTorch
runs eagerly, so there is no jit and no scan: the trainer loops in Python
over batches that stay on the device. Metrics come back as 0-d tensors on
the device, so a step forces no host synchronisation.
"""

from __future__ import annotations

import torch
from torch.nn import functional as F

from clearvae_torch.ops import losses as L
from clearvae_torch.ops.kernels.fused_loss import (fused_clear_latent_loss,
                                                   fused_contrastive_loss)
from clearvae_torch.ops.schedules import logistic_anneal


def _contrastive(cc, mu, logvar, label, ps):
    """Route to the fused kernels (cosine/snn) or the plain path."""
    fn = fused_contrastive_loss if cc.fused else L.contrastive_loss
    return fn(mu, logvar, label, sim_fn=cc.sim_fn, temperature=cc.temperature,
              loss_name=cc.loss_name, ps=ps)


def _clear_terms(lp, label, cc):
    """The two CLEAR regularizers (reference trainer.py:456-472)."""
    c_loss = _contrastive(cc, lp["mu_c"], lp["logvar_c"], label, False)
    s_loss = _contrastive(cc, lp["mu_s"], lp["logvar_s"], label, bool(cc.ps))
    return c_loss, (s_loss if cc.ps else -s_loss)


class ClearVAEStep:
    """One CLEAR-VAE training step (reference CLEARVAETrainer._train,
    trainer.py:435-493), routed as ``make_clear_vae_step`` of the JAX
    package. ``step`` counts the updates; the anneal weight uses its value
    before the increment."""

    def __init__(self, model, optimizer, anneal_cfg, contrastive_cfg):
        cc = contrastive_cfg
        self.model, self.optimizer = model, optimizer
        self.anneal_cfg, self.cc = anneal_cfg, cc
        self.use_fused = cc.fused and cc.sim_fn == "cosine" and cc.loss_name == "snn"
        self.step = 0

    def loss(self, x, label, eps):
        """(loss, metrics) of one train-mode forward; updates BN stats."""
        cc, a = self.cc, self.anneal_cfg
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
        w = logistic_anneal(self.step, beta=a.beta, loc=a.loc, scale=a.scale)
        loss = recon + w * kl_c + w * kl_s + cc.alpha * (c_loss + s_loss)
        metrics = {"loss": loss, "recon": recon, "kl_c": kl_c, "kl_s": kl_s,
                   "c_loss": c_loss, "s_loss": s_loss}
        return loss, {k: v.detach() for k, v in metrics.items()}

    def __call__(self, x, label, eps):
        self.optimizer.zero_grad(set_to_none=True)
        loss, metrics = self.loss(x, label, eps)
        loss.backward()
        self.optimizer.step()
        self.step += 1
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


# ---------------------------------------------------------------------------
# Epoch runners: an eager loop over batches gathered by index on the device
# (the JAX package's scanned epoch programs, steps.py:630-706,823-918)
# ---------------------------------------------------------------------------


def make_epoch_fn(step):
    """``epoch_fn(data, labels, batch_idx, draw_eps)``: one ``step`` per row
    of ``batch_idx`` [n_batches, B] on the gathered batch; returns the
    per-step outputs. A train step or an eval step (``make_eval_epoch_fn``
    of the JAX package)."""

    def epoch_fn(data, labels, batch_idx, draw_eps):
        return [step(data[idx], labels[idx], draw_eps(idx.numel()))
                for idx in batch_idx]

    return epoch_fn


def make_styled_epoch_fn(step, styler):
    """Counterpart of ``make_styled_epoch_fn``: each batch is gathered from
    the RAW images (0..255, [N, H, W]) by index, styled on the device by
    ``styler(raw, style_idx, draws)`` (the dataset's one protocol,
    ``StyledDataset.style``), given its channel dimension and stepped. Only
    the raw images stay resident; the pixels equal the materialized
    path's. With an eval step it is ``make_styled_eval_epoch_fn``."""

    def epoch_fn(raw, labels, style_idx, draws, batch_idx, draw_eps):
        return [step(styler(raw[idx], style_idx[idx], draws[idx])[..., None],
                     labels[idx], draw_eps(idx.numel()))
                for idx in batch_idx]

    return epoch_fn


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
