"""Training and eval steps (counterpart of ``clearvae_tpu/train/steps.py``).

A step factory closes over the model, the optimizer and the static
configuration and returns a callable that updates them in place. PyTorch
runs eagerly, so there is no jit and no scan: the trainer loops in Python
over batches that stay on the device. Metrics come back as 0-d tensors on
the device, so a step forces no host synchronisation.
"""

from __future__ import annotations

import torch

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
