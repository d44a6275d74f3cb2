"""The plain reference of the style–content VAE's training and evaluation,
in float32 torch operations with autograd: the model (the 28×28 ``VAE`` and
the 64×64 ``VAE64`` of scotsun/clear-vae, code/src/models/vae.py), the
unfused CLEAR loss (code/src/losses.py, trainer.py:435-493), Adam
(Kingma & Ba) and the evaluation's reconstruction error and gMIG
(trainer.py:495-570).

A configuration names its reference by module (``"reference": "vae"``);
the harness reads a reference module through the functions at the end of
this file: ``param_spec``, ``train_noise``, ``train`` and ``validate``.
Where the configuration's trainer holds more modules than ``model`` (its
``MODULES``), ``param_spec`` lists every one: the model's leaves by their
own names, then each other module's as ``<attribute>.<leaf>``
(``mi_estimator.net.mu_l1.weight``). The harness draws them in one call
and loads each module under a strict check of names and shapes; ``train``
returns ``grad1`` (each module's first gradient, as its own optimizer
takes it) and ``params`` over all of them, and the check compares each
module by itself (``clear_mim.py`` is such a reference).

It imports nothing of the program. Parameters are a dict of tensors whose
names follow the model's public state dict (the layout its checkpoints
use), so that the benchmark loads one set of weights into both sides.
Layout conventions that the weights depend on: the trunk is flattened in
(H, W, C) order, and the decoder's dense output is read as (H, W, C).

BatchNorm is flax's: momentum 0.1, eps 1e-5, one-pass statistics
E[x²] − E[x]² in float32, the biased variance in the running statistics.
"""

from __future__ import annotations

import math

import torch
from torch.nn import functional as F

from portbench.reference import mig as RM

BN_MOMENTUM, BN_EPS = 0.1, 1e-5
ADAM_BETAS, ADAM_EPS = (0.9, 0.999), 1e-8


class PlainVAE:
    """The architecture of a configuration's ``model`` block: ``image_size``,
    ``in_channel``, ``enc_channels``, ``enc_kernel``, ``dec_spatial``,
    ``dec_kernel``, ``dec_output_paddings`` and ``z_dim`` (z_c and z_s
    each take half)."""

    def __init__(self, m: dict):
        self.m = m
        self.zd = m["z_dim"] // 2
        self.enc = [m["in_channel"], *m["enc_channels"]]
        self.flat = m["dec_spatial"] ** 2 * m["enc_channels"][-1]
        self.dec = [m["enc_channels"][-1], *reversed(m["enc_channels"][:-1]),
                    m["in_channel"]]

    def param_spec(self) -> list:
        """[(name, shape, bound)]: every parameter, drawn uniform in
        ±bound (1/sqrt(fan_in) for kernels and biases; a ConvTranspose's
        fan_in is k·k·in, as flax counts it); BatchNorm scales are drawn in
        1 ± bound and shifts in ±bound."""
        m, k, dk = self.m, self.m["enc_kernel"], self.m["dec_kernel"]
        spec = []
        for i, (ci, co) in enumerate(zip(self.enc[:-1], self.enc[1:])):
            b = 1 / math.sqrt(ci * k * k)
            spec += [(f"encoder.convs.{i}.weight", (co, ci, k, k), b),
                     (f"encoder.convs.{i}.bias", (co,), b)]
        for i, co in enumerate(self.enc[1:]):
            spec += self._bn(f"encoder.bns.{i}", co)
        for head in ("mu_c", "logvar_c", "mu_s", "logvar_s"):
            b = 1 / math.sqrt(self.flat)
            spec += [(f"{head}_head.weight", (self.zd, self.flat), b),
                     (f"{head}_head.bias", (self.zd,), b)]
        b = 1 / math.sqrt(m["z_dim"])
        spec += [("decoder.dense.weight", (self.flat, m["z_dim"]), b),
                 ("decoder.dense.bias", (self.flat,), b)]
        for i, (ci, co) in enumerate(zip(self.dec[:-1], self.dec[1:])):
            b = 1 / math.sqrt(ci * dk * dk)
            spec += [(f"decoder.convts.{i}.weight", (ci, co, dk, dk), b),
                     (f"decoder.convts.{i}.bias", (co,), b)]
        spec += self._bn("decoder.bns.0", self.flat)
        for i, co in enumerate(self.dec[1:]):
            spec += self._bn(f"decoder.bns.{i + 1}", co)
        return spec

    @staticmethod
    def _bn(name: str, n: int) -> list:
        return [(f"{name}.weight", (n,), 0.1), (f"{name}.bias", (n,), 0.1)]

    def buffers(self, device) -> dict:
        """Fresh BatchNorm running statistics: means 0, variances 1."""
        out = {}
        for name, shape, _ in self.param_spec():
            if ".bns." in name and name.endswith(".weight"):
                base = name[: -len(".weight")]
                out[f"{base}.running_mean"] = torch.zeros(shape, device=device)
                out[f"{base}.running_var"] = torch.ones(shape, device=device)
        return out

    # -- forward -------------------------------------------------------------

    def _bn_apply(self, p, buf, name, x, train, new_buf):
        w, b = p[f"{name}.weight"], p[f"{name}.bias"]
        dims = (0,) + tuple(range(2, x.ndim))
        shape = (1, -1) + (1,) * (x.ndim - 2)
        if train:
            mean = x.mean(dims)
            var = ((x * x).mean(dims) - mean * mean).clamp_min(0.0)
            new_buf[f"{name}.running_mean"] = (
                (1 - BN_MOMENTUM) * buf[f"{name}.running_mean"]
                + BN_MOMENTUM * mean.detach())
            new_buf[f"{name}.running_var"] = (
                (1 - BN_MOMENTUM) * buf[f"{name}.running_var"]
                + BN_MOMENTUM * var.detach())
        else:
            mean = buf[f"{name}.running_mean"]
            var = buf[f"{name}.running_var"]
        return (x - mean.view(shape)) * (w * torch.rsqrt(var + BN_EPS)).view(shape) \
            + b.view(shape)

    def forward(self, p: dict, buf: dict, x: torch.Tensor, eps: torch.Tensor,
                train: bool):
        """(x_hat [N, H, W, C], (mu_c, logvar_c, mu_s, logvar_s), z,
        BatchNorm statistics after the call) of an NHWC batch ``x`` in
        [0, 1]; ``eps`` [2, N, z/2] is the reparameterization's noise, z_c's
        first."""
        m, new_buf = self.m, dict(buf)
        h = x.permute(0, 3, 1, 2)
        for i in range(len(self.enc) - 1):
            h = F.conv2d(h, p[f"encoder.convs.{i}.weight"],
                         p[f"encoder.convs.{i}.bias"], stride=2, padding=1)
            h = F.relu(self._bn_apply(p, buf, f"encoder.bns.{i}", h, train,
                                      new_buf))
        h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)
        heads = tuple(h @ p[f"{n}_head.weight"].T + p[f"{n}_head.bias"]
                      for n in ("mu_c", "logvar_c", "mu_s", "logvar_s"))
        mu_c, lv_c, mu_s, lv_s = heads
        z = torch.cat([mu_c + eps[0] * torch.exp(0.5 * lv_c),
                       mu_s + eps[1] * torch.exp(0.5 * lv_s)], -1)
        d = z @ p["decoder.dense.weight"].T + p["decoder.dense.bias"]
        d = F.relu(self._bn_apply(p, buf, "decoder.bns.0", d, train, new_buf))
        s = m["dec_spatial"]
        d = d.view(-1, s, s, self.dec[0]).permute(0, 3, 1, 2)
        last = len(self.dec) - 2
        for i in range(len(self.dec) - 1):
            d = F.conv_transpose2d(d, p[f"decoder.convts.{i}.weight"],
                                   p[f"decoder.convts.{i}.bias"], stride=2,
                                   padding=1,
                                   output_padding=m["dec_output_paddings"][i])
            d = self._bn_apply(p, buf, f"decoder.bns.{i + 1}", d, train,
                               new_buf)
            d = torch.sigmoid(d) if i == last else F.relu(d)
        return d.permute(0, 2, 3, 1), heads, z, new_buf


# -- the CLEAR loss -------------------------------------------------------------


def per_sample_mean(t: torch.Tensor) -> torch.Tensor:
    """Sum over every axis but the batch's, mean over the batch."""
    return t.flatten(1).sum(1).mean()


def kl(mu, logvar):
    return -0.5 * per_sample_mean(1 + logvar - mu * mu - torch.exp(logvar))


def snn(mu: torch.Tensor, label: torch.Tensor, temperature: float,
        different: bool) -> torch.Tensor:
    """Soft-nearest-neighbour loss of cosine similarities, the mean over the
    rows that have a positive: positives are the other rows of the same
    label, or with ``different`` (PS-SNN) of another label; each row's
    denominator runs over every other row."""
    u = mu / torch.linalg.vector_norm(mu, dim=1, keepdim=True).clamp_min(1e-8)
    s = (u @ u.T) / temperature
    n = s.shape[0]
    other = ~torch.eye(n, dtype=torch.bool, device=s.device)
    same = label[:, None] == label[None, :]
    pos = (~same if different else same) & other
    rows = pos.any(1)
    neg_inf = torch.full_like(s, float("-inf"))
    num = torch.logsumexp(torch.where(pos, s, neg_inf)[rows], 1)
    den = torch.logsumexp(torch.where(other, s, neg_inf)[rows], 1)
    return (den - num).mean()


def clear_loss(x, x_hat, heads, label, hp: dict, step: int, half: bool = False):
    """(loss, recon) of one train step; ``step`` is the update count before
    it (the KL weight's logistic anneal: β / (1 + exp(-step))).
    ``half`` computes the per-sample means over the first half of the batch
    (a planted fault: half of the batch left out)."""
    rows = slice(0, x.shape[0] // 2) if half else slice(None)
    mu_c, lv_c, mu_s, lv_s = heads
    recon = per_sample_mean((x_hat[rows] - x[rows]) ** 2)
    w = hp["beta"] / (1.0 + math.exp(-float(step)))
    c = snn(mu_c, label, hp["temperature"], False)
    s = snn(mu_s, label, hp["temperature"], True)
    loss = (recon + w * kl(mu_c[rows], lv_c[rows]) + w * kl(mu_s[rows], lv_s[rows])
            + hp["alpha"] * (c + s))
    return loss, recon


def train_steps(model: PlainVAE, params: dict, batches, hp: dict,
                half: bool = False) -> dict:
    """The reference's first steps from ``params``: each of ``batches`` an
    (x NHWC, label, eps) triple, one Adam step (lr ``hp["lr"]``, betas
    (0.9, 0.999), eps 1e-8) on each. Returns {"losses": [float],
    "grad1": {leaf: the first step's gradient}, "params": {leaf: after the
    last step}}."""
    dev = next(iter(params.values())).device
    p = {k: v.detach().clone() for k, v in params.items()}
    buf = model.buffers(dev)
    m = {k: torch.zeros_like(v) for k, v in p.items()}
    v2 = {k: torch.zeros_like(v) for k, v in p.items()}
    losses, grad1 = [], None
    for t, (x, label, eps) in enumerate(batches, start=1):
        leaves = {k: v.requires_grad_(True) for k, v in p.items()}
        x_hat, heads, _, buf = model.forward(leaves, buf, x, eps, train=True)
        loss, _ = clear_loss(x, x_hat, heads, label, hp, t - 1, half)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        losses.append(float(loss.detach()))
        g = dict(zip(leaves, grads))
        if grad1 is None:
            grad1 = {k: gi.detach().clone() for k, gi in g.items()}
        adam_update(p, m, v2, g, t, hp["lr"])
    return {"losses": losses, "grad1": grad1, "params": p}


@torch.no_grad()
def adam_update(p: dict, m: dict, v2: dict, g: dict, t: int,
                lr: float) -> None:
    """Adam's ``t``-th update of the leaves of ``g``, in place in ``p``
    and in the moments ``m`` and ``v2``."""
    b1, b2 = ADAM_BETAS
    for k in g:
        m[k] = b1 * m[k] + (1 - b1) * g[k]
        v2[k] = b2 * v2[k] + (1 - b2) * g[k] * g[k]
        m_hat = m[k] / (1 - b1 ** t)
        v_hat = v2[k] / (1 - b2 ** t)
        p[k] = (p[k] - lr * m_hat / (torch.sqrt(v_hat) + ADAM_EPS)).detach()


@torch.no_grad()
def evaluate(model: PlainVAE, params: dict, buf: dict, x_all, label,
             draw_eps, batch_size: int, half: bool = False):
    """(z_c [N, z/2], z_s, mse) of the eval-mode forward over ``x_all`` in
    order: batches of ``batch_size``, then the ragged tail, each with the
    noise ``draw_eps(n)``; mse is the mean over the batches of each batch's
    per-sample reconstruction error (the tail counting as one batch).
    ``half`` takes each batch's mean over its first half (a planted
    fault: half of the batch left out)."""
    n = x_all.shape[0]
    zs, recons = [], []
    for s in range(0, n, batch_size):
        x = x_all[s:s + batch_size]
        x_hat, _, z, _ = model.forward(params, buf, x, draw_eps(x.shape[0]),
                                       train=False)
        zs.append(z)
        rows = slice(0, max(1, x.shape[0] // 2)) if half else slice(None)
        recons.append(float(per_sample_mean((x_hat[rows] - x[rows]) ** 2)))
    z = torch.cat(zs)
    return z[:, :model.zd], z[:, model.zd:], sum(recons) / len(recons)


# -- the interface the harness reads ---------------------------------------------


def param_spec(config: dict) -> list:
    """[(name, shape, bound)] of the configuration's model (``PlainVAE``)."""
    return PlainVAE(config["model"]).param_spec()


def hyper(config: dict) -> dict:
    kw = config["trainer"]["kwargs"]
    return {"beta": kw["beta"], "alpha": kw["alpha"],
            "temperature": kw["temperature"], "lr": kw["vae_lr"]}


def train_noise(config: dict, gen: torch.Generator, n: int, device):
    """The draws of one step of n rows from the trainer's noise generator,
    in its order: the reparameterization's eps [2, n, z/2], z_c's first.
    An evaluation step draws the same."""
    zd = config["model"]["z_dim"] // 2
    return torch.randn((2, n, zd), generator=gen, device=device)


def train(config: dict, weights: dict, batches, half: bool = False) -> dict:
    """``train_steps`` of the configuration from ``weights``; ``batches``
    [(x NHWC, label, noise)]."""
    return train_steps(PlainVAE(config["model"]), weights, batches,
                       hyper(config), half)


def validate(config: dict, state: dict, x, labels, gen: torch.Generator,
             batch_size: int, half: bool = False,
             mig_dtype=torch.float64) -> tuple:
    """(gMIG, MSE) of the evaluation of ``x`` [N, H, W, C] from a model
    ``state`` (parameters and BatchNorm running statistics, by name) and
    the noise generator ``gen`` as the evaluation finds it. ``half``
    leaves half of each batch out of the MSE and of gMIG (a planted
    fault); ``mig_dtype`` float32 is the control's gMIG."""
    return validate_draws(config, state, x, labels,
                          lambda k: train_noise(config, gen, k, x.device),
                          batch_size, half, mig_dtype)


def validate_draws(config: dict, state: dict, x, labels, draw,
                   batch_size: int, half: bool = False,
                   mig_dtype=torch.float64) -> tuple:
    """``validate`` with an eval batch of k rows taking its noise from
    ``draw(k)``, which returns the reparameterization's eps [2, k, z/2]."""
    model = PlainVAE(config["model"])
    params = {k: state[k].float() for k, _, _ in model.param_spec()}
    buf = {k: v for k, v in state.items() if "running_" in k}
    z_c, z_s, mse = evaluate(model, params, buf, x, labels, draw, batch_size,
                             half)
    if half:
        keep = (torch.arange(len(labels), device=labels.device)
                % batch_size) < batch_size // 2
        labels, z_c, z_s = labels[keep], z_c[keep], z_s[keep]
    return RM.mutual_info_gap(labels, z_c, z_s, mig_dtype), mse
