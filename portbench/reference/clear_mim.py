"""The plain reference of CLEAR-MIM's training step (scotsun/clear-vae
code/src/trainer.py:781-897) with the two MI estimators its experiments
run, CLUB-Sample and L1OutUB (code/src/mi_estimator.py:108-146 and
149-198, after the CLUB repository), in float32 torch operations with
autograd. It has the interface of ``vae.py`` and takes from it the model
(``PlainVAE``), the KL term, the SNN loss, Adam and the evaluation; gMIG
is ``mig.py``'s. It imports nothing of the program.

A train step of a batch x with labels:

1. the VAE's update: recon + w·(KL_c + KL_s) + α·SNN(mu_c) + λ·bound(z_c,
   z_s), the bound the estimator's on the sampled latents, as the
   estimator stands; the gradient reaches the VAE's leaves alone, and
   one Adam step (``vae_lr``) takes it (w: the KL weight's logistic
   anneal, as in ``vae.py``);
2. the updated VAE encodes x again in train mode, on the batch's
   statistics (the BatchNorm running statistics stay as step 1 left them,
   as the program's step leaves them; they enter no number that the check
   compares, since validation starts from the program's state);
3. ``INNER_STEPS`` Adam steps of the estimator (``mi_estimator_lr``) on
   its learning loss, −E[log q(z_s | z_c)] up to constants, at z = mu +
   eps_i · std with mu and std from step 2 held fixed and a fresh eps_i a
   step.

L1OutUB keeps the published code's broadcast: its diagonal mask
``ones(B).diag().unsqueeze(-1) · −20`` is [B, B, 1], so added to the
[B, B] log-densities it makes a [B, B, B] tensor, whose logsumexp over dim
0 is not the paper's leave-one-out term (the bound reduces to mean(positive)
− mean(all) − log(B − 1 + e^−20) + log(B − 1)). That is the paper's code,
and so the step its experiments trained; it is computed here as written.

Leaves: the model's by ``PlainVAE``'s names, the estimator's as
``mi_estimator.net.<mu|lv>_<l1|l2>.<weight|bias>`` (the trainer's
attribute, then the critic's layers; ``linear`` layers [out, in]).
"""

from __future__ import annotations

import math

import torch
from torch.nn import functional as F

from portbench.reference import vae as V

EST = "mi_estimator"
# the estimator's updates a train step (trainer.py:874)
INNER_STEPS = 5


def _estimator(config: dict) -> str:
    """The configuration's estimator, by the zoo's names."""
    name = config["trainer"]["kwargs"]["mi_estimator"]
    if name not in ("L1OutUB", "CLUBSample"):
        raise ValueError(f"no reference of the MI estimator {name!r}")
    return name


def estimator_spec(config: dict) -> list:
    """[(name, shape, bound)] of the critic: for mu and for logvar a layer
    z/2 → h and a layer h → z/2, h = z_dim // 2 (the factory's
    ``hidden_size=z_dim``, halved for each of the two nets), uniform in
    ±1/sqrt(fan_in)."""
    zd = config["model"]["z_dim"] // 2
    h = config["model"]["z_dim"] // 2
    spec = []
    for net in ("mu", "lv"):
        for layer, fin, fout in (("l1", zd, h), ("l2", h, zd)):
            b = 1 / math.sqrt(fin)
            spec += [(f"{EST}.net.{net}_{layer}.weight", (fout, fin), b),
                     (f"{EST}.net.{net}_{layer}.bias", (fout,), b)]
    return spec


def critic(est: dict, x: torch.Tensor) -> tuple:
    """(mu, logvar) of q(y | x): two MLPs, logvar squashed by tanh."""

    def mlp(net):
        h = F.relu(x @ est[f"{EST}.net.{net}_l1.weight"].T
                   + est[f"{EST}.net.{net}_l1.bias"])
        return h @ est[f"{EST}.net.{net}_l2.weight"].T \
            + est[f"{EST}.net.{net}_l2.bias"]

    return mlp("mu"), torch.tanh(mlp("lv"))


def bound(name: str, est: dict, x, y, perm) -> torch.Tensor:
    """The estimator's MI upper bound on (x, y) = (z_c, z_s)."""
    mu, logvar = critic(est, x)
    if name == "CLUBSample":
        positive = -((mu - y) ** 2) / logvar.exp()
        negative = -((mu - y[perm]) ** 2) / logvar.exp()
        return (positive.sum(-1) - negative.sum(-1)).mean() / 2.0
    b = y.shape[0]
    positive = (-((mu - y) ** 2) / 2.0 / logvar.exp() - logvar / 2.0).sum(-1)
    all_probs = (-((y[None, :, :] - mu[:, None, :]) ** 2) / 2.0
                 / logvar[:, None, :].exp() - logvar[:, None, :] / 2.0).sum(-1)
    diag_mask = torch.ones(b, device=y.device).diag().unsqueeze(-1) * (-20.0)
    negative = torch.logsumexp(all_probs + diag_mask, 0) - math.log(b - 1.0)
    return (positive - negative).mean()


def learning_loss(est: dict, x, y) -> torch.Tensor:
    """−(−(mu − y)² / var − logvar) summed over y's dims, the batch's mean."""
    mu, logvar = critic(est, x)
    return -((-((mu - y) ** 2) / logvar.exp() - logvar).sum(1).mean(0))


def mim_loss(x, x_hat, heads, z, label, est, perm, hp: dict, step: int,
             half: bool = False):
    """The VAE's loss of step 1; ``half`` takes the per-sample means over
    the first half of the batch (a planted fault: half of the batch left
    out)."""
    rows = slice(0, x.shape[0] // 2) if half else slice(None)
    mu_c, lv_c, mu_s, lv_s = heads
    zd = mu_c.shape[1]
    recon = V.per_sample_mean((x_hat[rows] - x[rows]) ** 2)
    w = hp["beta"] / (1.0 + math.exp(-float(step)))
    c = V.snn(mu_c, label, hp["temperature"], False)
    mi = bound(hp["estimator"], est, z[:, :zd], z[:, zd:], perm)
    return (recon + w * V.kl(mu_c[rows], lv_c[rows])
            + w * V.kl(mu_s[rows], lv_s[rows]) + hp["alpha"] * c
            + hp["la"] * mi)


def train_steps(model: V.PlainVAE, params: dict, batches, hp: dict,
                half: bool = False) -> dict:
    """The reference's first CLEAR-MIM steps from ``params`` (the model's
    and the estimator's leaves): each of ``batches`` an (x NHWC, label,
    noise) triple, ``noise`` as ``train_noise`` draws it. Returns
    {"losses": [the VAE's loss a step], "grad1": {leaf: the first gradient
    that its optimizer takes: the model's in step 1's VAE update, the
    estimator's in step 1's first inner update}, "params": {leaf: after
    the last step}}."""
    dev = next(iter(params.values())).device
    p = {k: v.detach().clone() for k, v in params.items()}
    vae_keys = [k for k, _, _ in model.param_spec()]
    est_keys = [k for k in p if k.startswith(f"{EST}.")]
    buf = model.buffers(dev)
    m = {k: torch.zeros_like(v) for k, v in p.items()}
    v2 = {k: torch.zeros_like(v) for k, v in p.items()}
    losses, grad1, inner_t = [], {}, 0
    for t, (x, label, noise) in enumerate(batches, start=1):
        leaves = {k: p[k].requires_grad_(True) for k in vae_keys}
        est = {k: p[k] for k in est_keys}
        x_hat, heads, z, buf = model.forward(leaves, buf, x, noise["eps"],
                                             train=True)
        loss = mim_loss(x, x_hat, heads, z, label, est, noise["perm"], hp,
                        t - 1, half)
        g = dict(zip(vae_keys, torch.autograd.grad(loss, list(leaves.values()))))
        losses.append(float(loss.detach()))
        if t == 1:
            grad1.update({k: v.detach().clone() for k, v in g.items()})
        V.adam_update(p, m, v2, g, t, hp["lr"])
        with torch.no_grad():
            zeros = torch.zeros_like(noise["eps"])
            _, (mu_c, lv_c, mu_s, lv_s), _, _ = model.forward(
                p, buf, x, zeros, train=True)
            mu = torch.cat([mu_c, mu_s], -1)
            std = torch.exp(0.5 * torch.cat([lv_c, lv_s], -1))
        zd = mu_c.shape[1]
        for eps in noise["inner"]:
            zi = mu + eps * std
            est = {k: p[k].detach().requires_grad_(True) for k in est_keys}
            inner = learning_loss(est, zi[:, :zd], zi[:, zd:])
            g = dict(zip(est_keys, torch.autograd.grad(inner,
                                                       list(est.values()))))
            inner_t += 1
            if inner_t == 1:
                grad1.update({k: v.detach().clone() for k, v in g.items()})
            V.adam_update(p, m, v2, g, inner_t, hp["est_lr"])
    return {"losses": losses, "grad1": grad1, "params": p}


# -- the interface the harness reads ---------------------------------------------


def param_spec(config: dict) -> list:
    """[(name, shape, bound)]: the model's (``PlainVAE``), then the
    estimator's."""
    _estimator(config)
    return V.param_spec(config) + estimator_spec(config)


def hyper(config: dict) -> dict:
    kw = config["trainer"]["kwargs"]
    return {**V.hyper(config), "la": kw["la"], "est_lr": kw["mi_estimator_lr"],
            "estimator": _estimator(config)}


def _perm(config: dict, gen: torch.Generator, n: int, device):
    if _estimator(config) == "CLUBSample":
        return torch.randperm(n, generator=gen, device=device)
    return None


def train_noise(config: dict, gen: torch.Generator, n: int, device) -> dict:
    """The draws of one train step of n rows from the trainer's noise
    generator, in its order: the estimator's [INNER_STEPS, n, z], the
    reparameterization's eps [2, n, z/2] (z_c's first), then CLUB-S's
    permutation of the n rows (None for L1OutUB)."""
    z = config["model"]["z_dim"]
    inner = torch.randn((INNER_STEPS, n, z), generator=gen, device=device)
    eps = torch.randn((2, n, z // 2), generator=gen, device=device)
    return {"inner": inner, "eps": eps, "perm": _perm(config, gen, n, device)}


def train(config: dict, weights: dict, batches, half: bool = False) -> dict:
    """``train_steps`` of the configuration from ``weights``; ``batches``
    [(x NHWC, label, noise)]."""
    return train_steps(V.PlainVAE(config["model"]), weights, batches,
                       hyper(config), half)


def validate(config: dict, state: dict, x, labels, gen: torch.Generator,
             batch_size: int, half: bool = False,
             mig_dtype=torch.float64) -> tuple:
    """``vae.validate`` with an eval batch's draws in the trainer's order:
    eps [2, k, z/2], then CLUB-S's permutation of the k rows, which the
    evaluation's MI estimate takes and gMIG and the MSE do not."""
    zd = config["model"]["z_dim"] // 2

    def draw(k):
        eps = torch.randn((2, k, zd), generator=gen, device=x.device)
        _perm(config, gen, k, x.device)
        return eps

    return V.validate_draws(config, state, x, labels, draw, batch_size, half,
                            mig_dtype)
