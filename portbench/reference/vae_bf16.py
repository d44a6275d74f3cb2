"""The plain reference of the 64×64 runners' perf mode
(``downstream64.PERF_VAE_KWARGS``: ``{"dtype": "bfloat16", "fused_heads":
true}`` in a configuration's ``model`` block): ``vae.py``'s ``PlainVAE``
with its conv stacks computed in bfloat16 and its four latent heads as one
Linear, and ``vae.py``'s CLEAR loss, Adam and evaluation.

The configuration states bfloat16 for the conv stacks, so the reference
computes at that precision: in float32 operations (TF32 off, as the check
sets it) on values rounded to bfloat16 at the points where the program
casts (``clearvae_torch/models/layers.py`` ``cast_conv``,
``cast_conv_transpose``, ``cast_linear`` and ``BatchNorm.forward``;
``models/vae.py`` ``encode`` and ``_Decoder.forward``):

- each conv's, ConvTranspose's and the decoder's dense layer's input,
  weight, bias and output (a bf16 operation accumulates in float32 and
  rounds its result once). On a CUDA device torch adds a convolution's
  bias apart (``at::_convolution`` runs cuDNN's convolution without it and
  then adds it as a bf16 operation of its own; on the CPU oneDNN adds it
  inside the convolution), so there the convolution's result is rounded
  before the bias is added and the sum again;
- BatchNorm's output (its statistics and normalization are float32, on an
  input that is already bfloat16);
- the activations that follow in bfloat16: each ReLU, and the last
  sigmoid before the reconstruction goes back to float32.

Each rounding is ``rnd``, whose backward rounds the gradient the same way,
as the program's cast back of that gradient to bfloat16 does. These are
the configuration's stated precision, not departures from it. The latent
heads (one [4·z/2, flat] Linear, its rows in ``chunk(4)``'s order mu_c,
logvar_c, mu_s, logvar_s), the reparameterization, the loss and Adam stay
float32, as in the program.

``ROUND`` is the one rounding dtype. The check asks a reference for its
control, the reference one precision below the configuration's, by
turning TF32 on (``check.reference_steps(tf32=True)``). That puts the
float32 matmuls (the heads) in TF32 but leaves every bf16 value as it
was, since TF32 holds each one exactly; so under that switch this
reference rounds at
``BELOW`` (float8_e4m3fn), the precision below bfloat16, in ``ROUND``'s
place too: every stated precision one step down. The module imports
nothing of the program.
"""

from __future__ import annotations

import math

import torch
from torch.nn import functional as F

from portbench.reference import mig as RM
from portbench.reference import vae as V

ROUND = torch.bfloat16
BELOW = torch.float8_e4m3fn
HEADS = ("mu_c", "logvar_c", "mu_s", "logvar_s")


def rounding() -> torch.dtype:
    """``ROUND``, or ``BELOW`` where the check has turned TF32 on for its
    control."""
    return BELOW if torch.backends.cuda.matmul.allow_tf32 else ROUND


class _Round(torch.autograd.Function):
    """To ``rounding()`` and back to float32, the gradient likewise."""

    @staticmethod
    def forward(ctx, x):
        ctx.dtype = rounding()
        return x.to(ctx.dtype).float()

    @staticmethod
    def backward(ctx, g):
        return g.to(ctx.dtype).float()


def rnd(x: torch.Tensor) -> torch.Tensor:
    return _Round.apply(x)


class PlainVAEBF16(V.PlainVAE):
    """``PlainVAE`` in the perf mode: the fused heads' parameters, and the
    forward rounded as the module's docstring sets out. The ``model`` block
    has to state the mode."""

    def __init__(self, m: dict):
        if (m.get("dtype"), m.get("fused_heads")) != ("bfloat16", True):
            raise ValueError("the perf mode's reference needs a model block "
                             'with "dtype": "bfloat16", "fused_heads": true')
        super().__init__(m)

    def param_spec(self) -> list:
        """``PlainVAE``'s, the four heads replaced, in their place, by
        ``latent_heads.weight`` [4·z/2, flat] and ``latent_heads.bias``
        [4·z/2], drawn in ±1/sqrt(flat)."""
        heads = {f"{h}_head.{k}" for h in HEADS for k in ("weight", "bias")}
        spec, b = [], 1 / math.sqrt(self.flat)
        for entry in super().param_spec():
            if entry[0] == f"{HEADS[0]}_head.weight":
                spec += [("latent_heads.weight", (4 * self.zd, self.flat), b),
                         ("latent_heads.bias", (4 * self.zd,), b)]
            if entry[0] not in heads:
                spec.append(entry)
        return spec

    @staticmethod
    def _layer(fn, p, name, h, **kw):
        """``fn`` in bfloat16: input, weight, bias and output rounded, a
        convolution's bias added apart where torch adds it so."""
        x, w, b = rnd(h), rnd(p[f"{name}.weight"]), rnd(p[f"{name}.bias"])
        if fn is F.linear or not h.is_cuda:
            return rnd(fn(x, w, b, **kw))
        return rnd(rnd(fn(x, w, None, **kw)) + b.view(1, -1, 1, 1))

    def forward(self, p: dict, buf: dict, x: torch.Tensor, eps: torch.Tensor,
                train: bool):
        """As ``PlainVAE.forward``, in the perf mode."""
        m, new_buf = self.m, dict(buf)
        h = x.permute(0, 3, 1, 2)
        for i in range(len(self.enc) - 1):
            h = self._layer(F.conv2d, p, f"encoder.convs.{i}", h, stride=2,
                            padding=1)
            h = rnd(F.relu(rnd(self._bn_apply(p, buf, f"encoder.bns.{i}", h,
                                              train, new_buf))))
        h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)
        heads = tuple((h @ p["latent_heads.weight"].T
                       + p["latent_heads.bias"]).chunk(4, -1))
        mu_c, lv_c, mu_s, lv_s = heads
        z = torch.cat([mu_c + eps[0] * torch.exp(0.5 * lv_c),
                       mu_s + eps[1] * torch.exp(0.5 * lv_s)], -1)
        d = self._layer(F.linear, p, "decoder.dense", z)
        d = rnd(F.relu(rnd(self._bn_apply(p, buf, "decoder.bns.0", d, train,
                                          new_buf))))
        s = m["dec_spatial"]
        d = d.view(-1, s, s, self.dec[0]).permute(0, 3, 1, 2)
        last = len(self.dec) - 2
        for i in range(len(self.dec) - 1):
            d = self._layer(F.conv_transpose2d, p, f"decoder.convts.{i}", d,
                            stride=2, padding=1,
                            output_padding=m["dec_output_paddings"][i])
            d = rnd(self._bn_apply(p, buf, f"decoder.bns.{i + 1}", d, train,
                                   new_buf))
            d = rnd(torch.sigmoid(d) if i == last else F.relu(d))
        return d.permute(0, 2, 3, 1), heads, z, new_buf


# -- the interface the harness reads ---------------------------------------------


def param_spec(config: dict) -> list:
    """[(name, shape, bound)] of the configuration's model
    (``PlainVAEBF16``)."""
    return PlainVAEBF16(config["model"]).param_spec()


train_noise = V.train_noise


def train(config: dict, weights: dict, batches, half: bool = False) -> dict:
    """``vae.train_steps`` of ``PlainVAEBF16`` from ``weights``."""
    return V.train_steps(PlainVAEBF16(config["model"]), weights, batches,
                         V.hyper(config), half)


def validate(config: dict, state: dict, x, labels, gen: torch.Generator,
             batch_size: int, half: bool = False,
             mig_dtype=torch.float64) -> tuple:
    """(gMIG, MSE) as ``vae.validate``, of ``PlainVAEBF16``."""
    model = PlainVAEBF16(config["model"])
    params = {k: state[k].float() for k, _, _ in model.param_spec()}
    buf = {k: v for k, v in state.items() if "running_" in k}
    z_c, z_s, mse = V.evaluate(
        model, params, buf, x, labels,
        lambda k: train_noise(config, gen, k, x.device), batch_size, half)
    if half:
        keep = (torch.arange(len(labels), device=labels.device)
                % batch_size) < batch_size // 2
        labels, z_c, z_s = labels[keep], z_c[keep], z_s[keep]
    return RM.mutual_info_gap(labels, z_c, z_s, mig_dtype), mse
