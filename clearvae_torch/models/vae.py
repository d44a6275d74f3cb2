"""Style–content VAE (counterpart of ``clearvae_tpu/models/vae.py``;
reference code/src/models/vae.py:7-102).

``VAE`` (28×28): conv trunk in→32→64→128 (3×3, stride 2, pad 1, BN+ReLU),
flatten 2048, four Linear heads (mu_c, logvar_c, mu_s, logvar_s), decoder
Linear(2z→2048)+BN+ReLU → (4,4,128) → ConvT(64,3,s2,p1,op0)→7² →
ConvT(32,3,s2,p1,op1)→14² → ConvT(in,3,s2,p1,op1)→28², with BN after every
ConvT, the last one included, before the sigmoid (vae.py:44). ``VAE64``
(64×64): 5 conv / 5 ConvT stages with 4×4 kernels, channels 32…512, the
2×2×512 trunk (reference vae.py:105-156).

``dtype`` is the conv stacks' compute dtype (the decoder's Linear
included); the parameters, the latent heads, the losses and the decoder's
output stay float32, as in the JAX package (vae.py:63,117).

The public layout is NHWC, as in the JAX package; the flatten is in
(H, W, C) order, so flax's Dense kernels map by a transpose alone. The
reparameterization draws z_c, then z_s, from an explicit generator, or takes
injected ``eps`` = (eps_c, eps_s).

With ``group_mode`` ("GVAE" or "MLVAE") and a ``label`` passed to
``forward``, the content posterior is replaced by the per-class evidence of
``ops/group.py`` and z_c is drawn group-wise (reference vae.py:81-102).
"""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from clearvae_torch.models.layers import (BatchNorm, ConvBNReluStack,
                                          cast_conv_transpose, cast_linear,
                                          conv_transpose2d, linear)
from clearvae_torch.ops.group import accumulate_group_evidence, group_reparam


class _Decoder(nn.Module):
    """Linear → BN → ReLU → reshape → [ConvT → BN → ReLU]* → ConvT → BN →
    sigmoid, computed in ``dtype``; the reconstruction is float32."""

    def __init__(self, z_total: int, spatial: int, channels, kernel: int,
                 output_paddings, dtype=torch.float32):
        super().__init__()
        self.spatial, self.c0, self.dtype = spatial, channels[0], dtype
        self.dense = linear(z_total, spatial * spatial * channels[0])
        self.convts = nn.ModuleList(
            conv_transpose2d(ci, co, kernel, 2, 1, op)
            for ci, co, op in zip(channels[:-1], channels[1:], output_paddings))
        self.bns = nn.ModuleList(
            [BatchNorm(spatial * spatial * channels[0])]
            + [BatchNorm(co) for co in channels[1:]])

    def forward(self, z: torch.Tensor, train: bool) -> torch.Tensor:
        h = F.relu(self.bns[0](cast_linear(self.dense, z, self.dtype), train))
        x = h.view(-1, self.spatial, self.spatial, self.c0).permute(0, 3, 1, 2)
        last = len(self.convts) - 1
        for i, (convt, bn) in enumerate(zip(self.convts, self.bns[1:])):
            x = bn(cast_conv_transpose(convt, x, self.dtype), train)
            x = torch.sigmoid(x) if i == last else F.relu(x)
        return x.permute(0, 2, 3, 1).float()


class VAE(nn.Module):
    """28×28 style–content VAE (reference: code/src/models/vae.py:7-102).

    ``fused_heads`` emits the four latent heads from one [flat, 4·z] Linear
    (``latent_heads``) and splits it. ``first_conv_pack`` is accepted for
    configuration parity: the JAX package computes its first conv as a packed
    matmul for the TPU's matrix unit with identical math, so here it is the
    plain conv.
    """

    enc_channels = (32, 64, 128)
    enc_kernel = 3
    dec_spatial = 4
    dec_kernel = 3
    dec_output_paddings = (0, 1, 1)

    def __init__(self, total_z_dim: int, in_channel: int = 1,
                 image_size: int = 28, group_mode: str | None = None,
                 n_classes: int = 10, dtype=torch.float32,
                 fused_heads: bool = False, first_conv_pack: bool = False):
        super().__init__()
        self.total_z_dim, self.in_channel = total_z_dim, in_channel
        self.image_size, self.dtype = image_size, dtype
        self.group_mode, self.n_classes = group_mode, n_classes
        self.fused_heads, self.first_conv_pack = fused_heads, first_conv_pack
        zd = self.z_dim
        self.encoder = ConvBNReluStack(in_channel, self.enc_channels,
                                       self.enc_kernel, 2, 1, dtype)
        flat = self.dec_spatial * self.dec_spatial * self.enc_channels[-1]
        if fused_heads:
            self.latent_heads = linear(flat, 4 * zd)
        else:
            self.mu_c_head = linear(flat, zd)
            self.logvar_c_head = linear(flat, zd)
            self.mu_s_head = linear(flat, zd)
            self.logvar_s_head = linear(flat, zd)
        dec_channels = ((self.enc_channels[-1],)
                        + tuple(reversed(self.enc_channels[:-1]))
                        + (in_channel,))
        self.decoder = _Decoder(total_z_dim, self.dec_spatial, dec_channels,
                                self.dec_kernel, self.dec_output_paddings,
                                dtype)

    @property
    def z_dim(self) -> int:
        return self.total_z_dim // 2

    def encode(self, x: torch.Tensor, train: bool = False,
               update_stats: bool = True):
        """(mu_c, logvar_c, mu_s, logvar_s) of an NHWC batch — reference
        vae.py:48-50. ``update_stats=False`` runs train mode without moving
        the running statistics."""
        h = self.encoder(x.permute(0, 3, 1, 2), train, update_stats).float()
        if self.fused_heads:
            return tuple(self.latent_heads(h).chunk(4, dim=-1))
        return (self.mu_c_head(h), self.logvar_c_head(h),
                self.mu_s_head(h), self.logvar_s_head(h))

    def decode(self, z: torch.Tensor, train: bool = False) -> torch.Tensor:
        """NHWC reconstruction in (0, 1)."""
        return self.decoder(z, train)

    def forward(self, x: torch.Tensor, train: bool = True, eps=None,
                generator: torch.Generator | None = None,
                label: torch.Tensor | None = None, shard=None):
        """(x_hat, latent_params, z) — the JAX package's ``explicit=True``
        output. Noise: ``eps`` = (eps_c, eps_s) if given, else two draws
        from ``generator`` (z_c first, then z_s; reference vae.py:62-79).

        With ``label`` (GVAE/MLVAE) latent_params carry the [n_classes, z]
        group params under mu_c/logvar_c and a ``present`` mask. Under a
        data mesh (``shard``, a ``parallel.mesh.Shard``) ``x`` and ``eps``
        are this rank's rows and ``label`` the global batch's: the evidence
        is accumulated over the gathered mu_c and logvar_c, and each local
        row draws from its group."""
        mu_c, logvar_c, mu_s, logvar_s = self.encode(x, train)
        if eps is None:
            eps = [torch.randn(mu_c.shape, generator=generator,
                               device=mu_c.device, dtype=mu_c.dtype)
                   for _ in range(2)]
        if label is not None:
            if self.group_mode is None:
                raise ValueError("label given but group_mode is None")
            own = label
            if shard is not None:
                n = label.shape[0]
                mu_c, logvar_c = shard.gather(mu_c, n), shard.gather(logvar_c, n)
                own = shard.rows(label)
            mu_g, logvar_g, present = accumulate_group_evidence(
                mu_c, logvar_c, label, self.n_classes, self.group_mode)
            z_c = group_reparam(mu_g, logvar_g, own, eps[0])
            latent_params = {"mu_c": mu_g, "logvar_c": logvar_g,
                             "mu_s": mu_s, "logvar_s": logvar_s,
                             "present": present}
        else:
            z_c = mu_c + eps[0] * torch.exp(0.5 * logvar_c)
            latent_params = {"mu_c": mu_c, "logvar_c": logvar_c,
                             "mu_s": mu_s, "logvar_s": logvar_s}
        z_s = mu_s + eps[1] * torch.exp(0.5 * logvar_s)
        z = torch.cat([z_c, z_s], dim=-1)
        return self.decode(z, train), latent_params, z


class VAE64(VAE):
    """64×64 variant (reference: code/src/models/vae.py:105-156): RGB by
    default, 5 conv / 5 ConvT stages with 4×4 kernels, the decoder starting
    from 2×2×512."""

    enc_channels = (32, 64, 128, 256, 512)
    enc_kernel = 4
    dec_spatial = 2
    dec_kernel = 4
    dec_output_paddings = (0, 0, 0, 0, 0)

    def __init__(self, total_z_dim: int, in_channel: int = 3,
                 image_size: int = 64, **kwargs):
        super().__init__(total_z_dim, in_channel, image_size, **kwargs)
