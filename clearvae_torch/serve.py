"""Inference API: a frozen session over a trained VAE (counterpart of
``clearvae_tpu/serve.py``).

The session holds its own eval-mode copy of the model on the device that
``resolve_device`` gives (``cuda`` unless the caller asks for the CPU) and
runs every entry point under ``torch.no_grad()``: encode (the posterior
heads), deterministic or sampled reconstruction, decode, and the
style/content manipulations (swap, interpolate).

    sess = InferenceSession.from_checkpoint(VAE(total_z_dim=16), ckpt_dir)
    mu_c, logvar_c, mu_s, logvar_s = sess.encode(x)
    x_hat = sess.reconstruct(x)                 # deterministic (mu)
    swapped = sess.swap(x_content, x_style)     # z_c from A, z_s from B

Images are NHWC, as in the JAX package; outputs are tensors on the
session's device.
"""

from __future__ import annotations

import copy
import os

import numpy as np
import torch

from clearvae_torch import resolve_device
from clearvae_torch.utils.visual import interpolate_latent


class InferenceSession:
    def __init__(self, model, device=None):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.z_dim = model.total_z_dim // 2

    @classmethod
    def from_checkpoint(cls, model, directory_or_path: str,
                        device=None) -> "InferenceSession":
        """``model`` with the weights of the latest checkpoint a trainer
        saved in a directory (or of the given checkpoint)."""
        from clearvae_torch.utils.checkpoint import (latest_checkpoint,
                                                     restore_checkpoint)

        path = directory_or_path
        if os.path.isdir(path):
            path = latest_checkpoint(path)
        model.load_state_dict(restore_checkpoint(path)["modules"]["model"])
        return cls(model, device)

    @classmethod
    def from_trainer(cls, trainer) -> "InferenceSession":
        """A snapshot of a live trainer's model, on the trainer's device."""
        return cls(copy.deepcopy(trainer.model), trainer.device)

    # ------------------------------------------------------------------

    def _tensor(self, a) -> torch.Tensor:
        """An array or tensor as float32 on the session's device."""
        if not isinstance(a, torch.Tensor):
            a = torch.from_numpy(np.asarray(a, dtype=np.float32))
        return a.to(device=self.device, dtype=torch.float32)

    def _canon(self, x) -> torch.Tensor:
        """Canonicalize image input to NHWC [B, H, W, C] float32 on the
        session's device.

        Accepts [B,H,W,C]; [B,H,W] (grayscale batch, channel axis appended);
        [H,W,C] (single image, batch axis prepended); [H,W] (single
        grayscale). Disambiguates [X,H,W] -vs- [H,W,C] by the model's
        ``in_channel``. Anything else (e.g. torch-style NCHW) raises rather
        than silently encoding garbage."""
        x = self._tensor(x)
        c = self.model.in_channel
        if x.ndim == 2:
            x = x[None, :, :, None]
        elif x.ndim == 3:
            x = x[None] if x.shape[-1] == c else x[..., None]
        if x.ndim != 4 or x.shape[-1] != c:
            raise ValueError(
                f"expected NHWC images with {c} channel(s), got "
                f"{tuple(x.shape)} (torch-style NCHW input must be "
                "transposed)")
        return x

    @torch.no_grad()
    def encode(self, x):
        """(mu_c, logvar_c, mu_s, logvar_s)."""
        return self.model.encode(self._canon(x), train=False)

    @torch.no_grad()
    def decode(self, z):
        return self.model.decode(self._tensor(z), train=False)

    @torch.no_grad()
    def reconstruct(self, x, sample: bool = False, seed: int = 0):
        """Deterministic (z = mu) or, with ``sample``, sampled
        reconstruction, its noise from a generator seeded with ``seed``."""
        if sample:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            return self.model(self._canon(x), train=False, generator=gen)[0]
        mu_c, _, mu_s, _ = self.encode(x)
        return self.decode(torch.cat([mu_c, mu_s], -1))

    def swap(self, x_content, x_style):
        """Decode (z_c from x_content, z_s from x_style) — the feature-swap
        operation behind the reference's swapping grids."""
        mu_c, _, _, _ = self.encode(x_content)
        _, _, mu_s, _ = self.encode(x_style)
        return self.decode(torch.cat([mu_c, mu_s], -1))

    def interpolate(self, x1, x2, num_steps: int = 11, what: str = "style"):
        """Interpolation strip between two images in one latent half, the
        other half held at x1's."""
        mu_c1, _, mu_s1, _ = self.encode(x1)
        mu_c2, _, mu_s2, _ = self.encode(x2)
        if what == "style":
            zi = interpolate_latent(mu_s1[0], mu_s2[0], num_steps)
            z = torch.cat([mu_c1.repeat_interleave(num_steps, 0), zi], -1)
        else:
            zi = interpolate_latent(mu_c1[0], mu_c2[0], num_steps)
            z = torch.cat([zi, mu_s1.repeat_interleave(num_steps, 0)], -1)
        return self.decode(z)
