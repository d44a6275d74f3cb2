"""Weight bridge: the JAX package's flax ``VAE`` and ``ProbeMLP`` variables →
state dicts of the port's ``VAE`` and ``ProbeMLP``.

Takes the variables as nested dicts of numpy arrays (``params`` and
``batch_stats``), so it needs no JAX import. The map (after
scripts/reference_twin.py:67-140, without its flatten permutation: the port
flattens in flax's (H, W, C) order):

- Conv kernels HWIO → OIHW;
- ConvTranspose kernels flip(h, w) then HWIO → IOHW: the JAX layer is a
  cross-correlation over the lhs-dilated input, torch's ConvTranspose2d
  applies its kernel unflipped in the output domain;
- Dense kernels [in, out] → Linear weights [out, in];
- BatchNorm scale/bias → weight/bias, batch_stats mean/var → running stats.
"""

from __future__ import annotations

import numpy as np
import torch


def _dense(sd, prefix, d):
    sd[f"{prefix}.weight"] = np.asarray(d["kernel"]).T
    sd[f"{prefix}.bias"] = np.asarray(d["bias"])


def _bn(sd, prefix, p, s):
    sd[f"{prefix}.weight"] = np.asarray(p["scale"])
    sd[f"{prefix}.bias"] = np.asarray(p["bias"])
    sd[f"{prefix}.running_mean"] = np.asarray(s["mean"])
    sd[f"{prefix}.running_var"] = np.asarray(s["var"])


def params_from_flax(params: dict, batch_stats: dict) -> dict:
    """State dict of ``clearvae_torch.models.vae.VAE`` from the JAX
    package's ``VAE`` variables. Raises if a flax parameter is left
    unmapped."""
    sd: dict = {}
    used: set = set()
    enc, enc_s = params["encoder"], batch_stats["encoder"]
    n_conv = sum(k.startswith("BatchNorm_") for k in enc)
    # with first_conv_pack the first conv is Conv1MXUPack_0 (same kernel
    # shape) and flax numbers the remaining ConvTorch modules from 0
    packed = "Conv1MXUPack_0" in enc
    for i in range(n_conv):
        if packed and i == 0:
            conv, name = enc["Conv1MXUPack_0"], "Conv1MXUPack_0"
        else:
            name = f"ConvTorch_{i - packed}"
            conv = enc[name]["Conv_0"]
        sd[f"encoder.convs.{i}.weight"] = np.asarray(conv["kernel"]).transpose(
            3, 2, 0, 1)
        sd[f"encoder.convs.{i}.bias"] = np.asarray(conv["bias"])
        _bn(sd, f"encoder.bns.{i}", enc[f"BatchNorm_{i}"],
            enc_s[f"BatchNorm_{i}"])
        used |= {("encoder", name), ("encoder", f"BatchNorm_{i}")}
    used.add(("encoder",))

    heads = ("latent_heads",) if "latent_heads" in params else (
        "mu_c_head", "logvar_c_head", "mu_s_head", "logvar_s_head")
    for h in heads:
        _dense(sd, h, params[h]["Dense_0"])
        used.add((h,))

    dec, dec_s = params["decoder"], batch_stats["decoder"]
    _dense(sd, "decoder.dense", dec["DenseTorch_0"]["Dense_0"])
    n_ct = sum(k.startswith("ConvTransposeTorch_") for k in dec)
    for i in range(n_ct):
        k = np.asarray(dec[f"ConvTransposeTorch_{i}"]["kernel"])
        sd[f"decoder.convts.{i}.weight"] = k[::-1, ::-1].transpose(2, 3, 0, 1)
        sd[f"decoder.convts.{i}.bias"] = np.asarray(
            dec[f"ConvTransposeTorch_{i}"]["bias"])
    for i in range(n_ct + 1):
        _bn(sd, f"decoder.bns.{i}", dec[f"BatchNorm_{i}"],
            dec_s[f"BatchNorm_{i}"])
    used.add(("decoder",))
    left = [k for k in params if (k,) not in used]
    left += [f"encoder/{k}" for k in enc if ("encoder", k) not in used]
    left += [f"decoder/{k}" for k in dec
             if not (k == "DenseTorch_0" or k.startswith("ConvTransposeTorch_")
                     or k.startswith("BatchNorm_"))]
    if left:
        raise ValueError(f"flax parameters left unmapped: {sorted(left)}")
    return {k: torch.from_numpy(np.array(v, dtype=np.float32, order="C"))
            for k, v in sd.items()}


def probe_params_from_flax(params: dict, batch_stats: dict) -> dict:
    """State dict of ``clearvae_torch.models.mlp.ProbeMLP`` from the JAX
    package's ``ProbeMLP`` variables."""
    if sorted(params) != ["BatchNorm_0", "DenseTorch_0", "DenseTorch_1"]:
        raise ValueError(f"not a ProbeMLP's parameters: {sorted(params)}")
    sd: dict = {}
    _dense(sd, "dense_0", params["DenseTorch_0"]["Dense_0"])
    _bn(sd, "bn", params["BatchNorm_0"], batch_stats["BatchNorm_0"])
    _dense(sd, "dense_1", params["DenseTorch_1"]["Dense_0"])
    return {k: torch.from_numpy(np.array(v, dtype=np.float32, order="C"))
            for k, v in sd.items()}
