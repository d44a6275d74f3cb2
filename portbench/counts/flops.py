"""Analytic training FLOPs an image of the step that a configuration's
factory builds, 2 FLOPs a multiply-add, from the layer shapes.

CLEAR-VAE (``get_clearvae_trainer``): frozen from ``clearvae_torch/bench.py``
(``clear_vae_train_flops_per_image``, itself the repository's root
``bench.py`` count): the backward pass twice the forward's; the [B, B]
cosine similarities of both latent halves included. 28.04 MFLOP an image
for the 28×28 flagship (z = 16, B = 128), 423.9 for VAE64 (z = 64).

CLEAR-MIM (``get_clearmimvae_trainer``; scotsun/clear-vae
code/src/trainer.py:781-897), by the same rules: the VAE's update with one
[B, B] cosine similarity, z_c's (its loss has no style term); the
estimator's penalty on (z_c, z_s) in that update, forward and a backward
that reaches the latents and not the estimator's weights (the same
multiply-adds again); the phase-2 encoder and heads forward (none where
``reuse_phase1_encode`` takes phase 1's latents); and ``MIM_INNER_STEPS``
updates of the estimator's learning loss, forward and backward. The
estimator's critic is two MLPs z/2 → z/2 → z/2 (mu and logvar; hidden
``z_dim`` // 2). A bound's log-density term counts a multiply-add an
element, (y − mu)² weighted by 1 / var and summed over z/2, as the cosine
similarities count one: L1OutUB's [B, B, z/2] all-pairs term and CLUB-S's
[B, z/2] permuted one, beside each bound's [B, z/2] positive term and the
learning loss's. 32.45 MFLOP an image for L1OutUB at the flagship's
widths.

Any other factory raises: its step is not counted here."""

from __future__ import annotations

# the estimator's updates a train step (the paper's trainer.py:874)
MIM_INNER_STEPS = 5


def _conv_macs(size: int, chans, kernel: int) -> tuple[int, int, int]:
    """(encoder MACs, decoder MACs, flat dim) of the mirrored conv stacks:
    stride-2 convs in→chans, decoder ConvTs mirroring them."""
    enc = 0
    spatial = size
    for cin, cout in zip(chans[:-1], chans[1:]):
        spatial = (spatial + 1) // 2
        enc += spatial * spatial * cout * kernel * kernel * cin
    flat = spatial * spatial * chans[-1]
    dec = 0
    spatial_in = spatial
    for cin, cout in zip(reversed(chans[1:]), reversed(chans[:-1])):
        dec += spatial_in * spatial_in * cin * kernel * kernel * cout
        spatial_in *= 2
    return enc, dec, flat


def _vae_macs(z_dim: int, size: int, in_ch: int) -> tuple[int, int]:
    """(encoder and heads MACs, decoder MACs) of one image's forward."""
    if size >= 64:
        chans = (in_ch, 32, 64, 128, 256, 512)
        kernel = 4
    else:
        chans = (in_ch, 32, 64, 128)
        kernel = 3
    enc, dec, flat = _conv_macs(size, chans, kernel)
    heads = 4 * flat * (z_dim // 2)
    dec_dense = z_dim * flat
    return enc + heads, dec_dense + dec


def clear_train_flops_per_image(z_dim: int, batch: int, size: int,
                                in_ch: int) -> float:
    """A CLEAR step's training FLOPs an image (fwd + bwd = 3× fwd)."""
    encode, decode = _vae_macs(z_dim, size, in_ch)
    fwd = encode + decode
    fwd += 2 * batch * (z_dim // 2)
    return 2 * 3 * fwd


def mim_train_flops_per_image(z_dim: int, batch: int, size: int, in_ch: int,
                              estimator: str,
                              reuse_phase1_encode: bool = False) -> float:
    """A CLEAR-MIM step's training FLOPs an image (module docstring), for
    the estimators of the experiments' zoo, by its names."""
    zd = z_dim // 2
    if estimator == "L1OutUB":
        pairs = batch * zd                     # the all-pairs term
    elif estimator == "CLUBSample":
        pairs = zd                             # the permuted term
    else:
        raise ValueError(f"no count for the MI estimator {estimator!r}")
    encode, decode = _vae_macs(z_dim, size, in_ch)
    vae = 3 * (encode + decode + batch * zd)
    hidden = z_dim // 2                        # the factory's z_dim, halved
    critic = 4 * zd * hidden                   # mu and logvar, two layers each
    penalty = 2 * (critic + zd + pairs)
    phase2 = 0 if reuse_phase1_encode else encode
    inner = MIM_INNER_STEPS * 3 * (critic + zd)
    return 2 * (vae + penalty + phase2 + inner)


def per_image(config: dict) -> float:
    """The count for the step that the configuration's factory builds, at
    its model and batch."""
    m, t = config["model"], config["trainer"]
    shape = (m["z_dim"], config["fit"]["batch_size"], m["image_size"],
             m["in_channel"])
    if t["factory"] == "get_clearvae_trainer":
        return clear_train_flops_per_image(*shape)
    if t["factory"] == "get_clearmimvae_trainer":
        hp = t["kwargs"].get("hyperparameter") or {}
        return mim_train_flops_per_image(
            *shape, t["kwargs"]["mi_estimator"],
            bool(hp.get("reuse_phase1_encode", False)))
    raise ValueError(f"no FLOP count for the factory {t['factory']!r}")
