"""Analytic training FLOPs an image of a CLEAR-VAE step, frozen from
``clearvae_torch/bench.py`` (``clear_vae_train_flops_per_image``, itself
the repository's root ``bench.py`` count): 2 FLOPs a multiply-add, the
backward pass twice the forward's, from the layer shapes; the [B, B]
cosine similarities of both latent halves included. 28.04 MFLOP an image
for the 28×28 flagship (z = 16, B = 128), 423.9 for VAE64 (z = 64)."""

from __future__ import annotations


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


def clear_train_flops_per_image(z_dim: int, batch: int, size: int,
                                in_ch: int) -> float:
    """A CLEAR step's training FLOPs an image (fwd + bwd = 3× fwd)."""
    if size >= 64:
        chans = (in_ch, 32, 64, 128, 256, 512)
        kernel = 4
    else:
        chans = (in_ch, 32, 64, 128)
        kernel = 3
    enc, dec, flat = _conv_macs(size, chans, kernel)
    heads = 4 * flat * (z_dim // 2)
    dec_dense = z_dim * flat
    fwd = enc + heads + dec_dense + dec
    fwd += 2 * batch * (z_dim // 2)
    return 2 * 3 * fwd


def per_image(config: dict) -> float:
    """The count for a configuration's model and batch."""
    m = config["model"]
    return clear_train_flops_per_image(m["z_dim"], config["fit"]["batch_size"],
                                       m["image_size"], m["in_channel"])
