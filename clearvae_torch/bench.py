"""The analytic training FLOPs of a CLEAR-family step, the port's copy of
the repository ``bench.py``'s ``clear_vae_train_flops_per_image`` (the
port imports nothing of the JAX package's files). ``portbench`` freezes
its own copy in ``portbench/counts/flops.py``; the tests hold both to this
one and this one to the root bench's.

The port's training throughput is measured by ``python3 -m portbench.run``
(``--workload <cell>``), not here.
"""

from __future__ import annotations

BATCH = 128
Z_DIM = 16


def _conv_macs(size: int, chans, kernel: int) -> tuple[int, int, int]:
    """(encoder MACs, decoder MACs, flat dim) for the mirrored conv stacks
    (reference vae.py:15-46, 113-156): stride-2 convs in→chans, decoder
    ConvTs mirroring them."""
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


def clear_vae_train_flops_per_image(z_dim: int = Z_DIM, batch: int = BATCH,
                                    size: int = 28, in_ch: int = 1,
                                    variant: str = "clear") -> float:
    """Analytic training FLOPs per image for a CLEAR-family step: 2 FLOPs/MAC
    forward, backward ≈ 2× forward (standard MFU accounting), from the
    layer math.

    ``variant``: 'clear' = fwd+bwd (3× fwd). 'tc' adds the discriminator
    phase's fresh VAE forward (the factor classifier itself is O(z²),
    negligible). 'mim' adds one encoder-only forward plus 5 inner estimator
    steps on tiny MLPs."""
    if size >= 64:
        chans = (in_ch, 32, 64, 128, 256, 512)
        kernel = 4
    else:
        chans = (in_ch, 32, 64, 128)
        kernel = 3
    enc, dec, flat = _conv_macs(size, chans, kernel)
    heads = 4 * flat * (z_dim // 2)          # four latent heads
    dec_dense = z_dim * flat                 # decoder dense
    fwd = enc + heads + dec_dense + dec
    # contrastive [B,B] sim matrices on mu_c and mu_s (cosine: one matmul each)
    fwd += 2 * batch * (z_dim // 2)          # per image: B·z/2 MACs ×2 halves
    macs = 3 * fwd                           # fwd + bwd(≈2×fwd)
    if variant == "tc":
        z = z_dim
        macs += fwd + 3 * 2 * (z * z + z)   # fresh fwd + disc step (2×[B,2z]→1)
    elif variant == "mim":
        zh, hidden = z_dim // 2, z_dim
        est = 2 * (zh * hidden + hidden * zh)   # p_mu + p_logvar MLPs
        macs += (enc + heads) + 5 * 3 * est     # one encode + 5 estimator steps
    return 2 * macs
