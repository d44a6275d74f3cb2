"""The frozen counts equal the originals they were copied from at the
cells' shapes; CLEAR-MIM's count equals a count by hand, and a step that
no count covers raises."""

import os
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from clearvae_torch import bench  # noqa: E402
from portbench import harness as H  # noqa: E402
from portbench.counts import flops, k3  # noqa: E402

ROOT = os.path.dirname(H.PKG)


def test_flops_equal_the_ports_count():
    for name in ("clear-vae28-styledmnist", "clear-vae64-celeba"):
        cfg = H.load("configs", name)
        m = cfg["model"]
        assert flops.per_image(cfg) == bench.clear_vae_train_flops_per_image(
            z_dim=m["z_dim"], batch=cfg["fit"]["batch_size"],
            size=m["image_size"], in_ch=m["in_channel"])
    assert flops.per_image(H.load("configs", "clear-vae28-styledmnist")) \
        == 28035840


def _mim(estimator: str, **hp) -> dict:
    cfg = H.load("configs", "clear-vae28-styledmnist")
    kw = {**cfg["trainer"]["kwargs"], "mi_estimator": estimator, "la": 3,
          "mi_estimator_lr": 2e-3, "hyperparameter": hp}
    return {**cfg, "trainer": {"factory": "get_clearmimvae_trainer",
                               "kwargs": kw}}


def test_clear_mims_count_by_hand_at_the_flagships_widths():
    """z = 16 (z/2 = 8), B = 128, 28×28×1, MACs an image: encoder convs
    14²·32·9·1 + 7²·64·9·32 + 4²·128·9·64 = 2,139,264, heads 4·2048·8 =
    65,536; decoder dense 16·2048 = 32,768, ConvTs 4²·128·9·64 +
    8²·64·9·32 + 16²·32·9·1 = 2,433,024; z_c's cosines 128·8 = 1,024.
    The critic 4 layers of 8·8 = 256; L1OutUB's bound 8 + 128·8 = 1,032,
    CLUB-S's 8 + 8 = 16; the learning loss 8."""
    encode = 2_139_264 + 65_536
    vae = 3 * (encode + 32_768 + 2_433_024 + 1_024)
    inner = 5 * 3 * (256 + 8)
    l1out = 2 * (vae + 2 * (256 + 1_032) + encode + inner)
    club_s = 2 * (vae + 2 * (256 + 16) + encode + inner)
    assert flops.per_image(_mim("L1OutUB")) == l1out == 32_452_368
    assert flops.per_image(_mim("CLUBSample")) == club_s
    reused = flops.per_image(_mim("L1OutUB", reuse_phase1_encode=True))
    assert reused == l1out - 2 * encode


def test_a_step_without_a_count_raises():
    cfg = H.load("configs", "clear-vae28-styledmnist")
    tc = {**cfg, "trainer": {**cfg["trainer"],
                             "factory": "get_cleartcvae_trainer"}}
    with pytest.raises(ValueError, match="get_cleartcvae_trainer"):
        flops.per_image(tc)
    with pytest.raises(ValueError, match="InfoNCE"):
        flops.per_image(_mim("InfoNCE"))


def test_k3_bound_equals_chip_smokes_where_k3_styles_every_row():
    sys.path.insert(0, ROOT)
    try:
        import chip_smoke
    finally:
        sys.path.remove(ROOT)
    rng = np.random.RandomState(0)
    for b in (128, 512):
        codes = rng.randint(0, 7, b)
        ms, _ = chip_smoke.k3_bound(codes, 28)
        assert np.isclose(k3.bound_s(codes, 28) * 1e3, ms, rtol=1e-12)
    # rows of another route cost K3 nothing but their code
    assert k3.bound_s([-1] * 128, 28) < k3.bound_s([0] * 128, 28) / 50
