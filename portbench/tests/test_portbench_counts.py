"""The frozen counts equal the originals they were copied from at the
cells' shapes."""

import os
import sys

import numpy as np
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
