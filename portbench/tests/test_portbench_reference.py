"""The reference agrees with the program at tiny sizes on the CPU: its
styling copy on both style sets, its gMIG, and whole tiny runs of every
cell, whose check compares five steps of each configuration (and a
validation where the cell validates) and comes out correct."""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from clearvae_torch.ops import corruptions as PC  # noqa: E402
from clearvae_torch.ops import metrics as PM  # noqa: E402
from portbench import run as R  # noqa: E402
from portbench.reference import mig as RM  # noqa: E402
from portbench.reference.styling import corruptions as RC  # noqa: E402

STYLE_SETS = {"six": PC.EXPERIMENT_STYLES,
              "mnistc16": tuple((n, None) for n in PC.CORRUPTIONS)}

TINY = {"vae28-downstream-fit": {"traffic": {"n_images": 400}},
        "vae64-celeba-fit": {"traffic": {"n_train": 160}},
        "vae28-styled6-ondevice": {"traffic": {"n_images": 300}},
        "vae28-mnistc16-ondevice": {"traffic": {"n_images": 200}}}


@pytest.mark.parametrize("styles", sorted(STYLE_SETS))
def test_styling_copy_equals_the_program(styles):
    s = STYLE_SETS[styles]
    g = torch.Generator().manual_seed(1)
    x = torch.rand((48, 28, 28), generator=g) * 255
    ids = torch.arange(100, 148)
    idx = torch.arange(48) % len(s)
    prog = PC.style_batch(x, idx, PC.style_draws(9, ids), s)
    ref = RC.style_batch(x, idx, RC.style_draws(9, ids), s)
    assert torch.equal(prog, ref)


def test_gmig_equals_the_programs():
    rs = np.random.RandomState(3)
    y = rs.randint(0, 10, 600)
    zc = (rs.randn(600, 8) + 0.4 * y[:, None]).astype(np.float32)
    zs = rs.randn(600, 8).astype(np.float32)
    prog = PM.mutual_info_gap(y, zc, zs, backend="numpy")
    ref = RM.mutual_info_gap(torch.as_tensor(y), torch.as_tensor(zc),
                             torch.as_tensor(zs))
    assert abs(prog - ref) < 1e-12


@pytest.mark.parametrize("cell", sorted(TINY))
def test_a_tiny_run_is_correct(cell):
    over = {**TINY[cell], "config": {"fit": {"batch_size": 32}}}
    res = R.run(cell, 2 ** 31 + 5, 0.2, device="cpu", overrides=over)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert set(res["metrics"]) == {"train_images_per_s", "setup_s"}
    assert list(res)[-1] == "checks"
