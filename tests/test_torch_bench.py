"""The port's throughput bench (``clearvae_torch/bench.py``): its copy of
the analytic FLOP count equals the repository bench's, and it refuses to
measure without a card."""

import importlib.util
import os

import pytest

from clearvae_torch import bench as TB


def _root_bench():
    spec = importlib.util.spec_from_file_location(
        "bench", os.path.join(os.path.dirname(__file__), "..", "bench.py"))
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    return bench


@pytest.mark.parametrize("kw", [
    {}, {"variant": "tc"}, {"variant": "mim"}, {"batch": 2048},
    {"z_dim": 64, "size": 64, "in_ch": 3},
    {"z_dim": 64, "size": 64, "in_ch": 3, "variant": "mim"}])
def test_flops_equal_the_root_bench(kw):
    assert TB.clear_vae_train_flops_per_image(**kw) == \
        _root_bench().clear_vae_train_flops_per_image(**kw)


def test_rows_are_the_flagship_tc_and_mim():
    assert list(TB.ROWS) == ["clear", "tc", "mim"]
    assert TB.BATCH == 128 and TB.Z_DIM == 16
    assert TB.COMMON["hyperparameter"] == {"fused": True}


def test_refuses_the_cpu():
    with pytest.raises(SystemExit, match="CUDA"):
        TB.main(["--device", "cpu"])


def test_rows64_are_the_root_bench_vae64_rows():
    """``vae64_clear`` and ``vae64_bf16_b256`` with the shapes of the
    repository bench's rows (z = 64, 64×64×3; B = 128 fp32, B = 256 bf16),
    a CLEAR trainer on VAE64, and its data as the root bench makes it."""
    import numpy as np
    import torch

    extra = _root_bench().EXTRA_CONFIGS
    for name, (batch, bf16) in TB.ROWS64.items():
        cfg, flops_kw = extra[name]
        assert cfg.get("batch", 128) == batch
        assert (cfg.get("dtype") == "bf16") == bf16
        assert {k: cfg[k] for k in ("z_dim", "size", "in_ch")} == TB.SHAPE64
        assert {k: flops_kw[k] for k in TB.SHAPE64} == TB.SHAPE64
        t = TB.make_trainer(name, device="cpu")
        assert type(t.model).__name__ == "VAE64"
        assert t.model.dtype == (torch.bfloat16 if bf16 else torch.float32)
        assert (t.model.total_z_dim, t.model.in_channel) == (64, 3)
    ds = TB.data64(8)
    rs = np.random.RandomState(0)
    np.testing.assert_array_equal(ds.images,
                                  rs.rand(8, 64, 64, 3).astype(np.float32))
    np.testing.assert_array_equal(ds.labels, rs.randint(0, 10, 8))
