"""The port's throughput bench (``clearvae_torch/bench.py``): its copy of
the analytic FLOP count equals the repository bench's, its rows are the
root bench's, a launched job runs all of them, and it refuses to measure
without a card."""

import importlib.util
import os

import pytest
import torch

from clearvae_torch import bench as TB


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One intra-op thread: these small CPU workloads run several to a
    machine under the parallel test run, where more threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _root_bench():
    spec = importlib.util.spec_from_file_location(
        "bench", os.path.join(os.path.dirname(__file__), "..", "bench.py"))
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    return bench


@pytest.mark.parametrize("kw", [
    {}, {"variant": "tc"}, {"variant": "mim"}, {"batch": 2048}, {"batch": 512},
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


@pytest.mark.parametrize("name", list(TB.ROWS28))
def test_rows28_are_the_root_bench_perf_rows(name):
    """``clear_28_bf16``, ``clear_28_fusedheads``, ``perf_mode_b2048_bf16``
    and ``perf_mode_b512_bf16_fusedheads``: the root bench's batch, dtype,
    fused heads and image count, the flagship trainer with them, and the
    root bench's FLOPs at the row's batch."""
    import torch

    root = _root_bench()
    cfg, flops_kw = root.EXTRA_CONFIGS[name]
    batch, bf16, fused_heads, n_images = TB.ROWS28[name]
    assert cfg.get("batch", root.BATCH) == batch == flops_kw.get("batch", 128)
    assert (cfg.get("dtype") == "bf16") == bf16
    assert cfg.get("fused_heads", False) == fused_heads
    assert cfg.get("n_images", root.N_IMAGES) == n_images
    assert TB.clear_vae_train_flops_per_image(batch=batch) == \
        root.clear_vae_train_flops_per_image(**flops_kw)
    t = TB.make_trainer(name, device="cpu")
    assert t.model.dtype == (torch.bfloat16 if bf16 else torch.float32)
    assert t.model.fused_heads == fused_heads
    assert (t.model.total_z_dim, t.contr_cfg.fused) == (16, True)


@pytest.mark.parametrize("world", [1, 4])
def test_a_launched_job_runs_every_row(world):
    """A job of ``world`` cards (``WORLD_SIZE``, as torchrun sets it) runs
    every row, the 64×64 ones included, as the root bench shards them all
    over a data mesh: the same batches and FLOPs as one card, against the
    peak of all the job's cards."""
    rows, one = TB.job_rows(world), TB.job_rows()
    assert list(rows) == [*TB.ROWS, *TB.ROWS28, *TB.ROWS64]
    for kind, (batch, flops, peak) in rows.items():
        assert (batch, flops) == one[kind][:2]
        assert peak == world * one[kind][2]
    for kind, (batch, bf16) in TB.ROWS64.items():
        assert rows[kind] == (
            batch, TB.clear_vae_train_flops_per_image(batch=batch,
                                                      **TB.SHAPE64),
            world * (TB.PEAK_BF16_FLOPS if bf16 else TB.PEAK_FP32_FLOPS))


def test_time_steps_rows_cycle_their_permutations():
    """More steps than one permutation of the data holds (B = 2,048 on
    8,192 images): the rows take further permutations; within one
    permutation they are the batches that the timer took before."""
    import numpy as np

    rows = TB.batch_rows(12, 5, 4)
    rs = np.random.RandomState(1)
    want = np.concatenate([rs.permutation(12), rs.permutation(12)])[:20]
    np.testing.assert_array_equal(rows, want.reshape(5, 4))
    np.testing.assert_array_equal(
        TB.batch_rows(12, 3, 4),
        np.random.RandomState(1).permutation(12).reshape(3, 4))
