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
