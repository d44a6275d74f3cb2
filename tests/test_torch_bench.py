"""The port's copy of the analytic FLOP count (``clearvae_torch/bench.py``)
equals the repository bench's at every shape a cell or the root bench
counts."""

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
