"""The port's native KSG MI (``csrc/host_ops.cpp`` through
``clearvae_torch/native/bindings.py``) against the JAX package's native
library and the numpy backend, and the MIG backend ``"auto"``."""

import os
import shutil

import numpy as np
import pytest
import torch

from clearvae_tpu.native import bindings as JN
from clearvae_tpu.ops import metrics as JM
from clearvae_torch.native import bindings as TN
from clearvae_torch.ops import metrics as TM
from clearvae_torch.train import trainers as TR

# tests/test_native.py's bars for the native estimator against a reference
TOL = dict(rtol=1e-3, atol=1e-3)


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One intra-op thread: these small CPU workloads run several to a
    machine under the parallel test run, where more threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _needs_gxx():
    if shutil.which("g++") is None:
        pytest.skip("no g++: the native host library cannot build")
    assert TN.available() and JN.available()


def _data(seed, n=400, f=4, c=4, singleton=False):
    rs = np.random.RandomState(seed)
    y = rs.randint(0, c, n)
    if singleton:
        y[-1] = c                     # a class of one sample, dropped by KSG
    x = rs.randn(n, f) + 0.8 * y[:, None] * (np.arange(f) % 2)
    return x, y


@pytest.mark.parametrize("seed,singleton,k", [(0, False, 3), (1, True, 3),
                                               (2, False, 1), (3, True, 5)])
def test_native_core_is_bit_equal_to_jax(seed, singleton, k):
    """Same float64 columns and labels: the same bits (tolerance 0)."""
    x, y = _data(seed, singleton=singleton)
    x = x + 1e-10 * np.random.RandomState(seed + 10).randn(*x.shape)
    np.testing.assert_array_equal(TN.ksg_mi_cd_native(x, y, k),
                                  JN.ksg_mi_cd_native(x, y, k))


@pytest.mark.parametrize("seed,singleton", [(0, False), (1, True)])
def test_native_backend_matches_jax_and_numpy(seed, singleton):
    x, y = _data(seed, singleton=singleton)
    ours = TM.mutual_info_classif_native(x, y)
    # the JAX package's native path, preprocessing and dither included:
    # bit-equal (tolerance 0)
    np.testing.assert_array_equal(ours, JN.mutual_info_classif_native(x, y))
    # the numpy backend on the same preprocessed input, within TOL
    np.testing.assert_allclose(ours, TM.mutual_info_classif_np(x, y), **TOL)
    assert np.isfinite(ours).all() and (ours >= 0).all()


def test_mig_native_matches_jax_native():
    """MIG through the native backend equals the JAX package's (the same
    float64 arithmetic: rtol 1e-12)."""
    rs = np.random.RandomState(4)
    y = rs.randint(0, 10, 300)
    zc = (rs.randn(300, 8) + 0.5 * y[:, None]).astype(np.float32)
    zs = rs.randn(300, 8).astype(np.float32)
    ours = TM.mutual_info_gap(y, torch.as_tensor(zc), torch.as_tensor(zs),
                              backend="native")
    theirs = JM.mutual_info_gap(y, zc, zs, backend="native")
    np.testing.assert_allclose(ours, theirs, rtol=1e-12)
    np.testing.assert_allclose(
        ours, TM.mutual_info_gap(y, zc, zs, backend="numpy"), **TOL)


def test_auto_resolves_to_native_when_built(monkeypatch):
    assert TM.resolve_backend("auto") == "native"
    for name in ("native", "numpy", "torch"):
        assert TM.resolve_backend(name) == name
    with pytest.raises(ValueError, match="unknown MIG backend"):
        TM.resolve_backend("jnp")
    model = torch.nn.Linear(1, 1)
    assert TR.VAETrainerBase(model, device="cpu").mig_backend == "native"
    monkeypatch.setattr(TN, "available", lambda: False)
    assert TM.resolve_backend("auto") == "numpy"
    assert TR.VAETrainerBase(model, device="cpu").mig_backend == "numpy"


def test_native_core_checks_shapes_before_the_call():
    x, y = _data(5)
    with pytest.raises(ValueError, match="x \\[n, f\\] and y \\[n\\]"):
        TN.ksg_mi_cd_native(x, y[:-1])
    with pytest.raises(ValueError):
        TN.ksg_mi_cd_native(x[:, 0], y)


def test_library_is_built_into_the_ports_build_dir():
    path = TN.lib_path()
    assert os.path.exists(path)
    assert os.path.dirname(path) == os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(TN.__file__))),
        "_build")
