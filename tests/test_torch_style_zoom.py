"""K3's sparse zoom taps (clearvae_torch.ops.kernels.style): two taps an
output index rebuild the dense interpolation matrix of the JAX package's
Pallas style kernel, for every severity, at three image sizes."""

import numpy as np
import pytest
import torch

from clearvae_torch.ops.kernels import style as K3


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One intra-op thread: these small CPU workloads run several to a
    machine under the parallel test run, where more threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("severity", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("h", [17, 28, 64])
def test_zoom_taps_rebuild_the_interp_matrix(h, severity):
    """The kernel's sparse zoom (two taps an output index) holds every
    nonzero of the dense matrix, with the same float32 weights."""
    args = (h, K3._SCALE[severity - 1], (h - 1) / 2)
    idx, w = K3._zoom_taps(*args)
    dense = np.zeros((h, h), np.float32)
    for t in range(2):
        np.add.at(dense, (np.arange(h), idx[:, t]), w[:, t])
    np.testing.assert_array_equal(dense, K3._interp_matrix(*args))
    assert ((idx >= 0) & (idx < h)).all()
    table = K3._taps(h, severity, "cpu").numpy()
    np.testing.assert_array_equal(table[:, :2], idx)
    np.testing.assert_array_equal(table[:, 2:].view(np.float32), w)
