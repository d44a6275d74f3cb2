"""The port's image grids (clearvae_torch.utils.visual ``make_grid`` and
``make_colored_grid``) bit for bit equal to the JAX package's."""

import numpy as np
import pytest
import torch

from clearvae_tpu.utils import visual as JV
from clearvae_torch.utils import visual as TV

HW = 7


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One intra-op thread: these small CPU workloads run several to a
    machine under the parallel test run, where more threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _imgs(n, c, seed=0):
    return np.random.RandomState(seed).rand(n, HW, HW, c).astype(np.float32)


@pytest.mark.parametrize("c", [1, 3])
@pytest.mark.parametrize("n,nrow", [(1, 1), (5, 3), (8, 8), (7, 2), (6, 1)])
def test_make_grid_bit_equal(n, nrow, c):
    imgs = _imgs(n, c, seed=n)
    np.testing.assert_array_equal(TV.make_grid(imgs, nrow),
                                  JV.make_grid(imgs, nrow))
    np.testing.assert_array_equal(TV.make_grid(imgs, nrow, padding=3,
                                               pad_value=0.5),
                                  JV.make_grid(imgs, nrow, padding=3,
                                               pad_value=0.5))
    if c == 1:   # [N, H, W] grayscale as JAX takes it
        np.testing.assert_array_equal(TV.make_grid(imgs[..., 0], nrow),
                                      JV.make_grid(imgs[..., 0], nrow))


@pytest.mark.parametrize("color", ["red", "blue"])
@pytest.mark.parametrize("c", [1, 3])
@pytest.mark.parametrize("n,nrow", [(1, 1), (5, 3), (8, 8)])
def test_make_colored_grid_bit_equal(n, nrow, c, color):
    imgs = _imgs(n, c, seed=10 + n)
    imgs[0, 0, 0] = 0.25     # a pixel at the padding value is recolored too
    np.testing.assert_array_equal(TV.make_colored_grid(imgs, nrow, color),
                                  JV.make_colored_grid(imgs, nrow, color))


def test_make_colored_grid_rejects_other_colors():
    for mod in (TV, JV):
        with pytest.raises(ValueError, match="not implemented"):
            mod.make_colored_grid(_imgs(2, 1), 2, "green")
