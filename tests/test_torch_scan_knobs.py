"""The JAX package's scan knobs in the port, on the CPU: ``scan_unroll``
and ``scan_gather`` change nothing in the numbers (the one-step graph
replays either way) and raise JAX's errors."""

import optax
import pytest
import torch

from clearvae_tpu.data.mnist import synthetic_mnist as jax_synthetic_mnist
from clearvae_tpu.data.styled import make_styled_mnist as jax_make_styled
from clearvae_tpu.models.vae import VAE as JVAE
from clearvae_tpu.train.trainers import CLEARVAETrainer as JTrainer
from test_torch_graph_step import _state_equal, _trainer
from test_torch_scan_defaults import HP, _histories_equal, _styled


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One intra-op thread: these small CPU workloads run several to a
    machine under the parallel test run, where more threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("kind,unroll", [
    ("clear-fused", 4), ("clear-styled", 4), ("mim", 4),
    ("clear-fused", 0), ("clear-fused", True)])
def test_scan_unroll_equals_unroll_1_bitwise(kind, unroll):
    """7 batches of 16 (7 % 4 = 3 in a tail; 0 or True is the whole epoch,
    as in lax.scan): every unroll replays the one-step graph."""
    ds = _styled(112)
    styled = kind == "clear-styled"
    one, many = _trainer(kind), _trainer(kind)
    one.fit(2, ds, batch_size=16, style_on_device=styled)
    many.fit(2, ds, batch_size=16, style_on_device=styled, scan_unroll=unroll)
    _histories_equal(one, many)
    _state_equal(one, many)
    assert len(many._graphs) == 1
    assert next(iter(many._graphs.values()))[1].idx.shape == (16,)


@pytest.mark.parametrize("kind", ["clear-fused", "tc"])
def test_permute_slice_equals_take(kind):
    ds = _styled(96)
    take, sliced = _trainer(kind), _trainer(kind)
    take.fit(2, ds, batch_size=32)
    sliced.fit(2, ds, batch_size=32, scan_gather="permute_slice",
               epochs_per_scan=2)
    ref = _trainer(kind)
    ref.fit(2, ds, batch_size=32, epochs_per_scan=2)
    _state_equal(take, sliced)
    _histories_equal(ref, sliced)
    # the one-step graph, which gathers each batch inside it
    assert len(sliced._graphs) == 1


def _jax_error(**kw):
    ds = jax_make_styled(*jax_synthetic_mnist(32, seed=0), seed=0)
    jt = JTrainer(JVAE(total_z_dim=16), optax.adam(5e-4), sim_fn="cosine",
                  hyperparameter=HP, seed=0, mig_backend="numpy")
    with pytest.raises(ValueError) as err:
        jt.fit(1, ds, batch_size=16, **kw)
    return str(err.value)


@pytest.mark.parametrize("kw", [
    {"scan_gather": "bogus"},
    {"scan_gather": "permute_slice", "style_on_device": True},
    {"scan_gather": "bogus", "style_on_device": True},
    {"scan_unroll": -1},
])
def test_knob_errors_match_jax(kw):
    want = _jax_error(**kw)
    t = _trainer("clear-fused")
    with pytest.raises(ValueError) as err:
        t.fit(1, _styled(32), batch_size=16, **kw)
    assert str(err.value) == want
    assert t.train_step.step == 0 and t._graphs == {}
