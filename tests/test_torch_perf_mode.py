"""The 64×64 runners' perf mode (``downstream64.PERF_VAE_KWARGS``: bfloat16
conv stacks, fused latent heads) as a configuration names it: the compute
dtype by name, and the counter ``model.casts`` of every cast between
float32 and bfloat16 that the model makes, against a count by hand from
VAE64's shapes, and the per-step figure that the benchmark's reader
``model.cast_roofline`` takes from it."""

import importlib.util
import os

import numpy as np
import pytest
import torch

from clearvae_torch.data.common import ArrayDataset
from clearvae_torch.models import layers as LY
from clearvae_torch.models.vae import VAE64
from clearvae_torch.ops.kernels.counts import GraphLaunches
from clearvae_torch.train.factories import get_clearvae_trainer
from clearvae_torch.utils import logging as L

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
Z = 64
# VAE64's stages: encoder channels (4×4, stride 2) and the 2×2×512 trunk
ENC = (3, 32, 64, 128, 256, 512)
SIZE, KERNEL, SPATIAL = 64, 4, 2


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _vae(dtype, seed=0):
    torch.manual_seed(seed)
    return VAE64(Z, dtype=dtype, fused_heads=True)


def _inputs(b, seed=1):
    g = torch.Generator().manual_seed(seed)
    x = torch.rand((b, SIZE, SIZE, 3), generator=g)
    eps = torch.randn((2, b, Z // 2), generator=g)
    return x, (eps[0], eps[1])


def _trainer(vae_kwargs):
    """The CelebA runner's CLEAR trainer (``clear-vae64-celeba``'s
    arguments) with ``vae_kwargs``, on the CPU."""
    return get_clearvae_trainer(beta=1 / 32, ps=True, vae_lr=3e-5, z_dim=Z,
                                alpha=100.0, temperature=0.1, vae_arch="VAE64",
                                in_channel=3, verbose_period=5, device="cpu",
                                vae_kwargs=vae_kwargs)


def _counted(fn):
    """(calls, bytes) that ``fn()`` adds to ``model.casts``."""
    before = dict(LY.CASTS)
    fn()
    return tuple(LY.CASTS[k] - before.get(k, 0) for k in ("calls", "bytes"))


def _train_step(model, b):
    x, eps = _inputs(b)
    x_hat, lp, _ = model(x, train=True, eps=eps)
    ((x_hat - x) ** 2).sum().add(sum(v.sum() for v in lp.values())).backward()


def hand_count(b: int, train: bool) -> tuple:
    """(calls, bytes) of VAE64's casts in one bf16 forward of ``b`` images
    (and, ``train``, its backward): 6 bytes an element each way. The input
    image takes no gradient; every other cast is of a tensor that does."""
    each = 2 if train else 1
    casts = [(1, b * 3 * SIZE * SIZE)]                   # the image, to bf16
    s = SIZE
    for ci, co in zip(ENC[:-1], ENC[1:]):
        s //= 2
        casts += [(each, co * ci * KERNEL ** 2), (each, co),   # weight, bias
                  (each, b * co * s * s), (each, b * co * s * s)]  # BN in, out
    flat = SPATIAL * SPATIAL * ENC[-1]
    casts += [(each, b * flat)]                          # the trunk, to fp32
    casts += [(each, b * Z), (each, flat * Z), (each, flat),   # dense
              (each, b * flat), (each, b * flat)]        # its BN in, out
    s = SPATIAL
    for ci, co in zip(ENC[:0:-1], ENC[-2::-1]):
        s *= 2
        casts += [(each, ci * co * KERNEL ** 2), (each, co),
                  (each, b * co * s * s), (each, b * co * s * s)]
    casts += [(each, b * 3 * SIZE * SIZE)]               # x_hat, to fp32
    return (sum(n for n, _ in casts), sum(6 * n * e for n, e in casts))


@pytest.mark.parametrize("name,dtype", [("bfloat16", torch.bfloat16),
                                        ("float32", torch.float32)])
@pytest.mark.parametrize("train", [True, False])
def test_a_dtype_name_builds_the_same_model(name, dtype, train):
    by_name, by_dtype = _vae(name), _vae(dtype)
    assert by_name.dtype is dtype and by_name.encoder.dtype is dtype
    assert by_name.decoder.dtype is dtype
    for (k, a), b in zip(by_name.state_dict().items(),
                         by_dtype.state_dict().values(), strict=True):
        assert torch.equal(a, b), k
    x, eps = _inputs(4)
    out_name = by_name(x, train=train, eps=eps)
    out_dtype = by_dtype(x, train=train, eps=eps)
    assert torch.equal(out_name[0], out_dtype[0])
    assert torch.equal(out_name[2], out_dtype[2])
    for k in out_dtype[1]:
        assert torch.equal(out_name[1][k], out_dtype[1][k]), k


@pytest.mark.parametrize("name", ["float16", "bf16", "fp32", "torch.bfloat16"])
def test_an_unknown_dtype_name_raises(name):
    with pytest.raises(ValueError, match="unknown compute dtype"):
        VAE64(Z, dtype=name)
    with pytest.raises(ValueError, match="unknown compute dtype"):
        _trainer({"dtype": name, "fused_heads": True})


@pytest.mark.parametrize("fused_heads", [False, True])
def test_a_float32_model_counts_no_cast(fused_heads):
    torch.manual_seed(0)
    model = VAE64(Z, fused_heads=fused_heads)
    assert _counted(lambda: _train_step(model, 2)) == (0, 0)
    with torch.no_grad():
        assert _counted(lambda: model(*_inputs(2)[:1], train=False,
                                      eps=_inputs(2)[1])) == (0, 0)


def test_bf16_casts_are_counted_by_hand():
    model = _vae("bfloat16")
    assert _counted(lambda: _train_step(model, 2)) == hand_count(2, True)
    assert _counted(lambda: _train_step(model, 3)) == hand_count(3, True)
    x, eps = _inputs(2)
    with torch.no_grad():
        got = _counted(lambda: model(x, train=False, eps=eps))
    assert got == hand_count(2, False)
    assert hand_count(2, False)[0] == 48 and hand_count(2, True)[0] == 95


def test_a_gradients_cast_is_counted_when_the_backward_runs_it():
    model = _vae("bfloat16")
    x, eps = _inputs(2)
    out = []
    assert _counted(lambda: out.append(model(x, train=True, eps=eps))) \
        == hand_count(2, False)
    x_hat, lp, _ = out[0]
    loss = ((x_hat - x) ** 2).sum() + sum(v.sum() for v in lp.values())
    forward, both = hand_count(2, False), hand_count(2, True)
    assert _counted(loss.backward) == (both[0] - forward[0],
                                       both[1] - forward[1])


def test_a_capture_moves_the_cast_count_to_its_replays():
    """The casts counted inside a capture move to its replays, as a launch
    counter's count does: each replay runs the captured casts again."""
    launches = L.counter("test.perf_mode.launches", ("k",))
    gl = GraphLaunches()
    before = LY.CASTS["calls"]
    with gl.capture():
        LY.cast(torch.ones(3), torch.bfloat16)
        launches["k"] += 1
    assert LY.CASTS["calls"] == before and launches["k"] == 0
    for _ in range(4):
        gl.replay()
    assert LY.CASTS["calls"] == before + 4 and launches["k"] == 4
    assert gl.per_replay["model.casts"] == {"calls": 1, "bytes": 18}


def _reader():
    path = os.path.join(ROOT, "portbench", "metrics", "model.cast_roofline.py")
    spec = importlib.util.spec_from_file_location("cast_roofline", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_the_readers_step_figure_is_the_hand_count():
    """A tiny graphed fit of the perf mode on the CPU, where every train
    step runs its body in Python: the counter over the fit is the steps'
    hand count, and the reader's figure from it, with the steps counted as
    the card's warm-up calls and replays, is one step's."""
    b, steps = 4, 3
    rs = np.random.RandomState(0)
    ds = ArrayDataset(rs.rand(b * steps, SIZE, SIZE, 3).astype(np.float32),
                      rs.randint(0, 4, b * steps), rs.randint(0, 4, b * steps))
    t = _trainer({"dtype": "bfloat16", "fused_heads": True})
    before = dict(LY.CASTS)
    t.fit(1, ds, batch_size=b)
    assert len(t.history[-1]["loss"]) == steps
    counted = {k: LY.CASTS[k] - before.get(k, 0) for k in ("calls", "bytes")}
    calls, nbytes = hand_count(b, True)
    assert counted == {"calls": steps * calls, "bytes": steps * nbytes}
    reader = _reader()
    counters = {"model.casts": counted,
                "step.warmups": {"GraphedEpoch": 1},
                "step.captures": {"GraphedEpoch": 1},
                "step.replays": {"GraphedEpoch": steps - 1}}
    assert reader.step_bytes(counters) == nbytes
    assert reader.step_bytes({**counters, "model.casts": {}}) is None
    assert reader.step_bytes({**counters, "step.replays": {
        "GraphedEpoch": steps - 1, "GraphedEval": 1}}) is None
