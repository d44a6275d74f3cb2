"""K6, BatchNorm with its casts and activation (clearvae_torch/ops/kernels/
batchnorm.py), and its plain twin ``models/layers.batch_norm_plain``.

On the CPU: the twin and the layer (which takes the twin there) equal the
layer's torch code as it stood before K6, ``_todays``, bit for bit:
values, the input's, weight's and bias's gradients and the running
statistics, in float32 and bfloat16, 2-D and 4-D, each activation, in
train, eval and train without ``update_stats``. The kernels' arithmetic,
stage by stage (``_emulated``: each reduction's sums, the roundings, the
backward's closed form), run through K6's own ``autograd.Function``,
agrees with it to rounding. Then the wrapper's checks, the dispatch (a
CUDA tensor off a mesh always reaches the kernels' entry point, which
raises on what it does not take; the CPU and a mesh's group take the
twin), the grid's cover of every element, and a bf16 VAE64 step's cast
count with the kernels' Function, its stages emulated, in the twin's
place. K6 against the twin on a card at every layer shape is
``chip_smoke.py``'s phase 2; the test marked ``card`` here holds a captured
layer to the eager one and skips without a card. This file imports
nothing of JAX, so it runs there as

    python -m pytest tests/test_torch_batchnorm.py -m card --noconftest -q
"""

import importlib.util
import json
import os
import re

import numpy as np
import pytest
import torch
from torch.nn import functional as F

from clearvae_torch.models import layers as LY
from clearvae_torch.models.vae import VAE64
from clearvae_torch.ops.kernels import _build
from clearvae_torch.ops.kernels import batchnorm as K6
from clearvae_torch.ops.kernels.counts import GraphLaunches

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
spec = importlib.util.spec_from_file_location(
    "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
CS = importlib.util.module_from_spec(spec)
spec.loader.exec_module(CS)

MODES = CS.K6_MODES
SHAPES = {2: (16, 24), 4: (6, 5, 4, 3)}
# (C, H·W) of each BatchNorm of VAE64 (encoder, the decoder's dense layer,
# its ConvTs) and of the 28×28 VAE, at B = 128
LAYERS = tuple((c, hw) for layers in CS.K6_LAYERS.values()
               for c, hw, _ in layers)


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _todays(x, weight, bias, running_mean, running_var, train, update_stats,
            act, momentum=0.1, eps=1e-5):
    """The layer as ``BatchNorm.forward`` computed it before K6, then the
    activation its callers applied."""
    shape = (1, -1) + (1,) * (x.ndim - 2)
    dtype, x = x.dtype, LY.cast(x, torch.float32)
    if train:
        dims = (0,) + tuple(range(2, x.ndim))
        mean = x.mean(dims)
        var = ((x * x).mean(dims) - mean * mean).clamp_min(0.0)
    if train and update_stats:
        with torch.no_grad():
            running_mean.mul_(1 - momentum).add_(momentum * mean)
            running_var.mul_(1 - momentum).add_(momentum * var)
    elif not train:
        mean, var = running_mean, running_var
    mul = weight * torch.rsqrt(var + eps)
    y = LY.cast((x - mean.view(shape)) * mul.view(shape) + bias.view(shape),
                dtype)
    return {"none": y, "relu": F.relu(y), "sigmoid": torch.sigmoid(y)}[act]


# --- the kernels' arithmetic, stage by stage, in torch ----------------------


def _rnd(v, dtype):
    return v.to(dtype).float()


def _bc(t, x):
    return t.view((1, -1) + (1,) * (x.ndim - 2))


def _by_channel(t):
    return t.transpose(0, 1).reshape(t.shape[1], -1)


def _norm(x, mean, var, weight, bias, eps):
    """(x̂, y) in float32: y = (x − mean)·(w·rstd) + b, as the kernels."""
    rstd = torch.rsqrt(var.clamp_min(0.0) + eps)
    d = x.float() - _bc(mean, x)
    return d * _bc(rstd, x), d * _bc(weight * rstd, x) + _bc(bias, x)


def _act_grad(dy, y, act, dtype):
    v = _rnd(y, dtype)
    if act == "relu":
        return torch.where(v <= 0, torch.zeros_like(dy), dy)
    if act == "sigmoid":
        # each operation rounded, as torch's CUDA sigmoid_backward on a bf16
        # tensor does (its CPU one rounds once: within the bar here)
        s = _rnd(torch.sigmoid(v), dtype)
        return _rnd(_rnd(dy * _rnd(1 - s, dtype), dtype) * s, dtype)
    return dy


def _emulated(calls):
    """K6's four stages as the kernels compute them, counting their calls
    in ``calls``."""

    def stats(x, running_mean, running_var, momentum):
        calls["stats"] += 1
        v = _by_channel(x.float())
        mean = v.sum(1) / v.shape[1]
        var = (v * v).sum(1) / v.shape[1] - mean * mean
        if running_mean is not None:
            running_mean.copy_(running_mean * (1 - momentum) + momentum * mean)
            running_var.copy_(running_var * (1 - momentum)
                              + momentum * var.clamp_min(0.0))
        return torch.stack([mean, var])

    def apply(x, mean, var, weight, bias, act, eps):
        calls["apply"] += 1
        v = _rnd(_norm(x, mean, var, weight, bias, eps)[1], x.dtype)
        if act == "relu":
            v = torch.where(v < 0, torch.zeros_like(v), v)
        elif act == "sigmoid":
            v = torch.sigmoid(v)
        return v.to(x.dtype)

    def grad_reduce(dy, x, mean, var, weight, bias, act, eps):
        calls["grad_reduce"] += 1
        xhat, y = _norm(x, mean, var, weight, bias, eps)
        g = _act_grad(dy.float(), y, act, x.dtype)
        return torch.stack([_by_channel(g).sum(1),
                            _by_channel(g * xhat).sum(1)])

    def grad_apply(dy, x, mean, var, weight, bias, sums, act, eps, train):
        calls["grad_apply"] += 1
        xhat, y = _norm(x, mean, var, weight, bias, eps)
        g = _act_grad(dy.float(), y, act, x.dtype)
        cnt = x.numel() // x.shape[1]
        mg = sums[0] / cnt if train else torch.zeros_like(mean)
        mgx = (torch.where(var < 0, torch.zeros_like(var), sums[1] / cnt)
               if train else torch.zeros_like(mean))
        mul = weight * torch.rsqrt(var.clamp_min(0.0) + eps)
        return (_bc(mul, x) * (g - _bc(mg, x) - xhat * _bc(mgx, x))).to(
            x.dtype)

    return {"run_stats": stats, "run_apply": apply,
            "run_grad_reduce": grad_reduce, "run_grad_apply": grad_apply}


def _stand_in(monkeypatch, calls):
    """K6's Function in the twin's place on the CPU, its stages
    emulated."""
    for name, fn in _emulated(calls).items():
        monkeypatch.setattr(K6, name, fn)
    monkeypatch.setattr(LY, "batch_norm_plain", lambda x, *args, group:
                        K6.BatchNormAct.apply(x, *args))


def _operands(dtype, ndim, seed=0):
    g = torch.Generator().manual_seed(seed)
    shape = SHAPES[ndim]
    c = shape[1]
    x = (torch.randn(shape, generator=g) * 1.5 + 0.3).to(dtype)
    dy = torch.randn(shape, generator=g).to(dtype)
    params = (1 + 0.2 * torch.randn(c, generator=g),
              0.2 * torch.randn(c, generator=g),
              0.1 * torch.randn(c, generator=g),
              0.5 + torch.rand(c, generator=g))
    return x, dy, params


def _run(fn, dtype, ndim, act, mode):
    """fn's (y, dx, dweight, dbias, running_mean, running_var) on fresh
    copies of the operands."""
    x, dy, (w, b, rm, rv) = _operands(dtype, ndim)
    x = x.clone().requires_grad_(True)
    w, b = w.clone().requires_grad_(True), b.clone().requires_grad_(True)
    rm, rv = rm.clone(), rv.clone()
    y = fn(x, w, b, rm, rv, *MODES[mode], act)
    y.backward(dy)
    return (y.detach(), x.grad, w.grad, b.grad, rm, rv)


@pytest.mark.parametrize("act", sorted(K6.ACTS))
@pytest.mark.parametrize("ndim", sorted(SHAPES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
def test_twin_layer_and_kernel_arithmetic_against_todays(dtype, ndim, act,
                                                         monkeypatch):
    """For train, eval and update_stats=False: the twin and the layer on
    the CPU equal today's code bit for bit; K6's Function on the emulated
    stages agrees to rounding, with 4 stage calls a train step and 3 an
    eval forward and backward."""
    for mode in MODES:
        want = _run(_todays, dtype, ndim, act, mode)
        got = _run(LY.batch_norm_plain, dtype, ndim, act, mode)
        for k, (a, b) in enumerate(zip(got, want, strict=True)):
            assert a.dtype == b.dtype and torch.equal(a, b), (mode, k)

        x, dy, params = _operands(dtype, ndim)
        bn = LY.BatchNorm(x.shape[1])
        with torch.no_grad():
            for t, v in zip((bn.weight, bn.bias, bn.running_mean,
                             bn.running_var), params):
                t.copy_(v)
        x = x.clone().requires_grad_(True)
        y = bn(x, *MODES[mode], act=act)
        y.backward(dy)
        for k, (a, ref) in enumerate(zip(
                (y.detach(), x.grad, bn.weight.grad, bn.bias.grad,
                 bn.running_mean, bn.running_var), want)):
            assert torch.equal(a, ref), ("layer", mode, k)

        calls = {k: 0 for k in K6.STAGES}
        for name, fn in _emulated(calls).items():
            monkeypatch.setattr(K6, name, fn)
        emu = _run(lambda *a: K6.BatchNormAct.apply(*a, 0.1, 1e-5), dtype,
                   ndim, act, mode)
        assert calls == {"stats": int(mode != "eval"), "apply": 1,
                         "grad_reduce": 1, "grad_apply": 1}, mode
        tol = 1e-5 if dtype == torch.float32 else 2 ** -7
        for k, (a, ref) in enumerate(zip(emu, want)):
            assert a.dtype == ref.dtype, (mode, k)
            scale = max(float(ref.float().abs().max()), 1.0)
            err = float((a.float() - ref.float()).abs().max())
            assert err <= tol * scale * (4 if k in (2, 3) else 1), \
                (mode, k, err)


@pytest.mark.parametrize("case", ["device", "float16", "float64", "3-D",
                                  "contiguity", "weight", "running_var",
                                  "act"])
def test_wrapper_raises_on_what_the_kernels_do_not_take(case):
    x = torch.randn(4, 3, 2, 2)
    w, b, rm, rv = (torch.ones(3), torch.zeros(3), torch.zeros(3),
                    torch.ones(3))
    act = "relu"
    match = {"device": "CUDA device", "float16": "takes", "float64": "takes",
             "3-D": r"\[N, C\]", "contiguity": "contiguous",
             "weight": "weight must be", "running_var": "running_var must",
             "act": "unknown activation"}[case]
    if case in ("float16", "float64"):
        x = x.to(getattr(torch, case))
    elif case == "3-D":
        x = torch.randn(4, 3, 5)
    elif case == "contiguity":
        x = torch.randn(4, 3, 2, 4)[..., :2]
    elif case == "weight":
        w = w.double()
    elif case == "running_var":
        rv = torch.ones(4)
    elif case == "act":
        act = "tanh"
    with pytest.raises(ValueError, match=match):
        K6.batch_norm(x, w, b, rm, rv, True, True, act)


class _OnCard(torch.Tensor):
    """A CPU tensor that says it is on a CUDA card, as the layer's dispatch
    reads it."""

    @property
    def is_cuda(self):
        return True


def test_the_cpu_and_a_group_take_the_plain_twin(monkeypatch):
    """A CPU tensor never reaches the kernels' entry point; with a process
    group set (a mesh) neither does a CUDA tensor, and the twin gets the
    group."""
    seen, twin = [], []
    monkeypatch.setattr(K6, "batch_norm",
                        lambda *a: seen.append("kernel") or a[0])
    monkeypatch.setattr(LY, "batch_norm_plain",
                        lambda *a, group: twin.append(group) or a[0])
    bn = LY.BatchNorm(3)
    x = torch.randn(4, 3, 2, 2)
    before = dict(K6.LAUNCHES)
    bn(x, True, act="relu")
    assert seen == [] and twin == [None] and dict(K6.LAUNCHES) == before
    bn(x.as_subclass(_OnCard), True)
    assert seen == ["kernel"] and twin == [None]
    group = object()
    bn.group = group
    bn(x.as_subclass(_OnCard), True)
    assert seen == ["kernel"] and twin == [None, group]


@pytest.mark.parametrize("case", ["float32", "bfloat16", "float16", "float64",
                                  "3-D"])
def test_a_cuda_tensor_off_a_mesh_never_takes_the_twin(case, monkeypatch):
    """Off a mesh the layer sends every CUDA tensor to the kernels' entry
    point: a tensor the kernels take runs there, and any other raises
    there, never giving way to the twin."""
    twin, seen = [], []
    monkeypatch.setattr(LY, "batch_norm_plain",
                        lambda *a, group: twin.append(group) or a[0])
    x = (torch.randn(4, 3, 5) if case == "3-D"
         else torch.randn(4, 3, 2, 2).to(getattr(torch, case)))
    x = x.as_subclass(_OnCard)
    bn = LY.BatchNorm(3)
    if case in ("float32", "bfloat16"):
        monkeypatch.setattr(K6, "batch_norm",
                            lambda *a: seen.append(a[0].dtype) or a[0])
        bn(x, True, act="relu")
        assert seen == [x.dtype]
    else:
        with pytest.raises(ValueError, match=r"takes|\[N, C\]"):
            bn(x, True, act="relu")
    assert twin == []


def _reads(n, c, hw, lay):
    """Each reduction block's reads as the kernels compute their offsets:
    (offset, channel) of every element a block reads, over every block."""
    cpt, rows, vec = lay["cpt"], lay["rows"], lay["vec"]
    offs, chans = [], []
    for s in range(lay["chunks"]):
        r0, r1 = s * rows, min(n, s * rows + rows)
        if hw >= K6.ROWS_HW:
            for ch in range(c):
                f = np.arange((r1 - r0) * hw)
                assert (f[::vec] % hw + vec <= hw).all()   # a vector, a plane
                offs.append(((r0 + f // hw) * c + ch) * hw + f % hw)
                chans.append(np.full(len(f), ch))
            continue
        for t in range(lay["tiles"]):
            c0 = t * cpt
            span = min(cpt, c - c0) * hw
            slots = span // vec
            groups = K6.THREADS // slots
            tid = np.arange(K6.THREADS)
            slot, q = tid % slots, tid // slots
            slot, q = slot[q < groups], q[q < groups]
            col = c0 * hw + slot * vec
            assert span % vec == 0 and (col % vec == 0).all()
            for r in range(r0, r1):
                mine = (r - r0) % groups == q    # the threads of row r
                pos = (col[mine][:, None] + np.arange(vec)).ravel()
                offs.append(r * c * hw + pos)
                chans.append(pos // hw)
    return np.concatenate(offs), np.concatenate(chans)


def test_dense_layouts_and_the_kernels_view_of_them():
    """NCHW and channels-last tensors pass as they are (the conv stacks run
    channels-last), viewed as [N, C, H·W] and [N·H·W, C, 1]; 2-D as [N, C,
    1]; a tensor dense in neither order is copied to NCHW."""
    x = torch.randn(4, 3, 5, 2)
    cl = x.contiguous(memory_format=torch.channels_last)
    both = torch.randn(4, 3, 1, 1)
    strided = torch.randn(4, 3, 5, 4)[..., :2]
    assert K6.dense(x) is x and K6.dims(x) == (4, 3, 10)
    assert K6.dense(cl) is cl and K6.dims(cl) == (40, 3, 1)
    assert K6.dims(both) == (4, 3, 1)
    assert K6.dims(torch.randn(6, 7)) == (6, 7, 1)
    d = K6.dense(strided)
    assert d.is_contiguous() and torch.equal(d, strided)
    assert K6.dims(d) == (4, 3, 10)


def test_the_grid_covers_every_element_once():
    """Each reduction block's reads, as the kernels compute their offsets,
    over VAE64's and VAE28's layers in NCHW order (N = 128 and 7) and in
    channels-last order (N = 3: [N·H·W, C, 1]), and a few odd shapes:
    every element of x read once, by a block of its channel, vectors inside
    one plane; the elementwise stages' vectors inside one channel or over
    consecutive channels; at N = 128 in NCHW order both extremes (512
    channels of 4, 3 of 4,096) fill the 132 SMs."""
    shapes = [(n, c, hw) for n in (128, 7) for c, hw in (
        *LAYERS, (5, 3), (300, 1), (7, 33), (2, 31))]
    shapes += [(3 * hw, c, 1) for c, hw in LAYERS]
    for n, c, hw in shapes:
        for itemsize in (4, 2):
            lay = K6.layout(n, c, hw, itemsize)
            assert (lay["chunks"] - 1) * lay["rows"] < n
            assert n <= lay["chunks"] * lay["rows"]
            assert lay["chunks"] == 1 or lay["chunks"] * c <= K6.MAX_PARTIALS
            assert lay["cpt"] == 1 or hw < K6.ROWS_HW
            ew = lay["ew_vec"]
            assert hw % ew == 0 or (hw == 1 and c % ew == 0)
            off, ch = _reads(n, c, hw, lay)
            assert ((off // hw) % c == ch).all(), (n, c, hw, itemsize)
            assert (np.bincount(off, minlength=n * c * hw) == 1).all(), \
                (n, c, hw, itemsize)
            if n == 128 and (c, hw) in ((512, 4), (3, 4096)):
                assert lay["tiles"] * lay["chunks"] >= 132


def hand_count(b: int, train: bool) -> tuple:
    """(calls, bytes) of the casts a bf16 VAE64 still runs as copies once
    K6 folds its BatchNorms' in: the image to bf16 (no gradient); each
    conv's and ConvT's weight and bias (5 + 5 stages); the trunk to float32;
    the decoder's dense input, weight and bias; the reconstruction to
    float32. 26 a forward, 51 a train step (95 − 44 and 48 − 22 with
    BatchNorm's own); 6 bytes an element each way."""
    enc = (3, 32, 64, 128, 256, 512)
    each = 2 if train else 1
    casts = [(1, b * 3 * 64 * 64)]
    for ci, co in zip(enc[:-1], enc[1:]):
        casts += [(each, co * ci * 16), (each, co)]
    casts += [(each, b * 2048), (each, b * 64), (each, 2048 * 64),
              (each, 2048)]
    for ci, co in zip(enc[:0:-1], enc[-2::-1]):
        casts += [(each, ci * co * 16), (each, co)]
    casts += [(each, b * 3 * 64 * 64)]
    return (sum(n for n, _ in casts), sum(6 * n * e for n, e in casts))


def test_a_bf16_vae64_step_counts_only_the_casts_that_still_copy(monkeypatch):
    """The kernels' entry point stood in by their emulation on the CPU: a
    bf16 VAE64 train step counts the 51 casts of ``hand_count`` and calls 4
    stages a BatchNorm (44); an eval forward 26 casts and 11 stages."""
    calls = {k: 0 for k in K6.STAGES}
    _stand_in(monkeypatch, calls)
    torch.manual_seed(0)
    model = VAE64(64, dtype="bfloat16", fused_heads=True)
    g = torch.Generator().manual_seed(1)
    x = torch.rand((2, 64, 64, 3), generator=g)
    eps = tuple(torch.randn((2, 2, 32), generator=g))
    before = dict(LY.CASTS)
    x_hat, lp, _ = model(x, train=True, eps=eps)
    ((x_hat - x) ** 2).sum().add(sum(v.sum() for v in lp.values())).backward()
    got = tuple(LY.CASTS[k] - before.get(k, 0) for k in ("calls", "bytes"))
    assert got == hand_count(2, True) and got[0] == 51
    assert calls == {k: 11 for k in K6.STAGES}
    before = dict(LY.CASTS)
    with torch.no_grad():
        model(x, train=False, eps=eps)
    got = tuple(LY.CASTS[k] - before.get(k, 0) for k in ("calls", "bytes"))
    assert got == hand_count(2, False) and got[0] == 26
    assert calls == {"stats": 11, "apply": 22, "grad_reduce": 11,
                     "grad_apply": 11}


def test_binding_matches_the_extern_c_function():
    src = open(os.path.join(_build.CSRC, "batchnorm.cu")).read()
    params = re.search(r'extern "C" int bn_launch\(([^)]*)\)', src).group(1)
    assert len(params.split(",")) == len(K6.ARGTYPES)
    assert "batchnorm" in _build.sources()
    assert K6.STAGES == ("stats", "apply", "grad_reduce", "grad_apply")
    assert ("enum Stage { kStats = 0, kApply = 1, kGradReduce = 2, "
            "kGradApply = 3 };") in src
    assert K6.ACTS == {"none": 0, "relu": 1, "sigmoid": 2}
    assert "enum Act { kNone = 0, kRelu = 1, kSigmoid = 2 };" in src
    assert K6.DTYPES == {torch.float32: 0, torch.bfloat16: 1}
    assert "enum Dtype { kFloat32 = 0, kBFloat16 = 1 };" in src
    # no kernel's name (nor the parameter type in its signature) holds a
    # pattern by which the benchmark's model readers count convs or casts
    names = re.findall(r"__global__ void __launch_bounds__\(kThreads\) (\w+)",
                       src) + ["Params", "__nv_bfloat16"]
    assert len(names) == 5
    metrics = os.path.join(os.path.dirname(_build.CSRC), os.pardir,
                           "portbench", "metrics")
    with open(os.path.join(metrics, "model.conv_ms_per_step.json")) as f:
        patterns = json.load(f)["patterns"]
    with open(os.path.join(metrics, "model.cast_roofline.json")) as f:
        patterns += [k[0] for k in json.load(f)["kernels"]]
    assert not [(n, q) for n in names for q in patterns if q in n]


# ---------------------------------------------------------------------------
# card
# ---------------------------------------------------------------------------


@pytest.fixture
def card():
    """The CUDA device, or a skip where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.card
def test_card_captured_layer_replays_the_eager_one(card):
    """A bf16 layer's forward and backward captured in a graph: 4 launches
    a replay, moved to the replays by ``GraphLaunches``, and the eager
    call's values bit for bit."""
    ops = CS.k6_operands(128, 32, 1024, torch.bfloat16, card, 3, True)
    eager = CS.k6_layer(K6.batch_norm, ops, True, True, "relu")
    x, dy, w, b, rm, rv = ops
    x = x.clone().requires_grad_(True)
    w, b = w.clone().requires_grad_(True), b.clone().requires_grad_(True)
    rm0, rv0 = rm.clone(), rv.clone()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        K6.batch_norm(x, w, b, rm.clone(), rv.clone(), True, True,
                      "relu").backward(dy)
    torch.cuda.current_stream().wait_stream(side)
    x.grad = w.grad = b.grad = None
    graph, launches = torch.cuda.CUDAGraph(), GraphLaunches()
    K6.reset_launches()
    with launches.capture(), torch.cuda.graph(graph):
        rm.copy_(rm0)
        rv.copy_(rv0)
        y = K6.batch_norm(x, w, b, rm, rv, True, True, "relu")
        dx, dw, db = torch.autograd.grad(y, (x, w, b), dy)
    assert sum(K6.LAUNCHES.values()) == 0
    assert launches.per_replay["launches.batchnorm"] == {
        "stats": 1, "apply": 1, "grad_reduce": 1, "grad_apply": 1}
    for _ in range(3):
        graph.replay()
        launches.replay()
    torch.cuda.synchronize()
    assert K6.LAUNCHES["apply"] == 3
    for a, r in zip((y, dx, dw, db, rm, rv), eager):
        assert torch.equal(a, r)
