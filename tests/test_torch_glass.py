"""K5, glass_blur's pixel swaps (clearvae_torch/ops/kernels/glass.py).

On the CPU: a CPU tensor takes the plain twin and launches nothing, the
wrapper's checks, the binding against the kernel's C signature, and the
kernel's arithmetic (each swap's word: p, and q made from the deltas, a
clear flag or an index outside the image made a no-op; then the walk in
order) emulated in torch against the plain twin. Tests marked ``card`` hold
the kernel against its plain twin bit for bit on a CUDA card and skip
without one; this file imports nothing of JAX, so they run there as

    python -m pytest tests/test_torch_glass.py -m card --noconftest -q
"""

import os
import re

import numpy as np
import pytest
import torch

from clearvae_torch.ops import corruptions as C
from clearvae_torch.ops import prng as P
from clearvae_torch.ops.kernels import _build
from clearvae_torch.ops.kernels import glass as G
from clearvae_torch.ops.kernels.counts import GraphLaunches

MNISTC = tuple((name, None) for name in C.CORRUPTIONS)
# glass_blur's (max_delta, iterations) by severity
PARAMS = {1: (1, 2), 2: (2, 1), 3: (2, 3), 4: (3, 2), 5: (4, 2)}
# the CPU tests' bar of glass_blur (tests/test_torch_corruptions.py): atol
# on 0..255 and the share of pixels the uint8 truncation may move beyond it
GLASS_BAR = (1e-3, 0.005)


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def card():
    """The CUDA device, or a skip where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _operands(severity: int, b: int, seed: int = 0, device="cpu"):
    """What glass_blur hands ``glass_swaps`` at this severity for b images
    (truncated 0..255 pixels, deltas, flags, base), drawn from its keys;
    row 1 swaps with itself (deltas 0), row 2 swaps nothing, row 3 every
    coordinate, where the batch has those rows."""
    md, iters = PARAMS[severity]
    coords = C._glass_swap_coords(md, iters, 28)
    n = len(coords)
    g = torch.Generator().manual_seed(seed)
    img = torch.floor(torch.rand(b, 28, 28, generator=g) * 256).clamp(0, 255)
    keys = P.fold_in(P.key(seed, (b,)), torch.arange(b, dtype=torch.int32))
    k1, k2 = P.split(keys)
    do_swap = P.bernoulli(k1, 0.5, (n,))
    deltas = P.randint(k2, -md, md, (n, 2))
    if b > 1:
        deltas[1] = 0
        do_swap[1] = True
    if b > 2:
        do_swap[2] = False
    if b > 3:
        do_swap[3] = True
    base = torch.as_tensor(coords[:, 0] * 28 + coords[:, 1])
    return tuple(t.to(device) for t in (img, deltas, do_swap, base))


def _words(img, deltas, do_swap, base):
    """Each swap's (p, q) as the kernel packs them into one word: q = p + dy
    * W + dx, or p where the flag is clear or an index falls outside the
    image; [B, n] each, decoded from the words."""
    b, h, w = img.shape
    hw = h * w
    p = base[None, :].expand(b, -1)
    q = p + deltas[..., 1] * w + deltas[..., 0]
    inside = (p >= 0) & (p < hw) & (q >= 0) & (q < hw)
    p = torch.where(inside, p, 0)
    q = torch.where(inside & do_swap, q, p)
    word = p | (q << 16)
    return word & 0xFFFF, word >> 16


def _emulate(img, deltas, do_swap, base):
    """The kernel on the CPU: the words, then one walk over the swaps in
    order, the no-ops (p == q) skipped, over every image at once."""
    b, h, w = img.shape
    p, q = (t.numpy() for t in _words(img, deltas, do_swap, base))
    pix = img.reshape(b, h * w).numpy().copy()
    rows = np.arange(b)
    for j in range(base.shape[0]):
        live = p[:, j] != q[:, j]
        r, pj, qj = rows[live], p[live, j], q[live, j]
        a, bv = pix[r, pj], pix[r, qj]
        pix[r, pj] = bv
        pix[r, qj] = a
    return torch.from_numpy(pix).reshape(b, h, w)


# ---------------------------------------------------------------------------
# CPU
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("severity", sorted(PARAMS))
def test_kernel_arithmetic_matches_plain_twin(severity):
    """The kernel's words and walk give the plain twin's pixels bit for bit,
    rows of self-swaps, of no swap and of every swap among them."""
    img, deltas, do_swap, base = _operands(severity, 7, seed=severity)
    want = G.glass_swaps_plain(img.clone(), deltas, do_swap, base)
    assert torch.equal(_emulate(img, deltas, do_swap, base), want)
    assert torch.equal(want[2], img[2]) and torch.equal(want[1], img[1])
    assert not torch.equal(want[3], img[3])


@pytest.mark.parametrize("severity", (1, 5))
def test_kernel_partner_equals_the_loops(severity):
    """The q the kernel packs is the loop's partner wherever the flag is
    set, and p where it is clear; every partner lies inside its image."""
    img, deltas, do_swap, base = _operands(severity, 7)
    partner = base + deltas[..., 1] * 28 + deltas[..., 0]
    p, q = _words(img, deltas, do_swap, base)
    assert torch.equal(p, base[None, :].expand_as(p))
    assert torch.equal(q, torch.where(do_swap, partner, p))
    assert bool(((partner >= 0) & (partner < 28 * 28)).all())


def test_cpu_tensors_take_the_plain_twin_and_launch_nothing():
    G.reset_launches()
    img, deltas, do_swap, base = _operands(1, 4)
    got = G.glass_swaps(img.clone(), deltas, do_swap, base)
    assert torch.equal(got, G.glass_swaps_plain(img.clone(), deltas,
                                                do_swap, base))
    out = torch.empty_like(img)
    G.glass_swaps(img, deltas, do_swap, base, out=out)
    assert torch.equal(out, got)
    x = torch.rand(16, 28, 28) * 255
    draws = C.style_draws(0, torch.arange(16, dtype=torch.int32))
    C.style_batch(x, torch.arange(16) % 16, draws, MNISTC)
    assert G.LAUNCHES["glass"] == 0


def _bad(case):
    img, deltas, do_swap, base = _operands(1, 3)
    if case == "float64":
        img = img.double()
    elif case == "flat":
        img = img.reshape(3, -1)
    elif case == "strided":
        img = img.transpose(1, 2)
    elif case == "int32_deltas":
        deltas = deltas.int()
    elif case == "deltas_shape":
        deltas = deltas[:, :-1]
    elif case == "float_flags":
        do_swap = do_swap.float()
    elif case == "base_int32":
        base = base.int()
    elif case == "apart":
        base = base.to("meta")
    elif case == "too_many_pixels":
        img = torch.zeros(3, 300, 300)
    elif case == "too_many_swaps":
        n = G.SMEM_BYTES // 4
        base = torch.zeros(n, dtype=torch.int64)
        deltas = torch.zeros(3, n, 2, dtype=torch.int64)
        do_swap = torch.zeros(3, n, dtype=torch.bool)
    return img, deltas, do_swap, base


@pytest.mark.parametrize("case", [
    "float64", "flat", "strided", "int32_deltas", "deltas_shape",
    "float_flags", "base_int32", "apart", "too_many_pixels",
    "too_many_swaps", "out_shape"])
def test_wrapper_checks_raise(case):
    img, deltas, do_swap, base = _bad(case)
    out = torch.empty(3, 28, 27) if case == "out_shape" else None
    with pytest.raises(ValueError):
        G.glass_swaps(img, deltas, do_swap, base, out=out)


def test_binding_matches_the_extern_c_function():
    src = open(os.path.join(_build.CSRC, "glass_swap.cu")).read()
    params = re.search(r'extern "C" int glass_swaps\(([^)]*)\)', src).group(1)
    assert len(params.split(",")) == len(G.ARGTYPES)
    assert "glass_swap" in _build.sources()


# ---------------------------------------------------------------------------
# card
# ---------------------------------------------------------------------------


@pytest.mark.card
@pytest.mark.parametrize("severity", sorted(PARAMS))
def test_card_kernel_equals_plain_twin(card, severity):
    """B = 1, 7 and 128, in place and into ``out``, one launch a call, the
    pixels bit for bit the plain twin's on the CPU."""
    for b in (1, 7, 128):
        img, deltas, do_swap, base = _operands(severity, b, seed=b)
        want = G.glass_swaps_plain(img.clone(), deltas, do_swap, base)
        args = [t.to(card) for t in (deltas, do_swap, base)]
        G.reset_launches()
        inplace = img.to(card)
        G.glass_swaps(inplace, *args)
        out = torch.full_like(inplace, -1.0)
        G.glass_swaps(img.to(card), *args, out=out)
        torch.cuda.synchronize()
        assert G.LAUNCHES["glass"] == 2
        assert torch.equal(inplace.cpu(), want)
        assert torch.equal(out.cpu(), want)


@pytest.mark.card
def test_card_captured_call_replays_the_eager_one(card):
    """glass_blur captured in a graph: each replay one launch, counted by
    ``GraphLaunches``, and the eager call's pixels."""
    x = torch.rand(128, 28, 28, device=card) * 255
    keys = tuple(k.to(card) for k in P.fold_in(
        P.key(4, (128,)), torch.arange(128, dtype=torch.int32)))
    eager = C.glass_blur(x, keys)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        C.glass_blur(x, keys)
    torch.cuda.current_stream().wait_stream(side)
    graph, launches = torch.cuda.CUDAGraph(), GraphLaunches()
    G.reset_launches()
    with launches.capture(), torch.cuda.graph(graph):
        captured = C.glass_blur(x, keys)
    assert G.LAUNCHES["glass"] == 0
    assert launches.per_replay["launches.glass"] == {"glass": 1}
    for _ in range(3):
        graph.replay()
        launches.replay()
    torch.cuda.synchronize()
    assert G.LAUNCHES["glass"] == 3
    assert torch.equal(captured, eager)


@pytest.mark.card
def test_card_mnistc_style_batch_equals_plain_twin_and_cpu(card, monkeypatch):
    """One style_batch of MNIST-C's 16 styles at B = 128: one K5 launch,
    the styled pixels bit for bit those of the plain twin on the card; the
    glass-blurred rows within the CPU tests' bar of the CPU path's."""
    from clearvae_torch.data.mnist import synthetic_mnist

    x_cpu = torch.as_tensor(synthetic_mnist(128, seed=0)[0])
    sidx_cpu = torch.arange(128) % 16
    draws_cpu = C.style_draws(0, torch.arange(128, dtype=torch.int32))
    x, sidx, draws = (t.to(card) for t in (x_cpu, sidx_cpu, draws_cpu))
    G.reset_launches()
    got = C.style_batch(x, sidx, draws, MNISTC)
    torch.cuda.synchronize()
    assert G.LAUNCHES["glass"] == 1
    monkeypatch.setattr(C, "glass_swaps", G.glass_swaps_plain)
    want = C.style_batch(x, sidx, draws, MNISTC)
    torch.cuda.synchronize()
    assert G.LAUNCHES["glass"] == 1
    assert torch.equal(got, want)
    rows = sidx_cpu == C.CORRUPTIONS.index("glass_blur")
    cpu = C.style_batch(x_cpu, sidx_cpu, draws_cpu, MNISTC)
    atol, share = GLASS_BAR
    off = ((got.cpu()[rows] - cpu[rows]).abs() * 255 > atol).double().mean()
    assert float(off) <= share
