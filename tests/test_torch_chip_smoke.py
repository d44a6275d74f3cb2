"""``chip_smoke.py`` on the CPU: its set-up before the first phase (the GPU
lock, TF32 off), its one filter over profiler events, and the bounds of
its kernel table against byte, FLOP and exp counts made by hand."""

import importlib.util
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType

from clearvae_torch.utils import lock as L

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
spec = importlib.util.spec_from_file_location(
    "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
CS = importlib.util.module_from_spec(spec)
spec.loader.exec_module(CS)

# published H100 SXM peaks: HBM3 bytes/s, fp32 outside the tensor cores,
# MUFU exps (16 a clock an SM) and int32 operations (64 a clock an SM),
# 132 SMs at 1.98 GHz
HBM, FP32 = 3.35e12, 67e12
MUFU, INT32 = 132 * 16 * 1.98e9, 132 * 64 * 1.98e9


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _Stop(Exception):
    """Raised by the first phase: nothing runs on a card."""


def test_main_takes_the_lock_and_sets_fp32_before_its_first_phase(
        monkeypatch):
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    locks, seen = [], []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(L, "acquire_gpu_lock",
                        lambda *a, **k: locks.append(a) or False)
    monkeypatch.setattr(CS, "gpu_name_and_limit", lambda: "stand-in, 700 W")

    def first_phase():
        seen.append((len(locks), torch.backends.cudnn.allow_tf32,
                     torch.backends.cuda.matmul.allow_tf32))
        raise _Stop
    monkeypatch.setattr(CS, "phase_build", first_phase)
    try:
        with pytest.raises(_Stop):
            CS.main()
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = flags
    assert seen == [(1, False, False)]


def _event(name, device=DeviceType.CUDA, us=0.0, annotation=False):
    return SimpleNamespace(
        name=name, device_type=device, is_user_annotation=annotation,
        time_range=SimpleNamespace(elapsed_us=lambda: us))


class _Profile:
    def __init__(self, events):
        self._events = events

    def events(self):
        return self._events


# the host's events in every stand-in profile: a record_function range,
# which the profiler may mirror onto the device timeline, and a launch
_HOST = [_event("Optimizer.step#Adam.step", DeviceType.CPU, 9.0),
         _event("cudaLaunchKernel", DeviceType.CPU, 1.0)]


@pytest.mark.parametrize("events, want", [
    ([_event("clear_latent_fwdgrad_kernel<8, true>", us=2.5),
      _event("clear_latent_fwdgrad_kernel<8, true>", us=1.5),
      _event("style_kernel", us=4.0)],
     ({"clear_latent_fwdgrad_kernel<8, true>": 2, "style_kernel": 1},
      {"clear_latent_fwdgrad_kernel<8, true>": 4.0, "style_kernel": 4.0},
      8.0)),
    ([_event("Memcpy HtoD (Pageable -> Device)", us=3.0),
      _event("Memset (Device)", us=0.5)],
     ({}, {}, 3.5)),
    ([_event("Optimizer.step#Adam.step", us=7.0),
      _event("style_kernel", us=2.0)],
     ({"style_kernel": 1}, {"style_kernel": 2.0}, 2.0)),
    ([_event("portbench.epoch", us=30.0, annotation=True),
      _event("snn_fwd_kernel", us=1.0)],
     ({"snn_fwd_kernel": 1}, {"snn_fwd_kernel": 1.0}, 1.0)),
], ids=["kernels by name", "copies and fills busy, not kernels",
        "a mirrored host range neither", "a user annotation neither"])
def test_device_kernels(events, want):
    assert CS.device_kernels(_Profile(_HOST + events)) == want


# (B, name, bytes, fp32 operations, exps) at z = 8 (a half's width) with
# ps on and the labels arange(B) % 8 (B/8 rows a class): bytes read once
# and written once (labels int64); operations 2z a pair for S, 2z more
# for the gradient, + K1's two KL sums; exps one a valid pair, one a
# positive pair (ps: another label), two a row, per half, + K1's KL
@pytest.mark.parametrize("b, name, nbytes, flops, exps, unit", [
    (128, "clear_latent_fwdgrad", 25616, 1050624, 51328, "fp32"),
    (128, "clear_latent_bwd", 40976, 16384, 2048, "bytes"),
    (128, "snn_fwd", 5124, 260096, 30848, "exp (MUFU)"),
    (128, "snn_bwd", 9220, 520192, 30848, "fp32"),
    (2048, "clear_latent_fwdgrad", 409616, 268468224, 12617728, "fp32"),
    (2048, "clear_latent_bwd", 655376, 262144, 32768, "bytes"),
    (2048, "snn_fwd", 81924, 67076096, 7866368, "exp (MUFU)"),
    (2048, "snn_bwd", 147460, 134152192, 7866368, "fp32"),
])
def test_kernel_table_bound(b, name, nbytes, flops, exps, unit):
    t = {"bytes": nbytes / HBM, "fp32": flops / FP32, "exp (MUFU)": exps / MUFU}
    assert max(t, key=t.get) == unit
    ms, by, got_unit = CS.bound(name, b, 8, torch.arange(b) % 8, True)
    assert (by, got_unit) == ("bytes" if unit == "bytes" else "operations",
                              unit)
    assert ms == pytest.approx(t[unit] * 1e3, rel=1e-12)


# (pass, bytes, int32 operations): fog's last level, 128 keys x 16,384
# counters of one word (16 key bytes a key, 8 a word, 73 operations an
# element with bits' xor); a split of 128 keys into two, two words each
@pytest.mark.parametrize("one_pass, nbytes, ops, by", [
    (("bits", 128, 16384, 0), 16779264, 153092096, "operations"),
    (("split", 128, 2, 0), 6144, 18432, "bytes"),
])
def test_k4_bound(one_pass, nbytes, ops, by):
    ms, got_by = CS.k4_bound([one_pass])
    assert got_by == by
    assert ms == pytest.approx(max(nbytes / HBM, ops / INT32) * 1e3,
                               rel=1e-12)


# a train step's BatchNorms at B = 128: the bound's 5 element passes each
# (x read and y written by the forward, dy and x read and dx written by the
# backward) and K6's design's 8 (x read by stats, apply, grad_reduce,
# grad_apply; y written; dy read twice; dx written): VAE64's 17,825,792
# elements (4,194,304 + 2,097,152 + 1,048,576 + 524,288 + 262,144 in the
# encoder; 262,144 + 524,288 + 1,048,576 + 2,097,152 + 4,194,304 +
# 1,572,864 in the decoder), VAE28's 3,033,088 (802,816 + 401,408 +
# 262,144; 262,144 + 401,408 + 802,816 + 100,352)
@pytest.mark.parametrize("model, itemsize, passes, nbytes", [
    ("vae64", 2, None, 5 * 17825792 * 2), ("vae64", 4, None, 5 * 17825792 * 4),
    ("vae28", 4, None, 5 * 3033088 * 4), ("vae64", 2, 8, 8 * 17825792 * 2),
])
def test_k6_bound(model, itemsize, passes, nbytes):
    args = () if passes is None else (passes,)
    ms, by = CS.k6_bound(CS.K6_LAYERS[model], itemsize, *args)
    assert by == "bytes"
    assert ms == pytest.approx(nbytes / HBM * 1e3, rel=1e-12)


def _planted(case):
    """(got, ops, act) for ``k6_check`` on the CPU, the twin standing in for
    K6 with one fault or flip planted: a layer of 16 × 3 × 2 × 2, whose
    element (5, 1, 0, 1) has its ReLU input moved to zero by the bias."""
    from clearvae_torch.models.layers import batch_norm_plain as twin

    dtype = torch.bfloat16 if case == "bf16_equal" else torch.float32
    ops = CS.k6_operands(16, 3, 4, dtype, "cpu", 7)
    act = "none" if case == "nan_no_act" else "relu"
    idx = (5, 1, 0, 1)
    pre = CS.k6_layer(twin, ops, True, True, "none")[0]
    ops[3][1] -= pre[idx]      # that input is now within rounding of zero
    got = CS.k6_layer(twin, ops, True, True, act)
    if case in ("flip_near_zero", "flip_far_from_zero", "flip_wrong_dx"):
        pre = CS.k6_layer(twin, ops, True, True, "none")[0]
        at = idx if case != "flip_far_from_zero" else tuple(
            int(i) for i in np.unravel_index(int(pre.abs().argmax()),
                                             pre.shape))
        mask = pre > 0
        mask[at] = ~mask[at]
        flipped = CS.k6_layer(twin, ops, True, True, "relu", mask=mask)
        got[0] = torch.where(mask, pre.clamp_min(1e-9), 0.0)
        if case != "flip_wrong_dx":
            got[1:4] = flipped[1:4]
    elif case == "tail_row":
        got[1][-1] += 0.05
    elif case in ("nan", "nan_no_act"):
        got[1][3, 2, 1, 0] = float("nan")
    elif case == "running_var":
        got[5][2] += 1e-3
    return got, ops, act


@pytest.mark.parametrize("case, problem", [
    ("equal", None), ("bf16_equal", None), ("flip_near_zero", None),
    ("flip_far_from_zero", "other sides of zero"),
    ("flip_wrong_dx", "tensor 1"), ("tail_row", "tensor 1"),
    ("nan", "tensor 1"), ("nan_no_act", "tensor 1"),
    ("running_var", "tensor 5"),
])
def test_k6_check_lets_past_only_a_relu_input_at_zero(case, problem):
    """``k6_check`` against the twin (CPU): the twin itself agrees at 0.0;
    a ReLU input at zero on K6's other side passes when K6's gradients
    are the twin's through K6's mask, and fails when they are not or when
    the input lies far from zero; a spoiled row, a NaN and a running
    variance off by 1e-3 fail."""
    from clearvae_torch.models.layers import batch_norm_plain as twin

    got, ops, act = _planted(case)
    found, err, flips = CS.k6_check(got, ops, twin, True, True, act)
    if problem is None:
        # the flipped input's y: 0 on one side, at most 1e-9 on the other
        assert found is None and err <= 1e-9, (found, err)
        assert flips["n"] == (case == "flip_near_zero")
    else:
        assert found is not None and problem in found, found
