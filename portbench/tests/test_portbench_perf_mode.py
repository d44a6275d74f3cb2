"""The perf-mode cell ``vae64-celeba-perf`` against its plain reference
``reference/vae_bf16.py``, on the CPU at the tiny size of the faults' tests
(B = 32): the program is correct under the cell's own limits; half of each
batch left out of the loss, the check's control (the reference one
precision below the configuration's: float8_e4m3fn where it states
bfloat16, TF32 where it states float32) and a planted fault, BatchNorm's
statistics and normalization computed in bfloat16 where the configuration
states float32, are not. The reference's parameters are the program's,
name for name and shape for shape, and it imports nothing of the program
or of JAX. On the card (``-m card``), at the cell's size, the planted
BatchNorm fault fails the cell's limits too; ``test_portbench_control.py``
holds the check's control there."""

import json
import math
import os
import subprocess
import sys

import pytest
import torch

torch.set_num_threads(1)

from clearvae_torch.ops import losses as PL  # noqa: E402
from portbench import check as C  # noqa: E402
from portbench import harness as H  # noqa: E402
from portbench import run as R  # noqa: E402
from portbench.reference import vae_bf16 as VB  # noqa: E402

CELL = "vae64-celeba-perf"
TINY = {"traffic": {"n_train": 160}, "config": {"fit": {"batch_size": 32}}}
SEEDS = (2 ** 31 + 5, 2 ** 31 + 991)
CARD_SEEDS = (2 ** 31 + 101, 2 ** 31 + 202, 2 ** 31 + 303)
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "clearvae_tpu",
             "clearvae_torch"}


def _limits():
    return H.load_cell(CELL).workload["limits"]


def _correct(numbers: dict) -> bool:
    return C.verdict(numbers, _limits())[0]


def _run(seed):
    return R.run(CELL, seed, 0.2, device="cpu", overrides=TINY)


@pytest.mark.parametrize("seed", SEEDS)
def test_the_program_is_correct_against_its_reference(seed):
    res = _run(seed)
    assert res["correct"], res["checks"]


def test_half_a_batch_left_out_is_not_correct(monkeypatch):
    whole = PL.sample_level_reduction
    monkeypatch.setattr(PL, "sample_level_reduction",
                        lambda t: whole(t[: max(1, t.shape[0] // 2)]))
    res = _run(SEEDS[0])
    assert not res["correct"], res["checks"]


def _bn_in_bf16(self, p, buf, name, x, train, new_buf):
    """``PlainVAE._bn_apply`` with its statistics, its scale and each
    step of the normalization rounded to bfloat16."""
    r, V = VB.rnd, VB.V
    w, b = r(p[f"{name}.weight"]), r(p[f"{name}.bias"])
    dims = (0,) + tuple(range(2, x.ndim))
    shape = (1, -1) + (1,) * (x.ndim - 2)
    if train:
        mean = r(x.mean(dims))
        var = r(r((x * x).mean(dims)) - r(mean * mean)).clamp_min(0.0)
        for k, v in (("mean", mean), ("var", var)):
            new_buf[f"{name}.running_{k}"] = (
                (1 - V.BN_MOMENTUM) * buf[f"{name}.running_{k}"]
                + V.BN_MOMENTUM * v.detach())
    else:
        mean, var = buf[f"{name}.running_mean"], buf[f"{name}.running_var"]
    scale = r(w * torch.rsqrt(var + V.BN_EPS))
    return r(r(r(x - mean.view(shape)) * scale.view(shape)) + b.view(shape))


def against_the_reference(seed, device, overrides=None, tf32=False,
                          bn_apply=None) -> dict:
    """The compared numbers of the reference put in the program's place
    against the reference at the configuration's precision, on the batches
    of the program's run from ``seed``: with TF32 on (``tf32``: the check's
    control), or with ``bn_apply`` in place of its BatchNorm."""
    run = H.set_up(H.load_cell(CELL, overrides), seed, device)
    H.release(run)
    batches = C.first_batches(run)
    ref = C.reference_steps(run, batches=batches)
    whole = VB.PlainVAEBF16._bn_apply
    VB.PlainVAEBF16._bn_apply = bn_apply or whole
    try:
        alt = C.reference_steps(run, tf32=tf32, batches=batches)
    finally:
        VB.PlainVAEBF16._bn_apply = whole
    out = C.step_numbers(alt["losses"], alt["grad1"], alt["params"],
                         run.weights, ref, run.modules)
    out["nonfinite_losses"] = float(
        sum(not math.isfinite(v) for v in alt["losses"]))
    return out


def test_the_control_rounds_below_bfloat16():
    assert VB.rounding() is torch.bfloat16
    C._tf32(True)
    try:
        assert VB.rounding() is torch.float8_e4m3fn
    finally:
        C._tf32(False)
    assert VB.rounding() is torch.bfloat16


def test_the_checks_control_is_not_correct():
    numbers = against_the_reference(SEEDS[0], "cpu", TINY, tf32=True)
    assert not _correct(numbers), numbers


def test_batchnorm_in_bfloat16_is_not_correct():
    numbers = against_the_reference(SEEDS[0], "cpu", TINY,
                                    bn_apply=_bn_in_bf16)
    assert not _correct(numbers), numbers


def test_the_reference_has_the_programs_parameters():
    cell = H.load_cell(CELL, TINY)
    spec = {n: tuple(s) for n, s, _ in VB.param_spec(cell.config)}
    trainer = H.build_trainer(cell, 0, "cpu")
    program = {n: tuple(p.shape) for n, p in H.named_parameters(trainer).items()}
    assert spec == program
    z = cell.config["model"]["z_dim"]
    assert spec["latent_heads.weight"] == (2 * z, 2048)
    assert spec["latent_heads.bias"] == (2 * z,)
    assert not any(n.endswith(("mu_c_head.weight", "logvar_s_head.bias"))
                   for n in spec)


def test_the_reference_states_the_mode_it_follows():
    model = dict(H.load_cell(CELL).config["model"], dtype="float32")
    with pytest.raises(ValueError, match="perf mode"):
        VB.PlainVAEBF16(model)


def test_the_reference_imports_nothing_of_the_program_or_jax():
    root = os.path.dirname(H.PKG)
    code = ("import json, sys, portbench.reference.vae_bf16\n"
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, check=True,
                         env={**os.environ, "PYTHONPATH": root})
    tops = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "portbench" in tops and not tops & FORBIDDEN


@pytest.mark.card
def test_batchnorm_in_bfloat16_fails_on_the_card(card):
    for seed in CARD_SEEDS:
        numbers = against_the_reference(seed, card, bn_apply=_bn_in_bf16)
        assert not _correct(numbers), numbers
