#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``clearvae_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:

1. build      — compile every ``clearvae_torch/csrc/*.cu`` with nvcc for
                sm_90a (one nvcc per source, all started together) and print
                the build time and ptxas report.
2. kernels    — hold each CUDA kernel against its plain PyTorch twin on the
                card. The fused losses K1 (forward and backward kernel),
                K2f, K2b: values and autograd gradients at every (B, z) of
                SHAPES (each of K1's template instances, its column-tile
                ring, singleton-label rows), ps on and off; K1's backward
                with a non-unit cotangent; two K1, K2f and K2b calls
                bit-identical; K1 one launch a call each way, K2f and K2b
                one launch a call (profiler). Timed at (B, z/2) = (128, 8),
                (2048, 8) and (128, 32), phase 8's shape, with CUDA events
                and, per call, the profiler's device time. The
                styler K3: all seven codes × severities 1–5 at B = 128, 100
                and 512 (atol 1e-3 on the 0..255 scale), and rows of
                negative code left bit-equal in a pre-filled ``out``; timed
                at B = 128 and 512.
3. main       — the flagship configuration through the user entry points:
                ``get_clearvae_trainer`` (z = 16, batch 128, τ = 0.1, α = 100,
                β = 1/8, Adam 5e-4, fused latent losses) → ``fit`` for 2
                epochs on synthetic Styled-MNIST of the six styles, styled
                once by ``materialize`` (K3) → ``evaluate``, both as users
                call them: their default, the captured CUDA graph. The
                launch counters are zeroed just before and read just after
                (K1's forward and backward kernels once per train step, K2f
                twice per eval batch, counted by replay); one step is also
                checked fused against unfused on the card. Then an eager
                train step is timed and profiled: wall and device-busy ms
                per step, idle share, kernels per step.
5. adversarial — CLEAR-TC and CLEAR-MIM (CLUB-S) at the flagship widths
                through ``get_cleartcvae_trainer`` / ``get_clearmimvae_trainer``
                with ``hyperparameter={"fused": True}`` (λ = 1, factor Adam
                1e-4; λ = 3, estimator Adam 2e-3, 5 inner steps) → ``fit`` for
                2 epochs on phase 3's data → ``evaluate`` (graphed, the
                default). Each run's launch counters are zeroed before and
                read after: K2f (c_loss forward) and K2b (its backward) once
                per train step, by replay, K1 never; the eval is unfused, as
                in JAX. One step of each is checked fused against unfused on
                the card, and an eager train step of each is timed and
                profiled.
4. downstream — the Styled-MNIST downstream experiment through its entry
                point, ``styledmnist_downstream.main`` with
                ``--style_on_device --k_min 5 --k_max 5``: all seven zoo
                entries (baseline CNN, GVAE, ML-VAE, CLEAR, CLEAR-TC,
                CLEAR-MIM with L1OutUB and with CLUB-S) fit and validate
                through their captured graphs (the default), every batch
                styled inside them (K3, zigzag, canny); the VAEs' probes
                encode through the fused style→encode pass and train by
                replaying the captured probe step, the CNN classifies
                through its fused style→logits pass, and the result JSON is
                written.
                Width is the flagship's; depth is cut (20,000 train / 4,000
                test synthetic digits, 2 VAE, CNN and probe epochs). K3's
                launches, by replay inside the graphs, must equal one per
                styled batch and chunk and severity group, which the phase
                counts itself; the zoo is unfused, so K1/K2f/K2b must not
                launch. Then a styled CLEAR train step is profiled, eager
                and graphed: K3's and styling's share of it, and styling's
                kernels and host syncs a batch.

6. mig        — the Styled-MNIST MIG/ELBO sweep through its entry point,
                ``mig_expr.main`` at the flagship widths (z = 16, batch 128,
                τ = 0.1, α = 100, β = 1/8) with ``--mig_backend auto``: all
                eight zoo entries (clear-ps, clear-neg, bvae, clear-tc, two
                clear-mim, mlvae, gvae) fit, validate and test on
                materialized data (K3 in ``materialize``), through their
                captured graphs (the default). Depth is cut
                (12,000 synthetic digits: 8,000 / 2,000 / 2,000; 1 epoch).
                The CSV must hold the eight rows in the JAX order, every
                value finite; "auto" must resolve to the native C++ MIG
                (its g++ build is a failure here, not a fallback); native
                and numpy MIG must agree on the test latents of one entry
                (rtol 1e-3, atol 1e-3); K3's launches must equal what
                materializing the three splits takes, and K1/K2f/K2b none
                (the zoo is unfused). A second call of the same command
                must train nothing and rewrite the same CSV.

7. graph      — the captured steps, the default of ``fit`` and
                ``evaluate``, against the eager loops
                (``use_scan=False``) on phase 3's data, under
                ``cudnn.deterministic``: the fused CLEAR, CLEAR-TC and
                CLEAR-MIM (CLUB-S) trainers fit 2 epochs each way from the
                same seed: equal update counts, and histories and final
                state equal (max abs difference 0.0); K1 forward = K1
                backward = 126 on the graphed CLEAR fit and K2f = K2b = 126
                on each graphed TC/MIM fit, counted by replay (each fit's
                counters zeroed just before and read after). A checkpoint
                after epoch 0, restored into a fresh trainer, then
                ``fit(start_epoch=1)`` graphed: the uninterrupted graphed
                fit's epoch 1; ``InferenceSession.from_checkpoint`` on the
                card: its shapes, and equal to ``from_trainer`` (atol
                1e-6). Every other step that ``fit`` captures is fitted
                both ways the same way, with equal launches both ways:
                CLEAR and CLEAR-TC unfused, GVAE, ML-VAE, the CNN,
                CLEAR-MIM with CLUB, CLUBMean, L1OutUB, VarUB and InfoNCE,
                and the fused CLEAR trainer with ``style_on_device``, K3,
                zigzag and canny inside its graph: K3 = 126 by replay, and
                an epoch of its replays runs under
                ``torch.cuda.set_sync_debug_mode("error")`` (no
                synchronizing call between the first and the last replay)
                and K3 is found by name in the device trace of 20 replays,
                exactly once between each replay's K1 forward kernel and the
                one before it (a 21st replay opens the trace and is not
                inspected). Then ``evaluate`` graphed against eager: the
                fused CLEAR trainer materialized (K2f = 2 a batch by
                replay) and styled (K3 = 1 a batch), GVAE with
                ``with_evidence_acc``, each with a ragged tail: MIG, MSE and
                every per-batch mean equal. Then ``epochs_per_scan=2``: one
                history block of the last batch of each epoch, equal to the
                one-step graph's fit exactly. Then, through
                ``bench.time_steps``, eager and graphed steps in turns
                (wall, device busy, idle share, kernels a step,
                images/sec) and the fused-loss kernels counted by name in
                the device trace of 20 replays.

8. sixty-four — the 64×64 family at the runners' widths (VAE64, z = 64,
                B = 128, β = 1/32, τ = 0.1, α = 100, Adam 3e-5) on synthetic
                CelebA (2,048 images, 1,740 / 308): one VAE64 step fused
                against unfused on the card (phase 5's bars); the fused CLEAR
                trainer (``get_clearvae_trainer(vae_arch="VAE64", ...,
                hyperparameter={"fused": True})``) fit 2 epochs eagerly and
                graphed under ``cudnn.deterministic``, equal at 0.0, K1's
                forward and backward once a step by replay, then the graphed
                ``evaluate`` (K2f twice a batch, finite MIG and MSE); its
                steps timed by ``bench.time_steps`` (wall, device busy, idle
                share, kernels a step, images/sec, FLOP share) with the K1
                kernel of the trace the ``<32, true>`` instance and the top
                device kernels of a graphed step; fused CLEAR-TC 1 epoch
                (K2f = K2b = 1 a step by replay); LAM-CNN64 fit graphed and
                eagerly, equal at 0.0, and an epoch of its replays under
                ``set_sync_debug_mode("error")``; the perf mode (bf16 conv
                stacks, fused heads) fit and evaluated, finite, and timed;
                ``bench.py``'s ``vae64_clear`` and ``vae64_bf16_b256`` rows;
                then the runners through their ``main`` at cut depth
                (``RUNNERS64``: CelebA k = 1, 2 epochs, seven entries;
                Camelyon17 1 epoch, eight with the LAM-CNN; PACS and CheXpert
                k = 1, 1 epoch, clear and baseline; the CelebA MIG/ELBO sweep
                1 epoch, eight), each result in the JAX schema with finite
                values, and no fused-loss or styling kernel launched (the zoo
                is unfused and the 64×64 sets come styled).

Phases run in the order 1, 2, 3, 5, 7, 4, 6, 8 (phases 5 and 7 train on
phase 3's data).

It prints the card's name and power limit, one JSON line of per-kernel
numbers, and, last, ``{"ok": true, "device": {...}}``. It exits non-zero
without that line when there is no CUDA device or no ``clearvae_torch``
beside it. Imports nothing of JAX.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

# Published H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth, and fp32 on
# the CUDA cores (the kernels use no tensor cores). An IEEE expf or logf is
# one MUFU op (EX2 / LG2): 16 a clock per SM (CUDA programming guide,
# throughput table, compute capability 9.0), 132 SMs at 1.98 GHz boost.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12
PEAK_MUFU_PER_S = 132 * 16 * 1.98e9

# K1's template instances (rows of z <= 8, 16, 32, 64 floats; float4 rows
# where z is 8, 16, 32 or 64; 16 warps a CTA up to z = 16, 8 above), its
# column-tile ring (RING_SHAPE), and singleton-label rows (17, 8)
SHAPES = [(128, 8), (100, 7), (128, 16), (100, 12), (128, 32), (100, 24),
          (100, 48), (2048, 8), (2048, 64), (17, 8)]
RING_SHAPE = (2048, 64)
# B=128, z=8 is the main path's shape; z=32 the 64×64 path's (phase 8)
TIMED = [(128, 8), (2048, 8), (128, 32)]
VAL_TOL = dict(rtol=2e-5, atol=1e-6)
SOURCE = {"clear_latent_fwdgrad": "clearvae_torch/csrc/clear_latent.cu",
          "clear_latent_bwd": "clearvae_torch/csrc/clear_latent.cu",
          "snn_fwd": "clearvae_torch/csrc/clear_latent.cu",
          "snn_bwd": "clearvae_torch/csrc/clear_latent.cu"}
REPLACES = {
    "clear_latent_fwdgrad": "clearvae_tpu/ops/pallas/fused_loss.py:249",
    # K1's backward: the XLA-fused combine of its custom_vjp
    "clear_latent_bwd": "clearvae_tpu/ops/pallas/fused_loss.py:314",
    "snn_fwd": "clearvae_tpu/ops/pallas/fused_loss.py:76",
    "snn_bwd": "clearvae_tpu/ops/pallas/fused_loss.py:99",
}
K3_SOURCE = "clearvae_torch/csrc/style_kernel.cu"
K3_REPLACES = "clearvae_tpu/ops/pallas/style_kernel.py:52"
K3_SHAPES = (128, 100, 512)
K3_TIMED = (128, 512)
K3_ATOL = 1e-3          # 0..255 scale, the bar of the CPU test against JAX
# the styles the downstream path sends through K3 (identity, stripe,
# brightness@5, scale@5), the codes K3 is timed on
K3_PATH_CODES = (0, 1, 2, 6)
DOWNSTREAM_ARGS = ["--style_on_device", "--k_min", "5",
                   "--k_max", "5", "--seed", "0", "--epochs", "2",
                   "--n_train", "20000", "--n_test", "4000",
                   "--batch_size", "128", "--device", "cuda"]
ZOO = ["baseline", "gvae", "mlvae", "clear", "clear-tc", "clear-mim (L1OutUB)",
       "clear-mim (CLUB-S)"]
# phase 5: the flagship widths, and each trainer's own second player
ADV_COMMON = dict(beta=1 / 8, vae_lr=5e-4, z_dim=16, alpha=100,
                  temperature=0.1, seed=0, verbose_period=1,
                  hyperparameter={"fused": True}, device="cuda")
ADV_STEPS = 126
MIG_ARGS = ["--n_total", "12000", "--epochs", "1", "--batch_size", "128",
            "--z_dim", "16", "--temperature", "0.1", "--alpha", "100",
            "--betas", "0.125", "--seed", "0", "--mig_backend", "auto",
            "--device", "cuda"]
MIG_ZOO = ["clear-ps", "clear-neg", "bvae", "clear-tc", "clear-mim (L1OutUB)",
           "clear-mim (CLUB-S)", "mlvae", "gvae"]
MIG_TOL = dict(rtol=1e-3, atol=1e-3)   # tests/test_native.py's bars
# phase 8: the 64×64 runners' widths (reference run_celeba_downstream_expr.py:
# 225-238): VAE64, z = 64 (K1's 32-wide instance), B = 128, β = 1/32, τ = 0.1,
# α = 100, Adam 3e-5, the latent losses fused
SIXTY_FOUR = dict(vae_arch="VAE64", in_channel=3, z_dim=64, beta=1 / 32,
                  vae_lr=3e-5, alpha=100, temperature=0.1, seed=0,
                  hyperparameter={"fused": True}, device="cuda")
N64 = 2048              # synthetic CelebA images, the runners' default
STEPS64 = 12            # steps a turn of bench.time_steps (12·128 ≤ 1,740)
# each runner: its module, its arguments (depth cut), its result file, and
# the zoo entries it must write (None: its whole zoo)
RUNNERS64 = [
    ("celeba_downstream", ["--k_max", "1", "--epochs", "2"],
     "celeba-k1-0.json", None),
    ("camelyon17_downstream", ["--epochs", "1", "--cnn_epochs", "1"],
     "camelyon17-k1-0.json", None),
    ("pacs_downstream", ["--k_max", "1", "--epochs", "1", "--models", "clear",
                         "baseline"], "pacs-k1-0.json", ["baseline", "clear"]),
    ("chexpert_downstream", ["--k_max", "1", "--epochs", "1", "--models",
                             "clear", "baseline"], "chexpert-k1-0.json",
     ["baseline", "clear"]),
    ("mig_expr_celeba", ["--epochs", "1", "--mig_backend", "auto"],
     "mig_elbo_s0_a100.0_z16_t0.1.csv", MIG_ZOO),
]


def fail(msg: str):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check_close(name, got, ref, *, rtol, atol):
    """Max abs error of got vs ref; fails the run outside the tolerance."""
    got, ref = got.detach().double(), ref.detach().double()
    if not bool(torch.isfinite(got).all()):
        fail(f"{name}: non-finite output")
    err = (got - ref).abs()
    if bool((err > atol + rtol * ref.abs()).any()):
        fail(f"{name}: max abs err {float(err.max()):.3e} beyond "
             f"rtol={rtol} atol={atol}")
    return float(err.max())


def grad_tol(ref):
    return dict(rtol=1e-3, atol=3e-5 * max(float(ref.abs().max()), 1.0))


def cuda_ms(fn, iters: int = 200, warmup: int = 10) -> float:
    """Mean time of one call, from CUDA events around ``iters`` calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def exp_count(name: str, label, ps: bool, z: int) -> int:
    """The exps and logs (MUFU ops) that these labels make a fused-loss
    function need, counted as the plain twin computes them: a half's two
    masked softmaxes take one exp per valid pair (j != i) and one per
    positive pair, and two logs a row; the gradient reuses them (p_all and
    p_pos of the [B, B] softmaxes), so it needs no more. KL takes one exp an
    element of each log-variance. The kernels recompute the softmaxes
    rather than store [B, B], so they take more exps than this floor."""
    lbl = label.cpu().numpy()
    b = len(lbl)
    same = lbl[:, None] == lbl[None, :]
    np.fill_diagonal(same, False)

    def half(ps_half: bool) -> int:
        pos = (lbl[:, None] != lbl[None, :]) if ps_half else same
        return b * (b - 1) + int(pos.sum()) + 2 * b

    if name == "clear_latent_fwdgrad":
        return half(False) + half(ps) + 2 * b * z
    if name == "clear_latent_bwd":
        return 2 * b * z
    return half(ps)


def bound(name: str, b: int, z: int, label, ps: bool):
    """(bound_ms, bound_by, bound_unit): the largest of the bytes (each input
    read once, each output written once) over HBM bandwidth, the fp32
    operations over the CUDA-core peak, and the exps over the MUFU rate.
    fp32 operations per half: 2z a pair for S = mu_n mu_nᵀ, 2z more for
    (G + Gᵀ) mu_n where there is a gradient. bound_by names the first or
    either of the other two ("operations"); bound_unit says which unit."""
    pairs = b * (b - 1)
    lbl = 8 * b                                   # int64 labels
    if name == "clear_latent_fwdgrad":
        nbytes = 4 * (4 * b * z) + lbl + 4 * 4 + 4 * (2 * b * z)
        flops = 2 * (pairs * 4 * z) + 2 * 5 * b * z   # + the two KL sums
    elif name == "clear_latent_bwd":
        nbytes = 4 * (6 * b * z + 4) + 4 * (4 * b * z)
        flops = 2 * 8 * b * z
    elif name == "snn_fwd":
        nbytes = 4 * b * z + lbl + 4
        flops = pairs * 2 * z
    else:
        nbytes = 4 * b * z + lbl + 4 + 4 * b * z
        flops = pairs * 4 * z
    t = {"bytes": nbytes / PEAK_BYTES_PER_S, "fp32": flops / PEAK_FP32_FLOPS,
         "exp (MUFU)": exp_count(name, label, ps, z) / PEAK_MUFU_PER_S}
    unit = max(t, key=t.get)
    return (t[unit] * 1e3, "bytes" if unit == "bytes" else "operations", unit)


def device_us(fn, n: int = 50):
    """(device us per call, kernels per call) of fn from torch.profiler:
    the summed durations of the kernels (not copies) that n calls launched."""
    from clearvae_torch.bench import profile_window

    fn()
    torch.cuda.synchronize()
    with profile_window() as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    by_name, counts = _device_kernels(prof, counts=True)
    names = [k for k in by_name if not k.startswith(("Memcpy", "Memset"))]
    return (sum(by_name[k] for k in names) / n,
            sum(counts[k] for k in names) / n)


def kernels_per_call(fn, n: int = 10, tries: int = 3) -> float:
    """Kernels a call of fn launches, by the profiler over n calls. Every
    call launches at least one kernel (fn has run and been checked by then,
    and a wrapper raises on a failed launch), so a profile that recorded
    fewer kernels than calls is the profiler's loss, not a count: it is
    taken again, up to ``tries`` times."""
    for _ in range(tries):
        n_k = device_us(fn, n=n)[1]
        if n_k >= 1:
            return n_k
    fail(f"the profiler recorded fewer kernels than calls in {tries} "
         f"profiles of {n} calls")


def gpu_name_and_limit() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_build():
    from clearvae_torch.ops.kernels import _build

    srcs = _build.sources()
    t0 = time.perf_counter()
    _build.build(srcs)
    dt = time.perf_counter() - t0
    print(f"[build] {srcs} built in {dt:.2f} s")
    for name, log in _build.build_log.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}")
    for name in srcs:
        _build.load(name)
    print(f"[build] cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
          f"cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")


def _inputs(b, z, seed, dev):
    g = torch.Generator(device="cpu").manual_seed(seed)
    mats = [torch.randn(b, z, generator=g) * (1.0 if i % 2 == 0 else 0.3)
            for i in range(4)]
    label = torch.randint(0, 10, (b,), generator=g)
    return [m.to(dev) for m in mats], label.to(dev)


def phase_kernels():
    """Each fused-loss kernel against its plain twin on the card; returns
    per-kernel max errors and timings (CUDA-event ms and profiler device us
    per call, keyed by (name, B, z))."""
    from clearvae_torch.ops.kernels import fused_loss as FL

    dev = torch.device("cuda")
    errs = {k: 0.0 for k in REPLACES}
    w = torch.tensor([0.7, 1.3, 0.11, 0.05], device=dev)
    g4 = torch.tensor([0.7, -1.3, 0.11, 2.5], device=dev)  # a non-unit cotangent
    for si, (b, z) in enumerate(SHAPES):
        grid = FL.clear_latent_grid(b, z)
        if ((b, z) == RING_SHAPE) != (grid["tiles"] > 1):
            fail(f"K1 at B={b} z={z} runs {grid['tiles']} column tiles")
        for ps in (True, False):
            (mu_c, lv_c, mu_s, lv_s), lbl = _inputs(b, z, 100 + si, dev)
            tag = f"B={b} z={z} ps={ps}"
            # K1: values and the unit-cotangent SNN gradients
            k1 = lambda: FL.clear_latent_fwdgrad(mu_c, lv_c, mu_s, lv_s,  # noqa: E731
                                                 lbl, 0.1, ps)
            out, dc, ds = k1()
            rout, rdc, rds = FL.clear_latent_plain(mu_c, lv_c, mu_s, lv_s, lbl,
                                                   0.1, ps)
            e = [check_close(f"K1 terms {tag}", out, rout, **VAL_TOL)]
            e += [check_close(f"K1 dsnn {tag}", a, r, **grad_tol(r))
                  for a, r in zip((dc, ds), (rdc, rds))]
            # every sum in a fixed order: a second call is bit-identical
            if not all(torch.equal(a, r) for a, r in zip(k1(), (out, dc, ds))):
                fail(f"K1 {tag}: two calls on the same inputs differ")
            # K1's backward kernel against its twin, with a non-unit cotangent
            bwd = lambda: FL.clear_latent_bwd(mu_c, lv_c, mu_s, lv_s, dc, ds,  # noqa: E731
                                              g4)
            eb1 = [check_close(f"K1 bwd {n} {tag}", a, r, **VAL_TOL)
                   for n, a, r in zip(("dmu_c", "dlv_c", "dmu_s", "dlv_s"), bwd(),
                                      FL.clear_latent_bwd_plain(
                                          mu_c, lv_c, mu_s, lv_s, dc, ds, g4))]
            # one kernel a call, forward and backward
            for name, fn in (("K1", k1), ("K1 bwd", bwd)):
                n_k = kernels_per_call(fn)
                if n_k != 1:
                    fail(f"{name} {tag}: {n_k} kernels a call, not one")
            # K1 through autograd vs autograd of the plain terms
            args = [t.clone().requires_grad_() for t in (mu_c, lv_c, mu_s, lv_s)]
            terms = torch.stack(FL.fused_clear_latent_loss(
                *args, lbl, temperature=0.1, ps=ps))
            gf = torch.autograd.grad((w * terms).sum(), args)
            rargs = [t.clone().requires_grad_() for t in (mu_c, lv_c, mu_s, lv_s)]
            rterms = FL.clear_latent_plain(*rargs, lbl, 0.1, ps)[0]
            gr = torch.autograd.grad((w * rterms).sum(), rargs)
            e += [check_close(f"K1 grad {tag}", a, r, **grad_tol(r))
                  for a, r in zip(gf, gr)]
            errs["clear_latent_fwdgrad"] = max(errs["clear_latent_fwdgrad"], *e)
            errs["clear_latent_bwd"] = max(errs["clear_latent_bwd"], *eb1)
            # K2f and K2b, direct and through the autograd.Function
            k2f = lambda: FL.snn_fwd(mu_s, lbl, 0.1, ps)  # noqa: E731
            loss = k2f()
            ef = check_close(f"K2f {tag}", loss,
                             FL.snn_fwd_plain(mu_s, lbl, 0.1, ps), **VAL_TOL)
            errs["snn_fwd"] = max(errs["snn_fwd"], ef)
            if not torch.equal(k2f(), loss):
                fail(f"K2f {tag}: two calls on the same inputs differ")
            n_k = kernels_per_call(k2f)
            if n_k != 1:
                fail(f"K2f {tag}: {n_k} kernels a call, not one")
            g = torch.tensor(1.7, device=dev)
            rg = FL.snn_bwd_plain(mu_s, lbl, g, 0.1, ps)
            k2b = lambda: FL.snn_bwd(mu_s, lbl, g, 0.1, ps)  # noqa: E731
            dmu = k2b()
            eb = [check_close(f"K2b {tag}", dmu, rg, **grad_tol(rg))]
            if not torch.equal(k2b(), dmu):
                fail(f"K2b {tag}: two calls on the same inputs differ")
            n_k = kernels_per_call(k2b)
            if n_k != 1:
                fail(f"K2b {tag}: {n_k} kernels a call, not one")
            m1 = mu_s.clone().requires_grad_()
            gk = torch.autograd.grad(1.7 * FL.fused_contrastive_loss(
                m1, lv_s, lbl, temperature=0.1, ps=ps), m1)[0]
            m2 = mu_s.clone().requires_grad_()
            gp = torch.autograd.grad(1.7 * FL.snn_fwd_plain(m2, lbl, 0.1, ps),
                                     m2)[0]
            eb.append(check_close(f"K2b autograd {tag}", gk, gp, **grad_tol(gp)))
            errs["snn_bwd"] = max(errs["snn_bwd"], *eb)
            print(f"[kernels] {tag}: K1 {max(e):.2e} (bwd {max(eb1):.2e}; one "
                  f"launch each way, repeat bit-identical; grid {grid})  K2f "
                  f"{ef:.2e}  K2b {max(eb):.2e} (K2f and K2b: one launch, "
                  f"repeat bit-identical) (max abs err)")
    times = {}
    for b, z in TIMED:
        (mu_c, lv_c, mu_s, lv_s), lbl = _inputs(b, z, 7, dev)
        one = torch.ones((), device=dev)
        _, dc, ds = FL.clear_latent_fwdgrad(mu_c, lv_c, mu_s, lv_s, lbl, 0.1, True)
        pairs = {
            "clear_latent_fwdgrad": (
                lambda: FL.clear_latent_fwdgrad(mu_c, lv_c, mu_s, lv_s, lbl, 0.1, True),
                lambda: FL.clear_latent_plain(mu_c, lv_c, mu_s, lv_s, lbl, 0.1, True)),
            "clear_latent_bwd": (
                lambda: FL.clear_latent_bwd(mu_c, lv_c, mu_s, lv_s, dc, ds, g4),
                lambda: FL.clear_latent_bwd_plain(mu_c, lv_c, mu_s, lv_s, dc, ds, g4)),
            "snn_fwd": (lambda: FL.snn_fwd(mu_s, lbl, 0.1, True),
                        lambda: FL.snn_fwd_plain(mu_s, lbl, 0.1, True)),
            "snn_bwd": (lambda: FL.snn_bwd(mu_s, lbl, one, 0.1, True),
                        lambda: FL.snn_bwd_plain(mu_s, lbl, one, 0.1, True)),
        }
        for name, (kern, plain) in pairs.items():
            # turns: plain, kernel, kernel, plain
            p1, k1, k2, p2 = (cuda_ms(plain), cuda_ms(kern), cuda_ms(kern),
                              cuda_ms(plain))
            dus, n_k = device_us(kern)
            bms, by, unit = bound(name, b, z, lbl, True)
            times[(name, b, z)] = dict(ms=min(k1, k2), plain_ms=min(p1, p2),
                                    bound_ms=bms, bound_by=by, bound_unit=unit,
                                    device_us=dus)
            print(f"[kernels] {name} B={b} z={z}: kernel {k1:.4f}/{k2:.4f} ms "
                  f"(events), device {dus:.2f} us/call ({n_k:g} kernels a "
                  f"call), plain {p1:.4f}/{p2:.4f} ms, bound {bms:.6f} ms "
                  f"({by}: {unit})")
    return errs, times


def k3_bound(codes: np.ndarray, h: int):
    """(bound_ms, bound_by) of one K3 call: each pixel read and written once
    (plus the codes and the zoom matrix) over HBM bandwidth, against the fp32
    operations each sample's code needs: for scale, 2·2·2 a pixel (two
    passes through the zoom matrix, whose rows hold at most two nonzeros,
    a multiply and an add each), a handful for the elementwise styles."""
    per_pixel = {0: 0, 1: 1, 2: 5, 3: 1, 4: 3, 5: 8, 6: 8}
    b = len(codes)
    nbytes = 4 * (2 * b * h * h + b + h * h)
    flops = sum(per_pixel[int(c)] for c in codes) * h * h
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / PEAK_FP32_FLOPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def phase_style_kernel():
    """K3 against style_plain on the card at every code and severity;
    returns its max error and timings."""
    from clearvae_torch.data.mnist import synthetic_mnist
    from clearvae_torch.ops.kernels import style as K3

    dev = torch.device("cuda")
    digits, _ = synthetic_mnist(max(K3_SHAPES), seed=11)
    noise = np.random.RandomState(12).rand(*digits.shape).astype(np.float32)
    imgs = np.where(np.arange(len(digits))[:, None, None] % 3 == 0,
                    noise * 255, digits)
    err = 0.0
    for b in K3_SHAPES:
        x = torch.as_tensor(imgs[:b], device=dev)
        code = torch.as_tensor(np.random.RandomState(b).permutation(b) % 7,
                               dtype=torch.int32, device=dev)
        for sev in range(1, 6):
            e = check_close(f"K3 B={b} severity={sev}",
                            K3.style_batch_kernel(x, code, sev),
                            K3.style_plain(x, code, sev), rtol=0.0,
                            atol=K3_ATOL)
            err = max(err, e)
        print(f"[kernels] K3 B={b}: 7 codes x severities 1-5, max abs err "
              f"{err:.2e} (0..255 scale)")
        # rows of negative code are not K3's: left as ``out`` holds them
        neg = torch.where(torch.arange(b, device=dev) % 3 == 1, -1, code)
        prior = torch.rand(x.shape, generator=torch.Generator(device=dev)
                           .manual_seed(b), device=dev)
        mine = neg >= 0
        for sev in range(1, 6):
            out = prior.clone()
            if K3.style_batch_kernel(x, neg.to(torch.int32), sev,
                                     out=out) is not out:
                fail(f"K3 B={b}: out= was not written in place")
            if not torch.equal(out[~mine], prior[~mine]):
                fail(f"K3 B={b} severity={sev}: a row of negative code changed")
            err = max(err, check_close(
                f"K3 out= B={b} severity={sev}", out[mine],
                K3.style_plain(x, code, sev)[mine], rtol=0.0, atol=K3_ATOL))
        print(f"[kernels] K3 B={b}: negative-code rows untouched in out= at "
              f"severities 1-5; the others within {err:.2e}")
    times = {}
    for b in K3_TIMED:
        x = torch.as_tensor(imgs[:b], device=dev)
        codes = np.resize(np.asarray(K3_PATH_CODES, np.int32), b)
        code = torch.as_tensor(codes, device=dev)
        kern = lambda: K3.style_batch_kernel(x, code, 5)  # noqa: E731
        plain = lambda: K3.style_plain(x, code, 5)        # noqa: E731
        p1, k1, k2, p2 = (cuda_ms(plain), cuda_ms(kern), cuda_ms(kern),
                          cuda_ms(plain))
        bms, by = k3_bound(codes, x.shape[1])
        dus, n_k = device_us(kern)
        times[b] = dict(ms=min(k1, k2), plain_ms=min(p1, p2), bound_ms=bms,
                        bound_by=by, bound_unit=by if by == "bytes" else "fp32",
                        device_us=dus)
        print(f"[kernels] style_batch B={b} (codes {K3_PATH_CODES}, severity "
              f"5): kernel {k1:.4f}/{k2:.4f} ms (events), device {dus:.2f} "
              f"us/call ({n_k:g} kernels a call), plain {p1:.4f}/{p2:.4f} ms, "
              f"bound {bms:.6f} ms ({by})")
    return err, times


def k3_launches_expected(styles, batches) -> int:
    """K3 calls that styling ``batches`` (index arrays of a dataset) makes:
    one for each batch and severity group, over the whole batch, whether or
    not the batch holds a sample of the group's styles."""
    from clearvae_torch.ops.corruptions import k3_groups

    return sum(len(idx) > 0 for idx in batches) * len(k3_groups(styles))


def chunk_batches(n: int, chunk: int):
    """The rows of ``StyledDataset.chunked_apply``'s chunks, -1 for padding."""
    return [np.pad(np.arange(s, min(s + chunk, n)),
                   (0, chunk - (min(s + chunk, n) - s)), constant_values=-1)
            for s in range(0, n, chunk)]


def _step_check(dev, tag, build, x_shape, n_class: int, beta: float,
                lr: float):
    """One CLEAR step of the VAE ``build()`` makes (seeded), fused against
    unfused, from the same weights and draws on the card: metrics within
    rtol 1e-4, atol 1e-5 and the parameters within max(1e-3·max|w|,
    1.2e-3), phase 5's bars (Adam turns float noise in the zero gradients
    of the biases ahead of BatchNorm into ±lr moves)."""
    import copy

    from clearvae_torch.config import AnnealConfig, ContrastiveConfig
    from clearvae_torch.train.steps import make_clear_vae_step

    torch.manual_seed(0)
    base = build().to(dev)
    g = torch.Generator(device="cpu").manual_seed(1)
    b = x_shape[0]
    x = torch.rand(x_shape, generator=g).to(dev)
    lbl = torch.randint(0, n_class, (b,), generator=g).to(dev)
    eps = torch.randn(2, b, base.z_dim, generator=g).to(dev)
    out = {}
    for fused in (True, False):
        model = copy.deepcopy(base)
        opt = torch.optim.Adam(model.parameters(), lr=lr)
        step = make_clear_vae_step(model, opt, AnnealConfig(beta=beta),
                                   ContrastiveConfig(alpha=100.0, fused=fused))
        m = step(x, lbl, eps.unbind(0))
        out[fused] = ({k: float(v) for k, v in m.items()}, model.state_dict())
    (mf, sf), (mu, su) = out[True], out[False]
    for k, v in mu.items():
        if not math.isclose(mf[k], v, rel_tol=1e-4, abs_tol=1e-5):
            fail(f"{tag} step fused vs unfused on the card: {k} {mf[k]} vs {v}")
    worst = 0.0
    for k, v in su.items():
        err = float((sf[k].double() - v.double()).abs().max())
        worst = max(worst, err)
        if err > max(1e-3 * float(v.abs().max()), 1.2e-3):
            fail(f"{tag} step fused vs unfused: {k} off by {err:.3e}")
    print(f"{tag} one step (B={b}, z={2 * base.z_dim}) fused == unfused on "
          f"the card; params max |diff| {worst:.2e}: {mf}")

def phase_main(gpu):
    from clearvae_torch.data.mnist import synthetic_mnist
    from clearvae_torch.data.styled import make_styled_mnist, train_valid_split
    from clearvae_torch.models.vae import VAE
    from clearvae_torch.ops.kernels import fused_loss as FL
    from clearvae_torch.ops.kernels import style as K3
    from clearvae_torch.train.factories import get_clearvae_trainer

    dev = torch.device("cuda")
    _step_check(dev, "[main]", lambda: VAE(total_z_dim=16), (32, 28, 28, 1),
                10, 1 / 8, 5e-4)
    t0 = time.perf_counter()
    imgs, labels = synthetic_mnist(9600, seed=0)
    train_ds, valid_ds = train_valid_split(make_styled_mnist(imgs, labels, seed=0))
    K3.reset_launches()
    train_ds.materialize(dev)
    valid_ds.materialize(dev)
    torch.cuda.synchronize()
    k3_materialize = K3.LAUNCHES["style"]
    want = sum(k3_launches_expected(d.styles, chunk_batches(len(d), 512))
               for d in (train_ds, valid_ds))
    if k3_materialize != want:
        fail(f"K3 launched {k3_materialize} times in materialize; its "
             f"chunks and severity groups make {want}")
    print(f"[main] data: {len(train_ds)} train / {len(valid_ds)} held-out "
          f"images, six styles, made and styled in "
          f"{time.perf_counter() - t0:.2f} s; K3 launches in materialize: "
          f"{k3_materialize} (expected {want})")
    trainer = get_clearvae_trainer(beta=1 / 8, ps=True, vae_lr=5e-4, z_dim=16,
                                   alpha=100, temperature=0.1, seed=0,
                                   verbose_period=1,
                                   hyperparameter={"fused": True},
                                   device="cuda")
    bs = 128
    steps_per_epoch = len(train_ds) // bs
    FL.reset_launches()
    rates = []
    for epoch in range(2):
        t0 = time.perf_counter()
        trainer.fit(1, train_ds, batch_size=bs, start_epoch=epoch)
        torch.cuda.synchronize()
        rates.append(steps_per_epoch * bs / (time.perf_counter() - t0))
    t0 = time.perf_counter()
    mig, mse = trainer.evaluate(valid_ds, batch_size=bs)
    eval_s = time.perf_counter() - t0
    launches = dict(FL.LAUNCHES)
    hist = {k: np.concatenate([h[k] for h in trainer.history])
            for k in trainer.history[0]}
    n_steps = len(hist["loss"])
    for k, v in hist.items():
        if not np.isfinite(v).all():
            fail(f"non-finite training metric {k}")
    if not (math.isfinite(mig) and math.isfinite(mse)):
        fail(f"non-finite evaluation: mig={mig} mse={mse}")
    n_eval_batches = -(-len(valid_ds) // bs)
    if not launches["clear_latent_fwdgrad"] == launches["clear_latent_bwd"] \
            == n_steps:
        fail(f"K1 launched {launches['clear_latent_fwdgrad']} times forward "
             f"and {launches['clear_latent_bwd']} backward in {n_steps} train "
             f"steps")
    if launches["snn_fwd"] != 2 * n_eval_batches:
        fail(f"K2f launched {launches['snn_fwd']} times for "
             f"{n_eval_batches} eval batches")
    print(f"[main] {n_steps} train steps; loss {hist['loss'][0]:.3f} -> "
          f"{hist['loss'][-1]:.3f}; eval MIG {mig:.4f}, MSE {mse:.3f} "
          f"({eval_s:.2f} s)")
    print(f"[main] images/sec: epoch 1 {rates[0]:.1f} (with warm-up), "
          f"epoch 2 {rates[1]:.1f}; {gpu}")
    print(f"[main] launches: {launches}")
    _profile_steps(trainer, train_ds, bs, "[profile] CLEAR fused")
    return {**launches, "style_batch": k3_materialize}, (train_ds, valid_ds)


def _profile_steps(trainer, train_ds, bs, tag, n: int = 20):
    """Where a train step's time goes, after its path's launch counts are
    read: wall ms per step over n steps without the profiler, device-busy
    ms per step from torch.profiler over n more, the idle share of the
    unprofiled wall, kernels per step, the fused-loss kernels' (K1 forward
    and backward, K2f and K2b, all named clear_latent_*) device ms and
    share, and the top kernels."""
    from clearvae_torch.bench import profile_window

    data, labels = trainer._device_data(train_ds)
    idx = torch.arange(bs, device=data.device)
    x, lbl = data[idx], labels[idx]

    def steps():
        t0 = time.perf_counter()
        for _ in range(n):
            trainer.train_step(x, lbl, trainer._train_noise(bs))
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / n

    steps()  # warm-up
    wall_ms = steps()
    with profile_window() as prof:
        prof_wall_ms = steps()
    by_name, n_kernels = _device_kernels(prof)
    if not by_name:
        fail("the profiler recorded no device activity")
    busy_ms = sum(by_name.values()) / 1e3 / n
    fused = sum(v for k, v in by_name.items()
                if "clear_latent_" in k) / 1e3 / n
    print(f"{tag} train step (B={bs}): wall {wall_ms:.3f} ms "
          f"({prof_wall_ms:.3f} ms under the profiler), device busy "
          f"{busy_ms:.3f} ms, idle share {1 - busy_ms / wall_ms:.3f}, "
          f"{n_kernels / n:.0f} kernels/step, fused-loss kernels "
          f"{fused:.4f} ms/step ({fused / busy_ms:.4f} of the device time)")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:6]:
        print(f"{tag}   {us / 1e3 / n:.4f} ms/step  {name[:90]}")


def _adversarial_step_check(dev, b: int = 128):
    """One CLEAR-TC and one CLEAR-MIM (CLUB-S) step, fused against unfused,
    from the same weights and draws on the card: metrics within the fused
    CLEAR step's bar (rtol 1e-4, atol 1e-5); the VAE's parameters within
    the bar of the CPU step tests (max(1e-3·max|w|, 1.2e-3): Adam moves the
    biases ahead of BatchNorm on float noise); the second player's within
    rtol 1e-4, atol 1e-5."""
    import copy

    from clearvae_torch.config import (AnnealConfig, ContrastiveConfig,
                                       MIMConfig, TCConfig)
    from clearvae_torch.models.factor import FactorCls
    from clearvae_torch.models.mi_estimators import CLUBSample
    from clearvae_torch.models.vae import VAE
    from clearvae_torch.train import steps as S

    torch.manual_seed(0)
    vae = VAE(total_z_dim=16).to(dev)
    players = {"tc": FactorCls(16).to(dev), "mim": CLUBSample(8, 8, 16).to(dev)}
    g = torch.Generator(device="cpu").manual_seed(1)
    x = torch.rand(b, 28, 28, 1, generator=g).to(dev)
    lbl = torch.randint(0, 10, (b,), generator=g).to(dev)
    eps = [torch.randn(2, b, 8, generator=g).to(dev).unbind(0)
           for _ in range(2)]
    noise = {"tc": eps,
             "mim": {"eps": eps[0], "perm": torch.randperm(b, generator=g).to(dev),
                     "inner": torch.randn(5, b, 16, generator=g).to(dev)}}
    for kind, player in players.items():
        out = {}
        for fused in (True, False):
            model, second = copy.deepcopy(vae), copy.deepcopy(player)
            args = (model, second, torch.optim.Adam(model.parameters(), lr=5e-4),
                    torch.optim.Adam(second.parameters(),
                                     lr=1e-4 if kind == "tc" else 2e-3),
                    AnnealConfig(beta=1 / 8),
                    ContrastiveConfig(alpha=100.0, fused=fused))
            step = (S.make_clear_tc_step(*args, TCConfig(la=1.0)) if kind == "tc"
                    else S.make_clear_mim_step(*args, MIMConfig(la=3.0)))
            m = step(x, lbl, noise[kind])
            out[fused] = ({k: float(v) for k, v in m.items()},
                          model.state_dict(), second.state_dict())
        (mf, vf, pf), (mu, vu, pu) = out[True], out[False]
        for k, v in mu.items():
            if not math.isclose(mf[k], v, rel_tol=1e-4, abs_tol=1e-5):
                fail(f"{kind} step fused vs unfused on the card: {k} "
                     f"{mf[k]} vs {v}")
        worst = 0.0
        for k, v in vu.items():
            err = float((vf[k] - v).abs().max())
            worst = max(worst, err)
            if err > max(1e-3 * float(v.abs().max()), 1.2e-3):
                fail(f"{kind} step fused vs unfused: VAE {k} off by {err:.3e}")
        for k, v in pu.items():
            check_close(f"{kind} step fused vs unfused: {k}", pf[k], v,
                        rtol=1e-4, atol=1e-5)
        print(f"[adversarial] one {kind} step fused == unfused on the card "
              f"(B={b}); VAE params max |diff| {worst:.2e}: {mf}")


def phase_adversarial(gpu, train_ds, valid_ds):
    """CLEAR-TC and CLEAR-MIM through their factories with the fused c_loss
    (see the module docstring); returns {kernel: launches} summed over the
    two runs, each run's counters zeroed just before it and read after."""
    from clearvae_torch.ops.kernels import fused_loss as FL
    from clearvae_torch.ops.kernels import style as K3
    from clearvae_torch.train.factories import (get_clearmimvae_trainer,
                                                get_cleartcvae_trainer)

    _adversarial_step_check(torch.device(ADV_COMMON["device"]))
    runs = {"clear-tc": (get_cleartcvae_trainer,
                         dict(la=1, factor_cls_lr=1e-4)),
            "clear-mim (CLUB-S)": (get_clearmimvae_trainer,
                                   dict(mi_estimator="CLUBSample", la=3,
                                        mi_estimator_lr=2e-3))}
    bs = 128
    total = {k: 0 for k in (*REPLACES, "style_batch")}
    for name, (factory, kw) in runs.items():
        trainer = factory(**ADV_COMMON, **kw)
        FL.reset_launches()
        K3.reset_launches()
        t0 = time.perf_counter()
        result = trainer.fit(2, train_ds, batch_size=bs)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        mig, mse = trainer.evaluate(valid_ds, batch_size=bs)
        eval_s = time.perf_counter() - t0
        launches = {**FL.LAUNCHES, "style_batch": K3.LAUNCHES["style"]}
        hist = {k: np.concatenate([h[k] for h in trainer.history])
                for k in trainer.history[0]}
        n_steps = len(hist["loss"])
        if n_steps != ADV_STEPS:
            fail(f"{name}: {n_steps} train steps, expected {ADV_STEPS}")
        for k, v in hist.items():
            if not np.isfinite(v).all():
                fail(f"{name}: non-finite training metric {k}")
        losses = result if name == "clear-tc" else result[0] + result[1]
        if len(losses) != n_steps * (1 if name == "clear-tc" else 2) or \
                not np.isfinite(losses).all():
            fail(f"{name}: fit returned {len(losses)} losses or non-finite ones")
        if not (math.isfinite(mig) and math.isfinite(mse)):
            fail(f"{name}: non-finite evaluation: mig={mig} mse={mse}")
        if launches["snn_fwd"] != n_steps or launches["snn_bwd"] != n_steps:
            fail(f"{name}: K2f/K2b launched {launches['snn_fwd']}/"
                 f"{launches['snn_bwd']} times in {n_steps} fused train steps")
        if launches["clear_latent_fwdgrad"] or launches["clear_latent_bwd"] \
                or launches["style_batch"]:
            fail(f"{name}: K1 or K3 launched on the adversarial path: {launches}")
        print(f"[adversarial] {name}: {n_steps} train steps in {fit_s:.2f} s "
              f"({n_steps * bs / fit_s:.1f} images/sec, warm-up included); "
              f"loss {hist['loss'][0]:.3f} -> {hist['loss'][-1]:.3f}; "
              f"eval MIG {mig:.4f}, MSE {mse:.3f} ({eval_s:.2f} s); "
              f"launches {launches}; {gpu}")
        for k in total:
            total[k] += launches[k]
        _profile_steps(trainer, train_ds, bs, f"[profile] {name}")
    return total


def _graph_runs():
    from clearvae_torch.train.factories import (get_clearmimvae_trainer,
                                                get_cleartcvae_trainer,
                                                get_clearvae_trainer)

    return {"clear": (get_clearvae_trainer, dict(ps=True)),
            "clear-tc": (get_cleartcvae_trainer,
                         dict(la=1, factor_cls_lr=1e-4)),
            "clear-mim (CLUB-S)": (get_clearmimvae_trainer,
                                   dict(mi_estimator="CLUBSample", la=3,
                                        mi_estimator_lr=2e-3))}


def _graph_more_runs():
    """Every other train step that ``fit(use_scan=True)`` captures, each
    (factory, kwargs, fit kwargs): CLEAR and CLEAR-TC unfused, GVAE and
    ML-VAE, the CNN, CLEAR-MIM with each other MI estimator, and the fused
    CLEAR trainer styling on the card (K3, zigzag and canny inside the
    graph)."""
    from clearvae_torch.train.factories import (get_clearmimvae_trainer,
                                                get_cleartcvae_trainer,
                                                get_clearvae_trainer,
                                                get_cnn_trainer,
                                                get_hierarchical_vae_trainer)

    unfused = {**ADV_COMMON, "hyperparameter": {"fused": False}}
    hier = {k: ADV_COMMON[k] for k in ("beta", "vae_lr", "z_dim", "seed",
                                        "verbose_period", "device")}
    runs = {
        "clear unfused": (get_clearvae_trainer, {**unfused, "ps": True}, {}),
        "clear-tc unfused": (get_cleartcvae_trainer,
                             {**unfused, "la": 1, "factor_cls_lr": 1e-4}, {}),
        "gvae": (get_hierarchical_vae_trainer,
                 {**hier, "group_mode": "GVAE"}, {}),
        "mlvae": (get_hierarchical_vae_trainer,
                  {**hier, "group_mode": "MLVAE"}, {}),
        "cnn": (get_cnn_trainer, dict(n_class=10, seed=0, verbose_period=1,
                                      device="cuda"), {}),
    }
    for est in ("CLUB", "CLUBMean", "L1OutUB", "VarUB", "InfoNCE"):
        runs[f"clear-mim ({est})"] = (
            get_clearmimvae_trainer,
            {**ADV_COMMON, "mi_estimator": est, "la": 3,
             "mi_estimator_lr": 2e-3}, {})
    runs["clear styled on the card"] = (
        get_clearvae_trainer, {**ADV_COMMON, "ps": True},
        {"style_on_device": True})
    return runs


def _graph_fit(factory, kw, train_ds, epochs, **fit_kw):
    """(trainer, {kernel: launches}) of one fit, the counters zeroed just
    before it and read just after."""
    from clearvae_torch.ops.kernels import fused_loss as FL
    from clearvae_torch.ops.kernels import style as K3

    trainer = factory(**kw)
    FL.reset_launches()
    K3.reset_launches()
    trainer.fit(epochs, train_ds, batch_size=128, **fit_kw)
    torch.cuda.synchronize()
    return trainer, {**FL.LAUNCHES, "style_batch": K3.LAUNCHES["style"]}


def _same_training(tag, a, b, a_epochs=None, histories=True):
    """Fails unless trainer b's loss histories (with ``histories``) and
    final state equal a's (every module's state, max abs difference 0.0);
    returns that difference. ``a_epochs`` picks the epochs of a's history
    that b ran."""
    hist_a = a.history if a_epochs is None else a.history[a_epochs]
    if histories and len(hist_a) != len(b.history):
        fail(f"{tag}: {len(hist_a)} against {len(b.history)} epochs")
    worst = 0.0
    for ha, hb in zip(hist_a, b.history if histories else []):
        for k, v in ha.items():
            worst = max(worst, float(np.abs(hb[k] - v).max()))
    for m in a.MODULES:
        sa, sb = getattr(a, m).state_dict(), getattr(b, m).state_dict()
        for k, v in sa.items():
            worst = max(worst, float((sb[k].double() - v.double()).abs().max()))
    if worst != 0.0:
        fail(f"{tag}: histories or final state differ by up to {worst:.3e}")
    return worst


def _serve_check(trainer, ckpt_dir, x):
    """InferenceSession from the checkpoint on the card: shapes, finite
    outputs, and equal to the session taken from the live trainer that
    saved it (atol 1e-6)."""
    from clearvae_torch.models.vae import VAE
    from clearvae_torch.serve import InferenceSession

    sess = InferenceSession.from_checkpoint(VAE(total_z_dim=16), ckpt_dir)
    live = InferenceSession.from_trainer(trainer)
    if sess.device.type != "cuda":
        fail(f"the inference session runs on {sess.device}, not the card")
    b = len(x)
    shapes = {"encode": [tuple(h.shape) for h in sess.encode(x)],
              "reconstruct": tuple(sess.reconstruct(x).shape),
              "sampled": tuple(sess.reconstruct(x, sample=True, seed=1).shape),
              "swap": tuple(sess.swap(x[: b // 2], x[b // 2:]).shape),
              "interpolate": [tuple(sess.interpolate(x[0], x[1], 7, w).shape)
                              for w in ("style", "content")]}
    want = {"encode": [(b, 8)] * 4, "reconstruct": (b, 28, 28, 1),
            "sampled": (b, 28, 28, 1), "swap": (b // 2, 28, 28, 1),
            "interpolate": [(7, 28, 28, 1)] * 2}
    if shapes != want:
        fail(f"inference session shapes {shapes}, expected {want}")
    err = check_close("session from the checkpoint vs from the trainer",
                      sess.reconstruct(x), live.reconstruct(x), rtol=0.0,
                      atol=1e-6)
    print(f"[graph] InferenceSession.from_checkpoint on the card: shapes "
          f"{shapes}; reconstruct equals from_trainer's within {err:.2e}")


def _time_steps(trainer, train_ds, tag, gpu, n: int = 20):
    """Eager and graphed steps of one trainer on the same batches, in turns
    (eager, graphed, graphed, eager), through ``bench.time_steps``, the
    port's one step timer: wall ms a step, device-busy ms a step, idle
    share, kernels a step, images/sec, and the kernels by name in the
    profiled run of each mode (a Chrome trace of each under
    .runs/chip_smoke_graph/)."""
    from clearvae_torch.bench import time_steps

    traces = os.path.join(os.path.dirname(os.path.abspath(__file__)), ".runs",
                          "chip_smoke_graph", f"trace_{tag.split()[0]}")
    stats = time_steps(trainer, train_ds, n=n, trace_dir=traces)
    for mode, r in stats.items():
        if not r["kernels_by_name"]:
            fail(f"{tag} {mode}: the profiler recorded no kernel")
        print(f"[graph] {tag} {mode} step (B=128, {n} steps a turn): wall "
              f"{'/'.join(f'{w:.3f}' for w in r['walls_ms'])} ms, device busy "
              f"{r['device_busy_ms']:.3f} ms, idle share "
              f"{'/'.join(f'{s:.3f}' for s in r['idle_share'])}, "
              f"{r['kernels_per_step']:.1f} kernels/step, images/sec "
              f"{'/'.join(f'{i:.1f}' for i in r['images_per_sec'])}; {gpu}")
    return stats


def phase_graph(gpu, train_ds, valid_ds, here):
    """The graphed train step (``fit(use_scan=True)``, one captured CUDA
    graph a step) against the eager one, for the fused CLEAR, CLEAR-TC and
    CLEAR-MIM (CLUB-S) trainers on phase 3's data (see the module
    docstring), then every other captured step the same way
    (``_graph_more_runs``); returns {kernel: launches} summed over every
    graphed fit, each fit's counters zeroed just before it and read
    after."""
    import shutil

    dev = torch.device("cuda")
    total = {k: 0 for k in (*REPLACES, "style_batch")}
    root = os.path.join(here, ".runs", "chip_smoke_graph")
    shutil.rmtree(root, ignore_errors=True)
    det = torch.backends.cudnn.deterministic
    trainers = {}
    for name, (factory, kw) in _graph_runs().items():
        torch.backends.cudnn.deterministic = True
        try:
            eager, le = _graph_fit(factory, {**ADV_COMMON, **kw}, train_ds, 2,
                                   use_scan=False)
            graphed, lg = _graph_fit(factory, {**ADV_COMMON, **kw}, train_ds, 2,
                                     use_scan=True)
            n_e, n_g = eager.train_step.step, graphed.train_step.step
            if not n_e == n_g == ADV_STEPS:
                fail(f"{name}: {n_e} eager and {n_g} graphed updates, "
                     f"expected {ADV_STEPS}")
            diff = _same_training(f"{name} graphed vs eager", eager, graphed)
            want = ({"clear_latent_fwdgrad": n_g, "clear_latent_bwd": n_g,
                     "snn_fwd": 0, "snn_bwd": 0} if name == "clear" else
                    {"clear_latent_fwdgrad": 0, "clear_latent_bwd": 0,
                     "snn_fwd": n_g, "snn_bwd": n_g})
            want["style_batch"] = 0
            if lg != want or le != want:
                fail(f"{name}: launches eager {le}, graphed (replays) {lg}; "
                     f"expected {want}")
            for k in total:
                total[k] += lg[k]
            print(f"[graph] {name}: {n_g} graphed updates == {n_e} eager; "
                  f"histories and final state equal, max abs diff {diff:.3e} "
                  f"(cudnn.deterministic); launches by replay {lg}")
            # checkpoint after epoch 0 -> a fresh trainer restores and runs
            # epoch 1 graphed: the uninterrupted graphed fit's epoch 1
            ck = os.path.join(root, name.split()[0])
            first, _ = _graph_fit(factory, {**ADV_COMMON, **kw}, train_ds, 1,
                                  use_scan=True,
                                  checkpoint_dir=ck)
            resumed = factory(**ADV_COMMON, **kw)
            resumed.restore_checkpoint(ck)
            resumed.fit(1, train_ds, batch_size=128, use_scan=True,
                        start_epoch=1)
            torch.cuda.synchronize()
            rdiff = _same_training(f"{name} resumed vs uninterrupted", graphed,
                                   resumed, a_epochs=slice(1, 2))
            print(f"[graph] {name}: checkpoint -> restore -> fit(start_epoch=1)"
                  f" graphed equals the uninterrupted graphed fit, max abs diff "
                  f"{rdiff:.3e}")
            if name == "clear":
                x = valid_ds.materialize(dev)[:64, ..., None]
                _serve_check(first, ck, x)
        finally:
            torch.backends.cudnn.deterministic = det
        trainers[name] = factory(**ADV_COMMON, **kw)
        if name == "clear":
            clear_graphed = graphed
    more = {}
    for name, (factory, kw, fit_kw) in _graph_more_runs().items():
        torch.backends.cudnn.deterministic = True
        try:
            eager, le = _graph_fit(factory, kw, train_ds, 2, use_scan=False,
                                   **fit_kw)
            graphed, lg = _graph_fit(factory, kw, train_ds, 2, use_scan=True,
                                     **fit_kw)
        finally:
            torch.backends.cudnn.deterministic = det
        n_e, n_g = eager.train_step.step, graphed.train_step.step
        if not n_e == n_g == ADV_STEPS:
            fail(f"{name}: {n_e} eager and {n_g} graphed updates, expected "
                 f"{ADV_STEPS}")
        diff = _same_training(f"{name} graphed vs eager", eager, graphed)
        fused = kw.get("hyperparameter", {}).get("fused", False)
        kind = name.split()[0]
        k1 = n_g if fused and kind == "clear" else 0
        k2 = n_g if fused and kind != "clear" else 0
        want = {"clear_latent_fwdgrad": k1, "clear_latent_bwd": k1,
                "snn_fwd": k2, "snn_bwd": k2}
        styled = fit_kw.get("style_on_device", False)
        want["style_batch"] = n_g if styled else 0   # one severity group
        if lg != le or {k: lg[k] for k in want} != want:
            fail(f"{name}: launches eager {le}, graphed (replays) {lg}; "
                 f"expected {want}")
        for k in total:
            total[k] += lg[k]
        print(f"[graph] {name}: {n_g} graphed updates == {n_e} eager; "
              f"histories and final state equal, max abs diff {diff:.3e} "
              f"(cudnn.deterministic); launches {lg}")
        if styled:
            _styled_replays(graphed, train_ds, gpu)
        more[name] = graphed
    torch.backends.cudnn.deterministic = True
    try:
        _eval_pairs(clear_graphed, more["clear styled on the card"],
                    more["gvae"], valid_ds)
        _epochs_per_scan_fit(clear_graphed, train_ds)
    finally:
        torch.backends.cudnn.deterministic = det
    per_step = {"clear": {"clear_latent_fwdgrad_kernel": 1,
                          "clear_latent_bwd_kernel": 1}}
    for name in ("clear-tc", "clear-mim (CLUB-S)"):   # K2f and K2b
        per_step[name] = {"clear_latent_fwdgrad_kernel": 2}
    for name, trainer in trainers.items():
        stats = _time_steps(trainer, train_ds, name, gpu)
        seen = {}
        for k, v in stats["graphed"]["kernels_by_name"].items():
            for kname in per_step["clear"]:
                if kname in k:
                    seen[kname] = seen.get(kname, 0) + v
        want = {k: 20 * v for k, v in per_step[name].items()}
        if seen != want:
            fail(f"{name}: the device trace of 20 replays holds {seen} "
                 f"fused-loss kernels, expected {want}")
        print(f"[graph] {name}: device trace of 20 replays: {seen} (expected "
              f"{want})")
    return total


def _epoch_rows(n: int, seed: int, bs: int = 128):
    perm = np.random.RandomState(seed).permutation(n)
    nb = n // bs
    return torch.as_tensor(perm[: nb * bs].reshape(nb, bs), device="cuda")


def _styled_replays(trainer, train_ds, gpu, n: int = 20):
    """The styled graphed step (K3, zigzag and canny inside the graph) of a
    trainer that has fit: one epoch of its replays under
    ``set_sync_debug_mode("error")`` (a synchronizing call between the
    first and the last replay raises), K3's launches by replay (one a
    step), then K3 by name in the device trace of n replays, and their
    wall, device time and kernels a step."""
    from torch.autograd import DeviceType

    from clearvae_torch.bench import profile_window
    from clearvae_torch.ops.kernels import style as K3

    ep = trainer._graphs[(id(train_ds), 128, True)][1]
    if ep.graph is None:
        fail("the styled fit captured no graph")
    rows = _epoch_rows(len(train_ds), 99)
    torch.cuda.synchronize()
    K3.reset_launches()
    torch.cuda.set_sync_debug_mode("error")
    try:
        ep.run(rows)
    except RuntimeError as exc:
        fail(f"a synchronizing call inside the styled replay loop: {exc}")
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    if K3.LAUNCHES["style"] != len(rows):
        fail(f"K3 launched {K3.LAUNCHES['style']} times by replay in "
             f"{len(rows)} styled replays")
    sub = rows[:n]
    ep.run(sub)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ep.run(sub)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / n
    # one replay more than inspected: the first opens the trace and counts
    # for neither K1 nor K3. Each replay styles (K3) before its K1 forward
    # kernel, so each of the n inspected replays holds exactly one K3
    # between its K1 forward kernel and the one before it
    with profile_window() as prof:
        ep.run(rows[:n + 1])
        torch.cuda.synchronize()
    dev_events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    k1_at = sorted(e.time_range.start for e in dev_events
                   if "clear_latent_fwdgrad_kernel" in e.name)
    k3_at = [e.time_range.start for e in dev_events if "style_kernel" in e.name]
    if len(k1_at) != n + 1:
        fail(f"the device trace of {n + 1} styled replays holds {len(k1_at)} "
             f"K1 forward kernels")
    per_replay = np.bincount(np.searchsorted(k1_at, k3_at),
                             minlength=n + 2)[1:]
    if list(per_replay) != [1] * n + [0]:
        fail(f"the device trace of {n} inspected styled replays holds K3 "
             f"kernels {per_replay[:n].tolist()} a replay and "
             f"{per_replay[n]} after the last K1")
    k3 = int(per_replay.sum())
    with profile_window() as prof:
        ep.run(sub)
        torch.cuda.synchronize()
    by_name, counts = _device_kernels(prof, counts=True)
    busy = sum(by_name.values()) / 1e3 / n
    style_ms = sum(v for k, v in by_name.items() if "style_kernel" in k) / 1e3 / n
    print(f"[graph] styled fit: {len(rows)} replays with no synchronizing call "
          f"(sync debug mode 'error'); K3 {len(rows)} by replay; device trace "
          f"of {n} inspected replays: {k3} style_kernel, one in each; styled "
          f"graphed step (fused, "
          f"B=128): wall {wall:.3f} ms, device busy {busy:.4f} ms, idle share "
          f"{1 - busy / wall:.3f}, {sum(counts.values()) / n:.1f} kernels/step, "
          f"K3 {style_ms:.4f} ms/step; {gpu}")


def _eval_pairs(clear, styled, gvae, valid_ds):
    """``evaluate`` graphed (the default) against eager (``use_scan=False``)
    from the same eval noise, each with the ragged tail of the held-out
    split: MIG, MSE and every per-batch mean equal; the fused CLEAR eval's
    K2f = 2 a batch and the styled eval's K3 = 1 a batch, by replay."""
    from clearvae_torch.ops.kernels import fused_loss as FL
    from clearvae_torch.ops.kernels import style as K3

    n_batches = -(-len(valid_ds) // 128)
    if len(valid_ds) % 128 == 0:
        fail("the held-out split has no ragged tail")
    for tag, trainer, kw, want in (
            ("clear", clear, {}, {"snn_fwd": 2 * n_batches, "style": 0}),
            ("clear styled", styled, {"style_on_device": True},
             {"snn_fwd": 2 * n_batches, "style": n_batches}),
            ("gvae with_evidence_acc", gvae, {"with_evidence_acc": True},
             {"snn_fwd": 0, "style": 0})):
        res = {}
        for use_scan in (True, False):
            trainer.generator.manual_seed(11)
            FL.reset_launches()
            K3.reset_launches()
            t0 = time.perf_counter()
            out = trainer.evaluate(valid_ds, batch_size=128, use_scan=use_scan,
                                   **kw)
            torch.cuda.synchronize()
            res[use_scan] = (out, dict(trainer.last_eval_totals),
                             {"snn_fwd": FL.LAUNCHES["snn_fwd"],
                              "style": K3.LAUNCHES["style"]},
                             time.perf_counter() - t0)
        if res[True][:2] != res[False][:2]:
            fail(f"evaluate {tag}: graphed {res[True][:2]} vs eager "
                 f"{res[False][:2]}")
        if res[True][2] != want or res[False][2] != want:
            fail(f"evaluate {tag}: launches graphed {res[True][2]}, eager "
                 f"{res[False][2]}; expected {want}")
        if not all(math.isfinite(v) for v in (*res[True][0], *res[True][1].values())):
            fail(f"evaluate {tag}: non-finite {res[True][:2]}")
        print(f"[graph] evaluate {tag} ({len(valid_ds)} images, ragged tail "
              f"{len(valid_ds) % 128}): graphed == eager, MIG "
              f"{res[True][0][0]:.4f}, MSE {res[True][0][1]:.4f}, "
              f"{sorted(res[True][1])} equal; launches {res[True][2]}; "
              f"{res[True][3]:.3f} s graphed, {res[False][3]:.3f} s eager")


def _epochs_per_scan_fit(ref, train_ds):
    """The fused CLEAR trainer fit 2 epochs graphed with epochs_per_scan=2
    from the same seed as ``ref`` (the one-step graph's fit): the history
    is one block of the last batch of each epoch, equal to ref's, and the
    final state equal."""
    from clearvae_torch.train.factories import get_clearvae_trainer

    kw = {**ADV_COMMON, "ps": True}
    t, _ = _graph_fit(get_clearvae_trainer, kw, train_ds, 2, epochs_per_scan=2)
    last = {k: np.asarray([h[k][-1] for h in ref.history]) for k in ref.history[0]}
    if len(t.history) != 1 or any(
            not np.array_equal(t.history[0][k], v) for k, v in last.items()):
        fail(f"fit epochs_per_scan=2: history {t.history} vs the last batches "
             f"{last}")
    diff = _same_training("fit epochs_per_scan=2 vs 1", ref, t,
                          histories=False)
    print(f"[graph] fit epochs_per_scan=2: one block, the last batch of each "
          f"epoch equal to the one-step graph's, final state equal "
          f"(max abs diff {diff:.1e})")


class _Recorder:
    """Wraps methods of the port's trainers for the length of the downstream
    run: each call's bound arguments, result and seconds (ended by a device
    synchronize) are kept per name."""

    def __init__(self):
        self.calls: dict = {}
        self._undo = []

    def wrap(self, owner, attr: str, name: str):
        import functools
        import inspect

        orig = getattr(owner, attr)
        sig = inspect.signature(orig)

        @functools.wraps(orig)
        def timed(*args, **kwargs):
            bound_args = sig.bind(*args, **kwargs)
            bound_args.apply_defaults()
            t0 = time.perf_counter()
            out = orig(*args, **kwargs)
            torch.cuda.synchronize()
            self.calls.setdefault(name, []).append(dict(
                args=bound_args.arguments, out=out, t0=t0,
                s=time.perf_counter() - t0))
            return out

        setattr(owner, attr, timed)
        self._undo.append((owner, attr, orig))

    def seconds(self, name: str) -> float:
        return sum(c["s"] for c in self.calls.get(name, []))

    def restore(self):
        for owner, attr, orig in reversed(self._undo):
            setattr(owner, attr, orig)


def _expected_downstream_k3(rec) -> int:
    """K3 launches the recorded downstream run must have made: its styled
    train batches (each epoch's shuffle, every zoo entry), the VAEs' styled
    eval batches (full ones and the ragged tail), the chunks of the probes'
    fused style→encode passes and of the CNN's fused style→logits passes."""
    n = 0
    for c in rec.calls["fit"]:
        a = c["args"]
        ds, tr = a["train_ds"], a["self"]
        if not a["style_on_device"]:
            fail("the downstream fit did not style on the device")
        bs = min(a["batch_size"], len(ds))
        nb = len(ds) // bs
        for e in range(a["start_epoch"], a["start_epoch"] + a["epochs"]):
            perm = np.random.RandomState(tr.seed + e).permutation(len(ds))
            n += k3_launches_expected(ds.styles,
                                      perm[: nb * bs].reshape(nb, bs))
    for c in rec.calls.get("evaluate", []):
        a = c["args"]
        ds = a["ds"]
        if not a["style_on_device"]:
            fail("a downstream evaluation did not style on the device")
        bs = min(a["batch_size"], len(ds))
        batches = [np.arange(s, min(s + bs, len(ds)))
                   for s in range(0, len(ds), bs)]
        n += k3_launches_expected(ds.styles, batches)
    for name in ("encode", "cnn_evaluate"):
        for c in rec.calls.get(name, []):
            a = c["args"]
            ds = a["ds"]
            if not a["style_on_device"]:
                fail(f"a downstream {name} pass did not style on the device")
            n += k3_launches_expected(ds.styles,
                                      chunk_batches(len(ds), a["batch_size"]))
    return n


def phase_downstream(gpu, here):
    """The downstream experiment through its entry point (see the module
    docstring); returns {kernel: launches} of the run. The zoo runs the
    latent losses unfused, as the JAX zoo does, so K1/K2f/K2b must not
    launch."""
    import shutil

    from clearvae_torch.experiments import styledmnist_downstream as RUN
    from clearvae_torch.ops import metrics as MT
    from clearvae_torch.ops.kernels import fused_loss as FL
    from clearvae_torch.ops.kernels import style as K3
    from clearvae_torch.train import trainers as TR

    out_dir = os.path.join(here, ".runs", "chip_smoke_downstream")
    shutil.rmtree(out_dir, ignore_errors=True)   # the JSON is a resume manifest
    rec = _Recorder()
    rec.wrap(TR.TrainerCore, "fit", "fit")
    rec.wrap(TR.VAETrainerBase, "evaluate", "evaluate")
    rec.wrap(TR.SimpleCNNTrainer, "evaluate", "cnn_evaluate")
    rec.wrap(MT, "mutual_info_gap", "mig")
    rec.wrap(TR.DownstreamMLPTrainer, "_encode_all", "encode")
    rec.wrap(TR.DownstreamMLPTrainer, "fit", "probe_fit")
    rec.wrap(TR.DownstreamMLPTrainer, "evaluate", "probe_eval")
    print(f"[downstream] styledmnist_downstream.main {' '.join(DOWNSTREAM_ARGS)}"
          f" (all seven zoo entries; cut: depth only — 20,000/4,000 "
          f"synthetic digits, 2 VAE, CNN and probe epochs)")
    K3.reset_launches()
    FL.reset_launches()
    t0 = time.perf_counter()
    try:
        RUN.main(DOWNSTREAM_ARGS + ["--out", out_dir])
        torch.cuda.synchronize()
    finally:
        rec.restore()
    wall = time.perf_counter() - t0
    launches = K3.LAUNCHES["style"]
    other = dict(FL.LAUNCHES)

    want = _expected_downstream_k3(rec)
    if launches != want:
        fail(f"K3 launched {launches} times on the downstream path; its "
             f"styled batches and chunks and severity groups make {want}")
    if any(other.values()):
        fail(f"the unfused downstream path launched fused-loss kernels: {other}")
    trainers = [c["args"]["self"] for c in rec.calls["fit"]]
    if [type(t).__name__ for t in trainers] != [
            "SimpleCNNTrainer", "HierarchicalVAETrainer",
            "HierarchicalVAETrainer", "CLEARVAETrainer", "ClearTCVAETrainer",
            "ClearMIMVAETrainer", "ClearMIMVAETrainer"]:
        fail(f"the downstream run fit {[type(t).__name__ for t in trainers]}")
    for t in trainers:
        for h in t.history:
            for k, v in h.items():
                if not np.isfinite(v).all():
                    fail(f"non-finite downstream training metric {k} "
                         f"({type(t).__name__})")
    migs = [c["out"][0] for c in rec.calls["evaluate"]]
    if len(migs) != 6 or not all(math.isfinite(m) for m in migs):
        fail(f"downstream validation MIG missing or not finite: {migs}")
    with open(os.path.join(out_dir, "styledmnist-k5-0.json")) as f:
        res = json.load(f)
    ok_schema = list(res) == ZOO and all(
        set(r) == {"acc", "pr", "roc"} and math.isfinite(r["acc"])
        and 0 <= r["acc"] <= 1
        and all(set(r[p]) == {"overall", "stratified"}
                and len(r[p]["stratified"]) == 10 for p in ("pr", "roc"))
        for r in res.values())
    if not ok_schema:
        fail(f"the downstream result JSON is malformed: {res}")
    starts = [c["t0"] for c in rec.calls["fit"]] + [t0 + wall]
    for name, t, a, b, c in zip(ZOO, trainers, starts, starts[1:],
                                rec.calls["fit"]):
        r = res[name]
        print(f"[downstream] {name}: {b - a:.2f} s in all (fit {c['s']:.2f} s "
              f"with its validation, {sum(len(h['loss']) for h in t.history)} "
              f"styled steps); test acc {r['acc']}, AUPR {r['pr']['overall']},"
              f" AUROC {r['roc']['overall']}")
    clear = trainers[ZOO.index("clear")]
    clear_fit = rec.calls["fit"][ZOO.index("clear")]
    # MIG of the last validation's latents, both backends on the same input
    m_args = rec.calls["mig"][-1]["args"]
    lat = (m_args["label"], m_args["latent_c"], m_args["latent_s"])
    mig_s = {}
    for backend in ("numpy", "torch", "numpy", "torch"):   # second: warm
        t1 = time.perf_counter()
        val = MT.mutual_info_gap(*lat, backend=backend)
        torch.cuda.synchronize()
        mig_s.setdefault(backend, [val]).append(time.perf_counter() - t1)
    # every VAE validation and all but the last CNN evaluation (the test
    # one) ran inside a fit
    cnn_valid_s = sum(c["s"] for c in rec.calls["cnn_evaluate"][:-1])
    fit_s = rec.seconds("fit") - rec.seconds("evaluate") - cnn_valid_s
    print(f"[downstream] clear: loss {clear.history[0]['loss'][0]:.3f} -> "
          f"{clear.history[-1]['loss'][-1]:.3f}; validation MIG of the six "
          f"VAEs {migs}")
    print(f"[downstream] seconds: whole run {wall:.2f}; fits {fit_s:.2f} "
          f"(validation excluded); VAE validation "
          f"{rec.seconds('evaluate'):.2f} ({len(rec.calls['evaluate'])} calls, "
          f"MIG in them {rec.seconds('mig'):.2f}); CNN evaluation "
          f"{rec.seconds('cnn_evaluate'):.2f} "
          f"({len(rec.calls['cnn_evaluate'])} calls, the test one included); "
          f"fused style+encode {rec.seconds('encode'):.2f} "
          f"({len(rec.calls['encode'])} passes); probe fit "
          f"{rec.seconds('probe_fit'):.2f} (its encodes included); probe test "
          f"eval {rec.seconds('probe_eval'):.2f}; {gpu}")
    print(f"[downstream] MIG on {len(lat[0])} latents (first/second call): "
          f"numpy {mig_s['numpy'][0]:.4f} in {mig_s['numpy'][1]:.3f}/"
          f"{mig_s['numpy'][2]:.3f} s, torch {mig_s['torch'][0]:.4f} in "
          f"{mig_s['torch'][1]:.3f}/{mig_s['torch'][2]:.3f} s")
    print(f"[downstream] launches: style_batch {launches} (expected {want}); "
          f"{other}")
    _profile_styled_steps(clear, clear_fit["args"]["train_ds"])
    return {**other, "style_batch": launches}


def _run_mig_sweep(out_dir):
    """One ``mig_expr.main`` call with its fits, evaluations and MIG calls
    recorded; returns (recorder, wall s, K3 launches, fused-loss launches,
    the CSV's bytes, start time)."""
    from clearvae_torch.experiments import mig_expr as RUN
    from clearvae_torch.ops import metrics as MT
    from clearvae_torch.ops.kernels import fused_loss as FL
    from clearvae_torch.ops.kernels import style as K3
    from clearvae_torch.train import trainers as TR

    rec = _Recorder()
    rec.wrap(TR.TrainerCore, "fit", "fit")
    rec.wrap(TR.VAETrainerBase, "evaluate", "evaluate")
    rec.wrap(MT, "mutual_info_gap", "mig")
    K3.reset_launches()
    FL.reset_launches()
    t0 = time.perf_counter()
    try:
        RUN.main(MIG_ARGS + ["--out", out_dir])
        torch.cuda.synchronize()
    finally:
        rec.restore()
    wall = time.perf_counter() - t0
    path = RUN.sweep_path(RUN.get_args(MIG_ARGS + ["--out", out_dir]))
    with open(path, "rb") as f:
        data = f.read()
    return rec, wall, K3.LAUNCHES["style"], dict(FL.LAUNCHES), data, t0


def phase_mig(gpu, here):
    """The MIG/ELBO sweep through its entry point, twice (see the module
    docstring); returns {kernel: launches} of the first run."""
    import csv
    import io
    import shutil

    from clearvae_torch.native import bindings
    from clearvae_torch.ops import metrics as MT

    out_dir = os.path.join(here, ".runs", "chip_smoke_mig")
    shutil.rmtree(out_dir, ignore_errors=True)   # the CSV is a resume manifest
    if not bindings.available():
        fail("the native MIG library did not build with g++")
    print(f"[mig] native MIG library {os.path.basename(bindings.lib_path())}"
          f" (g++ at first use); 'auto' resolves to "
          f"{MT.resolve_backend('auto')}")
    print(f"[mig] mig_expr.main {' '.join(MIG_ARGS)} (all eight zoo entries; "
          f"cut: depth only — 12,000 synthetic digits, 8,000/2,000/2,000, "
          f"1 epoch)")
    rec, wall, k3, other, data, start = _run_mig_sweep(out_dir)
    trainers = [c["args"]["self"] for c in rec.calls["fit"]]
    if len(trainers) != len(MIG_ZOO):
        fail(f"the sweep fit {len(trainers)} trainers, not {len(MIG_ZOO)}")
    backends = {t.mig_backend for t in trainers}
    if backends != {"native"}:
        fail(f"--mig_backend auto resolved to {backends}, not native")
    fit = rec.calls["fit"][0]["args"]
    splits = [fit["train_ds"], fit["valid_ds"],
              rec.calls["evaluate"][-1]["args"]["ds"]]
    want = sum(k3_launches_expected(d.styles, chunk_batches(len(d), 512))
               for d in splits)
    if k3 != want:
        fail(f"K3 launched {k3} times in the sweep; materializing its three "
             f"splits ({[len(d) for d in splits]} images) takes {want}")
    if any(other.values()):
        fail(f"the unfused sweep launched fused-loss kernels: {other}")
    rows = list(csv.reader(io.StringIO(data.decode())))
    if rows[0] != ["model", "beta", "mig", "elbo"] or \
            [r[0] for r in rows[1:]] != MIG_ZOO:
        fail(f"the sweep CSV is malformed: {rows}")
    vals = [[float(v) for v in r[1:]] for r in rows[1:]]
    if not all(math.isfinite(v) for r in vals for v in r) or \
            any(r[0] != 0.125 for r in vals):
        fail(f"the sweep CSV holds a non-finite value or another beta: {rows}")
    starts = [c["t0"] for c in rec.calls["fit"]] + [start + wall]
    for name, a, b, r, c in zip(MIG_ZOO, starts, starts[1:], vals,
                                rec.calls["fit"]):
        print(f"[mig] {name}: {b - a:.2f} s in all (fit {c['s']:.2f} s with "
              f"its validation); test MIG {r[1]:.4f}, ELBO (recon) {r[2]:.3f}")
    print(f"[mig] seconds: whole sweep {wall:.2f}; fits {rec.seconds('fit'):.2f}"
          f" (validation included); evaluations {rec.seconds('evaluate'):.2f} "
          f"({len(rec.calls['evaluate'])} calls, MIG in them "
          f"{rec.seconds('mig'):.2f}); K3 launches {k3} (expected {want}); "
          f"{other}; {gpu}")
    # native against numpy (and torch, timed) on the last entry's test latents
    m_args = rec.calls["mig"][-1]["args"]
    lat = (m_args["label"], m_args["latent_c"], m_args["latent_s"])
    label = MT._host(lat[0]).ravel().astype(np.int64)
    for i, half in ((1, "z_c"), (2, "z_s")):
        x = MT._host(lat[i])
        nat = MT.mutual_info_classif_native(x, label)
        ref = MT.mutual_info_classif_np(x, label)
        if not np.allclose(nat, ref, **MIG_TOL):
            fail(f"native and numpy MI of {half} disagree: {nat} vs {ref}")
    mig_s = {}
    for backend in ("native", "numpy", "torch") * 2:       # second: warm
        t1 = time.perf_counter()
        val = MT.mutual_info_gap(*lat, backend=backend)
        torch.cuda.synchronize()
        mig_s.setdefault(backend, [val]).append(time.perf_counter() - t1)
    if not math.isclose(mig_s["native"][0], mig_s["numpy"][0], rel_tol=1e-3,
                        abs_tol=1e-3):
        fail(f"native MIG {mig_s['native'][0]} vs numpy {mig_s['numpy'][0]}")
    print(f"[mig] MIG of {len(label)} test latents (first/second call): " +
          ", ".join(f"{b} {v[0]:.6f} in {v[1]:.4f}/{v[2]:.4f} s"
                    for b, v in mig_s.items()))
    # the same command again: every cell is in the CSV, so nothing trains
    rec2, wall2, k3_2, other2, data2, _ = _run_mig_sweep(out_dir)
    if rec2.calls.get("fit") or k3_2 or any(other2.values()):
        fail(f"the resumed sweep trained {len(rec2.calls.get('fit', []))} "
             f"cells, K3 {k3_2}, {other2}")
    if data2 != data:
        fail("the resumed sweep rewrote a different CSV")
    print(f"[mig] resumed call: {wall2:.2f} s, no cell trained, the same CSV "
          f"({len(data)} bytes)")
    return {**other, "style_batch": k3}


def _k1_instance(kernels_by_name) -> str:
    """The name of the K1 forward kernel in a device trace; fails unless it
    is the <32, true> instance (32 columns a half, float4 rows)."""
    names = [k for k in kernels_by_name if "clear_latent_fwdgrad_kernel" in k]
    if len(names) != 1 or "clear_latent_fwdgrad_kernel<32, true>" not in names[0]:
        fail(f"the K1 forward kernels in the trace are {names}, not the "
             f"<32, true> instance alone")
    return names[0]


def _timed64(tag, trainer, train_ds, gpu, flops, batch: int = 128):
    """``bench.time_steps`` of a 64×64 trainer: eager and graphed steps in
    turns; prints wall, device busy, idle share, kernels a step, images/sec
    and the FLOP share over the fp32 peak; returns the stats."""
    from clearvae_torch.bench import PEAK_FP32_FLOPS, time_steps

    stats = time_steps(trainer, train_ds, n=STEPS64, batch=batch)
    for mode, r in stats.items():
        if not r["kernels_by_name"]:
            fail(f"{tag} {mode}: the profiler recorded no kernel")
        print(f"[sixty-four] {tag} {mode} step (B={batch}, {STEPS64} steps a "
              f"turn): wall {'/'.join(f'{w:.3f}' for w in r['walls_ms'])} ms,"
              f" device busy {r['device_busy_ms']:.3f} ms, idle share "
              f"{'/'.join(f'{s:.3f}' for s in r['idle_share'])}, "
              f"{r['kernels_per_step']:.1f} kernels/step, images/sec "
              f"{'/'.join(f'{i:.1f}' for i in r['images_per_sec'])}, FLOP "
              f"share {max(r['images_per_sec']) * flops / PEAK_FP32_FLOPS:.4f}"
              f" (fp32 peak); {gpu}")
    return stats


def _sync_free_replays(tag, trainer, train_ds):
    """One epoch of a graphed trainer's train-step replays under
    ``set_sync_debug_mode("error")``: a synchronizing call between the
    first and the last replay raises."""
    ep = trainer._graphs[(id(train_ds), 128, False)][1]
    if ep.graph is None:
        fail(f"{tag}: the graphed fit captured no graph")
    rows = _epoch_rows(len(train_ds), 98)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        ep.run(rows)
    except RuntimeError as exc:
        fail(f"{tag}: a synchronizing call inside the replay loop: {exc}")
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    print(f"[sixty-four] {tag}: {len(rows)} replays with no synchronizing "
          f"call (sync debug mode 'error')")


def _run_runner64(name, args, out_dir):
    """One 64×64 runner through its ``main`` on the card, its launch counts
    zeroed just before and read just after; returns (seconds, launches)."""
    import importlib

    from clearvae_torch.ops.kernels import fused_loss as FL
    from clearvae_torch.ops.kernels import style as K3

    mod = importlib.import_module(f"clearvae_torch.experiments.{name}")
    FL.reset_launches()
    K3.reset_launches()
    t0 = time.perf_counter()
    mod.main(args + ["--seed", "0", "--device", "cuda", "--out", out_dir])
    torch.cuda.synchronize()
    return time.perf_counter() - t0, {**FL.LAUNCHES,
                                      "style_batch": K3.LAUNCHES["style"]}


def _check_result64(name, path, names):
    """The runner's result in the JAX schema, every value finite: the
    downstream JSON ({entry: {acc, pr, roc}} in the zoo's order) or the
    sweep's CSV (model, beta, mig, elbo; eight rows in JAX's order)."""
    import csv

    if path.endswith(".csv"):
        with open(path, newline="") as f:
            rows = list(csv.reader(f))
        if rows[0] != ["model", "beta", "mig", "elbo"] or \
                [r[0] for r in rows[1:]] != names or not all(
                    math.isfinite(float(v)) for r in rows[1:] for v in r[1:]):
            fail(f"{name}: the sweep CSV is malformed or not finite: {rows}")
        return f"{len(rows) - 1} rows, MIG " + ", ".join(
            f"{r[0]} {float(r[2]):.4f}" for r in rows[1:])
    with open(path) as f:
        res = json.load(f)
    ok = list(res) == names and all(
        set(r) == {"acc", "pr", "roc"} and 0 <= r["acc"] <= 1
        and all(set(r[p]) == {"overall", "stratified"}
                and math.isfinite(r[p]["overall"])
                and all(math.isfinite(v) for v in r[p]["stratified"].values())
                for p in ("pr", "roc"))
        for r in res.values())
    if not ok:
        fail(f"{name}: the result JSON is malformed or not finite: {res}")
    return ", ".join(f"{k} acc {r['acc']}" for k, r in res.items())


def phase_sixty_four(gpu, here):
    """The 64×64 family on the card (see the module docstring); returns
    {kernel: launches} summed over the phase's fused fits and evaluations,
    each counted from zero just before it and read just after."""
    import shutil

    from clearvae_torch import bench
    from clearvae_torch.data.celeba import get_celeba
    from clearvae_torch.data.common import train_valid_split_array
    from clearvae_torch.experiments.downstream64 import (PERF_VAE_KWARGS,
                                                         model_zoo64)
    from clearvae_torch.models.vae import VAE64
    from clearvae_torch.ops.kernels import fused_loss as FL
    from clearvae_torch.train.factories import (get_clearvae_trainer,
                                                get_cleartcvae_trainer,
                                                get_lamcnn_trainer)

    dev = torch.device("cuda")
    total = {k: 0 for k in (*REPLACES, "style_batch")}
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    _step_check(dev, "[sixty-four] VAE64", lambda: VAE64(total_z_dim=64),
                (128, 64, 64, 3), 4, 1 / 32, 3e-5)
    print(f"[sixty-four] step check {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    train, valid = train_valid_split_array(get_celeba(None, n_synthetic=N64,
                                                      seed=0), 0.85, 0)
    print(f"[sixty-four] synthetic CelebA: {len(train)} train / {len(valid)} "
          f"held-out 64×64×3 images in {time.perf_counter() - t0:.2f} s")
    flops = bench.clear_vae_train_flops_per_image(batch=128, **bench.SHAPE64)
    det = torch.backends.cudnn.deterministic

    # 1. fused CLEAR on VAE64: eager and graphed fits equal, K1 by replay
    kw = {**SIXTY_FOUR, "ps": True}
    t0 = time.perf_counter()
    torch.backends.cudnn.deterministic = True
    try:
        eager, le = _graph_fit(get_clearvae_trainer, kw, train, 2,
                               use_scan=False)
        t_eager = time.perf_counter() - t0
        t0 = time.perf_counter()
        graphed, lg = _graph_fit(get_clearvae_trainer, kw, train, 2)
        t_graphed = time.perf_counter() - t0
    finally:
        torch.backends.cudnn.deterministic = det
    n = graphed.train_step.step
    if n != eager.train_step.step or n != 2 * (len(train) // 128):
        fail(f"VAE64 CLEAR: {eager.train_step.step} eager and {n} graphed "
             f"updates")
    want = {"clear_latent_fwdgrad": n, "clear_latent_bwd": n, "snn_fwd": 0,
            "snn_bwd": 0, "style_batch": 0}
    if lg != want or le != want:
        fail(f"VAE64 CLEAR: launches eager {le}, graphed (replays) {lg}; "
             f"expected {want}")
    diff = _same_training("VAE64 CLEAR graphed vs eager", eager, graphed)
    for k in total:
        total[k] += lg[k]
    FL.reset_launches()
    t0 = time.perf_counter()
    mig, mse = graphed.evaluate(valid, batch_size=128)
    torch.cuda.synchronize()
    t_eval = time.perf_counter() - t0
    n_eval = -(-len(valid) // 128)
    if FL.LAUNCHES["snn_fwd"] != 2 * n_eval or not (math.isfinite(mig)
                                                    and math.isfinite(mse)):
        fail(f"VAE64 CLEAR evaluate: K2f {FL.LAUNCHES['snn_fwd']} for "
             f"{n_eval} batches, MIG {mig}, MSE {mse}")
    total["snn_fwd"] += FL.LAUNCHES["snn_fwd"]
    hist = np.concatenate([h["loss"] for h in graphed.history])
    print(f"[sixty-four] VAE64 fused CLEAR: {n} graphed updates == eager "
          f"(histories and state equal, max abs diff {diff:.1e}, "
          f"cudnn.deterministic); fit {t_graphed:.2f} s graphed, {t_eager:.2f}"
          f" s eager (2 epochs each, warm-up and capture included); loss "
          f"{hist[0]:.2f} -> {hist[-1]:.2f}; launches by replay {lg}; "
          f"evaluate {t_eval:.2f} s: MIG {mig:.4f}, MSE {mse:.3f}, K2f "
          f"{FL.LAUNCHES['snn_fwd']} = 2 x {n_eval} batches")
    stats = _timed64("VAE64 CLEAR fused", graphed, train, gpu, flops)
    k1 = _k1_instance(stats["graphed"]["kernels_by_name"])
    top = sorted(stats["graphed"]["ms_by_name"].items(), key=lambda kv: -kv[1])
    print(f"[sixty-four] graphed step's K1: {k1}, "
          f"{stats['graphed']['kernels_by_name'][k1] / STEPS64:g} a step; "
          f"top device kernels (ms a step):")
    for name, ms in top[:8]:
        print(f"[sixty-four]   {ms:.4f}  {name[:100]}")

    # 2. fused CLEAR-TC on VAE64: K2f and K2b once a step, by replay
    t0 = time.perf_counter()
    tc, lt = _graph_fit(get_cleartcvae_trainer,
                        {**SIXTY_FOUR, "la": 1, "factor_cls_lr": 1e-4},
                        train, 1)
    n = tc.train_step.step
    want = {"clear_latent_fwdgrad": 0, "clear_latent_bwd": 0, "snn_fwd": n,
            "snn_bwd": n, "style_batch": 0}
    if lt != want or not all(np.isfinite(v).all() for h in tc.history
                             for v in h.values()):
        fail(f"VAE64 CLEAR-TC: launches {lt}, expected {want}; or a "
             f"non-finite metric")
    for k in total:
        total[k] += lt[k]
    print(f"[sixty-four] VAE64 fused CLEAR-TC: {n} graphed updates in "
          f"{time.perf_counter() - t0:.2f} s; launches by replay {lt}")

    # 3. LAM-CNN64: graphed and eager fits equal; replays free of syncs
    lam_kw = dict(n_class=4, lam_coef=0.001, cnn_arch="LAMCNN64Classifier",
                  in_channel=3, seed=0, device="cuda")
    t0 = time.perf_counter()
    torch.backends.cudnn.deterministic = True
    try:
        lam_e, _ = _graph_fit(get_lamcnn_trainer, lam_kw, train, 2,
                              use_scan=False)
        lam_g, _ = _graph_fit(get_lamcnn_trainer, lam_kw, train, 2)
    finally:
        torch.backends.cudnn.deterministic = det
    if lam_g.train_step.step != lam_e.train_step.step:
        fail("LAM-CNN64: the graphed and eager fits took other step counts")
    diff = _same_training("LAM-CNN64 graphed vs eager", lam_e, lam_g)
    (_, _), acc = lam_g.evaluate(valid, batch_size=128)
    if list(lam_g.history[0]) != ["ce_loss", "lam_loss"] or not \
            math.isfinite(acc):
        fail(f"LAM-CNN64: history keys {list(lam_g.history[0])}, acc {acc}")
    print(f"[sixty-four] LAM-CNN64: {lam_g.train_step.step} graphed updates =="
          f" eager (max abs diff {diff:.1e}); ce_loss "
          f"{lam_g.history[-1]['ce_loss'][-1]:.4f}, lam_loss "
          f"{lam_g.history[-1]['lam_loss'][-1]:.4f}; held-out acc {acc:.3f}; "
          f"{time.perf_counter() - t0:.2f} s")
    _sync_free_replays("LAM-CNN64", lam_g, train)

    # 4. perf mode: bf16 conv stacks + fused heads
    t0 = time.perf_counter()
    FL.reset_launches()
    perf = get_clearvae_trainer(**kw, vae_kwargs=dict(PERF_VAE_KWARGS))
    perf.fit(2, train, batch_size=128)
    pmig, pmse = perf.evaluate(valid, batch_size=128)
    torch.cuda.synchronize()
    lp = dict(FL.LAUNCHES)
    if not (math.isfinite(pmig) and math.isfinite(pmse)) or \
            lp["clear_latent_fwdgrad"] != perf.train_step.step:
        fail(f"perf mode: MIG {pmig}, MSE {pmse}, launches {lp}")
    for k in REPLACES:
        total[k] += lp[k]
    print(f"[sixty-four] perf mode (bf16, fused heads): fit + evaluate "
          f"{time.perf_counter() - t0:.2f} s, MIG {pmig:.4f}, MSE "
          f"{pmse:.3f}; launches {lp}")
    _timed64("VAE64 CLEAR fused, perf mode bf16", perf, train, gpu, flops)
    # bench.py's 64×64 rows
    for row, (batch, bf16) in bench.ROWS64.items():
        rflops = bench.clear_vae_train_flops_per_image(batch=batch,
                                                       **bench.SHAPE64)
        r = bench.row_stats(bench.make_trainer(row),
                            bench.data64(STEPS64 * batch), STEPS64, rflops,
                            bench.PEAK_BF16_FLOPS if bf16
                            else bench.PEAK_FP32_FLOPS, batch)
        print(f"[sixty-four] bench {row}: " + json.dumps(r))

    # 5. the runners through their entry points, at cut depth
    out_root = os.path.join(here, ".runs", "chip_smoke_64")
    shutil.rmtree(out_root, ignore_errors=True)    # results are manifests
    zoo = list(model_zoo64(4, {"beta": 1, "vae_lr": 1, "z_dim": 64,
                               "alpha": 1, "temperature": 1}, 0))
    for name, args, fname, names in RUNNERS64:
        if names is None:
            names = zoo + (["lam-cnn"] if name.startswith("camelyon") else [])
        out = os.path.join(out_root, name)
        secs, launches = _run_runner64(name, args, out)
        if any(launches.values()):
            fail(f"{name}: the unfused zoo launched {launches}")
        summary = _check_result64(name, os.path.join(out, fname), names)
        print(f"[sixty-four] {name} {' '.join(args)}: {secs:.2f} s, "
              f"{len(names)} entries; {summary}; {gpu}")
    print(f"[sixty-four] whole phase {time.perf_counter() - t_phase:.2f} s; "
          f"launches on its fused fits and evaluations {total}")
    return total


def _device_kernels(prof, counts: bool = False):
    """({kernel name: device us}, kernel count) of a profile, without the
    host ranges that the profiler mirrors onto the device timeline (a
    record_function range such as Optimizer.step#Adam.step spans kernels;
    it is not one). With counts, the count is per name."""
    from torch.autograd import DeviceType

    host_names = {e.name for e in prof.events() if e.device_type == DeviceType.CPU}
    by_name: dict = {}
    per_name: dict = {}
    for e in prof.events():
        if (e.device_type == DeviceType.CUDA and not e.is_user_annotation
                and e.name not in host_names):
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
            per_name[e.name] = per_name.get(e.name, 0) + 1
    return by_name, (per_name if counts else sum(per_name.values()))


def _profile_styled_steps(trainer, ds, n: int = 20, bs: int = 128):
    """Where a styled train step's time goes: wall ms of styling + step
    (eager, and graphed: one replay of the captured styled step a batch),
    styling alone and the step alone over n batches, then the device time
    of each under the profiler, K3's and styling's share of the styled
    step's device time, and styling's kernels and host syncs a batch."""
    from clearvae_torch.bench import profile_window
    from clearvae_torch.train import steps as S

    dev = trainer.device
    raw, sidx, draws = ds.device_arrays(dev)
    labels = torch.as_tensor(ds.labels, dtype=torch.int64, device=dev)
    idx = [torch.arange(i * bs, (i + 1) * bs, device=dev) for i in range(n)]
    pre = [ds.style(raw[i], sidx[i], draws[i])[..., None] for i in idx]

    def styled():
        for i in idx:
            trainer.train_step(ds.style(raw[i], sidx[i], draws[i])[..., None],
                               labels[i], trainer._train_noise(bs))

    def style_only():
        for i in idx:
            ds.style(raw[i], sidx[i], draws[i])

    def step_only():
        for i, x in zip(idx, pre):
            trainer.train_step(x, labels[i], trainer._train_noise(bs))

    graph = S.make_graphed_epoch_fn(trainer.train_step, None, labels, bs,
                                    trainer._train_noise, styler=ds.style,
                                    style_arrays=(raw, sidx, draws))
    rows = torch.stack(idx)

    def graphed():
        graph.run(rows)

    walls, busy, kernels, k3 = {}, {}, {}, 0.0
    for name, fn in (("styled step", styled), ("graphed styled step", graphed),
                     ("styling", style_only), ("step", step_only)):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls[name] = (time.perf_counter() - t0) * 1e3 / n
        with profile_window() as prof:
            fn()
            torch.cuda.synchronize()
        by_name, n_kernels = _device_kernels(prof)
        if not by_name:
            fail("the profiler recorded no device activity")
        busy[name] = sum(by_name.values()) / 1e3 / n
        kernels[name] = n_kernels / n
        if name == "styled step":
            k3 = sum(v for k, v in by_name.items() if "style_kernel" in k) / 1e3 / n
            top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    for name in ("styled step", "graphed styled step"):
        print(f"[profile] {name.replace('styled step', 'styled train step')} "
              f"(B={bs}): wall {walls[name]:.3f} ms, device busy "
              f"{busy[name]:.4f} ms, idle share "
              f"{1 - busy[name] / walls[name]:.3f}, {kernels[name]:.1f} "
              f"kernels/step")
    # host syncs of one styling call, as torch's sync debug mode reports them
    import warnings

    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            ds.style(raw[idx[0]], sidx[idx[0]], draws[idx[0]])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    syncs = sum("synchroniz" in str(w.message) for w in caught)
    print(f"[profile]   styling alone: wall {walls['styling']:.3f} ms, device "
          f"{busy['styling']:.4f} ms ({busy['styling'] / busy['styled step']:.3f}"
          f" of the styled step's device time), {kernels['styling']:g} kernels "
          f"and {syncs} host syncs a batch; K3 {k3:.4f} ms "
          f"({k3 / busy['styled step']:.4f} of it)")
    print(f"[profile]   step alone: wall {walls['step']:.3f} ms, device "
          f"{busy['step']:.4f} ms")
    # the set-up cost of the dataset's zigzag draws: one threefry pass over
    # all its sample ids (made once in device_arrays; batches gather)
    from clearvae_torch.ops.corruptions import zigzag_draws

    ids = torch.as_tensor(ds.sample_ids, dtype=torch.int64, device=dev)
    draw_ms = []
    for _ in range(2):                                  # second: warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        zigzag_draws(ds.seed, ids)
        torch.cuda.synchronize()
        draw_ms.append((time.perf_counter() - t0) * 1e3)
    print(f"[profile]   zigzag draws of all {len(ids)} sample ids, once per "
          f"dataset: {draw_ms[0]:.3f}/{draw_ms[1]:.3f} ms wall (first/second)")
    for name, us in top:
        print(f"[profile]   {us / 1e3 / n:.4f} ms/step  {name[:90]}")


def main():
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a CUDA card")
    t_start = time.perf_counter()
    here = os.path.dirname(os.path.abspath(__file__))
    try:
        import clearvae_torch
    except ImportError as exc:
        fail(f"the clearvae_torch package is not beside this script: {exc}")
    if os.path.dirname(os.path.abspath(clearvae_torch.__file__)) != os.path.join(
            here, "clearvae_torch"):
        fail(f"clearvae_torch was imported from {clearvae_torch.__file__}, "
             f"not from beside this script")
    torch.backends.cudnn.allow_tf32 = False       # fp32 convolutions, as the
    torch.backends.cuda.matmul.allow_tf32 = False  # JAX reference computes
    gpu = gpu_name_and_limit()
    phase_build()
    errs, times = phase_kernels()
    k3_err, k3_times = phase_style_kernel()
    launches, (train_ds, valid_ds) = phase_main(gpu)
    adv = phase_adversarial(gpu, train_ds, valid_ds)
    graph = phase_graph(gpu, train_ds, valid_ds, here)
    down = phase_downstream(gpu, here)
    mig = phase_mig(gpu, here)
    s64 = phase_sixty_four(gpu, here)
    by_path = {name: {"main": launches[name], "adversarial": adv[name],
                      "graph": graph[name], "downstream": down[name],
                      "mig": mig[name], "sixty-four": s64[name]}
               for name in (*REPLACES, "style_batch")}
    # ``launches``: each kernel's count on the path that its slice put it on
    # (K1: the fused CLEAR trainer; K2f/K2b: the fused CLEAR-TC and
    # CLEAR-MIM trainers; K3: the downstream zoo)
    own = {"clear_latent_fwdgrad": "main", "clear_latent_bwd": "main",
           "snn_fwd": "adversarial", "snn_bwd": "adversarial",
           "style_batch": "downstream"}
    for name, path in own.items():
        if by_path[name][path] == 0:
            fail(f"{name} was launched no time on the {path} path")
    # this slice's path, the 64×64 one, runs every fused-loss kernel
    for name in REPLACES:
        if by_path[name]["sixty-four"] == 0:
            fail(f"{name} was launched no time on the sixty-four path")
    kernels = [dict(name=name, route="cuda", source=SOURCE[name],
                    replaces=REPLACES[name], launches=by_path[name][own[name]],
                    max_abs_err=errs[name], **times[(name, 128, 8)],
                    library_ms=None, launches_by_path=by_path[name])
               for name in REPLACES]
    kernels.append(dict(name="style_batch", route="cuda", source=K3_SOURCE,
                        replaces=K3_REPLACES,
                        launches=by_path["style_batch"]["downstream"],
                        max_abs_err=k3_err, **k3_times[128], library_ms=None,
                        launches_by_path=by_path["style_batch"]))
    print(f"[chip_smoke] whole run {time.perf_counter() - t_start:.2f} s "
          f"(phases 1-8, the build included)")
    print(gpu)
    print(json.dumps({"kernels": kernels, "shape": {"B": 128, "z": 8, "H": 28},
                      "b2048": {n: times[(n, 2048, 8)] for n in REPLACES},
                      "b128_z32": {n: times[(n, 128, 32)] for n in REPLACES},
                      "b512": {"style_batch": k3_times[512]}}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
