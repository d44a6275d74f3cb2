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
                (512, 8) and (2048, 8), the perf rows' (phase 11), and
                (128, 32), phase 8's shape, with CUDA events
                and, per call, the profiler's device time. The
                styler K3: all seven codes × severities 1–5 at B = 128, 100
                and 512 (atol 1e-3 on the 0..255 scale), and rows of
                negative code left bit-equal in a pre-filled ``out``; timed
                at B = 128 and 512. The PRNG's threefry pass K4: bit-equal
                to its plain twin, one launch a pass, timed alone at the
                largest pass of a MNIST-C batch (fog's last level, 128 keys
                x 16,384 counters) and over the 73 passes of one
                ``style_batch`` of MNIST-C's 16 styles at B = 128, each
                against its bound (bytes over HBM bandwidth, int32
                operations over the int32 rate). glass_blur's swaps K5:
                bit-equal to its plain twin on the operands glass_blur
                draws at severities 1 and 5 on a B = 128 batch, in place
                and into ``out=``, one kernel a call, timed against the
                twin, and one glass_blur call's kernels and device time.
                BatchNorm K6: at each BatchNorm of VAE64 and the 28×28 VAE
                at B = 128 (``K6_LAYERS``), float32 and bfloat16,
                channels-last and NCHW, each activation in train, eval and
                train without ``update_stats``, the output, the input's,
                weight's and bias's gradients and the running statistics
                against the twin, every element within its bar
                (``k6_check``: a ReLU input that the two put on other sides
                of zero must lie within ``K6_FLIP_AT`` of it, and is then
                held through K6's mask, and printed), four launches and
                kernels a train call, one launch an eval forward, two calls
                bit-identical; a float16 BatchNorm raises; forward +
                backward timed channels-last (events, the profiler's device
                µs) against the twin and ``k6_bound`` (5 passes; K6's
                design moves 8).
                Every later phase counts K4's launches
                (``launches.threefry``), K5's (``launches.glass``) and K6's
                (``launches.batchnorm``) beside K3's, on the same paths
                (the JSON line's ``launches_by_path``): K5 runs only where
                glass_blur does, the MNIST-C paths of phase 10; K6 on every
                path without a mesh (4 a BatchNorm a train step, checked
                exactly on the fused fits of phases 3, 8, 10 and 11 (c)),
                never under one.
3. main       — the flagship configuration through the user entry points:
                ``get_clearvae_trainer`` (z = 16, batch 128, τ = 0.1, α = 100,
                β = 1/8, Adam 5e-4, fused latent losses) → ``fit`` for 2
                epochs on synthetic Styled-MNIST of the six styles, styled
                once by ``materialize`` (K3) → ``evaluate``, both as users
                call them: their default, the captured CUDA graph. The
                launch counters are zeroed just before and read just after
                (K1's forward and backward kernels once per train step, K2f
                twice per eval batch, counted by replay); one step is also
                checked fused against unfused on the card.
5. adversarial — CLEAR-TC and CLEAR-MIM (CLUB-S) at the flagship widths
                through ``get_cleartcvae_trainer`` / ``get_clearmimvae_trainer``
                with ``hyperparameter={"fused": True}`` (λ = 1, factor Adam
                1e-4; λ = 3, estimator Adam 2e-3, 5 inner steps) → ``fit`` for
                2 epochs on phase 3's data → ``evaluate`` (graphed, the
                default). Each run's launch counters are zeroed before and
                read after: K2f (c_loss forward) and K2b (its backward) once
                per train step, by replay, K1 never; the eval is unfused, as
                in JAX. One step of each is checked fused against unfused on
                the card.
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
                launch.

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
                one-step graph's fit exactly. Then the fused-loss kernels
                counted by name in the device trace of 20 replays of the
                graphed CLEAR, CLEAR-TC and CLEAR-MIM fits' steps.

8. sixty-four — the 64×64 family at the runners' widths (VAE64, z = 64,
                B = 128, β = 1/32, τ = 0.1, α = 100, Adam 3e-5) on synthetic
                CelebA (2,048 images, 1,740 / 308): one VAE64 step fused
                against unfused on the card (phase 5's bars); the fused CLEAR
                trainer (``get_clearvae_trainer(vae_arch="VAE64", ...,
                hyperparameter={"fused": True})``) fit 2 epochs eagerly and
                graphed under ``cudnn.deterministic``, equal at 0.0, K1's
                forward and backward once a step by replay, then the graphed
                ``evaluate`` (K2f twice a batch, finite MIG and MSE); the
                K1 kernel in the device trace of a replay the ``<32,
                true>`` instance; fused CLEAR-TC 1 epoch
                (K2f = K2b = 1 a step by replay); LAM-CNN64 fit graphed and
                eagerly, equal at 0.0, and an epoch of its replays under
                ``set_sync_debug_mode("error")``; the perf mode (bf16 conv
                stacks, fused heads) fit and evaluated, finite; then the
                runners through their ``main`` at cut depth
                (``RUNNERS64``: CelebA k = 1, 2 epochs, seven entries;
                Camelyon17 1 epoch, eight with the LAM-CNN; PACS and CheXpert
                k = 1, 1 epoch, clear and baseline; the CelebA MIG/ELBO sweep
                1 epoch, eight), each result in the JAX schema with finite
                values, and no fused-loss or styling kernel launched (the zoo
                is unfused and the 64×64 sets come styled).

9. artifacts  — the qualitative-artifact path through its entry points, at
                ``demo``'s own widths (z = 16, B = 128, τ = 2, α = 100,
                β = 1/8, Adam 5e-4): ``demo.main --model clearvae --dataset
                styled --epochs 31 --n_total 20000``, the notebook's depth
                (4,092 graphed steps), then bvae, gvae, mlvae, cleartcvae and
                clearmimvae on styled and clearvae on colored and celeba, 1
                epoch of 4,096 images each: finite gMIG, MSE and grids, the
                swapping, interpolation and (where sklearn and matplotlib
                are installed) t-SNE files written, K3 once a chunk of each
                styled half (none on the sets that come styled), no
                fused-loss kernel (demo's trainers are unfused). The
                reference run's swap grid and interpolation strips decoded
                on the card equal those that the same weights decode on the
                CPU (max abs 1e-4). A child process that sets nothing itself
                runs ``demo.main`` (lock skipped by its escape hatch) and
                must read both ``allow_tf32`` flags False after it; a second
                child asking for the GPU lock must be refused by the
                holder's pid. Then ``illustrate.main`` (three grids, K3
                counted), ``mi_simulation.main --reps 3`` (finite traces;
                PS-SNN and the kNN MI fall as the std rises) and
                ``analyze.main`` over phase 4's result JSON.

10. corruptions — the whole MNIST-C corruption library on the card. Each of
                the 32 styles of ``ALL_CORRUPTIONS`` at its default
                severity styles one B = 128 batch on the card and on the
                CPU under the same keys, held to the CPU tests' bars
                (``CORR_BARS``), its device time a call from the profiler.
                A Styled-MNIST of 12,000 synthetic digits on MNIST-C's 16
                ``CORRUPTIONS`` (uniform) trains the flagship fused CLEAR
                trainer (z = 16, B = 128, τ = 0.1, α = 100, β = 1/8) 1
                epoch through the graphed ``fit`` with ``style_on_device``
                (every style inside the captured step): K1 once a step each
                way, K3 twice a step (scale@3 and brightness@5, two
                severity groups), K4 73 times a step (after the
                dataset's 8 draw passes) and K5 once a step by replay, and
                K4's 73 and K5's one a step again over 10 replays alone;
                the graphed ``evaluate`` styled on the card (K3 and K2f
                twice a batch, K4 73 times, K5 once, finite MIG and MSE);
                no Poisson draw cut by its loop cap; 4 graphed steps equal
                to the eager loop at 0.0 (``cudnn.deterministic``).

11. parallel — data and tensor parallelism (``clearvae_torch/parallel``)
                at the flagship widths on phase 3's data. (a) One rank
                over NCCL in this process (``init_process_group`` on a
                ``HashStore``): on ``make_mesh(1)`` and on
                ``make_mesh2d(1, 1)``, the fused CLEAR trainer and the
                styled unfused one fit eagerly and graphed (1 epoch each;
                ``cudnn.deterministic``): graphed =
                eager at 0.0, and eager fits of 8 steps (the CPU tests'
                horizon, 1,024 of the images) on the mesh within those
                tests' bars of the no-mesh fit's (per-batch losses rtol
                2e-4, parameters 8e-3); by replay K1 once a step each
                way (fused), K3 once a step (styled) and the mesh's
                collectives (all-reduces: two a BatchNorm, two for the
                gathered heads, one for the metrics, one for the
                gradients, one more on 1 × 1, the model axis's gather)
                in the graph; the fused TC trainer 1 epoch graphed (K2f
                = K2b once a step); the graphed ``evaluate`` (K2f twice a
                batch); one replay
                profiled for NCCL's kernels; then SimpleCNN, LAM-CNN (also
                on 1 × 1), a styled SimpleCNN and the fused VAE64 CLEAR
                trainer at the 64×64 runners' widths (z = 64, B = 128), 1
                epoch of 1,024 images each, eager and graphed at 0.0, K1
                (VAE64: its ``<32, true>`` instance in a replay's trace),
                K3 (styled) and the all-reduces by replay (their own
                ``launches_by_path`` entry). A one-rank mesh runs every
                collective. (b) Two ranks on
                the one card over gloo, child processes of this
                script with ``CLEARVAE_TORCH_NO_LOCK=1`` (they share the
                card on purpose; this process holds the lock): one eager
                DP(2) step of the fused CLEAR, the fused TC, the LAM-CNN
                and the fused VAE64 CLEAR trainer on CUDA tensors against
                this process's single-rank step at the CPU tests' bars
                (loss rtol 1e-5, the gradients each optimizer applies,
                summed over the ranks, rtol 1e-5 with an atol of 1e-5 of
                the largest; VAE64's tensor by tensor in L2, see
                ``PAR_V64_L2_RTOL``; parameters within max(1e-3·max|a|,
                1.2e-3); TC rtol 2e-4), both ranks' parameters equal at
                0.0. (c) The 28×28 perf-mode trainers of the root
                bench's rows (``PERF28``: bf16 conv stacks and/or the four
                heads in one Linear, at B = 128, 512 and 2,048), fused, fit
                2 epochs graphed on phase 3's data without a mesh: K1 once
                a step each way by replay, at B = 512 and 2,048 too.

Phases run in the order 1, 2, 3, 5, 7, 4, 6, 8, 9, 10, 11 (phases 5, 7 and
11 train on phase 3's data; phase 9 reads phase 4's result).

It prints the card's name and power limit, one JSON line of per-kernel
numbers, and, last, ``{"ok": true, "device": {...}}``. It exits non-zero
without that line when there is no CUDA device or no ``clearvae_torch``
beside it. Imports nothing of JAX.

It times kernels alone (phase 2) and no train step: the port's step
throughput is ``portbench``'s (``python3 -m portbench.run --workload
<cell>``).
"""

from __future__ import annotations

import contextlib
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
          (100, 48), (512, 8), (2048, 8), (2048, 64), (17, 8)]
RING_SHAPE = (2048, 64)
# B=128, z=8 is the main path's shape; z=32 the 64×64 path's (phase 8);
# B=512 and 2,048 at z=8 the 28×28 perf rows' (phase 11)
TIMED = [(128, 8), (512, 8), (2048, 8), (128, 32)]
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
K4_SOURCE = "clearvae_torch/csrc/threefry.cu"
K4_TIMED = (128, 128 * 128)   # fog's last level: 128 keys x 16,384 counters
K4_BATCH_PASSES = 73          # a MNIST-C style_batch's passes at B = 128
# a dataset's draws (style_draws: fold_in, split, and zigzag's two randint,
# each a split and two random_bits), made once a dataset and device
K4_DRAWS_PASSES = 8
# int32 operations an element of a threefry pass (2 + 20 rounds of add,
# rotate, xor + 5 injections of 2 adds; random_bits xors the two words), and
# the H100's int32 rate: 64 lanes an SM a clock (CUDA programming guide,
# throughput table, compute capability 9.0), 132 SMs at 1.98 GHz
K4_OPS = 72
PEAK_INT32_OPS = 132 * 64 * 1.98e9
K5_SOURCE = "clearvae_torch/csrc/glass_swap.cu"
# glass_blur's severities K5 is held and timed at: 1,352 swaps an image
# (severity 1, MNIST-C's default) and 800 (severity 5), at B = 128
K5_SEVERITIES = (1, 5)
K6_SOURCE = "clearvae_torch/csrc/batchnorm.cu"
# (C, H·W, activation) of each BatchNorm of VAE64 (cells 2 and 5: the
# encoder's five, the decoder's dense layer and its five ConvTs) and of the
# 28×28 VAE (cells 1, 3, 4), at B = 128; K6 is held and timed at each, in
# float32 and bfloat16
K6_LAYERS = {
    "vae64": ((32, 1024, "relu"), (64, 256, "relu"), (128, 64, "relu"),
              (256, 16, "relu"), (512, 4, "relu"), (2048, 1, "relu"),
              (256, 16, "relu"), (128, 64, "relu"), (64, 256, "relu"),
              (32, 1024, "relu"), (3, 4096, "sigmoid")),
    "vae28": ((32, 196, "relu"), (64, 49, "relu"), (128, 16, "relu"),
              (2048, 1, "relu"), (64, 49, "relu"), (32, 196, "relu"),
              (1, 784, "sigmoid"))}
# the element passes of a train layer: the fewest any implementation moves
# (the forward reads x and writes y; the backward reads dy and x and writes
# dx), and K6's (stats and apply each read x; grad_reduce and grad_apply
# each read dy and x)
K6_MIN_PASSES = 5
K6_PASSES = 8
# the ReLU inputs that K6's statistics and the twin's may put on other sides
# of zero (the two sum in other orders): within this share of the layer's
# largest input (at least 1) of zero
K6_FLIP_AT = 2 ** -14
# the layer's modes: (train, update_stats)
K6_MODES = {"train": (True, True), "eval": (False, True),
            "no_update": (True, False)}
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
# phase 9: demo.main at its own defaults (z = 16, B = 128, τ = 2, α = 100,
# β = 1/8, Adam 5e-4): CLEAR on Styled-MNIST at the notebook's depth (31
# epochs of 17,000 images: 4,092 graphed steps), then the other five models
# and the other two sets at cut depth
DEMO_COMMON = ["--seed", "0", "--device", "cuda"]
DEMO_REF = ["--model", "clearvae", "--dataset", "styled", "--epochs", "31",
            "--n_total", "20000"]
DEMO_REF_STEPS = 31 * (17000 // 128)
DEMO_SHORT = [["--model", m, "--dataset", d, "--epochs", "1", "--n_total",
               "4096"]
              for m, d in (("bvae", "styled"), ("gvae", "styled"),
                           ("mlvae", "styled"), ("cleartcvae", "styled"),
                           ("clearmimvae", "styled"), ("clearvae", "colored"),
                           ("clearvae", "celeba"))]
DECODE_TOL = 1e-4       # the card's decode against the CPU's, same weights
# phase 10: MNIST-C's 16 styles (clearvae_tpu/ops/corruptions.py:57-61) at
# their default severities, uniform, on synthetic digits; the flagship
# widths of phase 5. CORR_BARS are tests/test_torch_corruptions.py's bars
# (0..255 scale: atol, and the share of pixels a discrete outcome may move
# beyond it), which the card's styles are held to against the CPU's
CORR_N = 12000
CORR_EPOCHS = 1
CORR_EAGER_N = 512      # graphed against eager: 4 steps
CORR_BARS = {"line": (5e-3, 0.0), "dotted_line": (5e-3, 0.0),
             "zigzag": (5e-3, 0.0), "elastic_transform": (5e-3, 0.0),
             "pessimal_noise": (5e-3, 0.0), "glass_blur": (1e-3, 0.005),
             "frost": (1e-3, 0.005), "snow": (1e-3, 0.005),
             "spatter": (1e-3, 0.005), "jpeg_compression": (1e-3, 0.005),
             "shot_noise": (1e-3, 0.002)}
CORR_DEFAULT_BAR = (1e-3, 0.0)
N64 = 2048              # synthetic CelebA images, the runners' default
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


SETTLE_S = 0.02


@contextlib.contextmanager
def profile_window():
    """``torch.profiler.profile`` of CPU and CUDA activity around a block
    that starts and ends ``SETTLE_S`` inside the window, the device idle
    at both edges. Kernels run right after the profiler started were
    missing from its traces on the card (one K3 of 20 graph replays, one
    of ten K2b calls); the trace drops device events it places outside its
    window, and the card's clock is matched to the host's only so far, so
    the block keeps away from the edges."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        time.sleep(SETTLE_S)
        yield prof
        torch.cuda.synchronize()
        time.sleep(SETTLE_S)


def device_kernels(prof) -> tuple[dict, dict, float]:
    """({kernel name: launches}, {kernel name: device us}, device-busy us)
    of a profile. Device copies and fills (``Memcpy``, ``Memset``) are busy
    time but not kernels. Host ranges that the profiler mirrors onto the
    device timeline (a record_function range such as
    Optimizer.step#Adam.step spans kernels) and user annotations are
    neither."""
    from torch.autograd import DeviceType

    host = {e.name for e in prof.events() if e.device_type == DeviceType.CPU}
    counts: dict = {}
    us: dict = {}
    busy = 0.0
    for e in prof.events():
        if (e.device_type != DeviceType.CUDA or e.is_user_annotation
                or e.name in host):
            continue
        busy += e.time_range.elapsed_us()
        if not e.name.startswith(("Memcpy", "Memset")):
            counts[e.name] = counts.get(e.name, 0) + 1
            us[e.name] = us.get(e.name, 0.0) + e.time_range.elapsed_us()
    return counts, us, busy


def device_us(fn, n: int = 50):
    """(device us per call, kernels per call) of fn from torch.profiler:
    the summed durations of the kernels (not copies) that n calls launched."""
    fn()
    torch.cuda.synchronize()
    with profile_window() as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    counts, us, _ = device_kernels(prof)
    return sum(us.values()) / n, sum(counts.values()) / n


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


# the launch counters read on each path: the fused-loss kernels', K3's
# (``style_batch``), K4's (``threefry``), K5's (``glass``) and K6's
# (``batchnorm``, its four stages together)
COUNTED = (*REPLACES, "style_batch", "threefry", "glass", "batchnorm")


def _zero_launches() -> None:
    from clearvae_torch.ops.kernels import batchnorm as K6
    from clearvae_torch.ops.kernels import fused_loss as FL
    from clearvae_torch.ops.kernels import glass as K5
    from clearvae_torch.ops.kernels import style as K3
    from clearvae_torch.ops.kernels import threefry as K4

    FL.reset_launches()
    K3.reset_launches()
    K4.reset_launches()
    K5.reset_launches()
    K6.reset_launches()


def _launches() -> dict:
    """{kernel: launches} since ``_zero_launches``, by ``COUNTED``'s
    names."""
    from clearvae_torch.ops.kernels import batchnorm as K6
    from clearvae_torch.ops.kernels import fused_loss as FL
    from clearvae_torch.ops.kernels import glass as K5
    from clearvae_torch.ops.kernels import style as K3
    from clearvae_torch.ops.kernels import threefry as K4

    return {**FL.LAUNCHES, "style_batch": K3.LAUNCHES["style"],
            "threefry": K4.LAUNCHES["threefry"], "glass": K5.LAUNCHES["glass"],
            "batchnorm": sum(K6.LAUNCHES.values())}


def _bn_layers(module) -> int:
    """The BatchNorm layers of ``module``: each takes K6's four launches a
    train step (stats, apply, grad_reduce, grad_apply), two a no-grad
    train-mode forward and one an eval forward, off a mesh."""
    from clearvae_torch.models.layers import BatchNorm

    return sum(isinstance(m, BatchNorm) for m in module.modules())


def k4_bound(passes):
    """(bound_ms, bound_by) of threefry passes, each (form, keys, counters a
    key, data bytes a key): each key word (two int64) and fold_in's data
    read once, each output word (int64) written once, over HBM bandwidth,
    against ``K4_OPS`` int32 operations an element (one more for bits' xor)
    over the int32 rate."""
    nbytes = ops = 0
    for form, n_keys, m, data_bytes in passes:
        n = n_keys * m
        words = 1 if form == "bits" else 2
        nbytes += n_keys * (16 + data_bytes) + 8 * words * n
        ops += n * (K4_OPS + (form == "bits"))
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, ops / PEAK_INT32_OPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def phase_threefry():
    """K4 against its plain twin on the card, bit for bit: alone at
    ``K4_TIMED`` and over the passes of one MNIST-C ``style_batch`` at
    B = 128 (recorded from the call, then replayed pass by pass); returns
    the timings of both."""
    from clearvae_torch.data.mnist import synthetic_mnist
    from clearvae_torch.ops import corruptions as TC
    from clearvae_torch.ops.kernels import threefry as K4

    dev = torch.device("cuda")
    b, n = K4_TIMED
    draws = TC.style_draws(0, torch.arange(b, dtype=torch.int32, device=dev))
    k0, k1 = draws[:, 2], draws[:, 3]     # strided, as _style_rows reads them
    kern = lambda: K4.bits(k0, k1, n)        # noqa: E731
    plain = lambda: K4.bits_plain(k0, k1, n)  # noqa: E731
    if not torch.equal(kern(), plain()):
        fail(f"K4 bits at {b} keys x {n}: not bit-equal to its plain twin")
    p1, t1, t2, p2 = (cuda_ms(plain, iters=20), cuda_ms(kern), cuda_ms(kern),
                      cuda_ms(plain, iters=20))
    dus, n_k = device_us(kern)
    if n_k != 1:
        fail(f"K4 bits: {n_k} kernels a call, not one")
    bms, by = k4_bound([("bits", b, n, 0)])
    alone = dict(ms=min(t1, t2), plain_ms=min(p1, p2), bound_ms=bms,
                 bound_by=by, bound_unit=by if by == "bytes" else "int32",
                 device_us=dus)
    print(f"[kernels] threefry bits {b} keys x {n} counters: kernel "
          f"{t1:.4f}/{t2:.4f} ms (events), device {dus:.2f} us/call, plain "
          f"{p1:.4f}/{p2:.4f} ms, bound {bms:.6f} ms ({by}): "
          f"{100 * bms * 1e3 / dus:.1f} % of the device time")

    # the passes of one style_batch, recorded with their own key views
    x = torch.as_tensor(synthetic_mnist(b, seed=0)[0], device=dev)
    sidx = torch.arange(b, device=dev) % len(TC.CORRUPTIONS)
    styles = tuple((name, None) for name in TC.CORRUPTIONS)
    forms = {"fold_in": K4.fold_in, "split": K4.split, "bits": K4.bits}
    passes = []

    def recorder(form):
        def call(a, c, arg):
            passes.append((form, a, c, arg))
            return forms[form](a, c, arg)
        return call

    try:
        for form in forms:
            setattr(K4, form, recorder(form))
        K4.reset_launches()
        TC.style_batch(x, sidx, draws, styles)
        torch.cuda.synchronize()
    finally:
        for form, fn in forms.items():
            setattr(K4, form, fn)
    if len(passes) != K4_BATCH_PASSES or \
            K4.LAUNCHES["threefry"] != K4_BATCH_PASSES:
        fail(f"K4: {len(passes)} passes and {K4.LAUNCHES['threefry']} "
             f"launches in one MNIST-C style_batch, not {K4_BATCH_PASSES}")
    twins = {"fold_in": K4.fold_in_plain, "split": K4.split_plain,
             "bits": K4.bits_plain}

    def batch_k():
        return [forms[f](a, c, arg) for f, a, c, arg in passes]

    def batch_p():
        return [twins[f](a, c, arg) for f, a, c, arg in passes]

    for f, got, want in zip((p[0] for p in passes), batch_k(), batch_p()):
        got, want = (got, want) if f == "bits" else (torch.stack(got),
                                                     torch.stack(want))
        if not torch.equal(got, want):
            fail(f"K4 {f}: a pass of the MNIST-C batch is not bit-equal to "
                 f"its plain twin")
    p1, t1, t2, p2 = (cuda_ms(batch_p, iters=5, warmup=2),
                      cuda_ms(batch_k, iters=50),
                      cuda_ms(batch_k, iters=50),
                      cuda_ms(batch_p, iters=5, warmup=2))
    dus, n_k = device_us(batch_k, n=5)
    # (form, keys: their broadcast shape's elements, with fold_in's data,
    # counters a key, data bytes a key)
    shaped = [(f, torch.broadcast_shapes(
        a.shape, c.shape, *((arg.shape,) if f == "fold_in" else ())).numel(),
        1 if f == "fold_in" else arg,
        arg.element_size() if f == "fold_in" else 0)
        for f, a, c, arg in passes]
    bms, by = k4_bound(shaped)
    n_el = sum(n * m for _, n, m, _ in shaped)
    batch = dict(ms=min(t1, t2), plain_ms=min(p1, p2), bound_ms=bms,
                 bound_by=by, device_us=dus, passes=len(passes),
                 elements=n_el, kernels=n_k)
    print(f"[kernels] threefry: the {len(passes)} passes ({n_el:,} elements) "
          f"of one MNIST-C style_batch at B={b}: kernel {t1:.4f}/{t2:.4f} ms "
          f"(events), device {dus:.2f} us ({n_k:g} kernels), plain "
          f"{p1:.4f}/{p2:.4f} ms, bound {bms:.6f} ms ({by}): "
          f"{100 * bms * 1e3 / dus:.1f} % of the device time")
    return alone, batch


def phase_glass():
    """K5 against its plain twin on the card, bit for bit, on the operands
    glass_blur hands it (recorded from the call) at ``K5_SEVERITIES`` on a
    B = 128 batch, in place and into ``out=``, one launch and one kernel a
    call; the kernel and the twin timed, and one glass_blur call's kernels
    and device time; returns {severity: timings}."""
    from clearvae_torch.data.mnist import synthetic_mnist
    from clearvae_torch.ops import corruptions as TC
    from clearvae_torch.ops import prng as P
    from clearvae_torch.ops.kernels import glass as K5

    dev = torch.device("cuda")
    b = 128
    x = torch.as_tensor(synthetic_mnist(b, seed=0)[0], device=dev)
    keys = tuple(k.to(dev) for k in P.fold_in(
        P.key(0, (b,)), torch.arange(b, dtype=torch.int32)))
    timings = {}
    for sev in K5_SEVERITIES:
        calls = []

        def record(img, deltas, do_swap, base, out=None):
            calls.append((img.clone(), deltas, do_swap, base))
            return K5.glass_swaps(img, deltas, do_swap, base, out=out)

        TC.glass_swaps = record
        try:
            TC.glass_blur(x, keys, sev)
        finally:
            TC.glass_swaps = K5.glass_swaps
        img, deltas, do_swap, base = calls[0]
        n = base.shape[0]
        want = K5.glass_swaps_plain(*(t.cpu() for t in calls[0]))
        K5.reset_launches()
        inplace = img.clone()
        K5.glass_swaps(inplace, deltas, do_swap, base)
        buf = torch.full_like(img, -1.0)
        K5.glass_swaps(img, deltas, do_swap, base, out=buf)
        torch.cuda.synchronize()
        if K5.LAUNCHES["glass"] != 2:
            fail(f"K5 severity {sev}: {K5.LAUNCHES['glass']} launches in two "
                 f"calls")
        if not (torch.equal(inplace.cpu(), want)
                and torch.equal(buf.cpu(), want)):
            fail(f"K5 severity {sev} at B={b}: not bit-equal to its plain "
                 f"twin")
        kern = lambda: K5.glass_swaps(img, deltas, do_swap, base,  # noqa: E731
                                      out=buf)
        plain = lambda: K5.glass_swaps_plain(img.clone(), deltas,  # noqa: E731
                                             do_swap, base)
        p1, t1, t2, p2 = (cuda_ms(plain, iters=3, warmup=1), cuda_ms(kern),
                          cuda_ms(kern), cuda_ms(plain, iters=3, warmup=1))
        dus, n_k = device_us(kern)
        if n_k != 1:
            fail(f"K5 severity {sev}: {n_k} kernels a call, not one")
        blur_us, blur_k = device_us(lambda: TC.glass_blur(x, keys, sev), n=10)
        timings[sev] = dict(swaps=n, ms=min(t1, t2), plain_ms=min(p1, p2),
                            device_us=dus, glass_blur_device_us=blur_us,
                            glass_blur_kernels=blur_k)
        print(f"[kernels] glass_swaps severity {sev} ({n} swaps an image, "
              f"B={b}): bit-equal to its plain twin; kernel {t1:.4f}/"
              f"{t2:.4f} ms (events), device {dus:.2f} us/call, plain "
              f"{p1:.3f}/{p2:.3f} ms; one glass_blur call {blur_us:.2f} "
              f"device us in {blur_k:g} kernels; bound: the serial chain of "
              f"{n} swaps, not bytes or FLOPs")
    return timings


def k6_bound(layers, itemsize: int, passes: int = K6_MIN_PASSES):
    """(bound_ms, bound_by) of a train step's BatchNorms, each (C, H·W,
    activation) at B = 128: ``passes`` element passes of ``itemsize`` bytes
    over HBM bandwidth (the per-channel vectors, a few KB, left out). The
    bound is the fewest any implementation moves, ``K6_MIN_PASSES``;
    ``K6_PASSES`` gives what K6's design moves."""
    nbytes = sum(passes * 128 * c * hw * itemsize for c, hw, _ in layers)
    return nbytes / PEAK_BYTES_PER_S * 1e3, "bytes"


def k6_operands(n, c, hw, dtype, device, seed, channels_last=False):
    """[x, dy, weight, bias, running mean, running var] of a layer of C
    channels of H·W (a square plane; 2-D where H·W = 1) at batch ``n``."""
    g = torch.Generator().manual_seed(seed)
    shape = (n, c) if hw == 1 else (n, c, *(2 * (math.isqrt(hw),)))
    fmt = (torch.channels_last if channels_last and hw > 1
           else torch.contiguous_format)
    x = (torch.randn(shape, generator=g) * 1.5 + 0.3).to(
        device, dtype, memory_format=fmt)
    dy = torch.randn(shape, generator=g).to(device, dtype, memory_format=fmt)
    params = (1 + 0.2 * torch.randn(c, generator=g),
              0.2 * torch.randn(c, generator=g),
              0.1 * torch.randn(c, generator=g),
              0.5 + torch.rand(c, generator=g))
    return [x, dy, *(t.to(device) for t in params)]


def k6_layer(fn, ops, train, update_stats, act, mask=None):
    """[y, dx, dweight, dbias, running mean, running var] of ``fn`` (K6's
    ``batch_norm`` or the twin) on copies of ``ops``; with a ReLU ``mask``,
    y is the pre-activation and the gradients are taken through ``mask``
    in place of y > 0."""
    x, dy, w, b, rm, rv = (t.clone() for t in ops)
    for t in (x, w, b):
        t.requires_grad_(True)
    y = fn(x, w, b, rm, rv, train, update_stats,
           act if mask is None else "none")
    grads = torch.autograd.grad(y, (x, w, b),
                                dy if mask is None else dy * mask)
    return [y.detach(), *grads, rm, rv]


def k6_bar(ref, k: int, dtype) -> float:
    """The bar of tensor ``k`` of ``k6_layer``'s list against the twin's
    ``ref``, for every element: 2e-5 of the twin's largest magnitude (at
    least 1) in a float32 layer (8 times that for dweight and dbias, sums
    over a channel), two bf16 steps (2^-7) in a bfloat16 layer."""
    tol = (2e-5 * (8 if k in (2, 3) else 1) if dtype == torch.float32
           else 2 ** -7)
    return tol * max(float(ref.float().abs().max()), 1.0)


def k6_check(got, ops, twin, train, update_stats, act):
    """``got`` (``k6_layer``'s list of K6) against the twin on ``ops``:
    (problem or None, max abs error, the ReLU inputs put on other sides of
    zero). Every element lies within ``k6_bar`` (a NaN never does). The
    one cause let past it: a ReLU input that the two statistics put on
    other sides of zero, which changes that element's gradient by its
    whole dy and its channel's sums by that element's share. Such an input
    has to lie within ``K6_FLIP_AT`` of zero on both sides, and the twin's
    gradients are then taken through K6's mask, to the same bars."""
    dtype = ops[0].dtype
    want = k6_layer(twin, ops, train, update_stats, act)
    flips = {"n": 0}
    if act == "relu":
        mask = got[0] > 0
        flipped = mask != (want[0] > 0)
        if flipped.any():
            pre = k6_layer(twin, ops, train, update_stats, act, mask=mask)
            near = K6_FLIP_AT * max(float(pre[0].float().abs().max()), 1.0)
            at = torch.maximum(pre[0][flipped].float().abs(),
                               got[0][flipped].float())
            worst = int(flipped.flatten().nonzero()[int(at.argmax())])
            idx = tuple(int(i) for i in np.unravel_index(
                worst, tuple(got[0].shape)))
            flips = {"n": int(flipped.sum()), "input_at": float(at.max()),
                     "where": idx, "x": float(ops[0][idx]),
                     "twin_input": float(pre[0][idx]),
                     "y": float(got[0][idx]), "twin_y": float(want[0][idx]),
                     "dy": float(ops[1][idx]),
                     "dx_err": float((got[1][idx].float()
                                      - want[1][idx].float()).abs()),
                     "dx_err_through_mask": float(
                         (got[1][idx].float() - pre[1][idx].float()).abs())}
            if not float(at.max()) <= near:
                return (f"{flips['n']} ReLU inputs on other sides of zero, "
                        f"up to {flips['input_at']:.3e} from it (the bar "
                        f"{near:.3e}): {flips}", math.inf, flips)
            want[1:4] = pre[1:4]
    err = 0.0
    for k, (p, q) in enumerate(zip(got, want)):
        bar = k6_bar(q, k, dtype)
        diff = (p.float() - q.float()).abs()
        off = ~(diff <= bar)
        if off.any():
            return (f"tensor {k} of [y, dx, dweight, dbias, running mean, "
                    f"running var] has {int(off.sum())} of its {q.numel()} "
                    f"elements beyond {bar:.2e} of the twin's (largest "
                    f"{float(diff.max()):.3e}; flips {flips})", math.inf,
                    flips)
        err = max(err, float(diff.max()))
    return None, err, flips


def phase_batchnorm():
    """K6 against its plain twin on the card at every BatchNorm of VAE64 and
    the 28×28 VAE at B = 128 (``K6_LAYERS``), float32 and bfloat16, in
    channels-last order (the models' layout) and in NCHW order, each
    activation in train, eval and train without ``update_stats``: the
    output, the input's, weight's and bias's autograd gradients and the
    running statistics (``k6_check``); four launches a train call (three
    in eval with a backward, one an eval forward); a second call bit for
    bit the first. A ReLU input put on other sides of zero is printed with
    its operands. Each layer's forward and backward with its own
    activation timed in channels-last order (CUDA events, the kernels' and
    the twin's; the kernels' device time by the profiler) against
    ``k6_bound``. A float16 tensor raises through the layer. Returns
    {"<model>_<dtype>": totals over the layers}."""
    from clearvae_torch.models.layers import BatchNorm, batch_norm_plain
    from clearvae_torch.ops.kernels import batchnorm as K6

    dev = torch.device("cuda")
    b = 128
    try:
        BatchNorm(4).to(dev)(torch.randn(8, 4, device=dev,
                                         dtype=torch.float16), True)
        fail("K6: a float16 BatchNorm on the card did not raise")
    except ValueError:
        pass
    out = {}
    for model, layers in K6_LAYERS.items():
        for dtype in (torch.float32, torch.bfloat16):
            tag = f"{model}_{str(dtype).split('.')[-1]}"
            tot = dict(ms=0.0, plain_ms=0.0, device_us=0.0, max_abs_err=0.0,
                       relu_flips=0)
            for i, (c, hw, own), cl in ((i, lay, cl) for i, lay in
                                        enumerate(layers)
                                        for cl in (True, False)):
                ops = k6_operands(b, c, hw, dtype, dev, 1000 + i, cl)
                where = (f"K6 {tag} layer {i} (C={c}, H·W={hw}, "
                         f"{'channels-last' if cl else 'NCHW'})")
                for act, (mode, (train, upd)) in ((a, m) for a in K6.ACTS
                                                  for m in K6_MODES.items()):
                    K6.reset_launches()
                    got = k6_layer(K6.batch_norm, ops, train, upd, act)
                    torch.cuda.synchronize()
                    launches = dict(K6.LAUNCHES)
                    again = k6_layer(K6.batch_norm, ops, train, upd, act)
                    if launches != {"stats": int(train), "apply": 1,
                                    "grad_reduce": 1, "grad_apply": 1}:
                        fail(f"{where} {act} {mode}: launches {launches}")
                    if not all(torch.equal(p, q) for p, q in zip(got, again)):
                        fail(f"{where} {act} {mode}: two calls differ")
                    problem, err, flips = k6_check(got, ops, batch_norm_plain,
                                                   train, upd, act)
                    if problem:
                        fail(f"{where} {act} {mode}: {problem}")
                    if flips["n"]:
                        print(f"[kernels] batchnorm {where} {act} {mode}: "
                              f"ReLU inputs on other sides of zero {flips}")
                    tot["relu_flips"] += flips["n"]
                    tot["max_abs_err"] = max(tot["max_abs_err"], err)
                x, _, w, bias, rm, rv = ops
                K6.reset_launches()
                with torch.no_grad():
                    K6.batch_norm(x, w, bias, rm, rv, False, True, own)
                torch.cuda.synchronize()
                if dict(K6.LAUNCHES) != {"stats": 0, "apply": 1,
                                         "grad_reduce": 0, "grad_apply": 0}:
                    fail(f"{where}: launches {dict(K6.LAUNCHES)} an eval "
                         f"forward")
                if not cl:
                    continue    # timed in the layout the models run

                def kern():
                    return k6_layer(K6.batch_norm, ops, True, True, own)

                def plain():
                    return k6_layer(batch_norm_plain, ops, True, True, own)

                p1, t1, t2, p2 = (cuda_ms(plain, iters=50), cuda_ms(kern),
                                  cuda_ms(kern), cuda_ms(plain, iters=50))
                dus, n_k = device_us(kern, n=20)
                if n_k != 4:
                    fail(f"{where}: {n_k} kernels a train call, not 4")
                tot["ms"] += min(t1, t2)
                tot["plain_ms"] += min(p1, p2)
                tot["device_us"] += dus
                lb = k6_bound([(c, hw, own)], x.element_size())[0]
                print(f"[kernels] batchnorm {tag} layer {i} (C={c}, H·W={hw}, "
                      f"{own}): forward + backward {t1:.4f}/{t2:.4f} ms "
                      f"(events), device {dus:.2f} us, plain {p1:.4f}/"
                      f"{p2:.4f} ms, bound {lb:.5f} ms")
            itemsize = torch.tensor([], dtype=dtype).element_size()
            bms, by = k6_bound(layers, itemsize)
            tot.update(bound_ms=bms, bound_by=by, layers=len(layers),
                       design_ms=k6_bound(layers, itemsize, K6_PASSES)[0])
            out[tag] = tot
            print(f"[kernels] batchnorm {tag}, {len(layers)} layers a train "
                  f"step: max abs err {tot['max_abs_err']:.3e} "
                  f"({tot['relu_flips']} ReLU inputs on other sides of "
                  f"zero); forward + backward {tot['ms']:.4f} ms (events), "
                  f"device {tot['device_us']:.2f} us, plain "
                  f"{tot['plain_ms']:.4f} ms, bound {bms:.5f} ms ({by}, "
                  f"{K6_MIN_PASSES} passes; K6's design moves {K6_PASSES}: "
                  f"{tot['design_ms']:.5f} ms)")
    return out


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

def phase_main():
    from clearvae_torch.data.mnist import synthetic_mnist
    from clearvae_torch.data.styled import make_styled_mnist, train_valid_split
    from clearvae_torch.models.vae import VAE
    from clearvae_torch.ops.kernels import batchnorm as K6
    from clearvae_torch.ops.kernels import fused_loss as FL
    from clearvae_torch.ops.kernels import style as K3
    from clearvae_torch.ops.kernels import threefry as K4
    from clearvae_torch.train.factories import get_clearvae_trainer

    dev = torch.device("cuda")
    _step_check(dev, "[main]", lambda: VAE(total_z_dim=16), (32, 28, 28, 1),
                10, 1 / 8, 5e-4)
    t0 = time.perf_counter()
    imgs, labels = synthetic_mnist(9600, seed=0)
    train_ds, valid_ds = train_valid_split(make_styled_mnist(imgs, labels, seed=0))
    _zero_launches()
    train_ds.materialize(dev)
    valid_ds.materialize(dev)
    torch.cuda.synchronize()
    k3_materialize = K3.LAUNCHES["style"]
    k4_materialize = K4.LAUNCHES["threefry"]
    if k4_materialize != 2 * K4_DRAWS_PASSES:
        fail(f"K4 launched {k4_materialize} times in materialize; the two "
             f"datasets' draws make {2 * K4_DRAWS_PASSES}")
    want = sum(k3_launches_expected(d.styles, chunk_batches(len(d), 512))
               for d in (train_ds, valid_ds))
    if k3_materialize != want:
        fail(f"K3 launched {k3_materialize} times in materialize; its "
             f"chunks and severity groups make {want}")
    print(f"[main] data: {len(train_ds)} train / {len(valid_ds)} held-out "
          f"images, six styles, made and styled in "
          f"{time.perf_counter() - t0:.2f} s; K3 launches in materialize: "
          f"{k3_materialize} (expected {want}), K4 {k4_materialize}")
    trainer = get_clearvae_trainer(beta=1 / 8, ps=True, vae_lr=5e-4, z_dim=16,
                                   alpha=100, temperature=0.1, seed=0,
                                   verbose_period=1,
                                   hyperparameter={"fused": True},
                                   device="cuda")
    bs = 128
    FL.reset_launches()
    K6.reset_launches()
    for epoch in range(2):
        trainer.fit(1, train_ds, batch_size=bs, start_epoch=epoch)
    torch.cuda.synchronize()
    k6_fit = sum(K6.LAUNCHES.values())
    t0 = time.perf_counter()
    mig, mse = trainer.evaluate(valid_ds, batch_size=bs)
    eval_s = time.perf_counter() - t0
    launches = dict(FL.LAUNCHES)
    k6 = sum(K6.LAUNCHES.values())
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
    if K4.LAUNCHES["threefry"] != k4_materialize:
        fail(f"K4 launched {K4.LAUNCHES['threefry'] - k4_materialize} times "
             f"in the fit and evaluate of materialized data")
    k5 = _launches()["glass"]
    if k5:
        fail(f"K5 launched {k5} times on the six styles' path")
    bns = _bn_layers(trainer.model)
    if k6_fit != 4 * bns * n_steps or k6 - k6_fit != bns * n_eval_batches:
        fail(f"K6 launched {k6_fit} times in {n_steps} train steps and "
             f"{k6 - k6_fit} in {n_eval_batches} eval batches of a model of "
             f"{bns} BatchNorms (4 a layer a step, 1 a layer a batch)")
    print(f"[main] {n_steps} train steps; loss {hist['loss'][0]:.3f} -> "
          f"{hist['loss'][-1]:.3f}; eval MIG {mig:.4f}, MSE {mse:.3f} "
          f"({eval_s:.2f} s)")
    print(f"[main] launches: {launches}; K6 {k6_fit} in the fit (4 x {bns} "
          f"layers x {n_steps} steps), {k6 - k6_fit} in evaluate")
    return ({**launches, "style_batch": k3_materialize,
             "threefry": k4_materialize, "glass": k5, "batchnorm": k6},
            (train_ds, valid_ds))


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
    from clearvae_torch.train.factories import (get_clearmimvae_trainer,
                                                get_cleartcvae_trainer)

    _adversarial_step_check(torch.device(ADV_COMMON["device"]))
    runs = {"clear-tc": (get_cleartcvae_trainer,
                         dict(la=1, factor_cls_lr=1e-4)),
            "clear-mim (CLUB-S)": (get_clearmimvae_trainer,
                                   dict(mi_estimator="CLUBSample", la=3,
                                        mi_estimator_lr=2e-3))}
    bs = 128
    total = {k: 0 for k in COUNTED}
    for name, (factory, kw) in runs.items():
        trainer = factory(**ADV_COMMON, **kw)
        _zero_launches()
        t0 = time.perf_counter()
        result = trainer.fit(2, train_ds, batch_size=bs)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        mig, mse = trainer.evaluate(valid_ds, batch_size=bs)
        eval_s = time.perf_counter() - t0
        launches = _launches()
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
                or launches["style_batch"] or launches["threefry"] \
                or launches["glass"] or not launches["batchnorm"]:
            fail(f"{name}: K1, K3, K4 or K5 launched on the adversarial path, "
                 f"or K6 not: {launches}")
        print(f"[adversarial] {name}: {n_steps} train steps in {fit_s:.2f} s; "
              f"loss {hist['loss'][0]:.3f} -> {hist['loss'][-1]:.3f}; "
              f"eval MIG {mig:.4f}, MSE {mse:.3f} ({eval_s:.2f} s); "
              f"launches {launches}; {gpu}")
        for k in total:
            total[k] += launches[k]
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
    trainer = factory(**kw)
    _zero_launches()
    trainer.fit(epochs, train_ds, batch_size=128, **fit_kw)
    torch.cuda.synchronize()
    return trainer, _launches()


def _replay_kernels(trainer, n: int = 1) -> dict:
    """{kernel name: launches} in ``n`` replays of the train step that
    ``trainer``'s graphed fit captured, by the profiler (up to three
    windows: one with no kernel is the profiler's loss)."""
    ep = next(fn for key, (_, fn) in trainer._graphs.items()
              if key[0] != "eval")
    graph = ep.graph[0]
    for _ in range(3):
        with profile_window() as prof:
            for _ in range(n):
                graph.replay()
        counts = device_kernels(prof)[0]
        if counts:
            return counts
    fail(f"the profiler recorded no kernel in three windows of {n} replays "
         f"of a captured step")


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


def phase_graph(train_ds, valid_ds, here):
    """The graphed train step (``fit(use_scan=True)``, one captured CUDA
    graph a step) against the eager one, for the fused CLEAR, CLEAR-TC and
    CLEAR-MIM (CLUB-S) trainers on phase 3's data (see the module
    docstring), then every other captured step the same way
    (``_graph_more_runs``); returns {kernel: launches} summed over every
    graphed fit, each fit's counters zeroed just before it and read
    after."""
    import shutil

    dev = torch.device("cuda")
    total = {k: 0 for k in COUNTED}
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
            want["style_batch"] = want["threefry"] = want["glass"] = 0
            if lg != le or {k: lg[k] for k in want} != want \
                    or not lg["batchnorm"]:
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
        trainers[name] = graphed
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
        want["threefry"] = 0   # the six styles' draws were made in phase 3
        want["glass"] = 0      # and none of them is glass_blur
        if lg != le or {k: lg[k] for k in want} != want \
                or not lg["batchnorm"]:
            fail(f"{name}: launches eager {le}, graphed (replays) {lg}; "
                 f"expected {want} and K6")
        for k in total:
            total[k] += lg[k]
        print(f"[graph] {name}: {n_g} graphed updates == {n_e} eager; "
              f"histories and final state equal, max abs diff {diff:.3e} "
              f"(cudnn.deterministic); launches {lg}")
        if styled:
            _styled_replays(graphed, train_ds)
        more[name] = graphed
    torch.backends.cudnn.deterministic = True
    try:
        _eval_pairs(trainers["clear"], more["clear styled on the card"],
                    more["gvae"], valid_ds)
        _epochs_per_scan_fit(trainers["clear"], train_ds)
    finally:
        torch.backends.cudnn.deterministic = det
    per_step = {"clear": {"clear_latent_fwdgrad_kernel": 1,
                          "clear_latent_bwd_kernel": 1}}
    for name in ("clear-tc", "clear-mim (CLUB-S)"):   # K2f and K2b
        per_step[name] = {"clear_latent_fwdgrad_kernel": 2}
    # last: the replays train the fits' trainers on
    for name, trainer in trainers.items():
        seen = {}
        for k, v in _replay_kernels(trainer, 20).items():
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


def _styled_replays(trainer, train_ds, n: int = 20):
    """The styled graphed step (K3, zigzag and canny inside the graph) of a
    trainer that has fit: one epoch of its replays under
    ``set_sync_debug_mode("error")`` (a synchronizing call between the
    first and the last replay raises), K3's launches by replay (one a
    step), then K3 by name in the device trace of n replays."""
    from torch.autograd import DeviceType

    from clearvae_torch.ops.kernels import style as K3
    from clearvae_torch.ops.kernels import threefry as K4

    ep = trainer._graphs[(id(train_ds), 128, True)][1]
    if ep.graph is None:
        fail("the styled fit captured no graph")
    rows = _epoch_rows(len(train_ds), 99)
    torch.cuda.synchronize()
    _zero_launches()
    torch.cuda.set_sync_debug_mode("error")
    try:
        ep.run(rows)
    except RuntimeError as exc:
        fail(f"a synchronizing call inside the styled replay loop: {exc}")
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    k5 = _launches()["glass"]
    if K3.LAUNCHES["style"] != len(rows) or K4.LAUNCHES["threefry"] or k5:
        fail(f"K3 launched {K3.LAUNCHES['style']} times, K4 "
             f"{K4.LAUNCHES['threefry']} and K5 {k5} by replay in {len(rows)} "
             f"styled replays (six styles: K3 once a replay, K4 and K5 "
             f"never)")
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
    print(f"[graph] styled fit: {len(rows)} replays with no synchronizing call "
          f"(sync debug mode 'error'); K3 {len(rows)}, K4 and K5 0 by "
          f"replay; device trace of {n} inspected replays: "
          f"{int(per_replay.sum())} style_kernel, one in each")


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
    from clearvae_torch.ops.kernels import threefry as K4
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
    _zero_launches()
    t0 = time.perf_counter()
    try:
        RUN.main(DOWNSTREAM_ARGS + ["--out", out_dir])
        torch.cuda.synchronize()
    finally:
        rec.restore()
    wall = time.perf_counter() - t0
    launches = K3.LAUNCHES["style"]
    other = dict(FL.LAUNCHES)
    k4 = K4.LAUNCHES["threefry"]
    # its six styles draw nothing inside a styling call: K4 runs only in
    # each dataset's draws
    if k4 == 0 or k4 % K4_DRAWS_PASSES:
        fail(f"K4 launched {k4} times on the downstream path, not a "
             f"multiple of a dataset's {K4_DRAWS_PASSES} draw passes")
    k5 = _launches()["glass"]
    if k5:
        fail(f"K5 launched {k5} times on the six styles' downstream path")

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
    k6 = _launches()["batchnorm"]
    if not k6:
        fail("K6 launched no time on the downstream path")
    return {**other, "style_batch": launches, "threefry": k4, "glass": k5,
            "batchnorm": k6}


def _run_mig_sweep(out_dir):
    """One ``mig_expr.main`` call with its fits, evaluations and MIG calls
    recorded; returns (recorder, wall s, {kernel: launches}, the CSV's
    bytes, start time)."""
    from clearvae_torch.experiments import mig_expr as RUN
    from clearvae_torch.ops import metrics as MT
    from clearvae_torch.train import trainers as TR

    rec = _Recorder()
    rec.wrap(TR.TrainerCore, "fit", "fit")
    rec.wrap(TR.VAETrainerBase, "evaluate", "evaluate")
    rec.wrap(MT, "mutual_info_gap", "mig")
    _zero_launches()
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
    return rec, wall, _launches(), data, t0


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
    rec, wall, launches, data, start = _run_mig_sweep(out_dir)
    k3 = launches["style_batch"]
    if launches["glass"]:
        fail(f"K5 launched {launches['glass']} times on the six styles' "
             f"sweep")
    other = {k: launches[k] for k in REPLACES}
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
          f"{rec.seconds('mig'):.2f}); K3 launches {k3} (expected {want}), "
          f"K4 {launches['threefry']}; {other}; {gpu}")
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
    rec2, wall2, launches2, data2, _ = _run_mig_sweep(out_dir)
    if rec2.calls.get("fit") or any(launches2.values()):
        fail(f"the resumed sweep trained {len(rec2.calls.get('fit', []))} "
             f"cells, launches {launches2}")
    if data2 != data:
        fail("the resumed sweep rewrote a different CSV")
    print(f"[mig] resumed call: {wall2:.2f} s, no cell trained, the same CSV "
          f"({len(data)} bytes)")
    return launches


def _k1_instance(kernels_by_name) -> str:
    """The name of the K1 forward kernel in a device trace; fails unless it
    is the <32, true> instance (32 columns a half, float4 rows)."""
    names = [k for k in kernels_by_name if "clear_latent_fwdgrad_kernel" in k]
    if len(names) != 1 or "clear_latent_fwdgrad_kernel<32, true>" not in names[0]:
        fail(f"the K1 forward kernels in the trace are {names}, not the "
             f"<32, true> instance alone")
    return names[0]


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

    mod = importlib.import_module(f"clearvae_torch.experiments.{name}")
    _zero_launches()
    t0 = time.perf_counter()
    mod.main(args + ["--seed", "0", "--device", "cuda", "--out", out_dir])
    torch.cuda.synchronize()
    return time.perf_counter() - t0, _launches()


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
    total = {k: 0 for k in COUNTED}
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
            "snn_bwd": 0, "style_batch": 0, "threefry": 0, "glass": 0,
            "batchnorm": 4 * _bn_layers(graphed.model) * n}
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
    counts = _replay_kernels(graphed)
    k1 = _k1_instance(counts)
    print(f"[sixty-four] a replay of the graphed step: K1 {k1}, "
          f"{counts[k1]:g} a step")

    # 2. fused CLEAR-TC on VAE64: K2f and K2b once a step, by replay
    t0 = time.perf_counter()
    tc, lt = _graph_fit(get_cleartcvae_trainer,
                        {**SIXTY_FOUR, "la": 1, "factor_cls_lr": 1e-4},
                        train, 1)
    n = tc.train_step.step
    # K6: the VAE's train step, then its no-grad train-mode forward
    want = {"clear_latent_fwdgrad": 0, "clear_latent_bwd": 0, "snn_fwd": n,
            "snn_bwd": n, "style_batch": 0, "threefry": 0, "glass": 0,
            "batchnorm": 6 * _bn_layers(tc.model) * n}
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
    _zero_launches()
    perf = get_clearvae_trainer(**kw, vae_kwargs=dict(PERF_VAE_KWARGS))
    perf.fit(2, train, batch_size=128)
    torch.cuda.synchronize()
    k6_fit = _launches()["batchnorm"]
    pmig, pmse = perf.evaluate(valid, batch_size=128)
    torch.cuda.synchronize()
    lp = _launches()
    bns = _bn_layers(perf.model)
    if not (math.isfinite(pmig) and math.isfinite(pmse)) or \
            lp["clear_latent_fwdgrad"] != perf.train_step.step or \
            k6_fit != 4 * bns * perf.train_step.step or \
            lp["batchnorm"] - k6_fit != bns * n_eval:
        fail(f"perf mode: MIG {pmig}, MSE {pmse}, launches {lp}, K6 {k6_fit} "
             f"in the fit")
    for k in (*REPLACES, "batchnorm"):
        total[k] += lp[k]
    print(f"[sixty-four] perf mode (bf16, fused heads): fit + evaluate "
          f"{time.perf_counter() - t0:.2f} s, MIG {pmig:.4f}, MSE "
          f"{pmse:.3f}; launches {lp}")

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
        if not launches.pop("batchnorm") or any(launches.values()):
            fail(f"{name}: the unfused zoo launched {launches}, or no K6")
        summary = _check_result64(name, os.path.join(out, fname), names)
        print(f"[sixty-four] {name} {' '.join(args)}: {secs:.2f} s, "
              f"{len(names)} entries; {summary}; {gpu}")
    print(f"[sixty-four] whole phase {time.perf_counter() - t_phase:.2f} s; "
          f"launches on its fused fits and evaluations {total}")
    return total


def _demo_run(args, out_dir):
    """One ``demo.main`` call on the card, its launch counts zeroed just
    before and read just after, its fit timed; returns (result, seconds,
    fit seconds, {kernel: launches})."""
    from clearvae_torch.experiments import demo as DEMO
    from clearvae_torch.train import trainers as TR

    rec = _Recorder()
    rec.wrap(TR.TrainerCore, "fit", "fit")
    _zero_launches()
    t0 = time.perf_counter()
    try:
        r = DEMO.main(args + DEMO_COMMON + ["--out", out_dir])
        torch.cuda.synchronize()
    finally:
        rec.restore()
    return (r, time.perf_counter() - t0, rec.seconds("fit"),
            _launches())


def _check_demo(tag, args, r, launches, out_dir, missing):
    """Finite gMIG, MSE and grids, the artifact files written, no fused-loss
    kernel launched (demo's trainers are unfused), and K3 exactly once a
    chunk of the styled train and validation halves (none on the other
    sets, which come styled)."""
    from clearvae_torch.ops.corruptions import EXPERIMENT_STYLES

    model = args[args.index("--model") + 1]
    dataset = args[args.index("--dataset") + 1]
    n_total = int(args[args.index("--n_total") + 1])
    if not (math.isfinite(r["mig"]) and math.isfinite(r["mse"])):
        fail(f"{tag}: gMIG {r['mig']}, MSE {r['mse']}")
    for g in (r["swap"], *r["interp"]):
        if not (np.isfinite(g).all() and 0 <= g.min() and g.max() <= 1):
            fail(f"{tag}: a grid is not finite or leaves [0, 1]")
    names = ["swapping", "interp-style", "interp-content"]
    if not missing:
        names += ["tsne-muc-by-class", "tsne-muc-by-style",
                  "tsne-mus-by-style", "tsne-mus-by-class"]
    for name in names:
        path = os.path.join(out_dir, f"{model}-{name}.png")
        if not os.path.isfile(path) or os.path.getsize(path) == 0:
            fail(f"{tag}: {path} was not written")
    n_train = int(0.85 * n_total)
    want = 0 if dataset != "styled" else sum(
        k3_launches_expected(EXPERIMENT_STYLES, chunk_batches(n, 512))
        for n in (n_train, n_total - n_train))
    if launches["style_batch"] != want:
        fail(f"{tag}: K3 launched {launches['style_batch']} times; the "
             f"chunks of its styled halves make {want}")
    fused = {k: launches[k] for k in REPLACES if launches[k]}
    if fused:
        fail(f"{tag}: the unfused trainer launched {fused}")


def _child_precision(here, out_dir):
    """``demo.main`` in a child process that sets nothing itself (the lock
    skipped by its escape hatch: this process holds it); returns the two
    TF32 flags before and after ``main``."""
    code = (
        "import json, sys, torch; sys.path.insert(0, sys.argv[1]); "
        "from clearvae_torch.experiments import demo; "
        "flags = lambda: [torch.backends.cudnn.allow_tf32, "
        "torch.backends.cuda.matmul.allow_tf32]; before = flags(); "
        "demo.main(['--n_total', '1024', '--epochs', '1', '--device', "
        "'cuda', '--out', sys.argv[2]]); "
        "print(json.dumps({'before': before, 'after': flags()}))")
    env = {**os.environ, "CLEARVAE_TORCH_NO_LOCK": "1"}
    r = subprocess.run([sys.executable, "-c", code, here, out_dir], env=env,
                       capture_output=True, text=True, timeout=300)
    if r.returncode != 0:
        fail(f"the child demo run failed: {r.stderr[-2000:]}")
    return json.loads(r.stdout.strip().splitlines()[-1])


def _child_lock(here):
    """A child process that asks for the GPU lock without the escape hatch:
    (exit code, its stderr)."""
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "from clearvae_torch.utils.lock import acquire_gpu_lock; "
            "acquire_gpu_lock(); print('acquired')")
    env = {k: v for k, v in os.environ.items() if k != "CLEARVAE_TORCH_NO_LOCK"}
    r = subprocess.run([sys.executable, "-c", code, here], env=env,
                       capture_output=True, text=True, timeout=120)
    return r.returncode, r.stderr.strip()


def phase_artifacts(gpu, here):
    """The qualitative-artifact path on the card (see the module
    docstring); returns {kernel: launches} summed over its in-process runs,
    each counted from zero just before it and read just after."""
    import copy
    import shutil

    from clearvae_torch.experiments import analyze as ANALYZE
    from clearvae_torch.experiments import illustrate as ILLUSTRATE
    from clearvae_torch.experiments import mi_simulation as MISIM
    from clearvae_torch.ops.kernels import fused_loss as FL
    from clearvae_torch.ops.kernels import style as K3
    from clearvae_torch.ops.kernels import threefry as K4
    from clearvae_torch.utils import lock as LOCK
    from clearvae_torch.utils import visual as V

    t_phase = time.perf_counter()
    out_root = os.path.join(here, ".runs", "chip_smoke_artifacts")
    shutil.rmtree(out_root, ignore_errors=True)
    total = {k: 0 for k in COUNTED}
    missing = V.missing_packages("sklearn", "matplotlib")
    if "sklearn" in missing:
        print("[artifacts] tsne_plot not run: sklearn is not installed on "
              "this machine")
    if "matplotlib" in missing:
        print("[artifacts] matplotlib is not installed on this machine: the "
              "t-SNE, MI and box plots are not drawn (every grid and trace "
              "is still computed and checked)")

    # 1. demo at the reference depth, then the other models and sets
    for i, args in enumerate([DEMO_REF] + DEMO_SHORT):
        tag = "[artifacts] demo " + " ".join(args)
        out = os.path.join(out_root, f"demo{i}")
        r, secs, fit_s, launches = _demo_run(args, out)
        _check_demo(tag, args, r, launches, out, missing)
        for k in total:
            total[k] += launches[k]
        t = r["trainer"]
        steps = t.train_step.step
        print(f"{tag}: {secs:.2f} s, fit {fit_s:.2f} s ({steps} graphed "
              f"steps with their validations), gMIG {r['mig']:.4f}, MSE {r['mse']:.3f}, K3 "
              f"{launches['style_batch']}; {gpu}")
        if i == 0:
            if steps != DEMO_REF_STEPS:
                fail(f"{tag}: {steps} train steps, not {DEMO_REF_STEPS}")
            # the decode holds on the card: the same weights on the CPU
            cpu = V.make_decode_fn(copy.deepcopy(t.model).cpu())
            zh = r["z"].shape[1] // 2
            z, sel = r["z"].cpu(), r["sel"]
            swap = V.feature_swapping_plot(z[sel, :zh], z[sel, zh:],
                                           r["x"][sel], cpu)
            interp = V.interpolation_plot(r["x"], z, cpu, z_dim=zh,
                                          sample_size=8)
            errs = [float(np.abs(a - b).max()) for a, b in
                    zip((r["swap"], *r["interp"]), (swap, *interp))]
            if max(errs) > DECODE_TOL:
                fail(f"{tag}: card decode vs CPU decode max abs "
                     f"{max(errs)} (swap, style, content: {errs})")
            print(f"[artifacts] card decode == CPU decode of the same "
                  f"weights: max abs {errs[0]:.3g} (swap grid), "
                  f"{errs[1]:.3g} / {errs[2]:.3g} (interpolation strips; "
                  f"bar {DECODE_TOL})")

    # 2. fp32 in a clean child; the lock refuses a second holder
    t0 = time.perf_counter()
    flags = _child_precision(here, os.path.join(out_root, "child"))
    if flags["after"] != [False, False]:
        fail(f"a runner left TF32 on in a clean child process: {flags}")
    print(f"[artifacts] clean child ({time.perf_counter() - t0:.2f} s): "
          f"(cudnn, matmul) allow_tf32 {flags['before']} before demo.main, "
          f"{flags['after']} after")
    if not LOCK.acquire_gpu_lock():         # held since main's start
        fail("this process does not hold the GPU lock")
    t0 = time.perf_counter()
    code, err = _child_lock(here)
    if code == 0 or f"'pid': {os.getpid()}" not in err:
        fail(f"a second lock holder was not refused by name: exit {code}, "
             f"{err[-500:]}")
    print(f"[artifacts] second lock holder refused (exit {code}, "
          f"{time.perf_counter() - t0:.2f} s): {err.splitlines()[-1][:160]}")

    # 3. illustrate: its three grids styled on the card
    _zero_launches()
    t0 = time.perf_counter()
    grids = ILLUSTRATE.main(["--device", "cuda", "--seed", "0", "--out",
                             os.path.join(out_root, "illustrate")])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    k3 = K3.LAUNCHES["style"]
    total["style_batch"] += k3
    total["threefry"] += K4.LAUNCHES["threefry"]
    total["glass"] += _launches()["glass"]
    if k3 == 0 or any(FL.LAUNCHES.values()):
        fail(f"illustrate launched K3 {k3} times, fused losses {FL.LAUNCHES}")
    for name, g in grids.items():
        if not (np.isfinite(g).all() and 0 <= g.min() and g.max() <= 1):
            fail(f"illustrate's {name} grid is not finite or leaves [0, 1]")
    print(f"[artifacts] illustrate: {secs:.2f} s, grids "
          f"{ {k: g.shape for k, g in grids.items()} }, K3 {k3}")

    # 4. the MI simulation
    t0 = time.perf_counter()
    ps, snn = MISIM.main(["--reps", "3", "--device", "cuda", "--out",
                          os.path.join(out_root, "mi-sim")])
    secs = time.perf_counter() - t0
    if not all(np.isfinite(v).all() for v in (*ps.values(), *snn.values())):
        fail("a trace of the MI simulation is not finite")
    falls = {}
    for k, v in ps.items():     # std 1 → 4, three reps a std
        v = np.asarray(v).reshape(-1, 3).mean(1)
        falls[k] = (float(v[0]), float(v[-1]))
        if not v[0] > v[-1]:
            fail(f"PS-SNN sweep: {k} does not fall with the std: {v}")
    print(f"[artifacts] mi_simulation --reps 3: {secs:.2f} s; PS-SNN sweep, "
          f"mean at std 1 -> 4: "
          + ", ".join(f"{k} {a:.4f} -> {b:.4f}" for k, (a, b) in falls.items()))

    # 5. analyze over phase 4's result JSON
    res_dir = os.path.join(here, ".runs", "chip_smoke_downstream")
    df, rel = ANALYZE.main(["--result_dir", res_dir, "--markdown", "--paired",
                            "--out", os.path.join(out_root, "analyze")])
    if len(df) != len(ZOO) or len(rel) != len(ZOO) or not np.isfinite(
            rel[["rel_acc", "rel_map", "rel_mauc"]].to_numpy()).all():
        fail(f"analyze: {len(df)} rows, relative frame {rel}")
    print(f"[artifacts] analyze: {len(df)} rows of phase 4's JSON")
    print(f"[artifacts] whole phase {time.perf_counter() - t_phase:.2f} s; "
          f"launches {total}")
    return total


def _styles_on_the_card(x_cpu, keys_cpu):
    """Every style of ``ALL_CORRUPTIONS`` at its default severity on a batch
    on the card against the same batch and keys on the CPU, at CORR_BARS;
    returns {name: (device ms of one call and its kernels, from the
    profiler; max abs and share of pixels beyond the bar against the
    CPU)}. The checked call is the profiled one (made again, up to 3
    times and with more calls a window, where the profiler recorded none
    of its kernels): a profiler
    window costs ~0.9 s here, and one call of every style launches
    ~31,000 kernels."""
    from clearvae_torch.ops import corruptions as TC
    from clearvae_torch.ops.kernels import style as K3

    x = x_cpu.cuda()
    keys = tuple(k.cuda() for k in keys_cpu)
    times, cpu_s = {}, 0.0
    for name in TC.ALL_CORRUPTIONS:
        fn = TC.CORRUPTION_FNS[name]
        # a window of one K3 style's call (two kernels) came back empty
        # three times running late in the script: those take 50 calls; so
        # did one of jpeg_compression's once: an empty window is made again
        # with 10 calls, then 50
        for calls in ((50,) * 3 if name in K3.STYLE_CODES else (1, 10, 50)):
            with profile_window() as prof:
                for _ in range(calls):
                    out = fn(x, keys)
                torch.cuda.synchronize()
            counts, us, _ = device_kernels(prof)
            if counts:
                break
        else:
            fail(f"{name}: the profiler recorded no kernel in 3 windows")
        got = out.cpu().double()
        t0 = time.perf_counter()
        ref = fn(x_cpu, keys_cpu).double()
        cpu_s += time.perf_counter() - t0
        atol, share = CORR_BARS.get(name, CORR_DEFAULT_BAR)
        off = float(((got - ref).abs() > atol).double().mean())
        if not bool(torch.isfinite(got).all()) or off > share:
            fail(f"{name} on the card vs the CPU: {off:.5f} of pixels beyond "
                 f"{atol} (bar {share}), max abs "
                 f"{float((got - ref).abs().max()):.3e}")
        times[name] = (sum(us.values()) / 1e3 / calls,
                       sum(counts.values()) / calls,
                       float((got - ref).abs().max()), off)
    return times, cpu_s


def phase_corruptions(gpu):
    """Phase 10: the MNIST-C corruption library on the card (see the module
    docstring); returns {kernel: launches} of the styled fused fit and its
    evaluation, each counted from zero just before it and read just
    after."""
    from clearvae_torch.data.mnist import synthetic_mnist
    from clearvae_torch.data.styled import (StyledDataset, make_styled_mnist,
                                            train_valid_split)
    from clearvae_torch.ops import corruptions as TC
    from clearvae_torch.ops import prng as P
    from clearvae_torch.ops.kernels import threefry as K4
    from clearvae_torch.train.factories import get_clearvae_trainer

    t_phase = time.perf_counter()
    imgs, labels = synthetic_mnist(CORR_N, seed=0)
    # (a) each style: a B = 128 batch on the card against the CPU
    ids = torch.arange(128)
    keys_cpu = P.fold_in(P.key(0, (128,)), ids)
    t0 = time.perf_counter()
    times, cpu_s = _styles_on_the_card(torch.as_tensor(imgs[:128]), keys_cpu)
    t_styles = time.perf_counter() - t0
    print(f"[corruptions] {gpu}: all {len(times)} styles at their default "
          f"severities, B=128, equal to the CPU's within the CPU tests' bars "
          f"({t_styles:.2f} s, {cpu_s:.2f} s of it the CPU's); device time "
          f"of one call, from the profiler:")
    for name, (ms, n_k, err, off) in sorted(times.items(),
                                            key=lambda kv: -kv[1][0]):
        print(f"[corruptions]   {name:18s} {ms:9.4f} ms  {n_k:7.0f} kernels  "
              f"max abs vs CPU {err:.2e}, share beyond bar {off:.5f}")

    # (b) a full-width graphed fit on MNIST-C's 16 styles, uniform
    styles = tuple((name, None) for name in TC.CORRUPTIONS)
    ds = make_styled_mnist(imgs, labels, styles=styles, seed=0)
    train_ds, valid_ds = train_valid_split(ds, seed=0)
    kw = {**ADV_COMMON, "ps": True}
    P.unfinished("cuda").zero_()
    t0 = time.perf_counter()
    trainer, launches = _graph_fit(get_clearvae_trainer, kw, train_ds,
                                   CORR_EPOCHS, style_on_device=True)
    t_fit = time.perf_counter() - t0
    steps = trainer.train_step.step
    n_batches = CORR_EPOCHS * (len(train_ds) // 128)
    # K4: the dataset's draws, then every threefry pass of each step; K5
    # once a step (glass_blur)
    want = {"clear_latent_fwdgrad": steps, "clear_latent_bwd": steps,
            "snn_fwd": 0, "snn_bwd": 0,
            "style_batch": k3_launches_expected(styles, [range(128)] * steps),
            "threefry": K4_DRAWS_PASSES + K4_BATCH_PASSES * steps,
            "glass": steps, "batchnorm": 4 * _bn_layers(trainer.model) * steps}
    if steps != n_batches or launches != want or want["style_batch"] != 2 * steps:
        fail(f"MNIST-C styled fit: {steps} updates ({n_batches} batches), "
             f"launches by replay {launches}, expected {want} (K3 twice a "
             f"batch: scale@3 and brightness@5; K4 {K4_BATCH_PASSES} a batch "
             f"after the draws' {K4_DRAWS_PASSES}; K5 once a batch)")
    hist = np.concatenate([h["loss"] for h in trainer.history])
    if not np.isfinite(hist).all():
        fail("MNIST-C styled fit: non-finite loss")
    total = dict(launches)
    # the fused CLEAR trainer's graphed evaluate, styled on the card
    _zero_launches()
    t0 = time.perf_counter()
    mig, mse = trainer.evaluate(valid_ds, batch_size=128, style_on_device=True)
    torch.cuda.synchronize()
    t_eval = time.perf_counter() - t0
    n_eval = -(-len(valid_ds) // 128)
    ev = _launches()
    if (ev["style_batch"] != 2 * n_eval or ev["snn_fwd"] != 2 * n_eval
            or ev["threefry"] != K4_DRAWS_PASSES + K4_BATCH_PASSES * n_eval
            or ev["glass"] != n_eval
            or not (math.isfinite(mig) and math.isfinite(mse))):
        fail(f"MNIST-C styled evaluate: launches {ev} for {n_eval} batches "
             f"(K3 and K2f twice a batch, K4 {K4_BATCH_PASSES} a batch after "
             f"the draws' {K4_DRAWS_PASSES}, K5 once a batch), MIG {mig}, "
             f"MSE {mse}")
    for k, v in ev.items():
        total[k] += v
    # (e) no Poisson draw of shot_noise was cut by its loop cap
    P.check_poisson("cuda")
    unfinished = int(P.unfinished("cuda"))
    print(f"[corruptions] MNIST-C Styled-MNIST ({len(train_ds)} train, "
          f"{len(valid_ds)} valid; styles {[n for n, _ in styles]}): graphed "
          f"fit {steps} updates in {t_fit:.2f} s (warm-up and capture "
          f"included), loss {hist[0]:.2f} -> {hist[-1]:.2f}; launches by "
          f"replay {launches}; graphed evaluate {t_eval:.2f} s: MIG "
          f"{mig:.4f}, MSE {mse:.3f}, launches {ev}; Poisson draws cut by "
          f"their cap: {unfinished}")

    # (d) a few graphed steps against the eager loop, bit for bit
    t0 = time.perf_counter()
    n = CORR_EAGER_N
    sub = StyledDataset(train_ds.images[:n], train_ds.labels[:n],
                        train_ds.style_idx[:n], styles, train_ds.seed,
                        train_ds.sample_ids[:n])
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        eager, le = _graph_fit(get_clearvae_trainer, kw, sub, 1,
                               use_scan=False, style_on_device=True)
        graphed, lg = _graph_fit(get_clearvae_trainer, kw, sub, 1,
                                 use_scan=True, style_on_device=True)
    finally:
        torch.backends.cudnn.deterministic = det
    diff = _same_training("MNIST-C styled fit graphed vs eager", eager, graphed)
    # the eager fit made sub's draws; the graphed one finds them made
    if le != {**lg, "threefry": lg["threefry"] + K4_DRAWS_PASSES} or \
            lg["threefry"] != K4_BATCH_PASSES * (n // 128) or \
            lg["glass"] != n // 128 or graphed.train_step.step != n // 128:
        fail(f"MNIST-C styled fit: launches eager {le}, graphed {lg}")
    print(f"[corruptions] {n // 128} graphed steps == eager: histories and "
          f"state equal, max abs diff {diff:.1e} (cudnn.deterministic); "
          f"launches {lg}; {time.perf_counter() - t0:.2f} s")

    # (f) K4 and K5 by replay alone: replays of the fit's own captured step
    ep = trainer._graphs[(id(train_ds), 128, True)][1]
    rows = torch.as_tensor(np.random.RandomState(1).permutation(len(train_ds))
                           [:10 * 128].reshape(10, 128), device="cuda")
    _zero_launches()
    ep.run(rows)
    torch.cuda.synchronize()
    if K4.LAUNCHES["threefry"] != K4_BATCH_PASSES * len(rows):
        fail(f"K4 launched {K4.LAUNCHES['threefry']} times by replay in "
             f"{len(rows)} MNIST-C replays, not {K4_BATCH_PASSES} a step")
    k5 = _launches()["glass"]
    if k5 != len(rows):
        fail(f"K5 launched {k5} times by replay in {len(rows)} MNIST-C "
             f"replays, not once a step")
    print(f"[corruptions] K4 by replay: {K4.LAUNCHES['threefry']} in "
          f"{len(rows)} replays of the MNIST-C step ({K4_BATCH_PASSES} a "
          f"step); K5 {k5} (one a step)")
    # (e) the counter that (b) read is the one the draws write: poisson's
    # loop sized for rates below the ones drawn cuts draws on the card, and
    # check_poisson and a fit must then raise
    cut_keys = (keys_cpu[0][:8].cuda(), keys_cpu[1][:8].cuda())
    P.poisson(cut_keys, torch.full((8, 28, 28), 9.5, device="cuda"), 0.0)
    planted = int(P.unfinished("cuda"))
    raised = []
    for what, call in (
            ("check_poisson", lambda: P.check_poisson("cuda")),
            ("fit", lambda: eager.fit(1, sub, batch_size=128, use_scan=False,
                                      style_on_device=True))):
        try:
            call()
        except RuntimeError as e:
            if "did not finish" in str(e):
                raised.append(what)
    P.unfinished("cuda").zero_()
    P.check_poisson("cuda")
    if planted < 0.2 * 8 * 28 * 28 or raised != ["check_poisson", "fit"]:
        fail(f"Poisson cap: {planted} draws cut on the card, raised in "
             f"{raised} (check_poisson and fit must raise)")
    print(f"[corruptions] Poisson cap: {planted} draws cut on the card by a "
          f"10-turn loop; check_poisson('cuda') and fit raised")
    t_all = time.perf_counter() - t_phase
    print(f"[corruptions] whole phase {t_all:.2f} s; launches {total}")
    return total


PAR_OTHER_N = 1024       # images of the CNN, LAM and VAE64 mesh fits
# VAE64's DP(2) gradients against one rank's, tensor by tensor: the L2
# norm of the difference within this share of the single rank's norm
# (plus 1e-5 of the largest entry an element). Element by element they
# cannot be held at PAR_STEP_RTOL: some ReLU input lies within float
# noise of zero and changes sides between any two orders of the float
# sums (B = 128: the single device on 1 and on 4 CPU threads gives
# gradients up to 0.098 apart, DP(2) sits on one of the two; DP(2)
# against one rank 0.27 on the card, of a largest entry ~236). A loss
# share off by the data size moves every tensor by 1/2 of its norm.
PAR_V64_L2_RTOL = 1e-2
PAR_LOSS_RTOL = 2e-4     # tests/test_torch_parallel.py's fit bar
PAR_HORIZON = 8          # over that file's fit: 2 epochs of 4 steps
PAR_PARAM_ATOL = 8e-3    # and the fit's parameters after them
PAR_STEP_RTOL = 1e-5     # and its step bar (loss, gradients)


def _collectives_per_step(tc: bool, tp: bool) -> int:
    """All-reduces a train step issues on a mesh: the VAE's 7 BatchNorms
    twice (forward and backward), a gathered operand twice, the metrics
    once, each module's gradients once; on a 2-D mesh one more a module
    (the model-axis all-gather of the updated shards). CLEAR gathers its
    heads; CLEAR-TC the heads (c_loss) and z in phase 1, then runs a
    no-grad forward (7) and gathers z2 in phase 2 for the classifier."""
    if not tc:
        return 2 * 7 + 2 + 1 + 1 + (1 if tp else 0)
    return 2 * 7 + 2 + 2 + 1 + 7 + 1 + 1 + 1 + (2 if tp else 0)


def _par_fit(factory, kw, train_ds, epochs, **fit_kw):
    """``_graph_fit`` with the mesh's collectives counted too."""
    from clearvae_torch.parallel import mesh as PM

    PM.reset_collectives()
    trainer, launches = _graph_fit(factory, kw, train_ds, epochs, **fit_kw)
    return trainer, {**launches, **PM.COLLECTIVES}


# the biases ahead of a BatchNorm: their gradient is analytically zero,
# float noise that Adam turns into steps of ±lr
PRE_BN_BIASES = ("encoder.convs.", "decoder.dense.", "decoder.convts.")


def _pre_bn_bias(name: str) -> bool:
    return name.startswith(PRE_BN_BIASES) and name.endswith(".bias")


def _param_diff(a, b, leave_out=lambda name: False) -> float:
    """Max abs difference of two trainers' model parameters, without the
    BatchNorm buffers and the names ``leave_out`` picks."""
    sa, sb = a.model.state_dict(), b.model.state_dict()
    return max(float((sb[k].double() - v.double()).abs().max())
               for k, v in sa.items()
               if "running" not in k and not leave_out(k))


def _horizon_params(tag, kw, fit_kw, ds, mesh, base=None):
    """Eager fits of one epoch of PAR_HORIZON batches of ``ds`` (the CPU
    tests' horizon: later steps amplify float differences chaotically,
    the fused and the unfused flagship end 2 epochs ~1 % apart), alone
    (``base``, made when None) and on ``mesh``: fails unless the mesh
    fit's parameters are within PAR_PARAM_ATOL and its per-batch losses
    within PAR_LOSS_RTOL of the single fit's. With graphed = eager at 0.0
    on the mesh, this holds the graphed mesh fit to the single device.
    Returns (base, max parameter diff, the same without the biases ahead
    of a BatchNorm, max rel loss diff)."""
    from clearvae_torch.train.factories import get_clearvae_trainer

    if base is None:
        base = _graph_fit(get_clearvae_trainer, kw, ds, 1, use_scan=False,
                          **fit_kw)[0]
    other = _graph_fit(get_clearvae_trainer, {**kw, "mesh": mesh}, ds, 1,
                       use_scan=False, **fit_kw)[0]
    la, lb = base.history[0]["loss"], other.history[0]["loss"]
    rel = float((np.abs(lb - la) / np.abs(la)).max())
    worst = _param_diff(base, other)
    rest = _param_diff(base, other, _pre_bn_bias)
    if (len(la) != PAR_HORIZON or len(lb) != PAR_HORIZON
            or worst > PAR_PARAM_ATOL or rel > PAR_LOSS_RTOL):
        fail(f"{tag}: after {len(lb)} steps (of {PAR_HORIZON}) the "
             f"parameters are {worst:.3e} (bar {PAR_PARAM_ATOL}) and the "
             f"losses {rel:.3e} (bar {PAR_LOSS_RTOL}) from the single fit's")
    return base, worst, rest, rel


def _data64(n: int):
    """``n`` uniform 64×64×3 images and labels 0..9 from ``RandomState(0)``,
    as the repository ``bench.py`` makes its 64×64 data."""
    from clearvae_torch.data.common import ArrayDataset

    rs = np.random.RandomState(0)
    images = rs.rand(n, 64, 64, 3).astype(np.float32)
    labels = rs.randint(0, 10, n)
    return ArrayDataset(images, labels, np.zeros(n, np.int64))


def _dp_inputs(train_ds):
    """Phase 11 (b)'s batches: the first 128 styled images of phase 3's
    data and its labels, with numpy noise for one CLEAR step and one
    CLEAR-TC step and the uniforms of one LAM-CNN step's shuffle; 128
    images of ``_data64``, with the noise of one VAE64 CLEAR step
    (global shapes: each rank slices its rows)."""
    rs = np.random.RandomState(11)

    def normal(*shape):
        return torch.as_tensor(rs.randn(*shape).astype(np.float32))

    x = train_ds.materialize(torch.device("cuda"))[:128].cpu()[..., None]
    ds64 = _data64(128)
    return {"x": x, "label": torch.as_tensor(np.asarray(train_ds.labels[:128])),
            "eps": normal(2, 128, 8),
            "noise_tc": (normal(2, 128, 8), normal(2, 128, 8)),
            "u": torch.as_tensor(rs.rand(2, 128).astype(np.float32)),
            "x64": torch.as_tensor(ds64.images),
            "label64": torch.as_tensor(np.asarray(ds64.labels)),
            "eps64": normal(2, 128, 32)}


def _record_grads(optimizer, out: list) -> None:
    """Make ``optimizer`` append the gradients it is about to apply (on
    the CPU, in its parameters' order) to ``out`` at each step: under a
    mesh, the gradients summed over the data axis."""
    update = optimizer.step

    def step_and_record(*a, **k):
        out.append([p.grad.detach().cpu() for group in optimizer.param_groups
                    for p in group["params"] if p.grad is not None])
        return update(*a, **k)
    optimizer.step = step_and_record


def _dp_steps(inp, mesh):
    """One eager step of the fused CLEAR, the fused CLEAR-TC, the LAM-CNN
    and the fused VAE64 CLEAR trainer (from their factories, seed 0, on
    the card) on ``inp``, on ``mesh`` (this rank's rows) or alone: {name:
    (metrics, model state on the CPU, the gradients each optimizer
    applied)}."""
    from clearvae_torch.train.factories import (get_cleartcvae_trainer,
                                                get_clearvae_trainer,
                                                get_lamcnn_trainer)

    out = {}
    dev = torch.device("cuda")
    lam = dict(n_class=10, lam_coef=1e-3, seed=0, device="cuda")
    v64 = {**SIXTY_FOUR, "ps": True}
    for name, factory, kw, sfx, noise in (
            ("clear", get_clearvae_trainer, {**ADV_COMMON, "ps": True}, "",
             inp["eps"]),
            ("clear-tc", get_cleartcvae_trainer,
             {**ADV_COMMON, "la": 1, "factor_cls_lr": 1e-4}, "",
             inp["noise_tc"]),
            ("lam-cnn", get_lamcnn_trainer, lam, "", inp["u"]),
            ("vae64-clear", get_clearvae_trainer, v64, "64", inp["eps64"])):
        t = factory(**{**kw, "mesh": mesh})
        x, label = inp["x" + sfx].to(dev), inp["label" + sfx].to(dev)
        noise = (tuple(n.to(dev) for n in noise) if isinstance(noise, tuple)
                 else noise.to(dev))
        grads = []
        for opt in (t.optimizer, getattr(t, "factor_optimizer", None)):
            if opt is not None:
                _record_grads(opt, grads)
        m = t.train_step(t.shard.rows(x), label, noise)
        torch.cuda.synchronize()
        out[name] = ({k: float(v) for k, v in m.items()},
                     {k: v.detach().cpu() for k, v in
                      t.model.state_dict().items()},
                     [g for gs in grads for g in gs])
    return out


def _dp_child(argv):
    """``chip_smoke.py --dp-child RANK PORT DIR``: rank RANK of phase 11
    (b)'s two gloo ranks on the one card."""
    import datetime

    import torch.distributed as dist

    from clearvae_torch.parallel import make_mesh
    from clearvae_torch.utils.cache import enable_compilation_cache

    enable_compilation_cache()   # fp32 as the parent (the lock: skipped)
    rank, port, d = int(argv[0]), int(argv[1]), argv[2]
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=2,
                            timeout=datetime.timedelta(seconds=180))
    try:
        inp = torch.load(os.path.join(d, "inputs.pt"), weights_only=True)
        out = _dp_steps(inp, make_mesh(2, device_type="cuda"))
        torch.save(out, os.path.join(d, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _nccl_kernels_in_replay(trainer):
    """(NCCL kernels, all kernels) in one replay of ``trainer``'s captured
    train step."""
    counts = _replay_kernels(trainer)
    return (sum(v for k, v in counts.items() if "nccl" in k.lower()),
            sum(counts.values()))


def _phase_parallel_one_rank(gpu, train_ds, valid_ds, total):
    """Phase 11 (a): one rank over NCCL (whose process group the caller
    holds), on make_mesh(1) and on make_mesh2d(1, 1); adds the graphed
    fits' and evaluations' launches to ``total``."""
    from clearvae_torch.data.styled import StyledDataset
    from clearvae_torch.ops.kernels import fused_loss as FL
    from clearvae_torch.parallel import make_mesh, make_mesh2d
    from clearvae_torch.parallel import mesh as PM
    from clearvae_torch.train.factories import (get_cleartcvae_trainer,
                                                get_clearvae_trainer)

    # name: (factory kwargs, fit kwargs); every fit is 1 epoch (63 steps),
    # to hold the phase near a minute
    runs = {"clear fused": (dict(ps=True), {}),
            "clear styled unfused": (dict(ps=True,
                                          hyperparameter={"fused": False}),
                                     {"style_on_device": True})}
    det = torch.backends.cudnn.deterministic
    n_h = PAR_HORIZON * 128
    horizon_ds = StyledDataset(train_ds.images[:n_h], train_ds.labels[:n_h],
                               train_ds.style_idx[:n_h], train_ds.styles,
                               train_ds.seed, train_ds.sample_ids[:n_h])
    horizon_base = {}
    for mesh_name, make in (("make_mesh(1)", lambda: make_mesh(1)),
                            ("make_mesh2d(1, 1)", lambda: make_mesh2d(1, 1))):
        mesh = make()
        tp = mesh_name.startswith("make_mesh2d")
        for name, (kw, fit_kw) in runs.items():
            t0 = time.perf_counter()
            torch.backends.cudnn.deterministic = True
            try:
                kw = {**ADV_COMMON, **kw, "mesh": mesh}
                eager, le = _par_fit(get_clearvae_trainer, kw, train_ds, 1,
                                     use_scan=False, **fit_kw)
                graphed, lg = _par_fit(get_clearvae_trainer, kw, train_ds, 1,
                                       use_scan=True, **fit_kw)
                horizon_base[name], h_params, h_rest, h_loss = _horizon_params(
                    f"{mesh_name} {name}", {**ADV_COMMON, **runs[name][0]},
                    fit_kw, horizon_ds, mesh, horizon_base.get(name))
            finally:
                torch.backends.cudnn.deterministic = det
            n = graphed.train_step.step
            diff = _same_training(f"{mesh_name} {name} graphed vs eager",
                                  eager, graphed)
            fused = "fused" in name and "unfused" not in name
            # the graphed fit adds the warm-up's one collective
            want = {"clear_latent_fwdgrad": n * fused,
                    "clear_latent_bwd": n * fused, "snn_fwd": 0,
                    "snn_bwd": 0,
                    "style_batch": n * bool(fit_kw), "threefry": 0,
                    "glass": 0, "batchnorm": 0,
                    "all_reduce": n * _collectives_per_step(False, tp)}
            if n != ADV_STEPS // 2 or le != want or lg != {
                    **want, "all_reduce": want["all_reduce"] + 1}:
                fail(f"{mesh_name} {name}: {n} updates; launches eager "
                     f"{le}, graphed (replays) {lg}; expected {want}")
            for k in total:
                total[k] += lg[k]
            print(f"[parallel] {mesh_name} {name}: {n} graphed updates "
                  f"== eager, max abs diff {diff:.3e} "
                  f"(cudnn.deterministic); eager fits of {PAR_HORIZON} "
                  f"steps on the mesh and alone: parameters {h_params:.3e} "
                  f"apart (bar {PAR_PARAM_ATOL}; {h_rest:.3e} without the "
                  f"biases ahead of BatchNorm), losses {h_loss:.3e} rel "
                  f"(bar {PAR_LOSS_RTOL}); "
                  f"launches by replay {lg} "
                  f"({time.perf_counter() - t0:.2f} s)")
            if fused and not tp:
                nccl, kernels = _nccl_kernels_in_replay(graphed)
                print(f"[parallel] {mesh_name} {name}: one replay of the "
                      f"captured step: {kernels} kernels, {nccl} of "
                      f"them NCCL's, for "
                      f"{_collectives_per_step(False, tp)} all-reduces "
                      f"captured (one rank: NCCL reduces in place "
                      f"without a kernel); {gpu}")
            if fused:
                FL.reset_launches()
                PM.reset_collectives()
                mig, mse = graphed.evaluate(valid_ds, batch_size=128)
                torch.cuda.synchronize()
                n_eval = -(-len(valid_ds) // 128)
                if (not (math.isfinite(mig) and math.isfinite(mse))
                        or FL.LAUNCHES["snn_fwd"] != 2 * n_eval):
                    fail(f"{mesh_name} evaluate: MIG {mig}, MSE {mse}, "
                         f"K2f {FL.LAUNCHES['snn_fwd']} for {n_eval} "
                         f"batches")
                total["snn_fwd"] += FL.LAUNCHES["snn_fwd"]
                print(f"[parallel] {mesh_name} graphed evaluate: MIG "
                      f"{mig:.4f}, MSE {mse:.3f}, K2f "
                      f"{FL.LAUNCHES['snn_fwd']} for {n_eval} batches, "
                      f"{PM.COLLECTIVES['all_reduce']} all-reduces")
        t0 = time.perf_counter()
        tc, lt = _par_fit(get_cleartcvae_trainer,
                          {**ADV_COMMON, "la": 1, "factor_cls_lr": 1e-4,
                           "mesh": mesh}, train_ds, 1, use_scan=True)
        n = tc.train_step.step
        want = {"clear_latent_fwdgrad": 0, "clear_latent_bwd": 0,
                "snn_fwd": n, "snn_bwd": n, "style_batch": 0, "threefry": 0,
                "glass": 0, "batchnorm": 0,
                "all_reduce": 1 + n * _collectives_per_step(True, tp)}
        if lt != want:
            fail(f"{mesh_name} clear-tc fused: launches by replay {lt}, "
                 f"expected {want}")
        for k in total:
            total[k] += lt[k]
        print(f"[parallel] {mesh_name} clear-tc fused: {n} graphed "
              f"updates, launches by replay {lt} "
              f"({time.perf_counter() - t0:.2f} s)")


def _bn_collectives(trainer, passes: int, gathers: int, tp: bool) -> int:
    """All-reduces a train step of ``trainer`` issues on a mesh: each
    BatchNorm of its model twice (forward and backward) in each of
    ``passes`` train-mode passes, ``gathers`` for its gathered operands
    (a gather with a gradient counts twice), the metrics and the
    gradients once each, and on a 2-D mesh the shards' all-gather."""
    from clearvae_torch.models.layers import BatchNorm

    bns = sum(isinstance(m, BatchNorm) for m in trainer.model.modules())
    return 2 * bns * passes + gathers + 2 + int(tp)


def _phase_parallel_other_models(train_ds):
    """Phase 11 (a), the other trainers on one NCCL rank (whose process
    group the caller holds): SimpleCNN, LAM-CNN (on make_mesh(1) and
    make_mesh2d(1, 1)), the styled SimpleCNN and VAE64 CLEAR at the 64×64
    runners' widths, each fit 1 epoch of PAR_OTHER_N images eagerly and
    graphed under ``cudnn.deterministic``: graphed = eager at 0.0, K1, K3
    and the all-reduces counted by replay, K1's <32, true> instance in a
    replay's trace for VAE64. Returns {kernel or "all_reduce": launches}
    of the graphed fits."""
    from clearvae_torch.data.styled import StyledDataset
    from clearvae_torch.parallel import make_mesh, make_mesh2d
    from clearvae_torch.train.factories import (get_clearvae_trainer,
                                                get_cnn_trainer,
                                                get_lamcnn_trainer)

    n = PAR_OTHER_N
    ds28 = StyledDataset(train_ds.images[:n], train_ds.labels[:n],
                         train_ds.style_idx[:n], train_ds.styles,
                         train_ds.seed, train_ds.sample_ids[:n])
    ds28.materialize(torch.device("cuda"))   # K3 here is not the fits'
    ds64 = _data64(n)
    cnn = dict(n_class=10, seed=0, verbose_period=10 ** 9, device="cuda")
    lam = {**cnn, "lam_coef": 1e-3}
    meshes = {"make_mesh(1)": make_mesh(1),
              "make_mesh2d(1, 1)": make_mesh2d(1, 1)}
    # tag: (mesh, factory, kwargs, data, fit kwargs, (passes, gathers))
    runs = {"SimpleCNN": ("make_mesh(1)", get_cnn_trainer, cnn, ds28, {},
                          (1, 0)),
            "LAM-CNN": ("make_mesh(1)", get_lamcnn_trainer, lam, ds28, {},
                        (2, 1)),
            "LAM-CNN 1 x 1": ("make_mesh2d(1, 1)", get_lamcnn_trainer, lam,
                              ds28, {}, (2, 1)),
            "styled SimpleCNN": ("make_mesh(1)", get_cnn_trainer, cnn, ds28,
                                 {"style_on_device": True}, (1, 0)),
            "VAE64 CLEAR": ("make_mesh(1)", get_clearvae_trainer,
                            {**SIXTY_FOUR, "ps": True}, ds64, {}, (1, 2))}
    det = torch.backends.cudnn.deterministic
    total = {k: 0 for k in (*COUNTED, "all_reduce")}
    for tag, (mesh_name, factory, kw, ds, fit_kw, (passes, gathers)) in \
            runs.items():
        t0 = time.perf_counter()
        kw = {**kw, "mesh": meshes[mesh_name]}
        torch.backends.cudnn.deterministic = True
        try:
            eager, le = _par_fit(factory, kw, ds, 1, use_scan=False, **fit_kw)
            graphed, lg = _par_fit(factory, kw, ds, 1, use_scan=True,
                                   **fit_kw)
        finally:
            torch.backends.cudnn.deterministic = det
        steps = graphed.train_step.step
        diff = _same_training(f"{mesh_name} {tag} graphed vs eager", eager,
                              graphed)
        vae = factory is get_clearvae_trainer
        want = {"clear_latent_fwdgrad": steps * vae,
                "clear_latent_bwd": steps * vae, "snn_fwd": 0, "snn_bwd": 0,
                "style_batch": steps * bool(fit_kw), "threefry": 0,
                "glass": 0, "batchnorm": 0,
                "all_reduce": steps * _bn_collectives(
                    graphed, passes, gathers, mesh_name != "make_mesh(1)")}
        # the graphed fit adds the warm-up's one collective
        if steps != n // 128 or le != want or lg != {
                **want, "all_reduce": want["all_reduce"] + 1}:
            fail(f"{mesh_name} {tag}: {steps} updates; launches eager {le}, "
                 f"graphed (replays) {lg}; expected {want}")
        for k in total:
            total[k] += lg[k]
        k1 = _k1_instance(_replay_kernels(graphed)) if vae else "-"
        print(f"[parallel] {mesh_name} {tag}: {steps} graphed updates == "
              f"eager, max abs diff {diff:.3e} (cudnn.deterministic); "
              f"launches by replay {lg}; K1 in a replay: {k1} "
              f"({time.perf_counter() - t0:.2f} s)")
    print(f"[parallel] launches by replay in the CNN, LAM and VAE64 mesh "
          f"fits: {total}")
    return total


# phase 11 (c): the root bench's 28×28 perf rows, each (batch, bfloat16
# conv stacks, the four latent heads in one Linear)
PERF28 = {"clear_28_bf16": (128, True, False),
          "clear_28_fusedheads": (128, False, True),
          "perf_mode_b2048_bf16": (2048, True, False),
          "perf_mode_b512_bf16_fusedheads": (512, True, True)}


def _phase_parallel_perf28(train_ds):
    """Phase 11 (c): the fused flagship CLEAR trainer in each form of
    ``PERF28``, without a mesh, fit 2 epochs graphed on phase 3's data (at
    B = 2,048 the three warm-up steps fill the first epoch and the second
    replays the captured step): K1 once a step each way by replay, no
    other kernel; returns {row: K1 forward launches}."""
    from clearvae_torch.train.factories import get_clearvae_trainer

    k1 = {}
    for row, (batch, bf16, fused_heads) in PERF28.items():
        vae = {"dtype": torch.bfloat16} if bf16 else {}
        vae.update({"fused_heads": True} if fused_heads else {})
        trainer = get_clearvae_trainer(**ADV_COMMON, ps=True, vae_kwargs=vae)
        _zero_launches()
        trainer.fit(2, train_ds, batch_size=batch)
        torch.cuda.synchronize()
        got, n = _launches(), trainer.train_step.step
        want = {k: 0 for k in COUNTED}
        want["clear_latent_fwdgrad"] = want["clear_latent_bwd"] = n
        want["batchnorm"] = 4 * _bn_layers(trainer.model) * n
        ep = trainer._graphs[(id(train_ds), batch, False)][1]
        if (n != 2 * (len(train_ds) // batch) or got != want
                or ep.graph is None or trainer.model.fused_heads != fused_heads
                or trainer.model.dtype != (torch.bfloat16 if bf16
                                           else torch.float32)):
            fail(f"{row}: {n} graphed updates at B={batch}, launches by "
                 f"replay {got}, expected {want}; captured "
                 f"{ep.graph is not None}")
        k1[row] = got["clear_latent_fwdgrad"]
        print(f"[parallel] {row} (B={batch}, {'bf16' if bf16 else 'fp32'}"
              f"{', fused heads' if fused_heads else ''}): {n} graphed "
              f"updates, K1 {k1[row]} each way by replay")
    return k1


def phase_parallel(gpu, train_ds, valid_ds, here):
    """Phase 11: data and tensor parallelism (see the module docstring);
    returns {kernel: launches} of the graphed fits and evaluations under
    the one-rank meshes, each counted from zero just before and read just
    after."""
    import shutil

    import torch.distributed as dist

    t_phase = time.perf_counter()
    total = {k: 0 for k in (*COUNTED, "all_reduce")}
    d = os.path.join(here, ".runs", "chip_smoke_parallel")
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    inp = _dp_inputs(train_ds)
    torch.save(inp, os.path.join(d, "inputs.pt"))
    port = _free_port()
    env = {**os.environ, "CLEARVAE_TORCH_NO_LOCK": "1", "PYTHONPATH": here}
    children = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--dp-child", str(r),
         str(port), d], env=env, cwd=here, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(2)]
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        _phase_parallel_one_rank(gpu, train_ds, valid_ds, total)
        t_other = time.perf_counter()
        other_total = _phase_parallel_other_models(train_ds)
        t_a = time.perf_counter()
        alone = _dp_steps(inp, None)
        logs = [c.communicate(timeout=300)[0] for c in children]
        t_b = time.perf_counter()
    finally:
        dist.destroy_process_group()
        for c in children:
            if c.poll() is None:
                c.kill()
                c.wait()
    for c, log in zip(children, logs):
        if c.returncode != 0:
            fail(f"a gloo rank on the card exited {c.returncode}: "
                 f"{log[-2000:]}")
    ranks = [torch.load(os.path.join(d, f"rank{r}.pt"), weights_only=True)
             for r in range(2)]
    for name, (metrics, state, grads) in alone.items():
        # the atol: 1e-5 of the largest entry (an analytically zero
        # gradient, of the conv biases ahead of BatchNorm, is float noise)
        scale = max(float(g.abs().max()) for g in grads)
        gdiff = l2 = 0.0
        by_norm = name == "vae64-clear"
        for r in ranks:
            m, st, gr = r[name]
            if len(gr) != len(grads):
                fail(f"DP(2) {name}: {len(gr)} gradients applied, the single "
                     f"rank {len(grads)}")
            for i, (a, w) in enumerate(zip(gr, grads)):
                gdiff = max(gdiff, float((a - w).abs().max()))
                if by_norm:
                    d = float((a - w).norm())
                    allowed = (PAR_V64_L2_RTOL * float(w.norm())
                               + 1e-5 * scale * w.numel() ** 0.5)
                    l2 = max(l2, d / allowed)
                    excess = d - allowed
                    bar = f"L2 within {PAR_V64_L2_RTOL} of"
                else:
                    excess = float(((a - w).abs() - PAR_STEP_RTOL * w.abs()
                                    - 1e-5 * scale).max())
                    bar = f"rtol {PAR_STEP_RTOL} (atol {1e-5 * scale:.2e}) of"
                if excess > 0:
                    fail(f"DP(2) {name}: gradient {i} before the update is "
                         f"{excess:.3e} beyond {bar} the single rank's")
            if m.keys() != metrics.keys():
                fail(f"DP(2) {name}: metrics {sorted(m)}")
            keys = (tuple(metrics) if name in ("clear-tc", "lam-cnn")
                    else ("loss", "c_loss"))
            rtol = 2e-4 if name == "clear-tc" else PAR_STEP_RTOL
            for k in keys:
                if abs(m[k] - metrics[k]) > rtol * abs(metrics[k]):
                    fail(f"DP(2) {name} {k}: {m[k]} against {metrics[k]} "
                         f"alone (rtol {rtol})")
            for k, v in state.items():
                if "running" in k:
                    continue
                tol = max(1e-3 * max(float(v.abs().max()), 1e-3), 1.2e-3)
                if float((st[k] - v).abs().max()) > tol:
                    fail(f"DP(2) {name} {k}: beyond {tol:.2e} of the single "
                         f"rank's update")
        for k, v in ranks[0][name][1].items():
            if not torch.equal(v, ranks[1][name][1][k]):
                fail(f"DP(2) {name}: the two ranks' {k} differ")
        first = next(iter(metrics))
        print(f"[parallel] two gloo ranks on one card (CLEARVAE_TORCH_NO_LOCK"
              f"=1: the children share the card on purpose): DP(2) {name} "
              f"step {first} {ranks[0][name][0][first]:.6f} against the "
              f"single rank's {metrics[first]:.6f}; the {len(grads)} gradients "
              f"applied (summed over the ranks) within "
              + (f"{PAR_V64_L2_RTOL} in L2 a tensor (the worst at "
                 f"{l2:.3f} of its bar)"
                 if by_norm else f"rtol {PAR_STEP_RTOL}")
              + f" of the single rank's (max abs diff {gdiff:.3e}, largest "
              f"entry {scale:.3e}); loss and update within the CPU tests' "
              f"bars; both ranks' parameters equal")
    t_c = time.perf_counter()
    k1 = _phase_parallel_perf28(train_ds)
    t_end = time.perf_counter()
    print(f"[parallel] whole phase {t_end - t_phase:.2f} s (one rank "
          f"{t_a - t_phase:.2f}, of it the CNN, LAM and VAE64 fits "
          f"{t_a - t_other:.2f}, the two gloo ranks' wait {t_b - t_a:.2f}, "
          f"the perf-mode fits {t_end - t_c:.2f}); launches on the meshes "
          f"{total}")
    return {**total, "perf28_k1": k1, "other": other_total}


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
    # the runners' set-up: the single-GPU-process lock, and fp32 matmuls and
    # convolutions (TF32 off), as the JAX reference computes
    from clearvae_torch.utils.cache import enable_compilation_cache
    enable_compilation_cache()
    gpu = gpu_name_and_limit()
    phase_build()
    errs, times = phase_kernels()
    k3_err, k3_times = phase_style_kernel()
    k4_alone, k4_batch = phase_threefry()
    k5 = phase_glass()
    k6 = phase_batchnorm()
    launches, (train_ds, valid_ds) = phase_main()
    adv = phase_adversarial(gpu, train_ds, valid_ds)
    graph = phase_graph(train_ds, valid_ds, here)
    down = phase_downstream(gpu, here)
    mig = phase_mig(gpu, here)
    s64 = phase_sixty_four(gpu, here)
    art = phase_artifacts(gpu, here)
    corr = phase_corruptions(gpu)
    par = phase_parallel(gpu, train_ds, valid_ds, here)
    by_path = {name: {"main": launches[name], "adversarial": adv[name],
                      "graph": graph[name], "downstream": down[name],
                      "mig": mig[name], "sixty-four": s64[name],
                      "artifacts": art[name], "corruptions": corr[name],
                      "parallel": par[name],
                      "parallel-cnn-lam-vae64": par["other"][name]}
               for name in COUNTED}
    # ``launches``: each kernel's count on the path that its slice put it on
    # (K1: the fused CLEAR trainer; K2f/K2b: the fused CLEAR-TC and
    # CLEAR-MIM trainers; K3: the downstream zoo; K4: the MNIST-C styled
    # fit, its draws and 73 passes a step)
    own = {"clear_latent_fwdgrad": "main", "clear_latent_bwd": "main",
           "snn_fwd": "adversarial", "snn_bwd": "adversarial",
           "style_batch": "downstream", "threefry": "corruptions",
           "glass": "corruptions", "batchnorm": "sixty-four"}
    for name, path in own.items():
        if by_path[name][path] == 0:
            fail(f"{name} was launched no time on the {path} path")
    # this slice's path, the 64×64 one, runs every fused-loss kernel
    for name in REPLACES:
        if by_path[name]["sixty-four"] == 0:
            fail(f"{name} was launched no time on the sixty-four path")
    # the qualitative-artifact path styles its data through K3
    if by_path["style_batch"]["artifacts"] == 0:
        fail("style_batch was launched no time on the artifacts path")
    # this slice's path, the MNIST-C styled fit, runs K1 both ways, K3 and
    # (in its evaluation) K2f
    for name in ("clear_latent_fwdgrad", "clear_latent_bwd", "snn_fwd",
                 "style_batch"):
        if by_path[name]["corruptions"] == 0:
            fail(f"{name} was launched no time on the corruptions path")
    # K6 on every path without a mesh, and under a mesh never (its
    # BatchNorms take the twin, whose statistics are all-reduced)
    for path, n in by_path["batchnorm"].items():
        if (n == 0) != path.startswith("parallel"):
            fail(f"batchnorm was launched {n} times on the {path} path")
    # this slice's path, the meshes' graphed fits and evaluations, runs
    # every kernel
    for name in (*REPLACES, "style_batch"):
        if by_path[name]["parallel"] == 0:
            fail(f"{name} was launched no time on the parallel path")
    # this slice's path, the CNN, LAM-CNN and VAE64 mesh fits, runs K1
    # both ways (VAE64 CLEAR) and K3 (the styled SimpleCNN)
    for name in ("clear_latent_fwdgrad", "clear_latent_bwd", "style_batch"):
        if by_path[name]["parallel-cnn-lam-vae64"] == 0:
            fail(f"{name} was launched no time on the CNN, LAM and VAE64 "
                 f"mesh path")
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
    kernels.append(dict(name="threefry", route="cuda", source=K4_SOURCE,
                        replaces=None,
                        launches=by_path["threefry"]["corruptions"],
                        max_abs_err=0.0, **k4_alone, library_ms=None,
                        launches_by_path=by_path["threefry"]))
    kernels.append(dict(name="glass", route="cuda", source=K5_SOURCE,
                        replaces=None, launches=by_path["glass"]["corruptions"],
                        max_abs_err=0.0, ms=k5[1]["ms"],
                        plain_ms=k5[1]["plain_ms"], bound_ms=None,
                        bound_by="the serial chain of swaps",
                        device_us=k5[1]["device_us"], library_ms=None,
                        launches_by_path=by_path["glass"]))
    perf = k6["vae64_bfloat16"]
    kernels.append(dict(name="batchnorm", route="cuda", source=K6_SOURCE,
                        replaces=None,
                        launches=by_path["batchnorm"]["sixty-four"],
                        max_abs_err=max(t["max_abs_err"] for t in k6.values()),
                        ms=perf["ms"], plain_ms=perf["plain_ms"],
                        bound_ms=perf["bound_ms"], bound_by=perf["bound_by"],
                        design_bound_ms=perf["design_ms"],
                        device_us=perf["device_us"], library_ms=None,
                        launches_by_path=by_path["batchnorm"]))
    print(f"[chip_smoke] whole run {time.perf_counter() - t_start:.2f} s "
          f"(phases 1-11, the build included)")
    print(gpu)
    print(json.dumps({"kernels": kernels, "shape": {"B": 128, "z": 8, "H": 28},
                      "b2048": {n: times[(n, 2048, 8)] for n in REPLACES},
                      "b128_z32": {n: times[(n, 128, 32)] for n in REPLACES},
                      "b512": {**{n: times[(n, 512, 8)] for n in REPLACES},
                               "style_batch": k3_times[512]},
                      "parallel_all_reduce": par["all_reduce"],
                      "parallel_cnn_lam_vae64_all_reduce":
                          par["other"]["all_reduce"],
                      "perf28_k1": par["perf28_k1"],
                      "threefry_mnistc_batch": k4_batch,
                      "glass_by_severity": k5,
                      "batchnorm_by_model": k6}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dp-child"]:
        _dp_child(sys.argv[2:])
    else:
        main()
