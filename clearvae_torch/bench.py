"""Training throughput of the port: the flagship, CLEAR-TC, CLEAR-MIM, the
four 28×28 perf rows and the two 64×64 rows of the repository's
``bench.py``, each eager and graphed.

    python -m clearvae_torch.bench [--steps 20]
    torchrun --nproc_per_node N -m clearvae_torch.bench   # on a data mesh

Flagship configuration (reference run_styledmnist_downstream_expr.py:
231-238): Styled-MNIST CLEAR-VAE, z_dim = 16, batch 128, β = 1/8, α = 100,
τ = 0.1, Adam 5e-4, cosine SNN, the latent losses fused (K1; K2f and K2b
for the TC and MIM c_loss). CLEAR-TC: λ = 1, factor Adam 1e-4. CLEAR-MIM:
CLUB-S, λ = 3, estimator Adam 2e-3. Each trainer comes from its factory
(seed 0) and trains on synthetic Styled-MNIST digits, styled once on the
card. The 64×64 rows (``ROWS64``, ``bench.py``'s ``vae64_clear`` and
``vae64_bf16_b256``): the same CLEAR trainer on ``VAE64``, z = 64, on
uniform random 64×64×3 images with labels 0..9 as ``bench.py`` makes them,
float32 at B = 128 and bfloat16 conv stacks at B = 256. The 28×28 perf
rows (``ROWS28``, ``bench.py``'s ``clear_28_bf16``, ``clear_28_fusedheads``,
``perf_mode_b2048_bf16`` and ``perf_mode_b512_bf16_fusedheads``): the
flagship CLEAR trainer with bfloat16 conv stacks and/or the four latent
heads in one Linear, at B = 128, 2,048 and 512, on the root bench's
synthetic Styled-MNIST (4,096 images; 8,192 at B = 2,048). Its
``_permute`` and ``_unroll4`` twins are left out: their knobs run the
port's one-step graph unchanged (``fit``'s ``scan_gather`` and
``scan_unroll``). So are both ``convpack`` rows: the port's
``first_conv_pack`` is the plain conv (``models/vae.py``), so they would
repeat their parents. Each row is timed
by ``time_steps``, the port's one step timer
(``chip_smoke.py`` and ``experiments/kernel_ab.py`` time with it too):
eager and graphed steps in turns on the same batches.

Under a launched multi-rank job (``WORLD_SIZE`` > 1, as torchrun sets it)
every row, the 64×64 ones included, runs on a data mesh over the job's
cards (NCCL; the root bench shards every row over a data mesh when it sees
more than one device), each rank on its block of every global batch;
images/sec count the global batch, the FLOP share is against the peaks of
all the cards (``job_rows``), and rank 0 prints.

Prints one JSON line: per row and mode, images/sec and the FLOP share per
turn (the analytic training FLOPs a second over the card's fp32 peak; TF32
stays off, as in ``chip_smoke.py``, so the float32 convolutions run on the
fp32 units; the bfloat16 row over the dense bf16 tensor-core peak), the
step's walls, device-busy time, idle share and kernels a step.
The FLOP count is ``bench.py``'s (``clear_vae_train_flops_per_image``),
copied here because the port imports nothing of the JAX package's files.
Needs a CUDA card; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import time

BATCH = 128
Z_DIM = 16
PEAK_FP32_FLOPS = 67e12   # H100 SXM, fp32 outside the tensor cores
PEAK_BF16_FLOPS = 989e12  # H100 SXM, dense bf16 on the tensor cores


def _conv_macs(size: int, chans, kernel: int) -> tuple[int, int, int]:
    """(encoder MACs, decoder MACs, flat dim) for the mirrored conv stacks
    (reference vae.py:15-46, 113-156): stride-2 convs in→chans, decoder
    ConvTs mirroring them."""
    enc = 0
    spatial = size
    for cin, cout in zip(chans[:-1], chans[1:]):
        spatial = (spatial + 1) // 2
        enc += spatial * spatial * cout * kernel * kernel * cin
    flat = spatial * spatial * chans[-1]
    dec = 0
    spatial_in = spatial
    for cin, cout in zip(reversed(chans[1:]), reversed(chans[:-1])):
        dec += spatial_in * spatial_in * cin * kernel * kernel * cout
        spatial_in *= 2
    return enc, dec, flat


def clear_vae_train_flops_per_image(z_dim: int = Z_DIM, batch: int = BATCH,
                                    size: int = 28, in_ch: int = 1,
                                    variant: str = "clear") -> float:
    """Analytic training FLOPs per image for a CLEAR-family step: 2 FLOPs/MAC
    forward, backward ≈ 2× forward (standard MFU accounting), from the
    layer math.

    ``variant``: 'clear' = fwd+bwd (3× fwd). 'tc' adds the discriminator
    phase's fresh VAE forward (the factor classifier itself is O(z²),
    negligible). 'mim' adds one encoder-only forward plus 5 inner estimator
    steps on tiny MLPs."""
    if size >= 64:
        chans = (in_ch, 32, 64, 128, 256, 512)
        kernel = 4
    else:
        chans = (in_ch, 32, 64, 128)
        kernel = 3
    enc, dec, flat = _conv_macs(size, chans, kernel)
    heads = 4 * flat * (z_dim // 2)          # four latent heads
    dec_dense = z_dim * flat                 # decoder dense
    fwd = enc + heads + dec_dense + dec
    # contrastive [B,B] sim matrices on mu_c and mu_s (cosine: one matmul each)
    fwd += 2 * batch * (z_dim // 2)          # per image: B·z/2 MACs ×2 halves
    macs = 3 * fwd                           # fwd + bwd(≈2×fwd)
    if variant == "tc":
        z = z_dim
        macs += fwd + 3 * 2 * (z * z + z)   # fresh fwd + disc step (2×[B,2z]→1)
    elif variant == "mim":
        zh, hidden = z_dim // 2, z_dim
        est = 2 * (zh * hidden + hidden * zh)   # p_mu + p_logvar MLPs
        macs += (enc + heads) + 5 * 3 * est     # one encode + 5 estimator steps
    return 2 * macs


COMMON = dict(beta=1 / 8, vae_lr=5e-4, z_dim=Z_DIM, alpha=100,
              temperature=0.1, seed=0, verbose_period=10 ** 9,
              hyperparameter={"fused": True})
ROWS = {
    "clear": ("get_clearvae_trainer", dict(ps=True)),
    "tc": ("get_cleartcvae_trainer", dict(la=1, factor_cls_lr=1e-4)),
    "mim": ("get_clearmimvae_trainer", dict(mi_estimator="CLUBSample", la=3,
                                            mi_estimator_lr=2e-3)),
}


# bench.py's 28×28 perf rows: (batch, bfloat16 conv stacks, fused heads,
# images of synthetic Styled-MNIST)
ROWS28 = {"clear_28_bf16": (128, True, False, 4096),
          "clear_28_fusedheads": (128, False, True, 4096),
          "perf_mode_b2048_bf16": (2048, True, False, 8192),
          "perf_mode_b512_bf16_fusedheads": (512, True, True, 4096)}

# bench.py's 64×64 rows: (batch, bfloat16 conv stacks)
ROWS64 = {"vae64_clear": (128, False), "vae64_bf16_b256": (256, True)}
SHAPE64 = dict(z_dim=64, size=64, in_ch=3)


def job_rows(world: int = 1) -> dict:
    """{row: (batch, analytic training FLOPs an image, the peak its FLOP
    share is against)} of every row a job of ``world`` cards runs: the same
    rows alone and on a data mesh (as the root bench runs them), each
    against the peak of all the job's cards, bf16's for a bfloat16 row."""
    rows = {kind: (BATCH, clear_vae_train_flops_per_image(variant=kind),
                   world * PEAK_FP32_FLOPS) for kind in ROWS}
    for kind, (batch, bf16, _, _) in ROWS28.items():
        rows[kind] = (batch, clear_vae_train_flops_per_image(batch=batch),
                      world * (PEAK_BF16_FLOPS if bf16 else PEAK_FP32_FLOPS))
    for kind, (batch, bf16) in ROWS64.items():
        rows[kind] = (batch,
                      clear_vae_train_flops_per_image(batch=batch, **SHAPE64),
                      world * (PEAK_BF16_FLOPS if bf16 else PEAK_FP32_FLOPS))
    return rows


def make_trainer(kind: str, device: str | None = "cuda", mesh=None):
    """The row's trainer from its factory (seed 0), on ``mesh`` when given
    (its device then the rank's)."""
    import torch

    from clearvae_torch.train import factories as TF

    on = {"device": device, "mesh": mesh}
    if kind in ROWS28:
        _, bf16, fused_heads, _ = ROWS28[kind]
        vae = {"dtype": torch.bfloat16} if bf16 else {}
        vae.update({"fused_heads": True} if fused_heads else {})
        return TF.get_clearvae_trainer(**COMMON, ps=True, vae_kwargs=vae, **on)
    if kind in ROWS64:
        kw = {"vae_kwargs": {"dtype": torch.bfloat16}} if ROWS64[kind][1] \
            else {}
        return TF.get_clearvae_trainer(
            **{**COMMON, "z_dim": SHAPE64["z_dim"]}, ps=True,
            vae_arch="VAE64", in_channel=SHAPE64["in_ch"], **on, **kw)
    name, kw = ROWS[kind]
    return getattr(TF, name)(**COMMON, **kw, **on)


def data28(n: int, device):
    """The root bench's 28×28 data: ``n`` synthetic digits (seed 0),
    Styled-MNIST of the six styles, styled once on ``device``."""
    from clearvae_torch.data.mnist import synthetic_mnist
    from clearvae_torch.data.styled import make_styled_mnist

    ds = make_styled_mnist(*synthetic_mnist(n, seed=0), seed=0)
    ds.materialize(device)
    return ds


def data64(n: int):
    """``bench.py``'s 64×64 data: uniform [n, 64, 64, 3] images and labels
    0..9 from ``RandomState(0)``."""
    import numpy as np

    from clearvae_torch.data.common import ArrayDataset

    rs = np.random.RandomState(0)
    size, ch = SHAPE64["size"], SHAPE64["in_ch"]
    images = rs.rand(n, size, size, ch).astype(np.float32)
    labels = rs.randint(0, 10, n)
    return ArrayDataset(images, labels, np.zeros(n, np.int64))


def device_kernels(prof) -> tuple[dict, dict, float]:
    """({kernel name: launches}, {kernel name: device us}, device-busy us)
    of a profile. Device copies and fills are busy time but not kernels.
    Host ranges that the profiler mirrors onto the device timeline (a
    record_function range such as Optimizer.step#Adam.step spans kernels)
    are neither."""
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


TURNS = ("eager", "graphed", "graphed", "eager")
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
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        time.sleep(SETTLE_S)
        yield prof
        torch.cuda.synchronize()
        time.sleep(SETTLE_S)


def batch_rows(n_data: int, n: int, batch: int):
    """[n, batch] sample indices of ``time_steps``: permutations of the
    ``n_data`` samples by ``RandomState(1)``, one after another, as many as
    ``n`` batches take."""
    import numpy as np

    rs = np.random.RandomState(1)
    perms = [rs.permutation(n_data) for _ in range(-(-n * batch // n_data))]
    return np.concatenate(perms)[: n * batch].reshape(n, batch)


def time_steps(trainer, ds, n: int = 20,
               trace_dir: str | None = None, batch: int = BATCH) -> dict:
    """The port's step timer: ``n`` train steps of ``trainer`` on the same
    ``n`` batches of ``batch`` images of ``ds`` (fixed permutations of the
    materialized path's resident data, as many as ``n`` batches take),
    eager (``make_epoch_fn``, the loop
    of ``fit``) and graphed (``make_graphed_epoch_fn``, one replay a step)
    where the package has it. After one warm-up run of each mode (the
    graphed one's warm-up steps and its capture), the modes run in
    ``TURNS``, each turn timed on the host clock up to a device
    synchronize; then one profiled run of each mode (written as a Chrome
    trace under ``trace_dir``).

    Per mode: ``walls_ms`` a step (per turn), ``wall_ms`` (their least),
    ``device_busy_ms`` a step, ``idle_share`` (1 - busy / wall, per turn),
    ``kernels_per_step``, ``images_per_sec`` (per turn),
    ``kernels_by_name`` (launches in the profiled run) and ``ms_by_name``
    (their device ms a step). It uses only what
    older checkouts of the package also have (they time eagerly only), so
    ``experiments/kernel_ab.py`` times a parent tree with the same code."""
    import os

    import numpy as np
    import torch

    from clearvae_torch.train import steps as S

    data, labels = trainer._device_data(ds)
    rows = torch.as_tensor(batch_rows(len(labels), n, batch),
                           device=labels.device)
    eager = S.make_epoch_fn(trainer.train_step)
    fns = {"eager": lambda: eager(data, labels, rows, trainer._train_noise)}
    if hasattr(S, "make_graphed_epoch_fn"):
        graphed = S.make_graphed_epoch_fn(trainer.train_step, data, labels,
                                          batch, trainer._train_noise)
        fns["graphed"] = lambda: graphed.run(rows)
    for fn in fns.values():
        fn()
    walls = {mode: [] for mode in fns}
    for mode in (m for m in TURNS if m in fns):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fns[mode]()
        torch.cuda.synchronize()
        walls[mode].append((time.perf_counter() - t0) * 1e3 / n)
    out = {}
    for mode, fn in fns.items():
        for _ in range(3):     # a profile with no kernel is the profiler's loss
            with profile_window() as prof:
                fn()
            counts, us, busy_us = device_kernels(prof)
            if counts:
                break
        if trace_dir:
            os.makedirs(trace_dir, exist_ok=True)
            prof.export_chrome_trace(os.path.join(trace_dir,
                                                  f"trace_{mode}.json"))
        busy = busy_us / 1e3 / n
        out[mode] = dict(
            walls_ms=walls[mode], wall_ms=min(walls[mode]),
            device_busy_ms=busy,
            idle_share=[1 - busy / w for w in walls[mode]],
            kernels_per_step=sum(counts.values()) / n,
            images_per_sec=[batch * 1e3 / w for w in walls[mode]],
            kernels_by_name=counts,
            ms_by_name={k: v / 1e3 / n for k, v in us.items()})
    return out


def row_stats(trainer, ds, steps: int, flops: float, peak: float,
              batch: int = BATCH) -> dict:
    """One row of the bench: ``time_steps`` of the trainer per mode, with
    the FLOP share of each turn against ``peak`` (the job's, on a mesh)."""
    row = {"flops_per_image": flops, "batch": batch, "peak_flops": peak}
    for mode, r in time_steps(trainer, ds, n=steps, batch=batch).items():
        row[mode] = {
            "images_per_sec": r["images_per_sec"],
            "flop_share": [i * flops / peak for i in r["images_per_sec"]],
            **{k: r[k] for k in ("walls_ms", "device_busy_ms", "idle_share",
                                 "kernels_per_step")}}
    return row


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=20,
                    help="steps a turn (eager, graphed, graphed, eager)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import os

    import torch

    from clearvae_torch import resolve_device
    from clearvae_torch.data.mnist import synthetic_mnist
    from clearvae_torch.data.styled import make_styled_mnist
    from clearvae_torch.utils.cache import enable_compilation_cache

    mesh, world = None, int(os.environ.get("WORLD_SIZE", "1"))
    if world > 1:
        import torch.distributed as dist

        from clearvae_torch.parallel.mesh import make_mesh, mesh_device

        dist.init_process_group("nccl")
        mesh = make_mesh(world)
        torch.cuda.set_device(mesh_device(mesh))
    dev = resolve_device(args.device if mesh is None else mesh_device(mesh))
    enable_compilation_cache(dev)  # the card to itself, and fp32: TF32 off
    if dev.type != "cuda":
        raise SystemExit("clearvae_torch.bench measures a CUDA card")
    on = {"device": None if mesh is not None else args.device, "mesh": mesh}
    ds = make_styled_mnist(*synthetic_mnist(args.steps * BATCH, seed=0),
                           seed=0)
    ds.materialize(dev)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[:1]
    data, configs = {}, {}
    for kind, (batch, flops, peak) in job_rows(world).items():
        if kind in ROWS:
            rows_ds = ds
        elif kind in ROWS28:
            n_images = ROWS28[kind][3]
            if n_images not in data:
                data[n_images] = data28(n_images, dev)
            rows_ds = data[n_images]
        else:
            rows_ds = data64(args.steps * batch)
        configs[kind] = row_stats(make_trainer(kind, **on), rows_ds,
                                  args.steps, flops, peak, batch)
    if mesh is None or torch.distributed.get_rank() == 0:
        print(json.dumps({
            "metric": "images_per_sec", "batch": BATCH, "z_dim": Z_DIM,
            "steps": args.steps, "peak_fp32_flops": PEAK_FP32_FLOPS,
            "world": world, "device": torch.cuda.get_device_name(0),
            "nvidia_smi": card[0] if card else None, "configs": configs}))
    if mesh is not None:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
