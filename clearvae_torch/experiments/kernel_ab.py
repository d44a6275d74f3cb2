"""Paired card timings of K3, K2f, K2b, the styling of one batch and the
fused CLEAR train step, for checkouts of this package, so that two trees (a parent and a change) are
compared in one call on one card, in turns:

    python3 clearvae_torch/experiments/kernel_ab.py --root PARENT --root . \\
        --root . --root PARENT

Each ``--root`` runs in a process of its own, in the order given: it imports
``clearvae_torch`` from that directory, builds its CUDA sources into that
checkout's build directory, and prints one JSON line:

- ``style_batch`` (K3) at B = 128 and 512 on the codes the downstream path
  sends it (identity, stripe, brightness, scale), severity 5;
- ``snn_fwd`` (K2f) and ``snn_bwd`` (K2b) at (B, z) = (128, 8) and
  (2048, 8), PS-SNN;
- ``styling``: one ``corruptions.style_batch`` call on a B = 128 batch of
  the six ``EXPERIMENT_STYLES``;
- ``step eager``: the fused CLEAR train step of ``get_clearvae_trainer`` at
  the flagship widths (B = 128, z = 16), 20 steps a turn through the eager
  epoch runner (gather, noise, step); and ``step graphed``, the same steps
  through ``make_graphed_epoch_fn`` (one replay of the captured step
  each), where the root has it. Both are timed by this checkout's
  ``bench.time_steps`` (eager, graphed, graphed, eager);

each with its profiler device µs, kernels and device copies a call, CUDA
event ms a call, and for styling the host syncs a call (torch's sync debug
mode) and host wall ms; for the steps, wall and device-busy ms a step, the
idle share, kernels a step and images/sec. Then one more line compares K3's outputs bit for bit:
every code 0..7 at severities 1-5 on digits and on noise at H = 17, 28 and
64, each root against the first. Needs a CUDA card; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time
import warnings

K3_CODES = (0, 1, 2, 6)


def _profile(fn, n: int = 50):
    """(device us, kernels, device copies) a call of fn over n calls."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    host = {e.name for e in prof.events() if e.device_type == DeviceType.CPU}
    us = kernels = copies = 0
    for e in prof.events():
        if e.device_type != DeviceType.CUDA or e.is_user_annotation \
                or e.name in host:
            continue
        if e.name.startswith(("Memcpy", "Memset")):
            copies += 1
        else:
            kernels += 1
            us += e.time_range.elapsed_us()
    return us / n, kernels / n, copies / n


def _event_ms(fn, iters: int = 200) -> float:
    import torch

    for _ in range(10):
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


def _syncs(fn) -> int:
    import torch

    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message) for w in caught)


def _record(fn) -> dict:
    us, kernels, copies = _profile(fn)
    return dict(device_us=us, kernels=kernels, copies=copies,
                event_ms=_event_ms(fn))


def k3_outputs(K3, torch) -> dict:
    """K3's output for every code 0..7 at severities 1-5, H in (17, 28, 64),
    on a seeded batch of noise and of digits (the digits zoomed to H)."""
    from torch.nn import functional as F

    from clearvae_torch.data.mnist import synthetic_mnist

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(5)
    digits = torch.as_tensor(synthetic_mnist(64, seed=3)[0])[:, None]
    outs = {}
    for h in (17, 28, 64):
        x = torch.cat([torch.rand(64, h, h, generator=gen) * 255,
                       F.interpolate(digits, size=(h, h), mode="bilinear")[:, 0]])
        x = x.contiguous().to(dev)
        code = (torch.arange(len(x), device=dev) % 8).to(torch.int32)
        for sev in range(1, 6):
            outs[f"H={h} severity={sev}"] = K3.style_batch_kernel(
                x, code, sev).cpu()
    return outs


def _bench():
    """This checkout's ``clearvae_torch/bench.py``, loaded from its file:
    the step timer is this tree's while the ``clearvae_torch`` it times is
    the root's."""
    spec = importlib.util.spec_from_file_location(
        "_kernel_ab_bench",
        os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                     "bench.py"))
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    return bench


def measure_steps(n: int = 20) -> dict:
    """The fused CLEAR train step of ``get_clearvae_trainer`` at the
    flagship widths, timed by ``bench.time_steps``: eager and, where the
    root has it, graphed, in turns."""
    from clearvae_torch.data.mnist import synthetic_mnist
    from clearvae_torch.data.styled import make_styled_mnist

    bench = _bench()
    ds = make_styled_mnist(*synthetic_mnist(n * bench.BATCH, seed=0), seed=0)
    steps = bench.time_steps(bench.make_trainer("clear"), ds, n=n)
    return {f"step {mode}": r for mode, r in steps.items()}


def measure(root: str, save: str | None = None) -> dict:
    sys.path.insert(0, os.path.abspath(root))
    import numpy as np
    import torch

    import clearvae_torch
    from clearvae_torch.data.mnist import synthetic_mnist
    from clearvae_torch.ops import corruptions as TC
    from clearvae_torch.ops.kernels import _build
    from clearvae_torch.ops.kernels import fused_loss as FL
    from clearvae_torch.ops.kernels import style as K3

    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab: needs a CUDA card")
    # fp32, as the trainers run, set here: a root may predate utils/cache.py
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    _build.build(_build.sources())
    out = dict(root=root, package=os.path.dirname(clearvae_torch.__file__),
               build_s=time.perf_counter() - t0,
               device=torch.cuda.get_device_name(0))
    dev = torch.device("cuda")
    digits, _ = synthetic_mnist(512, seed=11)
    for b in (128, 512):
        x = torch.as_tensor(digits[:b], device=dev)
        code = torch.as_tensor(np.resize(np.asarray(K3_CODES, np.int32), b),
                               device=dev)
        out[f"style_batch B={b}"] = _record(
            lambda: K3.style_batch_kernel(x, code, 5))
    for b, z in ((128, 8), (2048, 8)):
        gen = torch.Generator().manual_seed(7)
        mu = torch.randn(b, z, generator=gen).to(dev)
        lbl = torch.randint(0, 10, (b,), generator=gen).to(dev)
        one = torch.ones((), device=dev)
        out[f"snn_fwd B={b} z={z}"] = _record(
            lambda: FL.snn_fwd(mu, lbl, 0.1, True))
        out[f"snn_bwd B={b} z={z}"] = _record(
            lambda: FL.snn_bwd(mu, lbl, one, 0.1, True))
    b = 128
    x = torch.as_tensor(digits[:b], device=dev)
    sidx = torch.as_tensor(np.arange(b) % len(TC.EXPERIMENT_STYLES),
                           dtype=torch.int64, device=dev)
    ids = torch.arange(b, dtype=torch.int64, device=dev)
    # a tree from before the keyed styles takes zigzag's two draws alone
    draws = (TC.style_draws(0, ids) if hasattr(TC, "style_draws")
             else torch.stack(TC.zigzag_draws(0, ids), 1))

    def styling():
        return TC.style_batch(x, sidx, draws)

    rec = _record(styling)
    walls = []
    for _ in range(20):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        styling()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t1) * 1e3)
    rec.update(syncs=_syncs(styling), wall_ms=float(np.median(walls)))
    out["styling B=128"] = rec
    out.update(measure_steps())
    if save:
        torch.save(k3_outputs(K3, torch), save)
    return out


def compare(paths) -> dict:
    """Per code, the elements of K3's outputs that differ in their bits from
    the first root's, and the largest absolute difference, summed (and
    maxed) over H and severities."""
    import torch

    ref = torch.load(paths[0])
    diff = {}
    for i, path in enumerate(paths[1:], 1):
        got = torch.load(path)
        count, worst = [0] * 8, [0.0] * 8
        for key, r in ref.items():
            ne = got[key].view(torch.int32) != r.view(torch.int32)
            err = (got[key] - r).abs()
            for c in range(8):
                count[c] += int(ne[c::8].sum())
                worst[c] = max(worst[c], float(err[c::8].max()))
        diff[f"root {i} vs root 0"] = dict(differing=count, max_abs=worst)
    n = sum(r[0::8].numel() for r in ref.values())
    return {"k3_bitwise_by_code": diff, "elements_per_code": n}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", action="append", required=True,
                    help="a checkout holding clearvae_torch/ (repeatable)")
    ap.add_argument("--out", default=".runs/kernel_ab",
                    help="directory for each root's K3 outputs")
    ap.add_argument("--one", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.one:
        print(json.dumps(measure(args.root[0], args.one)), flush=True)
        return
    # this checkout's GPU lock, held for every root's turn: the roots run
    # in children, which take the escape hatch
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "..", ".."))
    from clearvae_torch.utils.cache import enable_compilation_cache
    enable_compilation_cache()
    env = {**os.environ, "CLEARVAE_TORCH_NO_LOCK": "1"}
    os.makedirs(args.out, exist_ok=True)
    paths = [os.path.join(args.out, f"k3_root{i}.pt")
             for i in range(len(args.root))]
    for root, path in zip(args.root, paths):
        subprocess.run([sys.executable, os.path.abspath(__file__), "--one",
                        path, "--root", root], check=True, env=env)
    print(json.dumps(compare(paths)), flush=True)


if __name__ == "__main__":
    main()
