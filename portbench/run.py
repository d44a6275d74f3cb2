"""One run of one benchmark cell on the card:

    python -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

With ``--trace 0`` it measures the cell's end-to-end metrics: set-up
(process start to the window's start) and the training images a second of
``fit`` over the window. With ``--trace 1`` it profiles a bounded stretch
of ``fit`` instead and prints the cell's per-layer metrics, the device's
busy seconds and a breakdown. Either way it then checks what the program
computed against the plain reference (``check.py``) and prints, as the last
line of standard output, one JSON object: ``correct``, ``attempted`` and
``failed`` (train steps, and those whose loss was not finite), ``metrics``,
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``: each
compared number with its limit, which also end standard error.

It needs a CUDA card (``chips`` of the cell's, at least) and exits with
code 3 and no result without one; with code 4 and no result if a module of
JAX or of the JAX package is loaded when the window has closed. Caches of
built kernels stay inside the checkout (the port's
``clearvae_torch/_build/``; ``TORCH_EXTENSIONS_DIR`` and
``TRITON_CACHE_DIR`` under ``.portbench_cache/``).
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, ".portbench_cache")


def _args(argv):
    p = argparse.ArgumentParser(description="Run one benchmark cell.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


class Forbidden(RuntimeError):
    """A module of JAX or of the JAX package is loaded."""


def run(workload: str, seed: int, seconds: float, trace: bool = False,
        device="cuda", overrides: dict | None = None) -> dict:
    """The result of one run (the JSON object ``main`` prints). ``device``
    and ``overrides`` serve the CPU tests, which run tiny cells without a
    card (untraced)."""
    import numpy as np
    import torch

    from portbench import check as C
    from portbench import harness as H

    cell = H.load_cell(workload, overrides)
    on_card = torch.device(device).type == "cuda"
    print(f"portbench: set-up imports and card: "
          f"{time.perf_counter() - T_START:.3f} s", file=sys.stderr)
    r = H.set_up(cell, seed, device)
    result = {"correct": False, "attempted": 0, "failed": 0, "metrics": {},
              "device": {}}
    if trace:
        readers = {n: H.reader(n) for n in cell.workload["metrics"]["per_layer"]}
        early = {n: m.read(H.Context(cell, r)) for n, m in readers.items()
                 if getattr(m, "BEFORE_TRACE", False)}
        stretch, tr = H.traced_stretch(r)
        ctx = H.Context(cell, r, stretch, tr)
        for name, mod in readers.items():
            value = early[name] if name in early else mod.read(ctx)
            if value is not None:
                result["metrics"][name] = {"value": value, "unit": mod.UNIT}
        result["device"].update(busy_s=tr.busy_s, window_s=stretch["wall_s"])
        result["breakdown"] = {"device_ops": tr.top_ops(),
                               "idle_gaps": tr.idle_gaps()}
        measured = stretch["epochs"]
    else:
        w = H.window(r, seconds)
        units = {"train_images_per_s": ("images/s", w["images"] / w["wall_s"]),
                 "setup_s": ("s", w["start"] - T_START)}
        for name in cell.workload["metrics"]["end_to_end"]:
            unit, value = units[name]
            result["metrics"][name] = {"value": value, "unit": unit}
        measured = w["epochs"]
    bad = H.forbidden_modules()
    if bad:
        raise Forbidden(f"loaded after the window: {', '.join(bad)}")
    if on_card:
        result["device"] = {
            "platform": "gpu", "kind": torch.cuda.get_device_name(),
            "count": cell.workload["chips"],
            "memory_peak_bytes": torch.cuda.max_memory_allocated(),
            **result["device"]}
    history = H.release(r)     # the reference runs after the program is freed
    result["attempted"] = int(sum(len(history[e]) for e in measured))
    result["failed"] = int(sum((~np.isfinite(history[e])).sum()
                               for e in measured))
    readings = C.program_readings(r, history)
    result["correct"], result["checks"] = C.verdict(
        readings, cell.workload["limits"])
    other = {k: v for k, v in readings.items() if k not in result["checks"]}
    print(f"portbench: read, not compared: {other}", file=sys.stderr)
    return result


def use_cache_dirs() -> None:
    """Kernel build caches inside the checkout, at fixed paths."""
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")


def card_name_and_limit() -> str:
    """``nvidia-smi``'s card name and power limit, read once the run's
    measurements are done, so that nothing runs beside them."""
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        out = []
    return out[0] if out else "nvidia-smi: no card read"


def main(argv=None) -> int:
    args = _args(argv)
    use_cache_dirs()
    import torch

    from portbench import harness as H

    chips = H.load("workloads", args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA card(s); this machine "
              f"has {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    try:
        result = run(args.workload, args.seed, args.seconds, bool(args.trace))
    except Forbidden as exc:
        print(f"portbench: {exc}", file=sys.stderr)
        return 4
    print(f"portbench: {card_name_and_limit()}", file=sys.stderr)
    print(f"portbench: memory_peak_bytes "
          f"{result['device'].get('memory_peak_bytes')}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
