"""MI simulation study: SNN / PS-SNN vs a kNN MI estimate on Gaussian blobs
(counterpart of ``clearvae_tpu/experiments/mi_simulation.py``; reference
code/mi_experiment.ipynb cells 2-7).

Three isotropic Gaussian blobs at centers [-1, 2, 7]·1⃗ in 3-D; as the
cluster std sweeps, the SNN loss (to be *maximized* for MI minimization on
z_s) and the PS-SNN loss should track ∓MI estimated by the KSG kNN estimator.
Produces mi-min.png / mi-max.png analogues of the reference's
mi-min.pdf / mi-max.pdf (where matplotlib is installed; ``main`` says so
where it is not, and returns the traces in any case).

The blobs are drawn on the device by the port's threefry
(``ops/prng.py``), so a seed gives the JAX runner's blobs; the losses are
the plain ``contrastive_loss``, as the JAX runner's are unfused.
``main`` first takes the single-GPU-process lock and sets fp32 numerics,
as the JAX runner takes its lock and cache.

Usage:
  python -m clearvae_torch.experiments.mi_simulation [--reps N] \\
      [--n_stds N] [--seed S] [--device cuda|cpu] [--out DIR]
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from clearvae_torch import resolve_device
from clearvae_torch.ops import prng as P
from clearvae_torch.ops.losses import contrastive_loss
from clearvae_torch.ops.metrics import mutual_info_classif_np
from clearvae_torch.utils.visual import missing_packages

TAUS = (0.1, 0.3, 0.5, 1.0)


def generate_gaussian_blobs(key, n_samples: int = 1500, dim: int = 3,
                            centers=(-1.0, 2.0, 7.0), cluster_std: float = 1.0):
    """reference mi_experiment.ipynb cell 3; ``key`` a threefry key of
    ``ops/prng.py``, the blobs on its device."""
    n_blobs = len(centers)
    per = n_samples // n_blobs
    keys = P.split(key, n_blobs)
    xs, ys = [], []
    for i, c in enumerate(centers):
        xs.append(c + cluster_std * P.normal(keys[i], (per, dim)))
        ys.append(torch.full((per,), i, dtype=torch.int32,
                             device=key[0].device))
    return torch.cat(xs), torch.cat(ys)


def snn_value(x, y, tau: float, ps: bool) -> float:
    return float(contrastive_loss(x, torch.zeros_like(x), y, sim_fn="cosine",
                                  temperature=tau, ps=ps))


def run(stds, n_samples: int = 1500, reps: int = 10, seed: int = 0,
        ps: bool = True, device=None):
    """Sweep cluster std; returns dict with knn-MI and per-τ loss traces."""
    out = {"knn_mi": [], **{f"tau_{t}": [] for t in TAUS}}
    key = P.key(seed, device=resolve_device(device))
    for sd in stds:
        for _ in range(reps):
            key, k = P.split(key)
            x, y = generate_gaussian_blobs(k, n_samples, cluster_std=float(sd))
            mi = mutual_info_classif_np(x.cpu().numpy(), y.cpu().numpy()).mean()
            out["knn_mi"].append(float(mi) if ps else -float(mi))
            for t in TAUS:
                out[f"tau_{t}"].append(snn_value(x, y, t, ps))
    return out


def plot(traces: dict, ps: bool, path: str):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    plt.figure(figsize=(5, 3))
    plt.plot(traces["knn_mi"], label="KNN estimate", color="black")
    shades = ["lightskyblue", "skyblue", "deepskyblue", "dodgerblue"]
    name = "PS-SNN" if ps else "SNN"
    for t, c in zip(TAUS, shades):
        plt.plot(traces[f"tau_{t}"], label=f"{name} (τ={t})", color=c)
    plt.xlabel("steps")
    plt.ylabel("MI" if ps else "-MI")
    plt.legend()
    plt.savefig(path, bbox_inches="tight", dpi=150)
    plt.close()


def main(argv=None):
    """Both sweeps (PS-SNN over rising std, SNN over falling std); returns
    (ps_traces, snn_traces)."""
    from clearvae_torch.utils.cache import enable_compilation_cache
    enable_compilation_cache()  # the GPU lock, and fp32: TF32 off
    p = argparse.ArgumentParser()
    p.add_argument("--n_samples", type=int, default=1500)
    p.add_argument("--reps", type=int, default=10)  # notebook uses 100
    p.add_argument("--n_stds", type=int, default=11)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: cuda)")
    p.add_argument("--out", type=str, default="./expr_output/mi-sim")
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    os.makedirs(args.out, exist_ok=True)
    ps_traces = run(np.linspace(1, 4, args.n_stds), args.n_samples,
                    args.reps, args.seed, ps=True, device=device)
    snn_traces = run(np.linspace(4, 1, args.n_stds), args.n_samples,
                     args.reps, args.seed + 1, ps=False, device=device)
    if missing_packages("matplotlib"):
        print("mi-min.png and mi-max.png not written: matplotlib not installed")
    else:
        plot(ps_traces, True, f"{args.out}/mi-min.png")
        plot(snn_traces, False, f"{args.out}/mi-max.png")
        print(f"wrote {args.out}/mi-min.png and mi-max.png")
    return ps_traces, snn_traces


if __name__ == "__main__":
    main()
