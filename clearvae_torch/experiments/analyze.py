"""Aggregate per-seed downstream-classification result JSONs into tidy
DataFrames and boxplots (counterpart of ``clearvae_tpu/experiments/
analyze.py``, which it copies; reference code/expr/analyze_cls_rlt.ipynb
cells 1-5: relative accuracy/mAP/mAUC vs #training styles K, per model).

It reads the ``{prefix}-k{k}-{seed}.json`` files that
``styledmnist_downstream`` (and the 64×64 runners) write, with pandas and
scipy; matplotlib draws the boxplots where it is installed, and ``main``
says so where it is not. It touches no device and takes no lock.

Usage:
  python -m clearvae_torch.experiments.analyze --result_dir DIR \
      [--prefix styledmnist] [--markdown] [--paired] [--out DIR]
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re

import pandas as pd

from clearvae_torch.utils.visual import missing_packages


def load_results(result_dir: str, prefix: str) -> pd.DataFrame:
    """Read ``{prefix}-k{k}-{seed}.json`` files into a tidy frame with
    columns model, k, seed, acc, map, mauc."""
    rows = []
    for path in sorted(glob.glob(os.path.join(result_dir, f"{prefix}-k*.json"))):
        m = re.search(rf"{re.escape(prefix)}-k(\d+)-(\d+)\.json$", path)
        if not m:
            continue
        k, seed = int(m.group(1)), int(m.group(2))
        res = json.load(open(path))
        for model, r in res.items():
            rows.append({"model": model, "k": k, "seed": seed,
                         "acc": r["acc"], "map": r["pr"]["overall"],
                         "mauc": r["roc"]["overall"]})
    return pd.DataFrame(rows)


def relative_to_baseline(df: pd.DataFrame, baseline: str = "baseline") -> pd.DataFrame:
    """Per (k, seed): metric of each model divided by the baseline CNN's
    (the notebook's 'relative' views)."""
    out = []
    for (k, seed), grp in df.groupby(["k", "seed"]):
        base = grp[grp.model == baseline]
        if base.empty:
            continue
        b = base.iloc[0]
        for _, r in grp.iterrows():
            out.append({"model": r.model, "k": k, "seed": seed,
                        "rel_acc": r.acc / max(b.acc, 1e-9),
                        "rel_map": r["map"] / max(b["map"], 1e-9),
                        "rel_mauc": r.mauc / max(b.mauc, 1e-9)})
    return pd.DataFrame(out)


def boxplots(df: pd.DataFrame, metric: str, save: str | None = None):
    """Boxplot of ``metric`` vs k, grouped by model (matplotlib; the
    reference uses seaborn with the same layout)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    models = sorted(df.model.unique())
    ks = sorted(df.k.unique())
    fig, ax = plt.subplots(figsize=(1.2 * len(ks) * len(models) / 4 + 3, 4))
    width = 0.8 / len(models)
    cmap = plt.get_cmap("tab10")
    for mi, model in enumerate(models):
        data = [df[(df.model == model) & (df.k == k)][metric].values
                for k in ks]
        pos = [k + (mi - len(models) / 2) * width for k in ks]
        bp = ax.boxplot(data, positions=pos, widths=width * 0.9,
                        patch_artist=True)
        for box in bp["boxes"]:
            box.set_facecolor(cmap(mi % 10))
    ax.set_xticks(ks)
    ax.set_xticklabels([str(k) for k in ks])
    ax.set_xlabel("# training styles K")
    ax.set_ylabel(metric)
    handles = [plt.Line2D([0], [0], color=cmap(i % 10), lw=6)
               for i in range(len(models))]
    ax.legend(handles, models, fontsize=7, ncol=2)
    if save:
        fig.savefig(save, bbox_inches="tight", dpi=120)
    plt.close(fig)
    return fig


def markdown_table(df: pd.DataFrame, metric: str = "acc") -> str:
    """Mean-over-seeds (±std when >1 seed) `metric` per model × k, as a
    markdown table (the BASELINE.md evidence format)."""
    ks = sorted(df.k.unique())
    lines = ["| model | " + " | ".join(f"k={k}" for k in ks) + " |",
             "|---|" + "---|" * len(ks)]
    for model in sorted(df.model.unique()):
        cells = []
        for k in ks:
            vals = df[(df.model == model) & (df.k == k)][metric].values
            if len(vals) == 0:
                cells.append("—")
            elif len(vals) == 1:
                cells.append(f"{vals[0]:.3f}")
            else:
                cells.append(f"{vals.mean():.3f}±{vals.std():.3f}")
        lines.append(f"| {model} | " + " | ".join(cells) + " |")
    return "\n".join(lines)


def paired_deltas(df: pd.DataFrame, metric: str = "acc",
                  baseline: str = "baseline") -> pd.DataFrame:
    """Seed-paired model-minus-baseline deltas per k: mean delta, std of
    the per-seed deltas, and win count. Pairing within each (k, seed)
    removes the between-seed variance that inflates the marginal std —
    the right lens when all models of a seed share its style split."""
    rows = []
    for (k, seed), grp in df.groupby(["k", "seed"]):
        base = grp[grp.model == baseline]
        if base.empty:
            continue
        b = float(base.iloc[0][metric])
        for _, r in grp.iterrows():
            if r.model == baseline:
                continue
            rows.append({"model": r.model, "k": k, "seed": seed,
                         "delta": float(r[metric]) - b})
    d = pd.DataFrame(rows)
    if d.empty:
        return d
    out = d.groupby(["model", "k"])["delta"].agg(
        mean="mean", std="std", wins=lambda s: int((s > 0).sum()),
        n="count", p=_wilcoxon_greater).reset_index()
    return out


def _wilcoxon_greater(deltas) -> float:
    """One-sided Wilcoxon signed-rank p-value for H1: median delta > 0
    (the seed-paired 'model beats baseline' claim). NaN when the test is
    undefined (n < 5 signed pairs, or every delta exactly 0)."""
    import numpy as np
    vals = np.asarray(deltas, dtype=float)
    vals = vals[vals != 0.0]  # wilcoxon's standard zero-handling
    if len(vals) < 5:
        return float("nan")
    from scipy import stats
    return float(stats.wilcoxon(vals, alternative="greater").pvalue)


def paired_markdown(df: pd.DataFrame, metric: str = "acc",
                    baseline: str = "baseline") -> str:
    """Markdown table of paired deltas vs the baseline: `+mean±std (wins/n)`
    per model × k."""
    d = paired_deltas(df, metric, baseline)
    if d.empty:
        return "(no paired results)"
    ks = sorted(d.k.unique())
    lines = [f"| model (Δ{metric} vs {baseline}) | "
             + " | ".join(f"k={k}" for k in ks) + " |",
             "|---|" + "---|" * len(ks)]
    for model in sorted(d.model.unique()):
        cells = []
        for k in ks:
            r = d[(d.model == model) & (d.k == k)]
            if r.empty:
                cells.append("—")
            else:
                r = r.iloc[0]
                std = f"±{r['std']:.3f}" if r["n"] > 1 else ""
                pv = "" if pd.isna(r["p"]) else f" p={r['p']:.3f}"
                cells.append(f"{r['mean']:+.3f}{std} ({int(r['wins'])}/"
                             f"{int(r['n'])}{pv})")
        lines.append(f"| {model} | " + " | ".join(cells) + " |")
    return "\n".join(lines)


def main(argv=None):
    # no enable_compilation_cache() here: this aggregator touches no device,
    # and the call would needlessly take the single-GPU-process lock while
    # a campaign holds the card
    p = argparse.ArgumentParser()
    p.add_argument("--result_dir", type=str, required=True)
    p.add_argument("--prefix", type=str, default="styledmnist")
    p.add_argument("--out", type=str, default=None)
    p.add_argument("--markdown", action="store_true",
                   help="print mean±std accuracy as a markdown table")
    p.add_argument("--paired", action="store_true",
                   help="also print seed-paired model-minus-baseline deltas")
    args = p.parse_args(argv)
    df = load_results(args.result_dir, args.prefix)
    if args.markdown:
        print(markdown_table(df))
    else:
        print(df.groupby(["model", "k"])[["acc", "map", "mauc"]].mean()
              .round(3))
    if args.paired:
        print()
        print(paired_markdown(df))
    rel = relative_to_baseline(df)
    if args.out and not rel.empty:
        if missing_packages("matplotlib"):
            print("boxplots not written: matplotlib not installed")
            return df, rel
        os.makedirs(args.out, exist_ok=True)
        for metric in ["rel_acc", "rel_map", "rel_mauc"]:
            boxplots(rel, metric, f"{args.out}/{args.prefix}-{metric}.png")
    return df, rel


if __name__ == "__main__":
    main()
