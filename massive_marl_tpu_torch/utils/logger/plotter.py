"""Learning-curve plotter (twin of massive_marl_tpu/utils/logger/plotter.py).

Usage: python -m massive_marl_tpu_torch.utils.logger.plotter --root logs/tenant
         --tag train/mean_reward --out curves.png

matplotlib is imported when a plot is drawn, as in the JAX package.
"""
from __future__ import annotations

import argparse
import os

import numpy as np


def smooth(y, radius: int = 5):
    """A centred moving average of half-width `radius`, the edges averaged
    over the points they have; y itself when shorter than the window."""
    if len(y) < 2 * radius + 1:
        return np.asarray(y)
    kernel = np.ones(2 * radius + 1)
    conv = np.convolve(y, kernel, mode="same")
    norm = np.convolve(np.ones_like(y), kernel, mode="same")
    return conv / norm


def plot_runs(root: str, tag: str, out: str | None = None, radius: int = 5):
    """One smoothed curve of `tag` per run dir under root that has a
    metrics.csv holding it; returns the PNG's path."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from massive_marl_tpu_torch.utils.logger.tools import read_metrics_csv

    fig, ax = plt.subplots(figsize=(7, 4.5))
    for dirpath, _, files in os.walk(root):
        if "metrics.csv" not in files:
            continue
        data = read_metrics_csv(os.path.join(dirpath, "metrics.csv"))
        if tag not in data:
            continue
        rows = sorted(data[tag], key=lambda r: r[1])
        steps = np.array([r[1] for r in rows])
        vals = smooth(np.array([r[2] for r in rows]), radius)
        ax.plot(steps, vals, label=os.path.relpath(dirpath, root))
    ax.set_xlabel("iteration")
    ax.set_ylabel(tag)
    ax.legend(fontsize=7)
    ax.grid(alpha=0.3)
    fig.tight_layout()
    out = out or os.path.join(root, tag.replace("/", "_") + ".png")
    fig.savefig(out, dpi=120)
    plt.close(fig)
    return out


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--root", required=True)
    p.add_argument("--tag", default="train/mean_reward")
    p.add_argument("--out", default=None)
    p.add_argument("--radius", type=int, default=5)
    a = p.parse_args()
    print(plot_runs(a.root, a.tag, a.out, a.radius))
