"""Figure styling and ``savefig`` for the experiment scripts (the port's
copy of ``experiments/figures.py`` of the JAX package, which imports no
JAX either).

A deterministic matplotlib rcParams bundle (serif fonts, constrained
layout, golden-ratio single-column sizing) and a ``savefig`` that writes
PDF and PNG into a per-experiment results directory beside this module.
matplotlib is optional: without it both are no-ops.

    from linpde_gp_tpu_torch.experiments.figures import apply_style, savefig
    apply_style("heat_1d")
    ... matplotlib plotting ...
    savefig("posterior")          # -> results/heat_1d/posterior.{pdf,png}
"""

from __future__ import annotations

import os

_GOLDEN = (1.0 + 5.0**0.5) / 2.0

#: The rcParams bundle.
STYLE = {
    "figure.figsize": (3.25, 3.25 / _GOLDEN),
    "figure.constrained_layout.use": True,
    "figure.dpi": 150,
    "savefig.dpi": 300,
    "font.family": "serif",
    "font.size": 9,
    "axes.titlesize": 9,
    "axes.labelsize": 9,
    "legend.fontsize": 8,
    "legend.frameon": False,
    "xtick.labelsize": 8,
    "ytick.labelsize": 8,
    "axes.spines.top": False,
    "axes.spines.right": False,
    "lines.linewidth": 1.2,
    "grid.alpha": 0.25,
}

_experiment_name = None


def apply_style(experiment_name: str | None = None, **overrides):
    """Apply the rcParams bundle (no-op if matplotlib is unavailable) and
    remember ``experiment_name`` for :func:`savefig`."""
    global _experiment_name
    if experiment_name is not None:
        _experiment_name = experiment_name
    try:
        import matplotlib

        matplotlib.rcParams.update({**STYLE, **overrides})
    except ImportError:
        pass


def results_dir(experiment_name: str | None = None) -> str:
    """``results/<experiment>`` beside this module, created if missing."""
    name = experiment_name or _experiment_name or "misc"
    out = os.path.join(os.path.dirname(os.path.abspath(__file__)), "results", name)
    os.makedirs(out, exist_ok=True)
    return out


def savefig(stem: str, fig=None, *, experiment_name: str | None = None, formats=("pdf", "png")):
    """Save the current (or given) figure as ``results/<experiment>/<stem>.<fmt>``
    per format; returns the paths ([] without matplotlib)."""
    try:
        import matplotlib.pyplot as plt
    except ImportError:
        return []
    fig = fig or plt.gcf()
    out = results_dir(experiment_name)
    paths = []
    for fmt in formats:
        path = os.path.join(out, f"{stem}.{fmt}")
        fig.savefig(path, format=fmt, bbox_inches="tight")
        paths.append(path)
    return paths
