"""Plotting helpers over run logs and results (port of ``turbojax.plotting``).

``plot_regret`` draws incumbent traces (the ``incumbent_trace`` of a
``Result``, a ``BOResult`` or a ``BigBOResult``, as numpy arrays, lists or
tensors on any device); ``plot_run_log`` draws a ``RunLog``'s records.
matplotlib is optional: it is imported only when a plot is asked for.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


def _numpy(values) -> np.ndarray:
    if hasattr(values, "detach"):  # a tensor, on any device
        values = values.detach().cpu().numpy()
    return np.asarray(values, dtype=float)


def _plt():
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        return plt
    except ImportError as e:  # pragma: no cover
        raise ImportError("plotting requires matplotlib") from e


def plot_regret(
    curves,
    labels: Optional[Sequence[str]] = None,
    optimum: float = 0.0,
    path: str = "regret.png",
    title: str = "simple regret",
    log_scale: bool = True,
):
    """Save incumbent-trace / regret curves to ``path``. ``curves`` is one
    trace or a list of traces of best-so-far values (regrets if
    ``optimum=0``)."""
    plt = _plt()
    if np.ndim(curves[0]) == 0:
        curves = [curves]
    fig, ax = plt.subplots(figsize=(6, 4))
    for i, c in enumerate(curves):
        r = _numpy(c) - optimum
        label = labels[i] if labels else None
        ax.plot(np.arange(1, len(r) + 1), np.maximum(r, 1e-12), label=label)
    if log_scale:
        ax.set_yscale("log")
    ax.set_xlabel("iteration")
    ax.set_ylabel("simple regret")
    ax.set_title(title)
    if labels:
        ax.legend()
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return path


def plot_run_log(records, path: str = "run.png"):
    """Panel plot of a ``RunLog``'s records to ``path``: the incumbent, and
    the TR length when the records have it."""
    plt = _plt()
    iters = [r["iter"] for r in records]
    best = [r.get("best_y") for r in records]
    has_tr = any("tr_length" in r for r in records)
    fig, axes = plt.subplots(1, 2 if has_tr else 1, figsize=(10 if has_tr else 6, 4))
    ax0 = axes[0] if has_tr else axes
    ax0.plot(iters, best)
    ax0.set_xlabel("iteration")
    ax0.set_ylabel("best y")
    if has_tr:
        axes[1].plot(iters, [r.get("tr_length", np.nan) for r in records])
        axes[1].set_xlabel("iteration")
        axes[1].set_ylabel("TR length")
        axes[1].set_yscale("log")
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return path
