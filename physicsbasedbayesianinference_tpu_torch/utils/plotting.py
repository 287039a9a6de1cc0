"""Plot helpers for the reference's figures (port of the JAX package's
``utils/plotting.py``): orbits, integrator error against step size,
sample scatter against reference draws and energy drift. Each takes torch
tensors (on any device) or numpy arrays and returns the matplotlib figure.

matplotlib is imported when a helper runs, with the Agg backend, and this
module itself is loaded only on first use (``utils.__getattr__``): nothing
else of the package needs it.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch


def _plt():
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        return plt
    except ImportError as e:  # pragma: no cover
        raise ImportError(
            "plotting helpers require matplotlib (not a core dependency)"
        ) from e


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def plot_trajectories(traj_x, *, body_names: Optional[Sequence[str]] = None,
                      save_path: Optional[str] = None):
    """Orbit plot from a physics Trajectory's positions [T, N, D]
    (the reference's solar-system figures)."""
    plt = _plt()
    x = _np(traj_x)
    fig, ax = plt.subplots(figsize=(6, 6))
    for b in range(x.shape[1]):
        label = body_names[b] if body_names else f"body {b}"
        ax.plot(x[:, b, 0], x[:, b, 1], lw=0.8, label=label)
    ax.set_xlabel("x")
    ax.set_ylabel("y")
    ax.set_aspect("equal")
    ax.legend()
    if save_path:
        fig.savefig(save_path, dpi=120, bbox_inches="tight")
    return fig


def plot_error_vs_stepsize(step_sizes, errors_by_method: dict,
                           save_path: Optional[str] = None):
    """Log-log integrator-accuracy plot (the reference's
    qErrorVsStepSize.png)."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(6, 4))
    for name, errs in errors_by_method.items():
        ax.loglog(_np(step_sizes), _np(errs), "o-",
                  label=name)
    ax.set_xlabel("step size")
    ax.set_ylabel("|q_num - q_analytic|")
    ax.legend()
    ax.grid(True, which="both", alpha=0.3)
    if save_path:
        fig.savefig(save_path, dpi=120, bbox_inches="tight")
    return fig


def plot_samples(samples, *, dims=(0, 1), reference_samples=None,
                 save_path: Optional[str] = None):
    """Posterior sample scatter, optionally against reference draws
    (the reference's HMC-vs-np.random.multivariate_normal comparison,
    test_HMC.py:131-175)."""
    plt = _plt()
    s = _np(samples)
    s = s.reshape(-1, s.shape[-1])
    fig, ax = plt.subplots(figsize=(5, 5))
    if reference_samples is not None:
        r = _np(reference_samples)
        ax.scatter(r[:, dims[0]], r[:, dims[1]], s=2, alpha=0.2,
                   label="reference", color="tab:gray")
    ax.scatter(s[:, dims[0]], s[:, dims[1]], s=2, alpha=0.3,
               label="sampler", color="tab:blue")
    ax.set_xlabel(f"dim {dims[0]}")
    ax.set_ylabel(f"dim {dims[1]}")
    ax.legend()
    if save_path:
        fig.savefig(save_path, dpi=120, bbox_inches="tight")
    return fig


def plot_energy_drift(times, energies, save_path: Optional[str] = None):
    """log10 |E_t - E_0| / |E_0| over time (the reference's drift plots,
    NBody.py:68-77)."""
    plt = _plt()
    t = _np(times)
    e = _np(energies)
    drift = np.abs(e - e[0]) / np.abs(e[0])
    fig, ax = plt.subplots(figsize=(6, 4))
    ax.semilogy(t, np.maximum(drift, 1e-17))
    ax.set_xlabel("time")
    ax.set_ylabel("|E - E0| / |E0|")
    ax.grid(True, alpha=0.3)
    if save_path:
        fig.savefig(save_path, dpi=120, bbox_inches="tight")
    return fig
