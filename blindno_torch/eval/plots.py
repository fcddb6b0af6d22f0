"""Paper-style figures (counterpart of ``blindno/eval/plots.py``): drift comparison,
error over time, final density, space-time maps and 2-D fields.

The reference's ``plot_*.py`` family as reusable functions over numpy arrays, in its
house style (DejaVu + STIX math, no top/right spines, a fixed model palette;
``1d_FPE/plot_error_over_time.py:5-25``). matplotlib is imported only when a figure is
drawn (:func:`_style`, with the Agg backend), so the package imports without it.
"""
from __future__ import annotations

import numpy as np

HOUSE_STYLE = {
    "font.family": "DejaVu Sans",
    "mathtext.fontset": "stix",
    "font.size": 20,
    "axes.labelsize": 20,
    "axes.spines.right": False,
    "axes.spines.top": False,
    "legend.frameon": True,
    "legend.framealpha": 0.8,
    "legend.fancybox": False,
    "legend.borderpad": 0.1,
    "legend.borderaxespad": 0.2,
    "lines.linewidth": 2,
}

COLORS = {
    "blindno": "#0B346E",  # deep blue
    "nio": "#00A7A7",  # teal
    "fno": "#2F7D32",  # green
    "other": "#9E9E9E",  # grey
    "ref": "#D32F2F",  # red (GT / reference)
}


def _style():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    matplotlib.rcParams.update(HOUSE_STYLE)
    return plt


def normalize_potential(u, u_ref):
    """Normalize by GT so max -> 0, min -> -1 (``plot_drift_comparison.py:48-56``)."""
    umax, umin = u_ref.max(), u_ref.min()
    return (u - umax) / (umax - umin)


def plot_drift_comparison(x, u_gt, model_potentials: dict, out_path: str):
    """1-D potential comparison, GT-normalized to [-1, 0]. model_potentials maps a
    palette key ('blindno'/'nio'/'fno'/...) to a (Nx,) array."""
    plt = _style()
    fig, ax = plt.subplots(figsize=(6, 6), constrained_layout=True)
    for name, u in model_potentials.items():
        label = {"blindno": "BlinDNO", "nio": "NIO", "fno": "FNO-NIO"}.get(name, name)
        ax.plot(x, normalize_potential(u, u_gt), color=COLORS.get(name, COLORS["other"]), label=label)
    ax.plot(x, normalize_potential(u_gt, u_gt), "--", color=COLORS["ref"], label="Reference")
    ax.set_xlabel("$x$")
    ax.set_ylabel("$U(x)$ (normalized)")
    ax.legend()
    fig.savefig(out_path, dpi=150)
    plt.close(fig)


def relative_l2_over_time(p_model, p_ref, eps: float = 1e-12):
    """(T, *grid) -> per-time rel-L2 (``plot_error_over_time.py:46-51``)."""
    t = p_model.shape[0]
    num = np.linalg.norm((p_model - p_ref).reshape(t, -1), axis=1)
    den = np.linalg.norm(p_ref.reshape(t, -1), axis=1) + eps
    return num / den


def plot_error_over_time(times, model_trajs: dict, p_ref, out_path: str):
    """Density rel-L2 vs time for several models against the GT rollout."""
    plt = _style()
    fig, ax = plt.subplots(figsize=(7, 5), constrained_layout=True)
    for name, pt in model_trajs.items():
        label = {"blindno": "BlinDNO", "nio": "NIO", "fno": "FNO-NIO"}.get(name, name)
        ax.plot(times, relative_l2_over_time(pt, p_ref), color=COLORS.get(name, COLORS["other"]), label=label)
    ax.set_xlabel("$t$")
    ax.set_ylabel("Relative $L^2$ error")
    ax.legend()
    fig.savefig(out_path, dpi=150)
    plt.close(fig)


def plot_final_density(x, model_trajs: dict, p_ref, out_path: str):
    """Final-time density comparison (``1d_GPE/plot_final_density*.py``)."""
    plt = _style()
    fig, ax = plt.subplots(figsize=(6, 5), constrained_layout=True)
    for name, pt in model_trajs.items():
        label = {"blindno": "BlinDNO", "nio": "NIO", "fno": "FNO-NIO"}.get(name, name)
        ax.plot(x, pt[-1], color=COLORS.get(name, COLORS["other"]), label=label)
    ax.plot(x, p_ref[-1], "--", color=COLORS["ref"], label="Reference")
    ax.set_xlabel("$x$")
    ax.set_ylabel(r"$\rho(x, T)$")
    ax.legend()
    fig.savefig(out_path, dpi=150)
    plt.close(fig)


def plot_spacetime_density(pt, out_path: str, extent=None, title=None):
    """Space-time |psi| / density map (``1d_GPE/plot_pt_*.py``)."""
    plt = _style()
    fig, ax = plt.subplots(figsize=(6, 5), constrained_layout=True)
    im = ax.imshow(pt, aspect="auto", origin="lower", cmap="viridis", extent=extent)
    ax.set_xlabel("$x$")
    ax.set_ylabel("$t$")
    if title:
        ax.set_title(title)
    fig.colorbar(im, ax=ax, fraction=0.046, pad=0.04)
    fig.savefig(out_path, dpi=150)
    plt.close(fig)


def plot_field_2d(field, out_path: str, title=None, clamp_nonpositive: bool = False):
    """2-D coefficient-field heatmap (``2d_FPE/plot_drift.py`` / ``plot_gt_density.py``;
    ``clamp_nonpositive`` reproduces the reference's ``U[U >= 0] = 0`` display clamp,
    ``2d_FPE/cal_traj.py:131``)."""
    plt = _style()
    field = np.asarray(field).copy()
    if clamp_nonpositive:
        field[field >= 0] = 0.0
    fig, ax = plt.subplots(figsize=(6, 5), constrained_layout=True)
    im = ax.imshow(field, origin="lower", cmap="viridis")
    if title:
        ax.set_title(title)
    fig.colorbar(im, ax=ax)
    fig.savefig(out_path, dpi=150)
    plt.close(fig)
