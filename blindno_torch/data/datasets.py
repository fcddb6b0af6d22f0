"""Dataset containers, normalization and batching for every suite (counterpart of
``blindno/data/datasets.py``).

Everything here is numpy and gives the JAX package's numbers bit for bit. The FPE suites
(fpe1d, fpe2d, ncfpe2d) take a fixed unit rescale, then per-gridpoint standardization
with train-set statistics (``1d_FPE/train_nio.py:19-37``, ``2d_FPE/train_nio.py:21-38``
and ``2d_Non_conservative_FPE/train_nio.py:21-36`` of the reference); the GPE suites
(schrodinger1d, gpe1d, gpe1d_vgk) a global division by maxima (:class:`MaxStats`).
:meth:`FieldStats.denormalize` also takes tensors. Whole splits live on the device in
:func:`blindno_torch.train.loop.train_model`; batches are device-side gathers.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch


@dataclass
class FieldStats:
    """Per-field standardization stats (computed AFTER unit rescale, like the reference)."""

    scale: float
    mean: np.ndarray
    std: np.ndarray

    @classmethod
    def standardize(cls, raw: np.ndarray, scale: float, axes) -> tuple["FieldStats", np.ndarray]:
        scaled = raw.astype(np.float32) * scale
        mean = scaled.mean(axis=axes, keepdims=True)
        std = scaled.std(axis=axes, keepdims=True) + 1e-8
        return cls(scale, mean, std), (scaled - mean) / std

    def normalize(self, raw: np.ndarray) -> np.ndarray:
        return (raw.astype(np.float32) * self.scale - self.mean) / self.std

    def denormalize(self, norm):
        """numpy in, numpy out; a tensor in, a tensor out on its device."""
        if isinstance(norm, torch.Tensor):
            std, mean = (torch.as_tensor(a, device=norm.device) for a in (self.std, self.mean))
            return (norm * std + mean) / self.scale
        return (norm * self.std + self.mean) / self.scale


# Unit-rescale constants (traj, target fields), blindno/data/datasets.py:50-52
FPE1D_SCALES = {"trajectories": 1e5, "potential": 1e20, "drag": 1e5}
FPE2D_SCALES = {"trajectories": 1e10, "potential": 1e21, "drag": 1e6}
NCFPE2D_SCALES = {"trajectories": 1e10, "F": 1e12}


@dataclass
class SetToFieldData:
    """Normalized arrays for one suite: inputs (M, L, *grid), targets (M, *grid, n_fields)."""

    inputs: np.ndarray
    targets: np.ndarray
    stats: dict = field(default_factory=dict)
    grid: np.ndarray | None = None


def load_fpe1d(data: dict) -> SetToFieldData:
    """1-D FPE: targets = stack(potential, the scalar drag replicated over the grid)
    (B, Nx, 2) (``1d_FPE/train_nio.py:43-58``)."""
    traj_stats, traj = FieldStats.standardize(np.asarray(data["trajectories"]), FPE1D_SCALES["trajectories"], (0, 1))
    pot_stats, pot = FieldStats.standardize(np.asarray(data["potential"]), FPE1D_SCALES["potential"], (0,))
    drag_stats, drag = FieldStats.standardize(np.asarray(data["drag"]).reshape(-1, 1), FPE1D_SCALES["drag"], (0,))
    targets = np.stack([pot, np.repeat(drag, pot.shape[1], axis=1)], axis=2)
    return SetToFieldData(traj, targets, {"traj": traj_stats, "potential": pot_stats, "drag": drag_stats})


def load_fpe2d(data: dict) -> SetToFieldData:
    """2-D FPE: targets = stack(potential, drag-field) (B, Nx, Ny, 2) (``2d_FPE/train_nio.py:43-60``)."""
    traj_stats, traj = FieldStats.standardize(np.asarray(data["trajectories"]), FPE2D_SCALES["trajectories"], (0, 1))
    pot_stats, pot = FieldStats.standardize(np.asarray(data["potential"]), FPE2D_SCALES["potential"], (0,))
    drag_stats, drag = FieldStats.standardize(np.asarray(data["drag"]), FPE2D_SCALES["drag"], (0,))
    targets = np.stack([pot, drag], axis=3)
    return SetToFieldData(traj, targets, {"traj": traj_stats, "potential": pot_stats, "drag": drag_stats})


def load_ncfpe2d(data: dict) -> SetToFieldData:
    """2-D NC FPE: targets = (Fx, Fy) (B, Nx, Ny, 2), the force standardized per channel
    and gridpoint as the archive holds it, (M, 2, Nx, Ny), then moved channel-last
    (``2d_Non_conservative_FPE/train_nio.py:21-36``)."""
    traj_stats, traj = FieldStats.standardize(np.asarray(data["trajectories"]), NCFPE2D_SCALES["trajectories"], (0, 1))
    f_stats, f_norm = FieldStats.standardize(np.asarray(data["F"]), NCFPE2D_SCALES["F"], (0,))
    return SetToFieldData(traj, np.moveaxis(f_norm, 1, -1), {"traj": traj_stats, "F": f_stats})


@dataclass
class MaxStats:
    """The GPE suites' global maxima of the snapshots, V, g and kappa."""

    y_max: float
    v_max: float
    g_max: float
    kappa_max: float


def load_gpe1d(data: dict, thirds: bool = True, include_gk: bool = False) -> SetToFieldData:
    """GPE and Schrodinger: division by global maxima. ``thirds`` divides by a third of the
    snapshots' and V's maxima (``train_nio_GPE.py:46-57``); ``include_gk`` appends g and
    kappa, each replicated over the grid, as two more target channels (``train_GPE.py:
    25-53``, targets (Nx, 3))."""
    y = np.asarray(data["y"], np.float32)
    v = np.asarray(data["V"], np.float32)
    g = np.asarray(data["g"], np.float32)
    kappa = np.asarray(data["kappa"], np.float32)
    div = 3.0 if thirds else 1.0
    y_max = float(y.max()) / div
    v_max = float(v.max()) / div
    g_max = float(g.max()) if g.max() > 0 else 1.0
    k_max = float(kappa.max()) if kappa.max() > 0 else 1.0
    y = y / y_max
    v = v / v_max
    nx = v.shape[1]
    if include_gk:
        gk = np.stack([np.repeat((g / g_max)[:, None], nx, axis=1),
                       np.repeat((kappa / k_max)[:, None], nx, axis=1)], axis=2)
        targets = np.concatenate([v[..., None], gk], axis=2)
    else:
        targets = v[..., None]
    return SetToFieldData(y, targets, {"max": MaxStats(y_max, v_max, g_max, k_max)})


def train_test_split(n: int, train_frac: float = 0.8, seed: int = 0):
    """80/20 split by a seeded numpy permutation."""
    perm = np.random.default_rng(seed).permutation(n)
    n_train = int(train_frac * n)
    return perm[:n_train], perm[n_train:]


def epoch_batch_indices(generator: torch.Generator, n: int, batch_size: int) -> torch.Tensor:
    """An epoch's shuffled batches, (n // batch_size, batch_size) indices into n samples:
    a permutation of range(n) drawn from ``generator`` (on its device), its tail past the
    last full batch dropped, as the JAX package's ``epoch_batch_indices`` shapes it."""
    perm = torch.randperm(n, generator=generator, device=generator.device)
    n_batches = n // batch_size
    return perm[: n_batches * batch_size].reshape(n_batches, batch_size)


def eval_batches(n: int, batch_size: int):
    """Index/mask pairs covering all n samples with a padded final batch."""
    out = []
    for s in range(0, n, batch_size):
        idx = np.arange(s, min(s + batch_size, n))
        mask = np.ones(batch_size, np.float32)
        if idx.shape[0] < batch_size:
            mask[idx.shape[0]:] = 0.0
            idx = np.concatenate([idx, np.zeros(batch_size - idx.shape[0], np.int64)])
        out.append((idx, mask))
    return out
