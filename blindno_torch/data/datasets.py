"""Dataset containers, normalization and batching for the 2-D suites, fpe2d and ncfpe2d
(counterpart of ``blindno/data/datasets.py:27-92,129-154``).

Everything here is numpy and gives the JAX package's numbers bit for bit: the fixed
unit rescale, then per-gridpoint standardization with train-set statistics
(``2d_FPE/train_nio.py:21-38`` and ``2d_Non_conservative_FPE/train_nio.py:21-36`` of the
reference). :meth:`FieldStats.denormalize` also takes tensors. Whole splits live on the
device in :func:`blindno_torch.train.loop.train_model`; batches are device-side gathers.
The other suites' loaders come with their suites.
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


# Unit-rescale constants (traj, target fields), blindno/data/datasets.py:51-52
FPE2D_SCALES = {"trajectories": 1e10, "potential": 1e21, "drag": 1e6}
NCFPE2D_SCALES = {"trajectories": 1e10, "F": 1e12}


@dataclass
class SetToFieldData:
    """Normalized arrays for one suite: inputs (M, L, *grid), targets (M, *grid, n_fields)."""

    inputs: np.ndarray
    targets: np.ndarray
    stats: dict = field(default_factory=dict)
    grid: np.ndarray | None = None


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


def train_test_split(n: int, train_frac: float = 0.8, seed: int = 0):
    """80/20 split by a seeded numpy permutation."""
    perm = np.random.default_rng(seed).permutation(n)
    n_train = int(train_frac * n)
    return perm[:n_train], perm[n_train:]


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
