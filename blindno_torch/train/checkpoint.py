"""Checkpointing: best-by-metric retention plus full resume state (counterpart of
``blindno/train/checkpoint.py``), in the JAX package's own formats, so that either
package takes over a workdir that the other trained in.

``best_{loss:.6f}_e{epoch}`` is the orbax directory that JAX's ``save_best`` writes, of
the params and batch statistics of the best eval so far; ``resume.msgpack`` is flax's
msgpack of the params, batch statistics, optax's Adam state, the epoch and the best
loss, as JAX's ``save_resume`` writes it. Both are written and read without JAX
(:mod:`blindno_torch.train.jax_checkpoint`); :func:`blindno_torch.convert.to_flax` and
:func:`~blindno_torch.convert.from_flax_checkpoint` map the trees, and
:func:`~blindno_torch.convert.adam_to_optax` and
:func:`~blindno_torch.convert.adam_from_optax` the optimizer's. Here ``params`` are the
model's named parameters and ``batch_stats`` its named buffers (the BatchNorm running
statistics).

An earlier version of the port wrote ``torch.save`` files, under the same ``best_*``
names and as ``resume.pt``: :func:`load_best` and :func:`load_resume` still read them, and
:func:`save_best` removes such a file as an older entry. Among the ``best_*`` entries of
both kinds the smallest loss wins, and :func:`save_best` removes the others, files or
directories, as JAX's does.

Among several ranks, only rank 0 writes, and every training rank waits for it at a
barrier of the group that the writers' ``group=`` names (the world unless given): the
state it is handed is the whole, unsharded one
(``blindno_torch.parallel.tp.gather_state``), as JAX's ``jax.device_get`` writes it, so a
checkpoint loads into a single-process model and a run resumes at any ``tp``.
"""
from __future__ import annotations

import contextlib
import functools
import glob
import os
import shutil

import numpy as np
import torch

from blindno_torch.convert import from_flax_checkpoint, to_flax
from blindno_torch.parallel.mesh import barrier, is_main_process
from blindno_torch.train import jax_checkpoint

RESUME = "resume.msgpack"
OLD_RESUME = "resume.pt"  # an earlier port version's torch.save file


def _best_loss_of(path: str) -> float:
    """Parse the loss out of a ``best_{loss:.6f}[_e{epoch}]`` name."""
    try:
        return float(os.path.basename(path).split("_")[1])
    except (IndexError, ValueError):
        return float("inf")


def _remove(path: str):
    """Remove a ``best_*`` entry, a directory or (an earlier port version's) a file, never
    raising, as JAX's ``save_best`` removes its old ones (``shutil.rmtree(...,
    ignore_errors=True)``)."""
    if os.path.isdir(path):
        shutil.rmtree(path, ignore_errors=True)
    else:
        with contextlib.suppress(OSError):
            os.remove(path)


def _write_atomic(write, path: str):
    """``write(tmp)`` to a hidden temporary file or directory beside ``path``, then renamed
    into place, so a crash mid-write never leaves a partial entry under ``path``'s name.
    The temporary name starts with a dot: no ``best_*`` glob takes it."""
    tmp = os.path.join(os.path.dirname(path), f".{os.path.basename(path)}.tmp")
    _remove(tmp)  # a crashed write's
    write(tmp)
    os.replace(tmp, path)


def _flax_sorted(tree: dict) -> dict:
    """``tree`` with every dict's keys in order, as ``jax.device_get`` returns it."""
    return {k: _flax_sorted(v) if isinstance(v, dict) else v for k, v in sorted(tree.items())}


def _main_writes(save):
    """``save`` run by rank 0 alone (or the only process); every rank of ``group`` (the
    training ranks; the world unless given) then waits at a barrier, so no rank reads or
    replaces a file that is still being written."""

    @functools.wraps(save)
    def wrapper(*args, group=None, **kwargs):
        path = save(*args, **kwargs) if is_main_process() else None
        barrier(group)
        return path

    return wrapper


@_main_writes
def save_best(ckpt_dir: str, params: dict, batch_stats: dict, epoch: int, test_loss: float):
    """Save best params/batch_stats to ``{dir}/best_{loss:.6f}_e{epoch}``, the orbax
    directory that JAX's ``save_best`` writes of their flax trees.

    The epoch suffix keeps names unique when two improvements round to the same
    6-decimal loss. The new checkpoint is written BEFORE older ``best_*`` entries are
    deleted, so a crash mid-save never leaves the directory without one (and
    :func:`load_best` picks the numerically best if more than one survives). The older
    entries go whatever wrote them, as JAX's ``save_best`` removes them
    (``blindno/train/checkpoint.py:62-64``)."""
    os.makedirs(ckpt_dir, exist_ok=True)
    olds = glob.glob(os.path.join(ckpt_dir, "best_*"))
    path = os.path.abspath(os.path.join(ckpt_dir, f"best_{test_loss:.6f}_e{epoch}"))
    if os.path.exists(path):
        # same loss AND epoch: a resume replay. Move the old entry ASIDE (it still parses
        # as a valid fallback for load_best) and delete it only after the new save lands
        aside = path + ".old"
        _remove(aside)
        os.replace(path, aside)
        olds = [aside if os.path.abspath(o) == path else o for o in olds]
    flax_params, flax_stats = to_flax({**params, **batch_stats})
    tree = {"params": flax_params, "batch_stats": flax_stats, "epoch": int(epoch),
            "test_loss": float(test_loss)}
    _write_atomic(lambda tmp: jax_checkpoint.write_orbax(tmp, tree), path)
    for old in olds:
        if os.path.abspath(old) != path:
            _remove(old)
    return path


def load_best(ckpt_dir: str, map_location="cpu"):
    """Load the numerically-best checkpoint in ``ckpt_dir`` (smallest parsed loss:
    lexicographic order would pick the WORST if several ``best_*`` survive a crash),
    an orbax directory or an earlier port version's file, as ``{"params",
    "batch_stats", "epoch", "test_loss"}`` with its tensors on ``map_location``. A
    directory that orbax did not write raises
    :class:`~blindno_torch.train.jax_checkpoint.JaxCheckpointError`."""
    matches = glob.glob(os.path.join(os.path.abspath(ckpt_dir), "best_*"))
    if not matches:
        raise FileNotFoundError(f"no best_* checkpoint under {ckpt_dir}")
    best = min(matches, key=_best_loss_of)
    if not os.path.isdir(best):
        return torch.load(best, map_location=map_location, weights_only=True)
    if not jax_checkpoint.is_orbax(best):
        raise jax_checkpoint.JaxCheckpointError(
            f"{best}: a directory, but not a checkpoint that orbax wrote with OCDBT (it has "
            f"no {' and '.join(jax_checkpoint.ORBAX_FILES)})")
    raw = from_flax_checkpoint(jax_checkpoint.read_orbax(best))
    for key in ("params", "batch_stats"):
        raw[key] = {k: v.to(map_location) for k, v in raw[key].items()}
    return raw


def _finite(tree: dict) -> bool:
    return all(torch.isfinite(v).all() for v in tree.values() if v.is_floating_point())


def load_best_as_warm_restart(ckpt_dir: str, params_target: dict, batch_stats_target: dict):
    """Best-checkpoint fallback for when the resume file is gone.

    Returns ``{"params", "batch_stats", "epoch", "test_loss"}``, or ``None`` when no
    ``best_*`` exists, its keys or shapes differ from the targets' (a different model),
    or its params are non-finite. Optimizer state is NOT recoverable from a best
    checkpoint: the caller performs a warm restart (fresh moments, advanced step count)."""
    try:
        raw = load_best(ckpt_dir)
    except FileNotFoundError:
        return None
    params, stats = raw["params"], raw.get("batch_stats") or {}
    for got, want in ((params, params_target), (stats, batch_stats_target)):
        if got.keys() != want.keys():
            print(f"[checkpoint] best-checkpoint warm restart: keys differ "
                  f"({sorted(got.keys() ^ want.keys())[:4]}...); starting fresh")
            return None
        if any(got[k].shape != want[k].shape for k in want):
            print("[checkpoint] best checkpoint shapes mismatch the model; starting fresh")
            return None
    if not _finite(params):
        print("[checkpoint] best checkpoint has non-finite params; starting fresh")
        return None
    return {"params": params, "batch_stats": stats,
            "epoch": int(raw["epoch"]), "test_loss": float(raw["test_loss"])}


@_main_writes
def save_resume(ckpt_dir: str, params: dict, batch_stats: dict, opt_state: dict, epoch: int,
                best_loss: float):
    """Full resume state, written atomically to ``{dir}/resume.msgpack`` as JAX's
    ``save_resume`` writes it: the flax trees of the params and batch statistics,
    ``opt_state`` (optax's Adam state, :func:`blindno_torch.convert.adam_to_optax`), the
    epoch and the best loss, every tree's keys in ``jax.device_get``'s order. An earlier
    port version's ``resume.pt`` goes once it is written: this state is newer."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, RESUME)
    flax_params, flax_stats = to_flax({**params, **batch_stats})
    state = {"params": _flax_sorted(flax_params), "batch_stats": _flax_sorted(flax_stats),
             "opt_state": _flax_sorted(opt_state), "epoch": int(epoch),
             "best_loss": float(best_loss)}
    _write_atomic(lambda tmp: jax_checkpoint.write_msgpack(tmp, state), path)
    _remove(os.path.join(ckpt_dir, OLD_RESUME))
    return path


def _read_resume(path: str) -> dict:
    """The resume state in ``path``: ``resume.msgpack``, whose ``opt_state`` is optax's
    tree (:func:`blindno_torch.convert.adam_from_optax` maps it onto an optimizer), or an
    earlier port version's ``resume.pt``, whose ``opt_state`` is ``Adam.state_dict()``."""
    if os.path.basename(path) == OLD_RESUME:
        return torch.load(path, map_location="cpu", weights_only=True)
    raw = jax_checkpoint.read_msgpack(path)
    state = from_flax_checkpoint({**raw, "test_loss": raw["best_loss"]})
    # torch counts each BatchNorm's training batches, which flax does not keep: every
    # training step runs each BatchNorm once, so the count is Adam's
    count = int(np.asarray(raw["opt_state"]["0"]["count"]))
    stats = {k: torch.tensor(count) if k.endswith("num_batches_tracked") else v
             for k, v in state["batch_stats"].items()}
    return {"params": state["params"], "batch_stats": stats, "opt_state": raw["opt_state"],
            "epoch": int(raw["epoch"]), "best_loss": float(raw["best_loss"])}


def load_resume(ckpt_dir: str):
    """The state :func:`save_resume` wrote, read to the host, with its ``"path"``, or
    ``None`` when there is none. Where an earlier port version left a ``resume.pt`` of a
    later epoch than ``resume.msgpack``'s (or there is no ``resume.msgpack``), that is
    read instead (see :func:`_read_resume`).

    Rejects non-finite restored params: the file is moved aside as
    ``<name>.poisoned`` so that a diverged run does not silently seed the next, and the
    other file, if any, is tried."""
    found = [_read_resume(p) | {"path": p}
             for p in (os.path.join(ckpt_dir, RESUME), os.path.join(ckpt_dir, OLD_RESUME))
             if os.path.exists(p)]
    # the later epoch first; resume.msgpack first on a tie (a stable sort keeps the order)
    for state in sorted(found, key=lambda s: -s["epoch"]):
        if _finite(state["params"]):
            return state
        quarantine = state["path"] + ".poisoned"
        os.replace(state["path"], quarantine)
        print(f"[checkpoint] resume state has non-finite params; quarantined -> {quarantine}")
    return None
