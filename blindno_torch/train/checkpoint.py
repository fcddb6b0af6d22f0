"""Checkpointing: best-by-metric retention plus full resume state (counterpart of
``blindno/train/checkpoint.py``), in a torch-native format.

A checkpoint is one ``torch.save`` file of state dicts, read back with
``torch.load(..., weights_only=True)``: ``best_{loss:.6f}_e{epoch}`` holds the params and
batch statistics of the best eval so far, ``resume.pt`` the params, batch statistics,
the optimizer's ``state_dict()``, the epoch and the best loss. ``params`` are the
model's named parameters and ``batch_stats`` its named buffers (the BatchNorm running
statistics).

The JAX package's files are read too, without JAX
(:mod:`blindno_torch.train.jax_checkpoint`), so the port's stages take over a workdir
that a JAX run left, the committed ``runs/ckpt`` among them: a ``best_*`` directory that
orbax wrote goes through :func:`blindno_torch.convert.from_flax_checkpoint`, and
``resume.msgpack`` is resumed from where it is newer than ``resume.pt``. Among the
``best_*`` entries of both formats the smallest loss wins, and :func:`save_best` removes
the others, files or directories, as JAX's does.

Among several ranks, only rank 0 writes, and every rank waits for it at a barrier: the
state it is handed is the whole, unsharded one (``blindno_torch.parallel.tp.gather_state``),
as JAX's ``jax.device_get`` writes it, so a file loads into a single-process model and a
run resumes at any ``tp``.
"""
from __future__ import annotations

import contextlib
import functools
import glob
import os
import shutil

import torch

from blindno_torch.convert import from_flax_checkpoint
from blindno_torch.parallel.mesh import barrier, is_main_process
from blindno_torch.train import jax_checkpoint

RESUME = "resume.pt"
JAX_RESUME = "resume.msgpack"


def _best_loss_of(path: str) -> float:
    """Parse the loss out of a ``best_{loss:.6f}[_e{epoch}]`` name."""
    try:
        return float(os.path.basename(path).split("_")[1])
    except (IndexError, ValueError):
        return float("inf")


def _save_atomic(obj, path: str):
    """Write to a hidden temporary file beside ``path``, then rename it into place, so a
    crash mid-write never leaves a partial file under ``path``'s name."""
    tmp = os.path.join(os.path.dirname(path), f".{os.path.basename(path)}.tmp")
    torch.save(obj, tmp)
    os.replace(tmp, path)


def _remove(path: str):
    """Remove a ``best_*`` entry, a file or (JAX's) a directory, never raising, as JAX's
    ``save_best`` removes its old ones (``shutil.rmtree(..., ignore_errors=True)``)."""
    if os.path.isdir(path):
        shutil.rmtree(path, ignore_errors=True)
    else:
        with contextlib.suppress(OSError):
            os.remove(path)


def _detached(tree: dict) -> dict:
    return {k: v.detach() for k, v in tree.items()}


def _main_writes(save):
    """``save`` run by rank 0 alone (or the only process); every rank then waits at a
    barrier, so no rank reads or replaces a file that is still being written."""

    @functools.wraps(save)
    def wrapper(*args, **kwargs):
        path = save(*args, **kwargs) if is_main_process() else None
        barrier()
        return path

    return wrapper


@_main_writes
def save_best(ckpt_dir: str, params: dict, batch_stats: dict, epoch: int, test_loss: float):
    """Save best params/batch_stats to ``{dir}/best_{loss:.6f}_e{epoch}``.

    The epoch suffix keeps names unique when two improvements round to the same
    6-decimal loss. The new checkpoint is written BEFORE older ``best_*`` entries are
    deleted, so a crash mid-save never leaves the directory without one (and
    :func:`load_best` picks the numerically best if more than one survives). The older
    entries go whatever their format: JAX's directories too, as JAX's ``save_best``
    removes them (``blindno/train/checkpoint.py:62-64``)."""
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
    _save_atomic({"params": _detached(params), "batch_stats": _detached(batch_stats),
                  "epoch": int(epoch), "test_loss": float(test_loss)}, path)
    for old in olds:
        if os.path.abspath(old) != path:
            _remove(old)
    return path


def load_best(ckpt_dir: str, map_location="cpu"):
    """Load the numerically-best checkpoint in ``ckpt_dir`` (smallest parsed loss:
    lexicographic order would pick the WORST if several ``best_*`` survive a crash),
    the port's file or JAX's orbax directory alike, as ``{"params", "batch_stats",
    "epoch", "test_loss"}`` with its tensors on ``map_location``. A directory that orbax
    did not write raises :class:`~blindno_torch.train.jax_checkpoint.JaxCheckpointError`."""
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
    """Best-checkpoint fallback for when ``resume.pt`` is gone.

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
    """Full resume state (params, batch statistics, ``optimizer.state_dict()``, epoch,
    best loss), written atomically to ``{dir}/resume.pt``."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, RESUME)
    _save_atomic({"params": _detached(params), "batch_stats": _detached(batch_stats),
                  "opt_state": opt_state, "epoch": int(epoch), "best_loss": float(best_loss)},
                 path)
    return path


def _read_resume(path: str) -> dict:
    """The resume state in ``path``, ``resume.pt`` or JAX's ``resume.msgpack``; the
    latter's ``opt_state`` is optax's tree, which
    :func:`blindno_torch.convert.adam_from_optax` maps onto an optimizer."""
    if os.path.basename(path) == RESUME:
        return torch.load(path, map_location="cpu", weights_only=True)
    raw = jax_checkpoint.read_msgpack(path)
    state = from_flax_checkpoint({**raw, "test_loss": raw["best_loss"]})
    return {"params": state["params"], "batch_stats": state["batch_stats"],
            "opt_state": raw["opt_state"], "epoch": int(raw["epoch"]),
            "best_loss": float(raw["best_loss"])}


def load_resume(ckpt_dir: str):
    """The state :func:`save_resume` wrote, read to the host, with its ``"path"``, or
    ``None`` when there is none. Where JAX's ``save_resume`` left a ``resume.msgpack``
    of a later epoch than ``resume.pt``'s (or there is no ``resume.pt``), that is read
    instead (see :func:`_read_resume`).

    Rejects non-finite restored params: the file is moved aside as
    ``<name>.poisoned`` so that a diverged run does not silently seed the next, and the
    other file, if any, is tried."""
    found = [_read_resume(p) | {"path": p}
             for p in (os.path.join(ckpt_dir, RESUME), os.path.join(ckpt_dir, JAX_RESUME))
             if os.path.exists(p)]
    # the later epoch first; resume.pt first on a tie (a stable sort keeps the order)
    for state in sorted(found, key=lambda s: -s["epoch"]):
        if _finite(state["params"]):
            return state
        quarantine = state["path"] + ".poisoned"
        os.replace(state["path"], quarantine)
        print(f"[checkpoint] resume state has non-finite params; quarantined -> {quarantine}")
    return None
