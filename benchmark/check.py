"""The numbers that decide ``correct``: each compares the program's output with the plain
reference's (:mod:`benchmark.reference`) and is held to the cell's limit
(``benchmark/limits/<cell>.json``)."""
from __future__ import annotations

import math
import statistics

import numpy as np

# a leaf whose reference gradient is under this share of the median leaf's moves under
# Adam by round-off alone, and is left out of the change
STILL_LEAF = 1e-3


def _norms(tree) -> dict:
    return {k: float(v.double().norm()) for k, v in tree.items()}


def _worst(prog: dict, ref: dict, names) -> float:
    """The widest gap of the leaves' norms, each over the larger of the reference's norm
    of that leaf and of the median leaf."""
    med = statistics.median(ref[k] for k in names)
    return max(abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30) for k in names)


def moved(ref: dict) -> list:
    """The leaves that the reference's first gradient moves: those whose norm is at least
    :data:`STILL_LEAF` of the median leaf's."""
    g = _norms(ref["grads"])
    med = statistics.median(g.values())
    return [k for k in g if g[k] >= STILL_LEAF * med]


def worst_leaves(prog: dict, ref: dict, key: str, top: int = 3, names=None) -> list:
    """The ``top`` leaves of the widest gaps of ``key`` (``grads`` or ``change``) among
    ``names`` (all leaves without it), each as (name, program's norm, reference's norm),
    the gaps measured as :func:`train_numbers` measures them: what a look at a reading
    starts from."""
    p, r = _norms(prog[key]), _norms(ref[key])
    names = list(r) if names is None else names
    med = statistics.median(r[k] for k in names)
    gaps = sorted(((abs(p[k] - r[k]) / max(r[k], med, 1e-30), k) for k in names), reverse=True)
    return [(k, p[k], r[k]) for _, k in gaps[:top]]


def grad_shares(ref: dict, names) -> dict:
    """Each named leaf's reference gradient norm over the median leaf's: how near it
    comes to :data:`STILL_LEAF`."""
    g = _norms(ref["grads"])
    med = statistics.median(g.values())
    return {k: g[k] / max(med, 1e-30) for k in names}


def train_numbers(prog: dict, ref: dict) -> dict:
    """``loss_gap``: the widest relative gap of the steps' losses; ``loss1_gap``: the
    first step's alone. ``grad_gap``: the first gradient's norms by the worst leaf.
    ``change_gap``: the norms of each leaf's change after the last step, by the worst
    leaf that the reference's gradient moves; ``change_median_gap``: the median of those
    leaves' relative gaps. A cell's limits file names the numbers it compares."""
    if set(prog["grads"]) != set(ref["grads"]) or len(prog["losses"]) != len(ref["losses"]):
        missing = sorted(set(prog["grads"]) ^ set(ref["grads"]))
        raise ValueError(f"the program's steps do not match the reference's: leaves {missing}, "
                         f"{len(prog['losses'])} against {len(ref['losses'])} losses")
    loss = [abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"])]
    gp, gr = _norms(prog["grads"]), _norms(ref["grads"])
    names = moved(ref)
    cp, cr = _norms(prog["change"]), _norms(ref["change"])
    return {"loss_gap": max(loss), "loss1_gap": loss[0], "grad_gap": _worst(gp, gr, gr),
            "change_gap": _worst(cp, cr, names),
            "change_median_gap": statistics.median(abs(cp[k] - cr[k]) / max(cr[k], 1e-30)
                                                   for k in names)}


def eval_numbers(pred: np.ndarray, ref: np.ndarray) -> dict:
    """``field_gap``: the widest relative L2 gap of one set's field, over the sets and
    fields compared."""
    diff = np.linalg.norm((pred - ref).astype(np.float64), axis=(1, 2))
    scale = np.linalg.norm(ref.astype(np.float64), axis=(1, 2))
    return {"field_gap": float(np.max(diff / np.maximum(scale, 1e-30)))}


def verdict(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}): correct where every number is finite and
    at most its limit."""
    checks = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    ok = all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
    return ok, checks
