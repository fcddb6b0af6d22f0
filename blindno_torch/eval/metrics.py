"""Field-space metrics (counterpart of ``blindno/eval/metrics.py``)."""
from __future__ import annotations

import torch


def relative_l2_per_field(pred, target, reference_denominator: bool = True):
    """pred/target: (B, *grid, F). Per-sample per-field relative L2, shape (B, F).

    With ``reference_denominator`` (the reference's quirk) the denominator is the norm
    of the whole multi-field target, not of the field's own slice.
    """
    b, f = pred.shape[0], pred.shape[-1]
    dp, dt = pred.reshape(b, -1, f), target.reshape(b, -1, f)
    num = torch.linalg.vector_norm(dp - dt, dim=1)
    if reference_denominator:
        den = torch.linalg.vector_norm(dt.reshape(b, -1), dim=1, keepdim=True)
    else:
        den = torch.linalg.vector_norm(dt, dim=1)
    return num / den.clamp_min(1e-12)


def mse(pred, target):
    """The mean squared error over every element, a 0-d tensor."""
    return torch.mean((pred - target) ** 2)
