"""Batched eval-mode field prediction, the port's serving entry point (counterpart of
``blindno/eval/field_eval.py:predict_fields``)."""
from __future__ import annotations

import numpy as np
import torch

from blindno_torch import default_device


def predict_fields(model, inputs_norm, grid, batch: int = 16, device=None):
    """inputs_norm (M, L, *spatial) and grid (*spatial, d), numpy -> (M, *spatial, F)
    numpy: the grid is (N, 1) for the 1-D models and (H, W, 2) for the 2-D one.

    Runs on ``device`` (CUDA unless the caller passes another), where the model must
    already live, under ``torch.inference_mode``.
    """
    dev = default_device(device)
    model_dev = next(model.parameters()).device
    if model_dev.type != dev.type:
        raise ValueError(f"the model lives on {model_dev}, not on {dev}; move it first")
    g = torch.as_tensor(np.asarray(grid, np.float32), device=model_dev)
    outs = []
    with torch.inference_mode():
        for s in range(0, inputs_norm.shape[0], batch):
            xb = torch.as_tensor(np.asarray(inputs_norm[s:s + batch], np.float32)).to(model_dev)
            outs.append(model(xb, g).cpu().numpy())
    return np.concatenate(outs)
