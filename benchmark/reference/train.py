"""The plain reference of the training loop's first steps and of the eval forward.

:func:`replay` works out again what the program's loop derives from the benchmark's
inputs (the train split, the bfloat16 archive, the gathered batch, the D4 element, the
set subsample) and takes the steps in plain PyTorch: the forward of
:mod:`benchmark.reference.models`, the mean squared error, ``backward()`` and
``torch.optim.Adam`` (lr from the configuration, b1 0.9, b2 0.999, eps 1e-8, optax's
defaults). Nothing here imports the program or the JAX package.
"""
from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import models


def train_split(n: int, train_frac: float, seed: int) -> np.ndarray:
    """The train split's archive rows: the first ``int(train_frac * n)`` of a seeded
    numpy permutation, as the JAX package and its port split an archive."""
    return np.random.default_rng(seed).permutation(n)[: int(train_frac * n)]


def d4(x, y, element: int):
    """D4 element ``element`` on snapshots (B, L, H, W) and scalar fields (B, H, W, F):
    a reflection y -> -y for elements 4-7, then ``element % 4`` quarter turns."""
    if element >= 4:
        x, y = torch.flip(x, (3,)), torch.flip(y, (2,))
    return torch.rot90(x, element % 4, (2, 3)), torch.rot90(y, element % 4, (1, 2))


def batch(config, inputs, targets, rows, element, device, compress=True):
    """The batch of archive ``rows``: snapshots rounded to bfloat16 when the
    configuration stores them so, cast back to float32; the D4 element applied."""
    x = torch.from_numpy(np.ascontiguousarray(inputs[rows])).to(device)
    if compress:
        x = x.to(torch.bfloat16).float()
    y = torch.from_numpy(np.ascontiguousarray(targets[rows])).to(device)
    return d4(x, y, element) if element is not None else (x, y)


def replay(config, weights, inputs, targets, grid, draws, device, keep=None,
           dtype=torch.float32):
    """The first steps of training from ``weights`` on ``draws`` (positions (S, B) in
    the train split, elements (S,), subsample indices (S, L) and masks (S, L)).
    ``keep(x, y)`` may cut each batch (a planted fault); ``dtype`` computes in another
    precision. Returns each step's loss, the
    first step's gradients, and each leaf's change after the last step."""
    train = config["train"]
    rows_of = train_split(inputs.shape[0], train["train_frac"], train["split_seed"])
    leaves = models.leaves(config)
    trained = [k for k, (_, kind) in leaves.items() if kind in models.TRAINED]
    p = {k: v.detach().to(device, dtype if v.is_floating_point() else v.dtype, copy=True)
         for k, v in weights.items()}
    for k in trained:
        p[k].requires_grad_(True)
    opt = torch.optim.Adam([p[k] for k in trained], lr=train["lr"])
    g = torch.as_tensor(grid, device=device, dtype=dtype)
    positions, elements, indices, masks = draws
    losses, grads = [], None
    for s in range(len(positions)):
        x, y = batch(config, inputs, targets, rows_of[np.asarray(positions[s])],
                     elements[s] if train["augment"] else None, device,
                     train["compress_inputs"])
        x, y = x.to(dtype), y.to(dtype)
        if keep is not None:
            x, y = keep(x, y)
        out = models.forward(config, p, x, g, train=True,
                             subsample=(indices[s].to(device), masks[s].to(device)))
        loss = torch.mean((out - y) ** 2)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        if grads is None:
            grads = {k: p[k].grad.detach().clone() for k in trained}
        opt.step()
        losses.append(float(loss.detach()))
    change = {k: (p[k].detach() - weights[k].to(device, dtype)) for k in trained}
    return {"losses": losses, "grads": grads, "change": change}


@torch.no_grad()
def predict(config, weights, sets, grid, device, batch_size=16):
    """The eval-mode forward over host snapshot sets (M, L, H, W), ``batch_size`` sets a
    block; returns (M, H, W, F) on the host."""
    p = {k: v.to(device) for k, v in weights.items()}
    g = torch.as_tensor(grid, device=device)
    out = [models.forward(config, p, torch.from_numpy(np.ascontiguousarray(sets[s:s + batch_size])).to(device), g)
           .cpu().numpy() for s in range(0, sets.shape[0], batch_size)]
    return np.concatenate(out)
