"""The plain reference of the two fpe2d models: their forward in plain PyTorch, float32,
with ``torch.fft`` for the FNO layers' spectral convolutions and no kernel, cache or
batching of the program's.

Each model is a module of this package, named by its configuration's ``reference``
key (``unet``, ``nio``): a set of named leaves (``leaves(config)``) and a function of
them (``forward``). The names are the state-dict keys of the program's module, so that
the benchmark hands the one set of seeded tensors to both sides. Nothing here imports
the program or the JAX package.

The equations follow the reference repository's ``2d_FPE`` models as the JAX package
restates them (``blindno/models/blindno_unet.py``, ``blindno/models/nio2d.py``):
- BatchNorm: batch statistics (biased variance, eps 1e-5) in train mode, the running
  statistics in eval mode.
- LayerNorm: the two-pass formula, exact where it normalizes one element.
- Leaky ReLU: ``where(x >= 0, x, slope * x)``, whose gradient is 1 at 0.
- Set subsampling: the L gathered snapshots all go through the encoder; only the set
  means (and the attention's keys) are masked.
"""
from __future__ import annotations

import importlib

from benchmark.reference.layers import TRAINED  # noqa: F401 (the kinds that train)


def model(config):
    """The reference module of the configuration's model."""
    return importlib.import_module(f"benchmark.reference.{config['reference']}")


def leaves(config) -> dict:
    """{name: (shape, kind)} of the configuration's model, in a fixed order. ``kind``
    says how the benchmark draws the leaf and whether it trains: ``weight``,
    ``weight_transposed``, ``bias``, ``norm_weight``, ``spectral``, ``scalar`` train;
    ``running_mean``, ``running_var``, ``count`` are statistics, ``frozen_weight`` and
    ``frozen_bias`` the frozen fusion's."""
    return model(config).leaves(config)


def forward(config, p, x, grid, train=False, subsample=None):
    """The model's output (B, H, W, F) for snapshots x (B, L, H, W) and the grid
    (H, W, 2). In train mode, ``subsample=(indices, mask)`` gathers the set first and
    masks its means."""
    mask = None
    if train and subsample is not None:
        indices, mask = subsample
        x = x.index_select(1, indices)
        mask = mask.to(x.dtype)
    return model(config).forward(config, p, x, grid, train, mask)
