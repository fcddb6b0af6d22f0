"""One training step of a model of ``models/``: a 1-D or 2-D NIO or the BlinDNO UNet
(counterpart of the step body of ``bench.py:157-186`` and of ``amp_cast_fns``,
``blindno/train/loop.py:156-198``).

The step is forward in train mode (set subsampling, batch-statistics BatchNorm), the mean
squared error of the float32 output against y, ``loss.backward()``, and one Adam update
(:func:`make_optimizer`: lr 5e-4; b1 0.9, b2 0.999 and eps 1e-8, optax's defaults, are
torch's). Two compute modes:

- ``compute_dtype=None``: float32 throughout, the mode the parity tests hold to JAX.
- ``compute_dtype="bfloat16"``, the JAX package's ``amp_policy="encoder_bn32"``: the snapshots go to
  the model in bfloat16 (``bench.py:176``), so the Encoder2D runs its convs and ``fc`` in
  bfloat16 (:class:`~blindno_torch.nn.cnn.Encoder2D`) while its BatchNorm parameters and
  statistics stay float32 and compute in float32; the trunk, fusion and heads run in
  float32. Master weights, gradients and Adam state stay float32. The JAX package's other
  policies, ``all`` and ``encoder``, failed their accuracy gates
  (``blindno/train/loop.py:105-123``) and are not ported. The policy casts the leaves of
  an Encoder only (``blindno/train/loop.py:172-180``): ``NIOFP2D`` and ``NIOAttn2D``
  have one; a model without one (the UNet, ``NIOFNO2D``, ``NIOFNOAttn2D``;
  ``blindno/train/loop.py:128``) has nothing to cast, and the step refuses bfloat16 for
  it.
"""
from __future__ import annotations

import torch

from blindno_torch.nn.cnn import Encoder2D

COMPUTE_DTYPES = {None: torch.float32, "bfloat16": torch.bfloat16}


def make_optimizer(model, lr: float = 5e-4) -> torch.optim.Adam:
    """Adam over the trainable parameters; the frozen mean-field fusion stays out."""
    return torch.optim.Adam([p for p in model.parameters() if p.requires_grad], lr=lr)


def check_compute_dtype(model, compute_dtype):
    """Raise ``ValueError`` unless ``model`` trains in ``compute_dtype``: None (float32),
    or "bfloat16" (``encoder_bn32``) for a model with an Encoder2D to cast."""
    if compute_dtype not in COMPUTE_DTYPES:
        raise ValueError(f"unknown compute_dtype {compute_dtype!r} (want None or 'bfloat16', "
                         "the encoder_bn32 policy)")
    if compute_dtype is not None and not any(isinstance(m, Encoder2D) for m in model.modules()):
        raise ValueError(f"compute_dtype={compute_dtype!r}: the port's encoder_bn32 mode "
                         f"casts an Encoder2D, and {type(model).__name__} has none (a model "
                         "without an Encoder has no leaf for it to cast in JAX either; the "
                         "1-D Encoder1D's bfloat16 mode is not ported); train it in float32")


def train_step(model, optimizer, x, y, grid, *, generator: torch.Generator | None = None,
               subsample=None, compute_dtype=None):
    """One step on the batch x (B, L, *spatial), y (B, *spatial, F) and grid
    (*spatial, d): (B, L, N), (B, N, F) and (N, 1) for a 1-D model, (B, L, H, W),
    (B, H, W, F) and (H, W, 2) for a 2-D one; tensors on the model's device, the model
    in train mode. The set subsample is drawn
    from ``generator``, or injected as ``subsample=(indices, mask)``. Returns the loss (a
    0-d float32 tensor on the device, not synchronized). The parameters' ``.grad`` keep
    this step's gradients until the next step."""
    if not model.training:
        raise ValueError("train_step: call model.train() first")
    check_compute_dtype(model, compute_dtype)
    optimizer.zero_grad(set_to_none=True)
    out = model(x.to(COMPUTE_DTYPES[compute_dtype]), grid, generator=generator,
                subsample=subsample)
    loss = torch.mean((out.float() - y) ** 2)
    loss.backward()
    optimizer.step()
    return loss.detach()
