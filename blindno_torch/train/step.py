"""One training step of a model of ``models/``: a 1-D, 2-D or 3-D NIO or the BlinDNO UNet
(counterpart of the step body of ``bench.py:157-186`` and of ``amp_cast_fns``,
``blindno/train/loop.py:156-198``).

The step is forward in train mode (set subsampling, batch-statistics BatchNorm), the mean
squared error of the float32 output against y, ``loss.backward()``, and one Adam update
(:func:`make_optimizer`: lr 5e-4; b1 0.9, b2 0.999 and eps 1e-8, optax's defaults, are
torch's). The compute modes are the JAX package's (``amp_cast_fns``,
``blindno/train/loop.py:156-198``):

- ``compute_dtype=None``: float32 throughout, the mode the parity tests hold to JAX.
- ``compute_dtype="bfloat16"``: the snapshots go to the model in bfloat16
  (``bench.py:176``), so the model's Encoder runs its convs and ``fc`` in bfloat16 under
  ``torch.autocast`` (:mod:`blindno_torch.nn.cnn`), and ``amp_policy`` says which other
  leaves take bfloat16 values:

  - ``"encoder_bn32"`` (``train_step``'s default): none; the encoder's BatchNorm
    parameters and statistics stay float32 and compute in float32;
  - ``"encoder"``: the encoder's BatchNorm parameters and running statistics too;
  - ``"all"``: every parameter and running statistic of the model.

  JAX casts those leaves to bfloat16 inside the loss, and every module past the
  encoder then computes in float32, since the float32 grid promotes it. The port does
  the same by rounding: such a parameter enters the forward as ``p.bfloat16().float()``
  (whose gradient autograd rounds to bfloat16 on the way back, as JAX's cast does), and
  such a statistic is rounded in place before the forward, after which BatchNorm's
  update takes it as flax takes the cast one. Master weights, gradients, Adam state and
  stored statistics stay float32 under every policy.

A model without an Encoder (the UNet, ``NIOFNO2D``, ``NIOFNOAttn2D``, ``NIOFNO1D``, the
Transolver NIOs) has no encoder for a policy to cast, and its bfloat16 snapshots would
reach the FNO kernels, which take float32 only; the step refuses bfloat16 for it. The
``all`` and ``encoder`` policies failed their accuracy gates in JAX
(``blindno/train/loop.py:105-123``); they are here for parity, ``encoder_bn32`` is the
mode to train with.
"""
from __future__ import annotations

import torch
from torch.func import functional_call

from blindno_torch.nn.cnn import SnapshotEncoder

COMPUTE_DTYPES = {None: torch.float32, "bfloat16": torch.bfloat16}
AMP_POLICIES = ("all", "encoder", "encoder_bn32")


def make_optimizer(model, lr: float = 5e-4) -> torch.optim.Adam:
    """Adam over the trainable parameters; the frozen mean-field fusion stays out."""
    return torch.optim.Adam([p for p in model.parameters() if p.requires_grad], lr=lr)


def check_compute_dtype(model, compute_dtype, amp_policy: str = "encoder_bn32"):
    """Raise ``ValueError`` unless ``model`` trains in ``compute_dtype``: None (float32,
    any policy, as JAX ignores it), or "bfloat16" under one of :data:`AMP_POLICIES` for a
    model with an Encoder to cast."""
    if compute_dtype not in COMPUTE_DTYPES:
        raise ValueError(f"unknown compute_dtype {compute_dtype!r} (want None or 'bfloat16')")
    if compute_dtype is None:
        return
    if amp_policy not in AMP_POLICIES:
        raise ValueError(f"unknown amp_policy {amp_policy!r} (want one of {AMP_POLICIES})")
    if not any(isinstance(m, SnapshotEncoder) for m in model.modules()):
        raise ValueError(f"compute_dtype={compute_dtype!r}: the amp policies (encoder_bn32 "
                         f"and the others) cast an Encoder, and {type(model).__name__} has "
                         "none (a model without an Encoder has no leaf for them to cast in "
                         "JAX either); train it in float32")


def _rounded_leaves(model, amp_policy):
    """The parameters that enter the forward rounded to bfloat16 under ``amp_policy``,
    as {name: rounded tensor}; the running statistics it rounds are rounded in place."""
    if amp_policy == "encoder_bn32":
        return {}
    modules = ([model] if amp_policy == "all" else
               [m for m in model.modules() if isinstance(m, SnapshotEncoder)])
    with torch.no_grad():
        for m in modules:
            for name, buf in m.named_buffers():
                if name.endswith(("running_mean", "running_var")):
                    buf.copy_(buf.bfloat16().float())
    keep = {id(p) for m in modules for p in m.parameters()}
    return {name: p.bfloat16().float() for name, p in model.named_parameters() if id(p) in keep}


def train_step(model, optimizer, x, y, grid, *, generator: torch.Generator | None = None,
               subsample=None, compute_dtype=None, amp_policy: str = "encoder_bn32"):
    """One step on the batch x (B, L, *spatial), y (B, *spatial, F) and grid
    (*spatial, d): (B, L, N), (B, N, F) and (N, 1) for a 1-D model, (B, L, H, W),
    (B, H, W, F) and (H, W, 2) for a 2-D one, (B, L, D, H, W), (B, D, H, W, F) and
    (D, H, W, 3) for the 3-D one; tensors on the model's device, the model in train
    mode; ``amp_policy`` applies with ``compute_dtype="bfloat16"``. The set subsample is drawn
    from ``generator``, or injected as ``subsample=(indices, mask)``. Returns the loss (a
    0-d float32 tensor on the device, not synchronized). The parameters' ``.grad`` keep
    this step's gradients until the next step."""
    if not model.training:
        raise ValueError("train_step: call model.train() first")
    check_compute_dtype(model, compute_dtype, amp_policy)
    optimizer.zero_grad(set_to_none=True)
    rounded = _rounded_leaves(model, amp_policy) if compute_dtype else {}
    args, kwargs = (x.to(COMPUTE_DTYPES[compute_dtype]), grid), dict(generator=generator,
                                                                      subsample=subsample)
    out = (functional_call(model, rounded, args, kwargs, strict=False) if rounded
           else model(*args, **kwargs))
    loss = torch.mean((out.float() - y) ** 2)
    loss.backward()
    optimizer.step()
    return loss.detach()
