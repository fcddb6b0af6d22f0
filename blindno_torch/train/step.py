"""One training step of a model of ``models/``: a 1-D, 2-D or 3-D NIO or the BlinDNO UNet
(counterpart of the step body of ``bench.py:157-186`` and of ``amp_cast_fns``,
``blindno/train/loop.py:156-198``).

The step is forward in train mode (set subsampling, batch-statistics BatchNorm), the mean
squared error of the float32 output against y, ``loss.backward()``, and one Adam update
(:func:`make_optimizer`: lr 5e-4; b1 0.9, b2 0.999 and eps 1e-8, optax's defaults, are
torch's). The compute modes are the JAX package's (``amp_cast_fns``,
``blindno/train/loop.py:156-198``, applied at ``:369-379``):

- ``compute_dtype=None`` (or ``"float32"``, whose casts are no-ops): float32 throughout,
  the mode the parity tests hold to JAX.
- ``compute_dtype="bfloat16"`` or ``"float16"``: every model gets its snapshots in that
  dtype, and ``amp_policy`` says which float32 leaves it casts as well:

  - ``"all"`` (``TrainConfig``'s default, as JAX's): every parameter and running
    statistic;
  - ``"encoder"``: those under an Encoder (:class:`~blindno_torch.nn.cnn.SnapshotEncoder`),
    its BatchNorms' too;
  - ``"encoder_bn32"`` (``train_step``'s default): those under an Encoder but its
    BatchNorms', which keep float32 parameters and statistics.

  A model without an Encoder (the UNets, the FNO-branch and Transolver NIOs) casts
  nothing but its snapshots under the two encoder policies, as in JAX.

The casts are JAX's. A parameter enters the forward cast to the compute dtype
(``functional_call``), so that its gradient is rounded to that dtype on the way back to
the float32 master, as the gradient of JAX's cast is. A running statistic is rounded to
the compute dtype in place before the forward, after which BatchNorm's update takes it
as flax takes the cast one. Where a low-precision operand meets a float32 one in a
product (``linear``, a convolution, ``matmul``, ``einsum``, ``layer_norm``), torch would
raise where jnp promotes: the modules promote such operands to their common dtype first,
as jnp does (:func:`blindno_torch.nn.torch_layers.promoted`), and torch's own promotion
agrees with jnp's elsewhere. So the UNet, whose grid is unused, computes in the compute
dtype end to end under ``all``, while a NIO's float32 grid promotes everything it meets
to float32; the output's dtype is JAX's (``tests/test_torch_amp.py``). BatchNorm computes
in float32 and hands back its input's dtype, as flax's ``TorchBatchNorm``; the FNO
kernels take float32 only, and their wrappers raise their inputs to float32 and return
the product's dtype (:mod:`blindno_torch.ops.spectral_cuda`). Master weights, gradients,
Adam state and stored statistics stay float32; there is no loss scaling, as in JAX.

:func:`train_step` is :func:`step_body`, the step's device work, after its checks and
``zero_grad``. ``TrainConfig(epoch_scan=True)`` captures :func:`step_body` in a CUDA graph
(:mod:`blindno_torch.train.scan`), with Adam in its capturable form
(:func:`make_capturable`: step counts and learning rate on the card); its state is saved
as optax's, which either form of Adam maps to (:func:`blindno_torch.convert.adam_to_optax`).

One case is refused, because JAX's own step gives NaN there: float16 on a model whose set
attention masks its keys in train mode (:func:`float16_refusal`). The ``all`` and
``encoder`` policies failed their accuracy gates in JAX (``blindno/train/loop.py:105-123``);
they are here for parity, ``encoder_bn32`` is the mode bench.py validated.
"""
from __future__ import annotations

import torch
from torch.func import functional_call

from blindno_torch.nn.cnn import SnapshotEncoder

COMPUTE_DTYPES = {None: torch.float32, "float32": torch.float32, "bfloat16": torch.bfloat16,
                  "float16": torch.float16}
AMP_POLICIES = ("all", "encoder", "encoder_bn32")

def make_optimizer(model, lr: float = 5e-4) -> torch.optim.Adam:
    """Adam over the trainable parameters; a frozen fusion (``trainable=False``, the
    default) stays out."""
    return torch.optim.Adam([p for p in model.parameters() if p.requires_grad], lr=lr)


def make_capturable(optimizer: torch.optim.Adam) -> torch.Tensor:
    """Turn ``optimizer`` (Adam over parameters on one CUDA card, its state fresh or
    loaded) into the form a CUDA graph of the step can capture, in place: Adam's
    ``capturable=True``, its step counts float32 tensors on the card, and its learning
    rate one 0-d float32 tensor there, shared by every group, which the caller fills
    between replays. A replay then reads the rate and the counts from the card, where
    the host's Adam reads them from Python numbers and host tensors: its bias
    corrections are float32 products on the card instead of float64 ones on the host.
    Returns the learning-rate tensor."""
    group = optimizer.param_groups[0]
    dev = group["params"][0].device
    if dev.type != "cuda":
        raise ValueError(f"a capturable optimizer needs its parameters on a CUDA card, got {dev}")
    lr = torch.tensor(float(group["lr"]), dtype=torch.float32, device=dev)
    for group in optimizer.param_groups:
        group["capturable"], group["lr"] = True, lr
    for state in optimizer.state.values():
        state["step"] = state["step"].to(device=dev, dtype=torch.float32)
    return lr


def float16_refusal(model) -> str | None:
    """Why the float16 step is refused for ``model``, or None. JAX casts the subsample
    mask to the snapshots' dtype (``blindno/nn/setops.py:53``), and its set attention
    adds ``(1 - mask) * -1e9`` to the scores (``:84``): in float16 -1e9 is -inf, the
    valid keys' term 0 x -inf is NaN, and JAX's step returns a NaN loss. The port computes
    the same NaN; it refuses the step instead."""
    from blindno_torch.models.blindno_unet import PermInvUNetAttn
    from blindno_torch.models.nio2d import NIOAttn2D, NIOFNOAttn2D, NIOTransAttn2D

    model = getattr(model, "module", model)  # the model inside a DistributedDataParallel
    masked = (isinstance(model, PermInvUNetAttn) and model.subsample
              and model.attention is not None)
    if masked or isinstance(model, (NIOAttn2D, NIOFNOAttn2D, NIOTransAttn2D)):
        return (f"compute_dtype='float16': {type(model).__name__}'s set attention masks its "
                "keys by adding (1 - mask) * -1e9 in the snapshots' dtype, which is -inf in "
                "float16, so the valid keys' scores are 0 * -inf = NaN; JAX's float16 step "
                "gives a NaN loss under every amp policy. Train it in bfloat16 or float32")
    return None


def check_compute_dtype(model, compute_dtype, amp_policy: str = "encoder_bn32"):
    """Raise ``ValueError`` unless ``model`` trains in ``compute_dtype`` under
    ``amp_policy``: None or ``"float32"`` under any policy (JAX ignores it), else a key
    of :data:`COMPUTE_DTYPES` under one of :data:`AMP_POLICIES`, but for the float16
    case :func:`float16_refusal` names."""
    if compute_dtype not in COMPUTE_DTYPES:
        raise ValueError(f"unknown compute_dtype {compute_dtype!r} (want one of "
                         f"{list(COMPUTE_DTYPES)})")
    if compute_dtype is None:
        return
    if amp_policy not in AMP_POLICIES:
        raise ValueError(f"unknown amp_policy {amp_policy!r} (want one of {AMP_POLICIES})")
    refusal = compute_dtype == "float16" and float16_refusal(model)
    if refusal:
        raise ValueError(refusal)


def _cast_leaves(model, amp_policy, dtype):
    """The parameters that enter the forward in ``dtype`` under ``amp_policy``, as {name:
    cast tensor}: every one under ``all``, those of the Encoders under ``encoder``, and
    those but their BatchNorms' under ``encoder_bn32``. The running statistics it casts
    are rounded to ``dtype`` in place."""
    modules = ([model] if amp_policy == "all" else
               [m for m in model.modules() if isinstance(m, SnapshotEncoder)])
    skip = set()
    if amp_policy == "encoder_bn32":
        skip = {id(t) for m in modules for bn in m.modules()
                if isinstance(bn, torch.nn.modules.batchnorm._BatchNorm)
                for t in (*bn.parameters(), *bn.buffers())}
    keep = {id(t) for m in modules for t in m.parameters()} - skip
    with torch.no_grad():
        for m in modules:
            for name, buf in m.named_buffers():
                if name.endswith(("running_mean", "running_var")) and id(buf) not in skip:
                    buf.copy_(buf.to(dtype))
    return {name: p.to(dtype) for name, p in model.named_parameters() if id(p) in keep}


def train_step(model, optimizer, x, y, grid, *, generator: torch.Generator | None = None,
               subsample=None, compute_dtype=None, amp_policy: str = "encoder_bn32"):
    """One step on the batch x (B, L, *spatial), y (B, *spatial, F) and grid
    (*spatial, d): (B, L, N), (B, N, F) and (N, 1) for a 1-D model, (B, L, H, W),
    (B, H, W, F) and (H, W, 2) for a 2-D one, (B, L, D, H, W), (B, D, H, W, F) and
    (D, H, W, 3) for the 3-D one; tensors on the model's device, the model in train
    mode; ``amp_policy`` applies with a low-precision ``compute_dtype``. The set subsample
    is drawn from ``generator``, or injected as ``subsample=(indices, mask)``. Returns the
    loss (a 0-d float32 tensor on the device, not synchronized). The parameters' ``.grad``
    keep this step's gradients until the next step."""
    if not model.training:
        raise ValueError("train_step: call model.train() first")
    check_compute_dtype(model, compute_dtype, amp_policy)
    optimizer.zero_grad(set_to_none=True)
    return step_body(model, optimizer, x, y, grid, generator=generator, subsample=subsample,
                     compute_dtype=compute_dtype, amp_policy=amp_policy)


def step_body(model, optimizer, x, y, grid, *, generator=None, subsample=None,
              compute_dtype=None, amp_policy: str = "encoder_bn32"):
    """The device work of :func:`train_step`, what a CUDA graph of the step captures:
    the forward (the policy's casts first), the loss, ``backward()`` and Adam's update,
    with no check and no host work. The parameters' gradients must be None on entry,
    so that ``backward()`` writes each one afresh (a replay then writes the same
    memory again). Returns the loss (a 0-d float32 tensor on the device)."""
    dtype = COMPUTE_DTYPES[compute_dtype]
    kwargs = dict(generator=generator, subsample=subsample)
    if dtype is torch.float32:
        out = model(x, grid, **kwargs)
    else:
        cast = _cast_leaves(model, amp_policy, dtype)
        out = functional_call(model, cast, (x.to(dtype), grid), kwargs, strict=False)
    loss = torch.mean((out.float() - y) ** 2)
    loss.backward()
    optimizer.step()
    return loss.detach()
