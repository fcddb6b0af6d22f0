"""Activations and layer builders with the JAX package's torch semantics
(counterpart of ``blindno/nn/torch_layers.py``).

Builders draw their initial weights from an explicit generator; ``skip_init`` keeps
the module constructors from touching the global RNG. :class:`BatchNorm1d` and
:class:`BatchNorm2d` and :class:`BatchNorm3d` are the counterparts of ``TorchBatchNorm``: torch's eps 1e-5 and
momentum 0.1, which are the JAX package's (flax's momentum 0.9 is the same running
average), with flax's running-variance update in train mode. :class:`ConvTranspose` is
``TorchConvTranspose``'s counterpart, :func:`max_pool` ``max_pool``'s, and
:class:`LayerNorm` flax's two-pass LayerNorm where it differs from torch's. The modules
that :func:`linear` and the convolution functions return, :class:`ConvTranspose` and
:class:`LayerNorm` promote their operands as jnp does (:func:`promoted`).
"""
from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn
from torch.nn.utils import skip_init

from blindno_torch.utils import torch_init as tinit

_LOW = (torch.bfloat16, torch.float16)


class _FlaxRunningVar:
    """Train-mode BatchNorm as flax computes it (``blindno/nn/torch_layers.py:88-107``).

    Both normalize with the biased batch variance, but torch updates ``running_var``
    with the unbiased one, n/(n-1) times larger, where flax takes the biased one. Train
    mode therefore runs torch's own batch norm on copies of the running statistics (its
    backward keeps them, so they must not change after it) and then takes the factor out
    of the update: torch added ``m * n/(n-1) * var`` to ``(1-m) * running_var``, and that
    term is scaled by (n-1)/n. This costs a few operations on C-sized vectors and no pass
    over the input. The normalization runs in float32 whatever the input's and the
    parameters' dtypes (torch's batch norm takes a bfloat16 or float16 input with float32
    parameters and statistics; parameters cast to a low precision are raised to float32),
    and the result has the input's dtype, as flax's ``dtype=float32`` plus the cast back
    gives.
    Eval mode is torch's, unchanged.

    In data-parallel training ``sync_group`` is the ``data`` process group, when it has
    more than one rank: the statistics are then the whole batch's, as JAX's jitted step
    takes them over the global batch (:class:`_SyncedBatchNorm`), and the running
    variance is flax's update with the global count.
    """

    sync_group = None

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        self.num_batches_tracked.add_(1)
        # torch's factor: the momentum, or a cumulative average without one
        m = (self.momentum if self.momentum is not None
             else 1.0 / float(self.num_batches_tracked))
        if self.sync_group is not None:
            y, mean, var = _SyncedBatchNorm.apply(x, self.weight, self.bias, self.eps,
                                                  self.sync_group)
            with torch.no_grad():
                self.running_mean.lerp_(mean, m)
                self.running_var.lerp_(var, m)
            return y
        mean, var = self.running_mean.clone(), self.running_var.clone()
        # parameters cast to a low precision are raised to float32, as flax computes
        w, b = (t.float() if t is not None and t.dtype in _LOW else t
                for t in (self.weight, self.bias))
        y = F.batch_norm(x, mean, var, w, b, True, m, self.eps)
        n = x.numel() // x.shape[1]
        with torch.no_grad():
            kept = self.running_var * (1.0 - m)
            self.running_var.copy_(kept + (var - kept) * ((n - 1) / n))
            self.running_mean.copy_(mean)
        return y.to(x.dtype)


class _SyncedBatchNorm(torch.autograd.Function):
    """Train-mode batch norm over the rows of every rank of ``group``, in float32.

    Each rank takes its per-channel count, mean and sum of squared deviations (M2); the
    ranks gather them and combine them by Chan's formula (in float64), so no rank sums
    squares about zero, which loses digits where a channel's mean is large against its
    spread. Returns the output in the input's dtype and the global mean and biased
    variance. Backward: the two reduced terms of ``dx`` (the sums of ``dy`` and of
    ``dy * xhat``) are summed over the group; the weight's and the bias's gradients are
    this rank's own sums, which data parallelism then averages as any other gradient."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps, group):
        xf = x.float()
        dims = [0, *range(2, x.dim())]
        shape = [1, -1] + [1] * (x.dim() - 2)
        mean = xf.mean(dims)
        m2 = (xf - mean.view(shape)).square().sum(dims)
        local = torch.stack([torch.full_like(mean, xf.numel() // xf.shape[1]), mean, m2]).double()
        parts = [torch.empty_like(local) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, local, group=group)
        counts, means, m2s = torch.stack(parts).unbind(1)
        n = counts.sum(0)
        g_mean = (counts * means).sum(0) / n
        var = ((m2s.sum(0) + (counts * (means - g_mean) ** 2).sum(0)) / n).float()
        g_mean = g_mean.float()
        invstd = torch.rsqrt(var + eps)
        xhat = (xf - g_mean.view(shape)) * invstd.view(shape)
        # the count stays on the device: reading it back would synchronize the host in
        # every step, which a captured step (``TrainConfig(epoch_scan=True)``) cannot do
        ctx.save_for_backward(xhat, weight, invstd, n[0])
        ctx.group, ctx.dtype = group, x.dtype
        ctx.mark_non_differentiable(g_mean, var)
        return (xhat * weight.view(shape) + bias.view(shape)).to(x.dtype), g_mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        xhat, weight, invstd, n = ctx.saved_tensors
        dims = [0, *range(2, xhat.dim())]
        shape = [1, -1] + [1] * (xhat.dim() - 2)
        dy = dy.float()
        sum_dy, sum_dy_xhat = dy.sum(dims), (dy * xhat).sum(dims)
        total = torch.stack([sum_dy, sum_dy_xhat])
        dist.all_reduce(total, group=ctx.group)
        g_dy, g_dy_xhat = total / n.float()
        dx = (weight * invstd).view(shape) * (dy - g_dy.view(shape) - xhat * g_dy_xhat.view(shape))
        return dx.to(ctx.dtype), sum_dy_xhat, sum_dy, None, None


class BatchNorm1d(_FlaxRunningVar, nn.BatchNorm1d):
    """``nn.BatchNorm1d`` with flax's train-mode running variance (see
    :class:`_FlaxRunningVar`); the state-dict keys are torch's."""


class BatchNorm2d(_FlaxRunningVar, nn.BatchNorm2d):
    """``nn.BatchNorm2d`` with flax's train-mode running variance (see
    :class:`_FlaxRunningVar`); the state-dict keys are torch's."""


class BatchNorm3d(_FlaxRunningVar, nn.BatchNorm3d):
    """``nn.BatchNorm3d`` with flax's train-mode running variance (see
    :class:`_FlaxRunningVar`); the state-dict keys are torch's."""


def promoted(*tensors):
    """The tensors in the dtype that jnp's promotion gives them together (None entries
    pass as they are). torch's products (``linear``, the convolutions, ``matmul``,
    ``einsum``, ``layer_norm``) refuse operands of two float dtypes where jnp's promote
    them; the modules whose operands may differ, as a low-precision training step's do
    (:mod:`blindno_torch.train.step`), promote them with this first."""
    dtype = None
    for t in tensors:
        if t is not None and t.dtype != dtype:
            dtype = t.dtype if dtype is None else torch.promote_types(dtype, t.dtype)
    return tuple(t if t is None or t.dtype == dtype else t.to(dtype) for t in tensors)


class Linear(nn.Linear):
    """nn.Linear whose input and parameters are :func:`promoted` first."""

    def forward(self, x):
        return F.linear(*promoted(x, self.weight, self.bias))


class _PromotedConv:
    """A convolution whose input and parameters are :func:`promoted` first."""

    def _conv_forward(self, x, weight, bias):
        return super()._conv_forward(*promoted(x, weight, bias))


class Conv1d(_PromotedConv, nn.Conv1d):
    pass


class Conv2d(_PromotedConv, nn.Conv2d):
    pass


class Conv3d(_PromotedConv, nn.Conv3d):
    pass


class LayerNorm(nn.LayerNorm):
    """nn.LayerNorm over the last axis, its input and parameters :func:`promoted` first,
    exact where it normalizes a single element, as flax's two-pass LayerNorm is there:
    x - mean(x) is 0, the output is the bias, and the gradients of the input and the
    scale are exactly 0. torch's fused kernel gives the bias too, but its backward leaves
    rounding in those gradients (up to 7e-5 at a one-channel ConvNeXt block on the CPU),
    so over one element this computes flax's formula, mean((x - mean)^2) for the
    variance, in plain operations."""

    def forward(self, x):
        x, weight, bias = promoted(x, self.weight, self.bias)
        if self.normalized_shape != (1,):
            return F.layer_norm(x, self.normalized_shape, weight, bias, self.eps)
        xc = x - x.mean(-1, keepdim=True)
        var = (xc * xc).mean(-1, keepdim=True)
        return xc * torch.rsqrt(var + self.eps) * weight + bias


def gelu(x):
    """Exact (erf) gelu, torch's default and the JAX package's choice."""
    return F.gelu(x)


def leaky_relu(x, slope: float = 0.01):
    """``x`` where ``x >= 0``, else ``slope * x``, with the JAX package's gradient: 1 at
    0, where ``F.leaky_relu``'s is ``slope``. The two differ only at exact zeros, as the
    trunk's first layers have at grid point (0, 0) while their biases are zero. Without
    a gradient to take, ``F.leaky_relu``'s one kernel computes the same values."""
    if torch.is_grad_enabled() and x.requires_grad:
        return torch.where(x >= 0, x, slope * x)
    return F.leaky_relu(x, slope)


def linear(in_features: int, out_features: int, generator, bias: bool = True) -> Linear:
    """:class:`Linear` with torch's default init drawn from ``generator``."""
    m = skip_init(Linear, in_features, out_features, bias=bias)
    return tinit.torch_default_(m, in_features, generator)


def conv1d(in_channels: int, out_channels: int, kernel_size: int, stride: int, padding: int,
           generator, groups: int = 1) -> Conv1d:
    """:class:`Conv1d` (symmetric integer padding) with torch's default init; fan_in is
    ``kernel * in_channels / groups``."""
    m = skip_init(Conv1d, in_channels, out_channels, kernel_size, stride=stride,
                  padding=padding, groups=groups)
    return tinit.torch_default_(m, in_channels // groups * m.kernel_size[0], generator)


def conv2d(in_channels: int, out_channels: int, kernel_size, stride, padding,
           generator, groups: int = 1) -> Conv2d:
    """:class:`Conv2d` (symmetric integer padding) with torch's default init; fan_in is
    ``kh * kw * in_channels / groups``."""
    m = skip_init(Conv2d, in_channels, out_channels, kernel_size, stride=stride,
                  padding=padding, groups=groups)
    kh, kw = m.kernel_size
    return tinit.torch_default_(m, in_channels // groups * kh * kw, generator)


def conv3d(in_channels: int, out_channels: int, kernel_size, stride, padding,
           generator, groups: int = 1) -> Conv3d:
    """:class:`Conv3d` (symmetric integer padding) with torch's default init; fan_in is
    ``kd * kh * kw * in_channels / groups``."""
    m = skip_init(Conv3d, in_channels, out_channels, kernel_size, stride=stride,
                  padding=padding, groups=groups)
    kd, kh, kw = m.kernel_size
    return tinit.torch_default_(m, in_channels // groups * kd * kh * kw, generator)


def max_pool(x, window: int):
    """torch MaxPoolNd(window): stride = window, floor mode. Channel-first, 1-D or 2-D."""
    return (F.max_pool1d if x.dim() == 3 else F.max_pool2d)(x, window)


class ConvTranspose(nn.Module):
    """The JAX package's ``TorchConvTranspose`` (``blindno/nn/torch_layers.py:50-85``) in
    1-D, 2-D or 3-D, channel-first: a VALID transposed convolution with its bias, output
    ``(in - 1) * stride + kernel``, then ``output_padding`` rows (and columns) of zeros
    at the end. torch's own ``output_padding`` would fill them with the bias instead, so
    the convolution runs without it and :func:`F.pad` adds the zeros.

    ``weight`` is torch's (cin, cout, *kernel) and ``bias`` (cout,), with torch's
    ConvTranspose init (:func:`~blindno_torch.utils.torch_init.torch_conv_transpose_`).
    A flax kernel (*kernel, cin, cout) becomes this weight only flipped in space
    (``blindno_torch.convert``): flax's transposed convolution does not flip the kernel,
    torch's does.
    """

    def __init__(self, in_channels: int, out_channels: int, kernel_size, stride,
                 output_padding, generator: torch.Generator):
        super().__init__()
        self.kernel_size, self.stride = tuple(kernel_size), tuple(stride)
        self.output_padding = tuple(output_padding)
        self.weight = nn.Parameter(torch.empty(in_channels, out_channels, *self.kernel_size))
        self.bias = nn.Parameter(torch.empty(out_channels))
        tinit.torch_conv_transpose_(self, generator)

    def forward(self, x):
        fn = (F.conv_transpose1d, F.conv_transpose2d, F.conv_transpose3d)[len(self.kernel_size) - 1]
        y = fn(*promoted(x, self.weight, self.bias), self.stride)
        if not any(self.output_padding):
            return y
        pads = [p for op in reversed(self.output_padding) for p in (0, op)]
        return F.pad(y, pads)
