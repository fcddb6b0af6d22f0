"""Analytic operation counts from a configuration's shapes, whatever implements them.

A model is a list of :class:`Op`: each product (a convolution, a dense layer, a batched
matrix product) counts 2 operations a multiply-add, each FFT 5 N log2 N (half for real
data, :func:`benchmark.kernel_bounds.fft_flops`), each complex multiply-add 8.
Elementwise work (norms, activations, pools, residual adds) is not counted, so an MFU
share built on these counts is a floor of the work done, never above it.

A training step's backward repeats each product once for every operand that needs a
gradient (``bwd``): 2 for a layer whose input and weights both do, 1 for the first
layer (the snapshots need none) or a frozen layer's input, 0 for a product of
constants; an FFT stage's backward is one transform of the same size.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

from benchmark.kernel_bounds import fft_flops


@dataclass(frozen=True)
class Op:
    name: str
    flops: float
    bwd: int  # products of this size in the backward
    kind: str = "matmul"  # "matmul" (products FlopCounterMode counts) or "spectral"
    groups: int = 1  # a grouped convolution's groups


def conv(name, n, cin, cout, kernel, out_size, groups=1, bwd=2):
    """A convolution over ``n`` images to ``out_size`` points (any dimension)."""
    return Op(name, 2.0 * n * (cin // groups) * cout * math.prod(kernel) * math.prod(out_size),
              bwd, groups=groups)


def dense(name, rows, fan_in, fan_out, bwd=2):
    return Op(name, 2.0 * rows * fan_in * fan_out, bwd)


def bmm(name, batch, m, k, n, bwd=2):
    return Op(name, 2.0 * batch * m * k * n, bwd)


def fno2d_layer(name, b, c, h, w, m1, m2, o=None):
    """One FNO2d layer's products: the truncated FFTs (forward over the C input
    channels, inverse over the O output ones), the complex mix of the kept 2·m1 x m2
    modes, and the 1x1 pointwise term."""
    o = c if o is None else o
    transforms = (b * (c + o) * h * fft_flops(w, True)
                  + b * (c + o) * m2 * fft_flops(h, False))
    return [Op(f"{name}.fft", transforms, 1, "spectral"),
            Op(f"{name}.mix", 8.0 * b * c * o * 2 * m1 * m2, 2, "spectral"),
            Op(f"{name}.pointwise", 2.0 * b * c * o * h * w, 2)]


def fno2d_head(name, b, h, w, width, modes, layers, in_dim, out_dim, padding_frac):
    """An FNO2d head on (B, H, W, in_dim): the lift, the layers on the padded grid, the
    128-wide projection; and the layer calls' kernel shapes (B, C, H, W, m1, m2)."""
    hp, wp = h + int(round(h * padding_frac)), w + int(round(w * padding_frac))
    pts = b * h * w
    ops = [dense(f"{name}.fc0", pts, in_dim, width)]
    for k in range(layers):
        ops += fno2d_layer(f"{name}.layer{k}", b, width, hp, wp, modes, modes)
    ops += [dense(f"{name}.fc1", pts, width, 128), dense(f"{name}.fc2", pts, 128, out_dim)]
    return ops, [(b, width, hp, wp, modes, modes)] * layers


def forward_flops(ops) -> float:
    return sum(op.flops for op in ops)


def train_flops(ops) -> float:
    """Forward and backward of a training step (the optimizer's elementwise update is
    not counted)."""
    return sum(op.flops * (1 + op.bwd) for op in ops)


def by_kind(ops, kind, train=False) -> float:
    return sum(op.flops * ((1 + op.bwd) if train else 1) for op in ops if op.kind == kind)
