"""The yardstick: the frozen layer bounds give the kernel table's, and each
configuration's analytic operations sit beside torch's FlopCounterMode count of the same
forward and training step, the FNO layers' spectral products left out of both (the
port's CPU path computes them as dense DFT products, the count as FFTs)."""
from __future__ import annotations

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import common, flops
from benchmark.kernel_bounds import layer_bound
from benchmark.reference import models
from benchmark.tests.conftest import small_config


@pytest.mark.parametrize("shape,bound_ms", [((4, 12, 76, 76, 32, 32), 0.00137),
                                            ((16, 12, 76, 76, 32, 32), 0.00335)])
def test_layer_bound(shape, bound_ms):
    assert layer_bound(shape, True)["bound_ms"] == pytest.approx(bound_ms, rel=5e-3)


def _no_spectral(monkeypatch):
    """The port's plain FNO layer without its spectral convolution (zeros in its
    place), forward and backward."""
    from blindno_torch.ops import fno_layer

    def spectral(x, wr, wi):
        return x.new_zeros(x.shape[0], wr.shape[1], *x.shape[2:])

    def backward(x, wr, wi, pk, du):
        return (torch.einsum("bohw,io->bihw", du, pk), torch.zeros_like(wr), torch.zeros_like(wi),
                torch.einsum("bihw,bohw->io", x, du), du.sum(dim=(0, 2, 3)))

    monkeypatch.setattr(fno_layer, "spectral_conv2d", spectral)
    monkeypatch.setattr("blindno_torch.ops.spectral_cuda.fno2d_layer_backward_plain", backward)


@pytest.mark.parametrize("name", ["fpe2d_unet", "fpe2d_nio"])
def test_flops_beside_flop_counter(name, monkeypatch):
    _no_spectral(monkeypatch)
    cfg = small_config(name)
    b, l = 2, cfg["snapshots"]
    weights = common.draw_leaves(models.leaves(cfg), common.generator(1, 1, "cpu"), "cpu")
    model = common.build_model(cfg, weights, "cpu")
    x = torch.randn(b, l, 61, 61)
    g = torch.as_tensor(common.grid(cfg))
    ops, _ = common.flops_module(cfg).model_ops(cfg, b, l)
    with FlopCounterMode(display=False) as fwd, torch.no_grad():
        model(x, g)
    assert fwd.get_total_flops() == pytest.approx(flops.by_kind(ops, "matmul"), rel=2e-3)
    model.train()
    sub = (torch.arange(l), torch.ones(l, dtype=torch.bool))
    with FlopCounterMode(display=False) as step:
        ((model(x, g, subsample=sub) - 1.0) ** 2).mean().backward()
    # FlopCounterMode counts a grouped convolution's weight gradient as if it were dense,
    # groups times its operations (the convolution backward formula of
    # torch.utils.flop_counter)
    dense_wgrad = sum(op.flops * (op.groups - 1) for op in ops if op.groups > 1)
    assert step.get_total_flops() == pytest.approx(
        flops.by_kind(ops, "matmul", train=True) + dense_wgrad, rel=2e-3)
