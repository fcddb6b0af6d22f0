"""Package rules of the port: no JAX imports, the device rule, wrappers that take the plain
path only for CPU tensors (forward only but for the FNO1d and FNO2d layers), and a
converter that refuses partial trees."""
import ast
import pathlib

import numpy as np
import pytest
import torch

import blindno_torch
from blindno_torch import default_device
from blindno_torch.convert import from_flax
from blindno_torch.eval.field_eval import predict_fields
from blindno_torch.models.nio1d import NIOFNO1D, NIOFP1D
from blindno_torch.models.nio2d import NIOFP2D
from blindno_torch.ops.fno_layer import fno1d_layer_plain, fno2d_layer_plain
from blindno_torch.ops.spectral import spectral_conv1d, spectral_conv2d
from blindno_torch.ops.spectral_cuda import (fno1d_layer_cuda, fno2d_layer_cuda,
                                             spectral_conv1d_cuda, spectral_conv2d_cuda)

ROOT = pathlib.Path(__file__).resolve().parent.parent
# the JAX package's checkpoint formats are read by the port itself
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "blindno", "tensorstore", "msgpack",
             "zstandard"}


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_port_imports_nothing_of_jax_or_the_jax_package():
    files = sorted((ROOT / "blindno_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    # every subpackage is walked, the training, data, suites and logging ones included
    walked = {f.relative_to(ROOT / "blindno_torch").parts[0] for f in files[:-1]}
    assert {"data", "eval", "models", "nn", "ops", "suites", "tools", "train", "utils"} <= walked
    assert {"loop.py", "checkpoint.py", "jax_checkpoint.py", "datasets.py", "run.py",
            "registry.py", "logging.py", "field_eval.py"} <= {f.name for f in files}
    bad = {str(f.relative_to(ROOT)): sorted(set(_imported_roots(f)) & FORBIDDEN) for f in files}
    assert not {f: r for f, r in bad.items() if r}
    # the JAX formats' reader and writer: numpy, the standard library and ctypes alone
    formats = ROOT / "blindno_torch" / "train" / "jax_checkpoint.py"
    assert {"read_orbax", "write_orbax", "read_msgpack", "write_msgpack"} <= {
        n.name for n in ast.parse(formats.read_text()).body if isinstance(n, ast.FunctionDef)}
    assert set(_imported_roots(formats)) <= {"__future__", "base64", "ctypes", "functools",
                                              "json", "numpy", "os", "struct", "time", "uuid"}


def test_default_device_needs_cuda_or_an_explicit_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        default_device()
    with pytest.raises(RuntimeError):
        default_device("cuda")
    assert default_device("cpu") == torch.device("cpu")
    with pytest.raises(RuntimeError):
        NIOFP2D(width=4, modes=4, n_basis=3, neurons=8, fno_layers=1)
    model = NIOFP2D(width=4, modes=4, n_basis=3, neurons=8, fno_layers=1, device="cpu")
    with pytest.raises(RuntimeError):
        predict_fields(model, np.zeros((1, 2, 61, 61), np.float32), np.zeros((61, 61, 2), np.float32))


def _layer_inputs(requires_grad=False):
    g = torch.Generator().manual_seed(0)
    t = lambda *s: torch.randn(*s, generator=g).requires_grad_(requires_grad)
    return t(2, 3, 12, 10), t(3, 4, 6, 4), t(3, 4, 6, 4), t(3, 4), t(4)


def test_wrappers_take_the_plain_path_on_cpu():
    x, wr, wi, pk, pb = _layer_inputs()
    counts = fno2d_layer_cuda.launches, spectral_conv2d_cuda.launches
    for act in (True, False):
        torch.testing.assert_close(fno2d_layer_cuda(x, wr, wi, pk, pb, act),
                                   fno2d_layer_plain(x, wr, wi, pk, pb, act), rtol=0, atol=0)
    torch.testing.assert_close(spectral_conv2d_cuda(x, wr, wi), spectral_conv2d(x, wr, wi),
                               rtol=0, atol=0)
    assert (fno2d_layer_cuda.launches, spectral_conv2d_cuda.launches) == counts


def test_wrappers_raise_under_autograd():
    """``spectral_conv2d_cuda`` stays forward only, as in JAX; ``fno2d_layer_cuda``
    gives gradients under autograd (held against JAX in ``test_torch_train.py``)."""
    x, wr, wi, pk, pb = _layer_inputs(requires_grad=True)
    with pytest.raises(RuntimeError, match="forward only"):
        spectral_conv2d_cuda(x, wr, wi)
    fno2d_layer_cuda(x, wr, wi, pk, pb).sum().backward()
    for t in (x, wr, wi, pk, pb):
        assert t.grad is not None and t.grad.shape == t.shape and torch.isfinite(t.grad).all()
    with torch.no_grad():
        assert fno2d_layer_cuda(x, wr, wi, pk, pb).shape == (2, 4, 12, 10)


def test_wrappers_refuse_other_devices():
    x, wr, wi, pk, pb = (t.to("meta") for t in _layer_inputs())
    with pytest.raises(ValueError, match="CUDA tensors"):
        fno2d_layer_cuda(x, wr, wi, pk, pb)
    with pytest.raises(ValueError, match="CUDA tensors"):
        spectral_conv2d_cuda(x, wr, wi)


def test_1d_models_need_cuda_or_an_explicit_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for cls in (NIOFP1D, NIOFNO1D):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            cls(width=4, modes=4, fno_layers=1)
        model = cls(width=4, modes=4, fno_layers=1, device="cpu")
        with pytest.raises(RuntimeError):
            predict_fields(model, np.zeros((1, 2, 80), np.float32), np.zeros((80, 1), np.float32))


def _layer_inputs_1d(requires_grad=False):
    g = torch.Generator().manual_seed(1)
    t = lambda *s: torch.randn(*s, generator=g).requires_grad_(requires_grad)
    return t(2, 3, 20), t(3, 4, 6), t(3, 4, 6), t(3, 4), t(4)


def test_1d_wrappers_take_the_plain_path_on_cpu():
    x, wr, wi, pk, pb = _layer_inputs_1d()
    counts = fno1d_layer_cuda.launches, spectral_conv1d_cuda.launches
    for dc_half in (True, False):
        for act in (True, False):
            torch.testing.assert_close(fno1d_layer_cuda(x, wr, wi, pk, pb, dc_half, act),
                                       fno1d_layer_plain(x, wr, wi, pk, pb, dc_half, act),
                                       rtol=0, atol=0)
        torch.testing.assert_close(spectral_conv1d_cuda(x, wr, wi, dc_half),
                                   spectral_conv1d(x, wr, wi, dc_half), rtol=0, atol=0)
    assert (fno1d_layer_cuda.launches, spectral_conv1d_cuda.launches) == counts


def test_1d_wrappers_raise_under_autograd():
    """``spectral_conv1d_cuda`` stays forward only, as in JAX; ``fno1d_layer_cuda``
    gives gradients under autograd (held against JAX in ``test_torch_train1d.py``)."""
    x, wr, wi, pk, pb = _layer_inputs_1d(requires_grad=True)
    with pytest.raises(RuntimeError, match="forward only"):
        spectral_conv1d_cuda(x, wr, wi)
    fno1d_layer_cuda(x, wr, wi, pk, pb).sum().backward()
    for t in (x, wr, wi, pk, pb):
        assert t.grad is not None and t.grad.shape == t.shape and torch.isfinite(t.grad).all()
    with torch.no_grad():
        assert fno1d_layer_cuda(x, wr, wi, pk, pb).shape == (2, 4, 20)


def test_1d_wrappers_refuse_other_devices():
    x, wr, wi, pk, pb = (t.to("meta") for t in _layer_inputs_1d())
    with pytest.raises(ValueError, match="CUDA tensors"):
        fno1d_layer_cuda(x, wr, wi, pk, pb)
    with pytest.raises(ValueError, match="CUDA tensors"):
        spectral_conv1d_cuda(x, wr, wi)


def _flax_tree():
    """A tiny flax-layout tree: one conv block with BN, and one FNO head layer."""
    z = lambda *s: np.zeros(s, np.float32)
    params = {
        "Encoder2D_0": {"ConvBlock_0": {"TorchConv_0": {"Conv_0": {"kernel": z(1, 7, 1, 4), "bias": z(4)}},
                                        "TorchBatchNorm_0": {"BatchNorm_0": {"scale": z(4), "bias": z(4)}}}},
        "FNO2d_0": {"SpectralConv2d_0": {"weights_re": z(3, 3, 4, 2), "weights_im": z(3, 3, 4, 2)},
                    "PointwiseConv_0": {"kernel": z(3, 5), "bias": z(5)}},
        "DeepOnetNoBias_0": {"b0": z()},
    }
    stats = {"Encoder2D_0": {"ConvBlock_0": {"TorchBatchNorm_0": {"BatchNorm_0": {"mean": z(4), "var": z(4)}}}}}
    return params, stats


def test_from_flax_maps_layouts():
    params, stats = _flax_tree()
    sd = from_flax(params, stats)
    assert sd["deeponet.branch.blocks.0.conv.weight"].shape == (4, 1, 1, 7)
    assert sd["deeponet.branch.blocks.0.bn.running_var"].shape == (4,)
    assert sd["heads.0.pointwise.0.weight"].shape == (5, 3)
    assert sd["heads.0.spectral.0.weights_re"].shape == (3, 3, 4, 2)
    assert sd["deeponet.b0"].shape == ()


def test_from_flax_maps_a_tree_without_statistics():
    """A gradient tree has no batch statistics: with ``batch_stats=None`` its BatchNorm
    modules give weight and bias only, and nothing else changes."""
    params, stats = _flax_tree()
    full, grads = from_flax(params, stats), from_flax(params, None)
    assert grads.keys() == {k for k in full if not k.endswith(
        ("running_mean", "running_var", "num_batches_tracked"))}
    assert all(torch.equal(grads[k], full[k]) for k in grads)


@pytest.mark.parametrize("fault", ["missing_stat", "missing_bias", "extra_leaf", "extra_module",
                                   "extra_stat"])
def test_from_flax_raises_on_missing_or_extra_keys(fault):
    params, stats = _flax_tree()
    bn_stats = stats["Encoder2D_0"]["ConvBlock_0"]["TorchBatchNorm_0"]["BatchNorm_0"]
    if fault == "missing_stat":
        del bn_stats["var"]
    elif fault == "missing_bias":
        del params["FNO2d_0"]["PointwiseConv_0"]["bias"]
    elif fault == "extra_leaf":
        params["FNO2d_0"]["SpectralConv2d_0"]["weights_x"] = np.zeros(1, np.float32)
    elif fault == "extra_module":
        params["Bogus_0"] = {"kernel": np.zeros(1, np.float32)}
    else:
        stats["FNO2d_0"] = {"PointwiseConv_0": {"mean": np.zeros(5, np.float32)}}
    with pytest.raises(KeyError):
        from_flax(params, stats)


def test_missing_nvcc_raises(monkeypatch):
    from blindno_torch.ops import _build

    monkeypatch.setattr(_build.os, "access", lambda *args: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.find_nvcc()
    assert _build.build_dir().parent.name == "_build"


def test_version():
    assert blindno_torch.__version__
