"""Committed JAX checkpoints served on the card: ``load_best`` reads the orbax directory
with the port's own reader (``blindno_torch/train/jax_checkpoint.py``), its tensors land
on the card, and the model's fields there agree with the same weights on the CPU within
2e-3 of each field's scale, the FNO layers' kernels launched once a layer.

Marked ``cuda``: each test asks the ``cuda_device`` fixture, which skips it where no
CUDA device is present. The file imports nothing of JAX, so on the card host it runs with
``--noconftest``.
"""
import os

import numpy as np
import pytest
import torch

from blindno_torch.eval.field_eval import predict_fields
from blindno_torch.nn.fno import FNO1d, FNO2d
from blindno_torch.ops.spectral_cuda import fno1d_layer_cuda, fno2d_layer_cuda
from blindno_torch.suites.registry import SUITES
from blindno_torch.train.checkpoint import load_best

pytestmark = pytest.mark.cuda

CKPT = os.path.join(os.path.dirname(__file__), "..", "runs", "ckpt")
SERVE_TOL = 2e-3  # of each field's scale: the NIO parity bound


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("suite,model,sets", [("fpe2d", "nio", 2), ("fpe2d", "unet", 2),
                                              ("fpe1d", "nio", 16), ("gpe1d", "fno", 16)])
def test_committed_checkpoint_serves_on_the_card(suite, model, sets, cuda_device):
    spec = SUITES[suite]
    ckpt = os.path.join(CKPT, f"{suite}_{model}")
    card, cpu = load_best(ckpt, cuda_device), load_best(ckpt)
    assert all(v.device.type == "cuda" for v in {**card["params"], **card["batch_stats"]}.values())
    assert card["epoch"] == cpu["epoch"] and card["test_loss"] == cpu["test_loss"]
    models = {}
    for label, state, dev in (("card", card, cuda_device), ("cpu", cpu, "cpu")):
        models[label] = spec.models[model](device=dev)
        models[label].load_state_dict({**state["params"], **state["batch_stats"]})
        models[label].eval()
    x = np.random.default_rng(0).standard_normal(
        (sets, 100, *spec.grid.shape[:-1])).astype(np.float32)
    layer = fno2d_layer_cuda if spec.grid.shape[-1] == 2 else fno1d_layer_cuda
    calls = sum(len(m.spectral) for m in models["card"].modules()
                if isinstance(m, (FNO1d, FNO2d)))
    before = layer.launches
    got = predict_fields(models["card"], x, spec.grid, batch=sets)
    assert layer.launches - before == calls > 0
    want = predict_fields(models["cpu"], x, spec.grid, batch=sets, device="cpu")
    assert got.shape == want.shape and np.isfinite(got).all()
    for f in range(want.shape[-1]):
        scale = np.abs(want[..., f]).max()
        np.testing.assert_allclose(got[..., f], want[..., f], rtol=SERVE_TOL,
                                   atol=SERVE_TOL * scale, err_msg=f"field {f}")
