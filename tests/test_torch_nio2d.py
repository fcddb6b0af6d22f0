"""The port's NIOFP2D serving path against the flax model, in eval mode.

Weights move over with ``blindno_torch.convert.from_flax``; both models see the same
numpy inputs. The tolerance is the 2-D NIO parity bound of
``tests/test_nio2d_torch_parity.py``.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blindno.eval.field_eval import predict_fields as jax_predict_fields
from blindno.models.nio2d import NIOFP2D as JNIOFP2D
from blindno.ops.config import set_spectral_impl, spectral_impl
from blindno_torch.convert import from_flax
from blindno_torch.eval.field_eval import predict_fields
from blindno_torch.eval.metrics import relative_l2_per_field
from blindno_torch.models.nio2d import NIOFP2D
from test_nio2d_torch_parity import _randomize_bn

NX = 61
CKPT = os.path.join(os.path.dirname(__file__), "..", "runs", "ckpt", "fpe2d_nio")


def _grid():
    xs, ys = np.meshgrid(np.linspace(0, 1, NX), np.linspace(0, 1, NX), indexing="ij")
    return np.stack([xs, ys], axis=-1).astype(np.float32)


def _torch_model(variables, **cfg):
    model = NIOFP2D(**cfg, device="cpu")
    model.load_state_dict(from_flax(jax.tree.map(np.asarray, variables["params"]),
                                    jax.tree.map(np.asarray, variables["batch_stats"])))
    return model


@pytest.fixture(scope="module")
def small_flax():
    """The flax model at the shapes of ``tests/test_nio2d_torch_parity.py``, randomized
    BN."""
    cfg = dict(width=6, modes=8, n_basis=7, neurons=16, fno_layers=2)
    x = np.random.default_rng(0).standard_normal((2, 3, NX, NX)).astype(np.float32)
    grid = _grid()
    jmodel = JNIOFP2D(**cfg)
    variables = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(grid),
                            training=False)
    variables = _randomize_bn(variables, np.random.default_rng(7))
    return cfg, jmodel, variables, x, grid


@pytest.mark.parametrize("impl", ["pallas_fused", "jnp"])
def test_small_niofp2d_matches_flax(small_flax, impl):
    """The flax model's eval-mode output under the impl that reaches the fused Pallas
    kernel (interpret mode on the CPU) and under the plain impl."""
    cfg, jmodel, variables, x, grid = small_flax
    previous = spectral_impl()
    set_spectral_impl(impl)
    try:
        want = np.asarray(jmodel.apply(variables, jnp.asarray(x), jnp.asarray(grid),
                                       training=False))
    finally:
        set_spectral_impl(previous)
    got = predict_fields(_torch_model(variables, **cfg), x, grid, batch=1, device="cpu")
    assert got.shape == want.shape == (2, NX, NX, 2)
    assert np.std(want) > 1e-3
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)


def test_full_width_checkpoint_matches_jax_predict_fields():
    """The committed fpe2d NIO checkpoint at full width (12/32/25/100/3)."""
    from blindno.train.checkpoint import load_best

    ckpt = load_best(CKPT)
    variables = {"params": ckpt["params"], "batch_stats": ckpt["batch_stats"]}
    x = np.random.default_rng(5).standard_normal((2, 6, NX, NX)).astype(np.float32)
    grid = _grid()
    jmodel = JNIOFP2D(width=12, modes=32, n_basis=25, neurons=100, fno_layers=3)
    want = jax_predict_fields(jmodel, variables["params"], variables["batch_stats"], x, grid,
                              batch=2)
    model = _torch_model(variables, width=12, modes=32, n_basis=25, neurons=100, fno_layers=3)
    got = predict_fields(model, x, grid, batch=2, device="cpu")
    assert got.shape == want.shape == (2, NX, NX, 2)
    assert np.isfinite(got).all() and np.std(want) > 1e-3
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)
    err = relative_l2_per_field(torch.tensor(got), torch.tensor(want)).numpy()
    assert err.shape == (2, 2) and err.max() < 2e-3


def test_relative_l2_per_field_matches_jax():
    from blindno.eval.metrics import relative_l2_per_field as jax_rel_l2

    rng = np.random.default_rng(6)
    pred, target = (rng.standard_normal((3, 7, 5, 2)).astype(np.float32) for _ in range(2))
    for ref_den in (True, False):
        got = relative_l2_per_field(torch.tensor(pred), torch.tensor(target), ref_den).numpy()
        want = np.asarray(jax_rel_l2(jnp.asarray(pred), jnp.asarray(target), ref_den))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)


def test_masked_mean_and_fusion_match_jax():
    from blindno.nn.setops import MeanFieldFusion as JFusion
    from blindno.nn.setops import masked_mean as jax_masked_mean
    from blindno_torch.nn.setops import MeanFieldFusion, masked_mean

    rng = np.random.default_rng(8)
    snaps = rng.standard_normal((2, 5, 7, 6)).astype(np.float32)
    grid_feats = rng.standard_normal((2, 7, 6, 2)).astype(np.float32)
    for mask in (np.array([1, 1, 0, 1, 0], np.float32), (rng.random((2, 5)) > 0.4).astype(np.float32)):
        np.testing.assert_allclose(masked_mean(torch.tensor(snaps), torch.tensor(mask)).numpy(),
                                   np.asarray(jax_masked_mean(jnp.asarray(snaps), jnp.asarray(mask))),
                                   rtol=1e-6, atol=1e-6)
    jmod = JFusion(width=4, grid_channels=2)
    variables = jmod.init(jax.random.PRNGKey(0), jnp.asarray(grid_feats), jnp.asarray(snaps))
    want = np.asarray(jmod.apply(variables, jnp.asarray(grid_feats), jnp.asarray(snaps),
                                 jnp.asarray(mask)))
    fusion = MeanFieldFusion(4, 2, torch.Generator())
    kernel = np.asarray(variables["params"]["kernel"])
    fusion.load_state_dict({"weight": torch.tensor(kernel.T),
                            "bias": torch.tensor(np.asarray(variables["params"]["bias"]))})
    assert not any(p.requires_grad for p in fusion.parameters())
    got = fusion(torch.tensor(grid_feats), torch.tensor(snaps), torch.tensor(mask)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_training_forward_raises():
    """NIOFP2D trains: in train mode every trainable parameter gets a finite gradient and
    the frozen fusion none. So does the 1-D NIOFP1D, which refused train mode until 1-D
    training came."""
    from blindno_torch.models.nio1d import NIOFP1D

    model = NIOFP2D(width=4, modes=4, n_basis=3, neurons=8, fno_layers=1, l_min=2,
                    device="cpu").train()
    x = torch.tensor(np.random.default_rng(0).standard_normal((2, 3, NX, NX)).astype(np.float32))
    out = model(x, torch.tensor(_grid()), generator=torch.Generator().manual_seed(0))
    (out ** 2).mean().backward()
    for name, p in model.named_parameters():
        if name.startswith("fusion."):
            assert not p.requires_grad and p.grad is None, name
        else:
            assert p.grad is not None and torch.isfinite(p.grad).all(), name
    model_1d = NIOFP1D(width=4, modes=4, fno_layers=1, l_min=2, device="cpu").train()
    x_1d = torch.tensor(np.random.default_rng(1).standard_normal((2, 3, 80)).astype(np.float32))
    grid_1d = torch.linspace(0, 1, 80).reshape(80, 1)
    (model_1d(x_1d, grid_1d, generator=torch.Generator().manual_seed(0)) ** 2).mean().backward()
    assert all(p.grad is not None and torch.isfinite(p.grad).all()
               for k, p in model_1d.named_parameters() if not k.startswith("fusion."))
