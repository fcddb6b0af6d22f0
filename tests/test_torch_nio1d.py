"""The port's 1-D NIO serving path (``NIOFP1D``, ``NIOFNO1D``) against the flax models,
in eval mode.

Weights move over with ``blindno_torch.convert.from_flax``; both models see the same
numpy inputs. The tolerance is the NIO parity bound of
``tests/test_nio2d_torch_parity.py``, 2e-3.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blindno.eval.field_eval import predict_fields as jax_predict_fields
from blindno.models.nio1d import NIOFNO1D as JNIOFNO1D
from blindno.models.nio1d import NIOFP1D as JNIOFP1D
from blindno.nn.cnn import Encoder1D as JEncoder1D
from blindno.ops.config import set_spectral_impl, spectral_impl
from blindno.suites.registry import ENC_FPE80 as J_ENC_FPE80
from blindno.suites.registry import ENC_GPE128 as J_ENC_GPE128
from blindno_torch.convert import from_flax
from blindno_torch.eval.field_eval import predict_fields
from blindno_torch.eval.metrics import relative_l2_per_field
from blindno_torch.models.nio1d import NIOFNO1D, NIOFP1D
from blindno_torch.nn.cnn import ENC_FPE80, ENC_GPE128, Encoder1D
from test_nio2d_torch_parity import _randomize_bn

TOL = 2e-3
N = 80
CKPT = os.path.join(os.path.dirname(__file__), "..", "runs", "ckpt")
# (JAX model, port model, config) of the small models and of the committed checkpoints
SMALL = {
    "nio": (JNIOFP1D, NIOFP1D, dict(width=6, modes=8, n_basis=7, neurons=16, fno_layers=2)),
    "fno": (JNIOFNO1D, NIOFNO1D, dict(width=6, modes=8, fno_layers=2)),
}
# (JAX model, port model, config, grid points, output fields) of the committed
# full-width checkpoints: fpe1d on 80 points, the GPE suites on 128
# (blindno/suites/registry.py:88-90,111-173). Both packages' encoder schedules are the
# same tuples (test_encoder_schedules_match_jax).
_GPE_NIO = dict(head_dims=(1,), encoder_final_convs=ENC_GPE128)
FULL = {
    "fpe1d_nio": (JNIOFP1D, NIOFP1D, dict(width=30, modes=15), N, 2),
    "fpe1d_fno": (JNIOFNO1D, NIOFNO1D, dict(width=30, modes=15), N, 2),
    "schrodinger1d_nio": (JNIOFP1D, NIOFP1D, dict(width=10, modes=30, **_GPE_NIO), 128, 1),
    "schrodinger1d_fno": (JNIOFNO1D, NIOFNO1D, dict(width=10, modes=30, head_dims=(1,)), 128, 1),
    "gpe1d_nio": (JNIOFP1D, NIOFP1D, dict(width=20, modes=40, **_GPE_NIO), 128, 1),
    "gpe1d_fno": (JNIOFNO1D, NIOFNO1D, dict(width=20, modes=40, head_dims=(1,)), 128, 1),
    "gpe1d_vgk_nio": (JNIOFP1D, NIOFP1D, dict(width=25, modes=32, fno_layers=4, head_dims=(1, 2),
                                              encoder_final_convs=ENC_GPE128), 128, 3),
}


def _grid(n=N):
    """A 1-D suite's grid of n points, ``blindno/suites/registry.py:_grid_1d``."""
    return np.linspace(0.0, 1.0, n, dtype=np.float32).reshape(n, 1)


def _torch_model(cls, variables, **cfg):
    model = cls(**cfg, device="cpu")
    model.load_state_dict(from_flax(jax.tree.map(np.asarray, variables["params"]),
                                    jax.tree.map(np.asarray, variables.get("batch_stats", {}))))
    return model


def test_encoder_schedules_match_jax():
    assert ENC_FPE80 == J_ENC_FPE80 and ENC_GPE128 == J_ENC_GPE128


@pytest.fixture(scope="module", params=sorted(SMALL))
def small_flax(request):
    """A small flax model with randomized BN, its variables and inputs."""
    jcls, cls, cfg = SMALL[request.param]
    x = np.random.default_rng(0).standard_normal((2, 3, N)).astype(np.float32)
    jmodel = jcls(**cfg)
    variables = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(_grid()),
                            training=False)
    variables = _randomize_bn(variables, np.random.default_rng(7))
    return cls, cfg, jmodel, variables, x


@pytest.mark.parametrize("impl", ["pallas_fused", "jnp"])
def test_small_nio1d_matches_flax(small_flax, impl):
    """The flax model's eval-mode output under the impl that reaches the fused Pallas
    kernel (interpret mode on the CPU) and under the plain impl."""
    cls, cfg, jmodel, variables, x = small_flax
    previous = spectral_impl()
    set_spectral_impl(impl)
    try:
        want = np.asarray(jmodel.apply(variables, jnp.asarray(x), jnp.asarray(_grid()),
                                       training=False))
    finally:
        set_spectral_impl(previous)
    got = predict_fields(_torch_model(cls, variables, **cfg), x, _grid(), batch=1, device="cpu")
    assert got.shape == want.shape == (2, N, 2)
    assert np.std(want) > 1e-3
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("name", sorted(FULL))
def test_full_width_checkpoint_matches_jax_predict_fields(name):
    """The committed fpe1d, schrodinger1d and gpe1d checkpoints at full width
    (``runs/RESULTS.md``), each on its suite's grid."""
    from blindno.train.checkpoint import load_best

    jcls, cls, cfg, n, fields = FULL[name]
    ckpt = load_best(os.path.join(CKPT, name))
    variables = {"params": ckpt["params"], "batch_stats": ckpt.get("batch_stats") or {}}
    x = np.random.default_rng(5).standard_normal((3, 10, n)).astype(np.float32)
    want = jax_predict_fields(jcls(**cfg), variables["params"], variables["batch_stats"], x,
                              _grid(n), batch=2)
    got = predict_fields(_torch_model(cls, variables, **cfg), x, _grid(n), batch=2, device="cpu")
    assert got.shape == want.shape == (3, n, fields)
    assert np.isfinite(got).all() and np.std(want) > 1e-3
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    err = relative_l2_per_field(torch.tensor(got), torch.tensor(want)).numpy()
    assert err.shape == (3, fields) and err.max() < TOL


@pytest.mark.parametrize("n,final_convs", [(128, ENC_GPE128), (80, ENC_FPE80)])
def test_encoder1d_collapses_and_matches_flax(n, final_convs):
    x = np.random.default_rng(9).standard_normal((2, 3, n)).astype(np.float32)
    jmodel = JEncoder1D(5, tuple(final_convs))
    variables = jmodel.init(jax.random.PRNGKey(2), jnp.asarray(x))
    variables = _randomize_bn(variables, np.random.default_rng(3))
    want = np.asarray(jmodel.apply(variables, jnp.asarray(x)))
    params, stats = (jax.tree.map(np.asarray, variables[k]) for k in ("params", "batch_stats"))
    state = from_flax({"Encoder1D_0": params}, {"Encoder1D_0": stats})
    model = Encoder1D(5, final_convs).eval()
    model.load_state_dict({k.removeprefix("deeponet.branch."): v for k, v in state.items()})
    with torch.inference_mode():
        got = model(torch.tensor(x)).numpy()
    assert got.shape == want.shape == (2, 3, 5)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    with pytest.raises(ValueError, match="did not collapse"):
        model(torch.zeros(1, 2, n + 16))


def _flax_tree_1d():
    """A tiny flax-layout 1-D FNO-branch tree: the branch FNO1d, one head, the fusion."""
    z = lambda *s: np.zeros(s, np.float32)
    fno = lambda cin, w, m: {
        "TorchDense_0": {"Dense_0": {"kernel": z(cin, w), "bias": z(w)}},
        "SpectralConv1d_0": {"weights_re": z(w, w, m), "weights_im": z(w, w, m)},
        "PointwiseConv_0": {"kernel": z(w, w), "bias": z(w)},
        "TorchDense_1": {"Dense_0": {"kernel": z(w, 128), "bias": z(128)}},
        "TorchDense_2": {"Dense_0": {"kernel": z(128, 1), "bias": z(1)}},
    }
    return {"FNO1d_0": fno(2, 4, 3), "FNO1d_1": fno(6, 6, 5),
            "MeanFieldFusion_0": {"kernel": z(2, 6), "bias": z(6)}}


def test_from_flax_maps_the_fno_branch_and_1d_conv_layouts():
    sd = from_flax(_flax_tree_1d(), {})
    assert sd["branch.spectral.0.weights_re"].shape == (4, 4, 3)
    assert sd["branch.fc0.weight"].shape == (4, 2)
    assert sd["heads.0.spectral.0.weights_re"].shape == (6, 6, 5)
    assert sd["fusion.weight"].shape == (6, 2)
    model = NIOFNO1D(fno_layers=1, width=6, modes=5, head_dims=(1,), inner_modes=3,
                     inner_width=4, inner_layers=1, device="cpu")
    model.load_state_dict(sd)
    kernel = np.arange(3 * 2 * 4, dtype=np.float32).reshape(3, 2, 4)
    params = {"Encoder1D_0": {"ConvBlock_0": {"TorchConv_0": {"Conv_0": {"kernel": kernel,
                                                                           "bias": np.zeros(4, np.float32)}}}}}
    weight = from_flax(params, {})["deeponet.branch.blocks.0.conv.weight"]
    np.testing.assert_array_equal(weight.numpy(), kernel.transpose(2, 1, 0))


@pytest.mark.parametrize("fault", ["missing_weights", "missing_bias", "extra_leaf",
                                   "extra_module", "extra_stat"])
def test_from_flax_raises_on_missing_or_extra_1d_keys(fault):
    params, stats = _flax_tree_1d(), {}
    if fault == "missing_weights":
        del params["FNO1d_0"]["SpectralConv1d_0"]["weights_im"]
    elif fault == "missing_bias":
        del params["FNO1d_1"]["PointwiseConv_0"]["bias"]
    elif fault == "extra_leaf":
        params["FNO1d_1"]["SpectralConv1d_0"]["weights_x"] = np.zeros(1, np.float32)
    elif fault == "extra_module":
        params["FNO1d_1"]["Bogus_0"] = {"kernel": np.zeros(1, np.float32)}
    else:
        stats["FNO1d_0"] = {"PointwiseConv_0": {"mean": np.zeros(4, np.float32)}}
    with pytest.raises(KeyError):
        from_flax(params, stats)


@pytest.mark.parametrize("name", sorted(SMALL))
def test_train_mode_subsamples(name):
    """In train mode the forward gathers the set by the subsample's indices and masks
    the fusion's mean: handing it (indices, mask) equals handing it the gathered set with
    the identity indices; a generator's draw is the same for the same seed and another
    for another seed; with no BatchNorm (``NIOFNO1D``) the masked-out snapshots do not
    enter at all, and the output is the eval-mode forward of the kept ones. Every
    trainable parameter gets a finite gradient and the frozen fusion none."""
    _, cls, cfg = SMALL[name]
    model = cls(**cfg, l_min=2, device="cpu").train()
    rng = np.random.default_rng(1)
    x = torch.tensor((rng.standard_normal((2, 1, N)) + rng.standard_normal((2, 6, N)))
                     .astype(np.float32))
    grid = torch.tensor(_grid())
    idx, mask = torch.tensor([5, 0, 0, 3, 1, 2]), torch.tensor([1, 1, 1, 0, 0, 0.0])
    out = model(x, grid, subsample=(idx, mask))
    torch.testing.assert_close(out, model(x[:, idx], grid, subsample=(torch.arange(6), mask)),
                               rtol=0, atol=0)
    drawn = [model(x, grid, generator=torch.Generator().manual_seed(s)) for s in (0, 0, 1)]
    torch.testing.assert_close(drawn[0], drawn[1], rtol=0, atol=0)
    assert not torch.allclose(drawn[0], drawn[2]) and not torch.allclose(out, drawn[0])
    if name == "fno":
        with torch.no_grad():
            want = model.eval()(x[:, idx[:3]], grid)
        model.train()
        torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-6)
    (out ** 2).mean().backward()
    for key, p in model.named_parameters():
        if key.startswith("fusion."):
            assert not p.requires_grad and p.grad is None, key
        else:
            assert p.grad is not None and torch.isfinite(p.grad).all(), key
