"""The port's 1-D spectral conv, FNO1d layer and FNO1d stack against the JAX package on
the CPU.

Inputs are numpy arrays from a seed and go through both. The plain spectral conv and
layer are held against the Pallas kernels in interpret mode (as the JAX tests run them
on the CPU) and against the jnp chain; the torch ``FNO1d`` and ``SpectralConv1d``
modules (weights moved over with the converter's rules) against the flax modules.
The tolerance is the 1-D Pallas kernels' own, 2e-4 (``tests/test_spectral_pallas.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blindno.nn.fno import FNO1d as JFNO1d
from blindno.nn.fno import SpectralConv1d as JSpectralConv1d
from blindno.ops import spectral as jspectral
from blindno.ops.config import set_spectral_impl, spectral_impl
from blindno.ops.spectral_pallas import fno1d_layer_pallas, spectral_conv1d_pallas
from blindno_torch.convert import from_flax
from blindno_torch.nn.fno import FNO1d, SpectralConv1d
from blindno_torch.ops.fno_layer import fno1d_layer_plain
from blindno_torch.ops.spectral import dft_matrices_1d, spectral_conv1d, spectral_conv1d_fft

TOL = 2e-4
# (B, C, N, modes): the fpe1d heads' padded width, a ragged one, and modes = N//2+1
SHAPES = [(2, 6, 100, 15), (3, 5, 37, 7), (2, 3, 16, 9)]


def _inputs(shape, seed, cout_extra=1):
    b, c, n, modes = shape
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    cout = c + cout_extra
    return f(b, c, n), f(c, cout, modes), f(c, cout, modes), f(c, cout), f(cout)


def test_dft_matrices_1d_match_jax():
    from blindno.ops.dft import rdft_forward, rdft_inverse

    for dc_half in (True, False):
        got = dft_matrices_1d(100, 15, dc_half, torch.float32, "cpu")
        want = (*rdft_forward(100, 15, jnp.float32, dc_half=dc_half),
                *rdft_inverse(100, 15, jnp.float32))
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("dc_half", [True, False])
@pytest.mark.parametrize("shape", SHAPES)
def test_spectral_conv1d_matches_jax_and_pallas(shape, dc_half):
    x, wr, wi, _, _ = _inputs(shape, 1)
    got = spectral_conv1d(*map(torch.tensor, (x, wr, wi)), dc_half).numpy()
    jx = list(map(jnp.asarray, (x, wr, wi)))
    want_jnp = np.asarray(jspectral.spectral_conv1d(*jx, dc_half=dc_half))
    want_pallas = np.asarray(spectral_conv1d_pallas(*jx, dc_half=dc_half, interpret=True))
    assert got.shape == want_jnp.shape == (shape[0], shape[1] + 1, shape[2])
    np.testing.assert_allclose(got, want_jnp, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got, want_pallas, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("dc_half", [True, False])
@pytest.mark.parametrize("shape", SHAPES)
def test_spectral_conv1d_matches_fft_restatement(shape, dc_half):
    x, wr, wi, _, _ = map(torch.tensor, _inputs(shape, 2))
    np.testing.assert_allclose(spectral_conv1d(x, wr, wi, dc_half).numpy(),
                               spectral_conv1d_fft(x, wr, wi, dc_half).numpy(),
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("apply_act", [True, False])
@pytest.mark.parametrize("shape", SHAPES[:2])
def test_fno1d_layer_plain_matches_pallas(shape, apply_act):
    x, wr, wi, pk, pb = _inputs(shape, 3, cout_extra=0)
    want = np.asarray(fno1d_layer_pallas(*map(jnp.asarray, (x, wr, wi, pk, pb)),
                                         apply_act=apply_act, interpret=True))
    got = fno1d_layer_plain(*map(torch.tensor, (x, wr, wi, pk, pb)), apply_act=apply_act)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


def test_fno1d_layer_plain_without_dc_half_matches_pallas():
    x, wr, wi, pk, pb = _inputs(SHAPES[1], 4, cout_extra=0)
    want = np.asarray(fno1d_layer_pallas(*map(jnp.asarray, (x, wr, wi, pk, pb)),
                                         dc_half=False, interpret=True))
    got = fno1d_layer_plain(*map(torch.tensor, (x, wr, wi, pk, pb)), dc_half=False)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


def _fno_state(params):
    """Flax FNO1d params -> torch FNO1d state dict, through the converter as a head."""
    state = from_flax({"FNO1d_0": params}, {})
    return {k.removeprefix("heads.0."): v for k, v in state.items()}


@pytest.mark.parametrize("impl", ["pallas_fused", "jnp"])
@pytest.mark.parametrize("config", [(15, 30, 3, 30, 1, 80), (12, 4, 2, 2, 1, 80),
                                    (7, 5, 2, 3, 2, 37)])
def test_fno1d_matches_flax(config, impl):
    """(modes, width, n_layers, input_dim, output_dim, N): an fpe1d head, the FNO-branch
    model's inner FNO1d, and a ragged stack."""
    modes, width, n_layers, input_dim, output_dim, n = config
    x = np.random.default_rng(5).standard_normal((3, n, input_dim)).astype(np.float32)
    jmodel = JFNO1d(modes, width, n_layers, input_dim, output_dim)
    previous = spectral_impl()
    set_spectral_impl(impl)
    try:
        variables = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(x))
        want = np.asarray(jmodel.apply(variables, jnp.asarray(x)))
    finally:
        set_spectral_impl(previous)
    model = FNO1d(modes, width, n_layers, input_dim, output_dim)
    model.load_state_dict(_fno_state(jax.tree.map(np.asarray, variables["params"])))
    with torch.inference_mode():
        got = model(torch.tensor(x)).numpy()
    assert got.shape == want.shape == (3, n, output_dim)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("shape", SHAPES)
def test_spectral_conv1d_module_matches_flax(shape):
    b, c, n, modes = shape
    x = np.random.default_rng(6).standard_normal((b, c, n)).astype(np.float32)
    jmodule = JSpectralConv1d(c, c + 1, modes)
    variables = jmodule.init(jax.random.PRNGKey(1), jnp.asarray(x))
    want = np.asarray(jmodule.apply(variables, jnp.asarray(x)))
    module = SpectralConv1d(c, c + 1, modes, torch.Generator())
    assert module.dc_half == jmodule.dc_half
    module.load_state_dict({k: torch.tensor(np.asarray(v))
                            for k, v in variables["params"].items()})
    with torch.inference_mode():
        got = module(torch.tensor(x)).numpy()
    assert got.shape == want.shape == (b, c + 1, n)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("n,padded", [(80, 100), (128, 160), (37, 46)])
def test_fno1d_lift_pads_a_quarter(n, padded):
    model = FNO1d(4, 5, 1, 3, 1)
    x = torch.tensor(np.random.default_rng(7).standard_normal((2, n, 3)).astype(np.float32))
    with torch.inference_mode():
        lifted = model.lift(x)
    assert lifted.shape == (2, 5, padded) and lifted.is_contiguous()
    torch.testing.assert_close(lifted[..., :n], model.fc0(x).permute(0, 2, 1))
    assert not lifted[..., n:].any()
