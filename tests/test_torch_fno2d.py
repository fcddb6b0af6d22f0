"""The port's FNO2d layer and stack against the JAX package on the CPU.

The layer's plain version is held against the Pallas fused-layer kernel in interpret
mode, and the torch ``FNO2d`` (weights moved over with the converter's rules) against
the flax ``FNO2d`` under the impl that reaches the fused Pallas kernel and under the
plain impl. ``SpectralConv2d`` on its own is held against the flax module (the flax
``pallas`` impl runs only on a TPU; the spectral kernel itself is held against the
Pallas one in ``test_torch_spectral.py``). Last, the CUDA kernel's choice of 3xTF32
tensor-core products is checked by emulating TF32 rounding on the CPU.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blindno.nn.fno import FNO2d as JFNO2d
from blindno.nn.fno import SpectralConv2d as JSpectralConv2d
from blindno.ops.config import set_spectral_impl, spectral_impl
from blindno.ops.spectral_pallas import fno2d_layer_pallas, spectral_conv2d_pallas
from blindno_torch.convert import from_flax
from blindno_torch.nn.fno import FNO2d, SpectralConv2d
from blindno_torch.ops.fno_layer import fno2d_layer_plain
from blindno_torch.ops.spectral import dft_matrices_2d, spectral_conv2d

# (B, C, H, W, m1, m2); the last two are shapes whose padded grid the CUDA kernel takes in
# its tiled layouts, at small widths: a thin grid, and a square one past 176 x 176
TILED_SHAPES = [(1, 2, 16, 360, 4, 40), (1, 1, 184, 184, 32, 32)]
SHAPES = [(2, 4, 24, 20, 6, 5), (3, 5, 40, 36, 7, 9), *TILED_SHAPES]


@pytest.mark.parametrize("apply_act", [True, False])
@pytest.mark.parametrize("shape", SHAPES)
def test_fno2d_layer_plain_matches_pallas(shape, apply_act):
    b, c, h, w, m1, m2 = shape
    rng = np.random.default_rng(3)
    x = rng.standard_normal((b, c, h, w)).astype(np.float32)
    wr, wi = (rng.standard_normal((c, c, 2 * m1, m2)).astype(np.float32) for _ in range(2))
    pk = rng.standard_normal((c, c)).astype(np.float32)
    pb = rng.standard_normal((c,)).astype(np.float32)
    want = np.asarray(fno2d_layer_pallas(*map(jnp.asarray, (x, wr, wi, pk, pb)),
                                         apply_act=apply_act, interpret=True))
    got = fno2d_layer_plain(*map(torch.tensor, (x, wr, wi, pk, pb)), apply_act=apply_act)
    np.testing.assert_allclose(got.numpy(), want, rtol=3e-4, atol=3e-4)


@pytest.mark.parametrize("shape", TILED_SHAPES)
def test_spectral_conv2d_plain_matches_pallas(shape):
    b, c, h, w, m1, m2 = shape
    rng = np.random.default_rng(7)
    x = rng.standard_normal((b, c, h, w)).astype(np.float32)
    wr, wi = (rng.standard_normal((c, c + 1, 2 * m1, m2)).astype(np.float32) for _ in range(2))
    want = np.asarray(spectral_conv2d_pallas(*map(jnp.asarray, (x, wr, wi)), interpret=True))
    got = spectral_conv2d(*map(torch.tensor, (x, wr, wi)))
    assert got.shape == want.shape == (b, c + 1, h, w)
    np.testing.assert_allclose(got.numpy(), want, rtol=3e-4, atol=3e-4)


def _fno_state(params):
    """Flax FNO2d params -> torch FNO2d state dict, through the converter as a head."""
    state = from_flax({"FNO2d_0": params}, {})
    return {k.removeprefix("heads.0."): v for k, v in state.items()}


@pytest.mark.parametrize("impl", ["pallas_fused", "jnp"])
def test_fno2d_matches_flax(impl):
    modes, width, n_layers, input_dim, output_dim = 6, 5, 3, 4, 2
    x = np.random.default_rng(4).standard_normal((2, 21, 19, input_dim)).astype(np.float32)
    jmodel = JFNO2d(modes, width, n_layers, input_dim, output_dim)
    previous = spectral_impl()
    set_spectral_impl(impl)
    try:
        variables = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(x))
        want = np.asarray(jmodel.apply(variables, jnp.asarray(x)))
    finally:
        set_spectral_impl(previous)
    model = FNO2d(modes, width, n_layers, input_dim, output_dim)
    model.load_state_dict(_fno_state(jax.tree.map(np.asarray, variables["params"])))
    with torch.inference_mode():
        got = model(torch.tensor(x)).numpy()
    assert got.shape == want.shape == (2, 21, 19, output_dim)
    np.testing.assert_allclose(got, want, rtol=3e-4, atol=3e-4)


@pytest.mark.parametrize("shape", SHAPES)
def test_spectral_conv2d_module_matches_flax(shape):
    b, c, h, w, m1, m2 = shape
    x = np.random.default_rng(5).standard_normal((b, c, h, w)).astype(np.float32)
    jmodule = JSpectralConv2d(c, c + 1, m1, m2)
    variables = jmodule.init(jax.random.PRNGKey(1), jnp.asarray(x))
    want = np.asarray(jmodule.apply(variables, jnp.asarray(x)))
    module = SpectralConv2d(c, c + 1, m1, m2, torch.Generator())
    module.load_state_dict({k: torch.tensor(np.asarray(v))
                            for k, v in variables["params"].items()})
    with torch.inference_mode():
        got = module(torch.tensor(x)).numpy()
    assert got.shape == want.shape == (b, c + 1, h, w)
    np.testing.assert_allclose(got, want, rtol=3e-4, atol=3e-4)


def test_fno2d_lift_pads_a_quarter():
    model = FNO2d(4, 5, 1, 3, 1)
    x = torch.tensor(np.random.default_rng(6).standard_normal((2, 21, 19, 3)).astype(np.float32))
    with torch.inference_mode():
        lifted = model.lift(x)
    assert lifted.shape == (2, 5, 26, 24) and lifted.is_contiguous()
    torch.testing.assert_close(lifted[:, :, :21, :19], model.fc0(x).permute(0, 3, 1, 2))
    assert not lifted[:, :, 21:].any() and not lifted[..., 19:].any()


def _tf32(a):
    """Round float32 to TF32 as ``cvt.rna.tf32.f32`` does: nearest at 10 mantissa bits,
    ties away from zero (the sign is apart from the magnitude bits, so adding half of the
    last kept bit and clearing the 13 dropped bits rounds the magnitude)."""
    bits = a.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _emulated_chain(x, wr, wi, split):
    """The dense chain of ``spectral_conv2d`` with each of its four transforms' products
    rounded as the CUDA kernel's tensor cores would: single-pass TF32 operands, or 3xTF32
    (a_hi b_lo + a_lo b_hi + a_hi b_hi, with a_lo = tf32(a - a_hi)). The mode mix stays in
    float32, as in the kernel."""
    def prod(eq, a, b):
        ah, bh = _tf32(a), _tf32(b)
        if not split:
            return torch.einsum(eq, ah, bh)
        al, bl = _tf32(a - ah), _tf32(b - bh)
        return torch.einsum(eq, ah, bl) + torch.einsum(eq, al, bh) + torch.einsum(eq, ah, bh)

    h, w = x.shape[-2:]
    fyre, fyim, fxre, fxim, gxre, gxim, gyre, gyim = dft_matrices_2d(
        h, w, wr.shape[2] // 2, wr.shape[3], torch.float32, "cpu")
    yr, yi = prod("bchw,wm->bchm", x, fyre), prod("bchw,wm->bchm", x, fyim)
    xr = prod("bchm,hk->bckm", yr, fxre) - prod("bchm,hk->bckm", yi, fxim)
    xi = prod("bchm,hk->bckm", yr, fxim) + prod("bchm,hk->bckm", yi, fxre)
    ein = torch.einsum
    outr = ein("bikm,iokm->bokm", xr, wr) - ein("bikm,iokm->bokm", xi, wi)
    outi = ein("bikm,iokm->bokm", xr, wi) + ein("bikm,iokm->bokm", xi, wr)
    zr = prod("bokm,kh->bohm", outr, gxre) - prod("bokm,kh->bohm", outi, gxim)
    zi = prod("bokm,kh->bohm", outr, gxim) + prod("bokm,kh->bohm", outi, gxre)
    return prod("bohm,mw->bohw", zr, gyre) + prod("bohm,mw->bohw", zi, gyim)


def test_tensor_core_numerics_need_the_3xtf32_correction():
    """Why the CUDA kernel splits every transform operand into two TF32 parts: at the main
    serving shape and unit-normal inputs, 3xTF32 stays within the kernels' 3e-4 of the
    float64 chain, and single-pass TF32 does not."""
    b, c, h, w, m1, m2 = 4, 12, 76, 76, 32, 32
    rng = np.random.default_rng(7)
    x = torch.tensor(rng.standard_normal((b, c, h, w)).astype(np.float32))
    wr, wi = (torch.tensor(rng.standard_normal((c, c, 2 * m1, m2)).astype(np.float32))
              for _ in range(2))
    want = spectral_conv2d(x.double(), wr.double(), wi.double())
    split = _emulated_chain(x, wr, wi, split=True).double()
    single = _emulated_chain(x, wr, wi, split=False).double()
    torch.testing.assert_close(split, want, rtol=3e-4, atol=3e-4)
    assert not torch.allclose(single, want, rtol=3e-4, atol=3e-4)
