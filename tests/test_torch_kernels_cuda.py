"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test asks the ``cuda_device`` fixture, which skips it where no
CUDA device is present (the decision is taken when the test runs, never at import).
"""
import numpy as np
import pytest
import torch

from blindno_torch.ops.fno_layer import fno1d_layer_plain, fno2d_layer_plain
from blindno_torch.ops.spectral import spectral_conv1d, spectral_conv2d
from blindno_torch.ops.spectral_cuda import (fno1d_layer_cuda, fno2d_layer_cuda,
                                             spectral_conv1d_cuda, spectral_conv2d_cuda)

pytestmark = pytest.mark.cuda

# (B, C, H, W, m1, m2): the main serving shape, a ragged one, the ncfpe2d heads (an
# 80x80 grid padded by a quarter), the NIOFNO2D inner branch over 4 x 100 snapshots, one
# smaller than every tile of the kernel, and one whose +-H matrix must take the x plane's
# place in shared memory and whose 2*m1 mode rows outnumber the first stage's warps
SHAPES = [(4, 12, 76, 76, 32, 32), (3, 5, 40, 36, 7, 9), (4, 12, 100, 100, 32, 32),
          (400, 4, 76, 76, 12, 12), (1, 1, 9, 11, 2, 3), (1, 2, 130, 132, 65, 20)]
# 1-D (B, C, N, modes, dc_half): the fpe1d heads, the FNO-branch model's inner FNO1d,
# the GPE width, and a ragged shape without the DC halving
SHAPES_1D = [(16, 30, 100, 15, True), (1600, 4, 100, 12, True), (8, 25, 160, 32, True),
             (3, 5, 37, 7, False)]
TOL_1D = 2e-4  # the 1-D Pallas kernels' tolerance, tests/test_spectral_pallas.py


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(shape, device):
    b, c, h, w, m1, m2 = shape
    rng = np.random.default_rng(0)
    t = lambda *s: torch.tensor(rng.standard_normal(s).astype(np.float32), device=device)
    return t(b, c, h, w), t(c, c, 2 * m1, m2), t(c, c, 2 * m1, m2), t(c, c), t(c)


@pytest.mark.parametrize("apply_act", [True, False])
@pytest.mark.parametrize("shape", SHAPES)
def test_fno2d_layer_kernel_matches_plain(cuda_device, shape, apply_act):
    x, wr, wi, pk, pb = _inputs(shape, cuda_device)
    before = fno2d_layer_cuda.launches
    with torch.inference_mode():
        got = fno2d_layer_cuda(x, wr, wi, pk, pb, apply_act)
        want = fno2d_layer_plain(x, wr, wi, pk, pb, apply_act)
    torch.cuda.synchronize()
    assert fno2d_layer_cuda.launches == before + 1
    torch.testing.assert_close(got, want, rtol=3e-4, atol=3e-4)


@pytest.mark.parametrize("shape", SHAPES)
def test_spectral_conv2d_kernel_matches_plain(cuda_device, shape):
    x, wr, wi, _, _ = _inputs(shape, cuda_device)
    before = spectral_conv2d_cuda.launches
    with torch.inference_mode():
        got = spectral_conv2d_cuda(x, wr, wi)
        want = spectral_conv2d(x, wr, wi)
    torch.cuda.synchronize()
    assert spectral_conv2d_cuda.launches == before + 1
    torch.testing.assert_close(got, want, rtol=3e-4, atol=3e-4)


def test_kernel_takes_a_transposed_pointwise_kernel(cuda_device):
    x, wr, wi, pk, pb = _inputs(SHAPES[1], cuda_device)
    pk_t = pk.t().contiguous().t()  # same values, column-major strides
    with torch.inference_mode():
        torch.testing.assert_close(fno2d_layer_cuda(x, wr, wi, pk_t, pb),
                                   fno2d_layer_cuda(x, wr, wi, pk, pb), rtol=0, atol=0)


def test_kernel_wrapper_refuses_what_the_kernel_does_not_take(cuda_device):
    x, wr, wi, pk, pb = _inputs(SHAPES[1], cuda_device)
    with torch.inference_mode():
        with pytest.raises(ValueError, match="contiguous"):
            fno2d_layer_cuda(x.transpose(2, 3), wr, wi, pk, pb)
        with pytest.raises(ValueError, match="float32"):
            fno2d_layer_cuda(x.double(), wr, wi, pk, pb)
        with pytest.raises(ValueError):
            spectral_conv2d_cuda(x, wr[:, :, :-1], wi[:, :, :-1])


def test_kernel_refuses_a_grid_beyond_its_shared_memory(cuda_device):
    """A 200x200 grid at 64x64 modes (the PR 5 kernel took it) needs more shared memory
    in the first stage than a block has: the wrapper raises and counts no launch."""
    x, wr, wi, pk, pb = _inputs((1, 1, 200, 200, 64, 64), cuda_device)
    before = fno2d_layer_cuda.launches, spectral_conv2d_cuda.launches
    with torch.inference_mode():
        with pytest.raises(RuntimeError, match="shared memory"):
            fno2d_layer_cuda(x, wr, wi, pk, pb)
        with pytest.raises(RuntimeError, match="shared memory"):
            spectral_conv2d_cuda(x, wr, wi)
    assert (fno2d_layer_cuda.launches, spectral_conv2d_cuda.launches) == before


def _inputs_1d(shape, device):
    b, c, n, modes, _ = shape
    rng = np.random.default_rng(1)
    t = lambda *s: torch.tensor(rng.standard_normal(s).astype(np.float32), device=device)
    return t(b, c, n), t(c, c, modes), t(c, c, modes), t(c, c), t(c)


@pytest.mark.parametrize("apply_act", [True, False])
@pytest.mark.parametrize("shape", SHAPES_1D)
def test_fno1d_layer_kernel_matches_plain(cuda_device, shape, apply_act):
    x, wr, wi, pk, pb = _inputs_1d(shape, cuda_device)
    dc_half = shape[-1]
    before = fno1d_layer_cuda.launches
    with torch.inference_mode():
        got = fno1d_layer_cuda(x, wr, wi, pk, pb, dc_half, apply_act)
        want = fno1d_layer_plain(x, wr, wi, pk, pb, dc_half, apply_act)
    torch.cuda.synchronize()
    assert fno1d_layer_cuda.launches == before + 1
    torch.testing.assert_close(got, want, rtol=TOL_1D, atol=TOL_1D)


@pytest.mark.parametrize("dc_half", [True, False])
@pytest.mark.parametrize("shape", SHAPES_1D)
def test_spectral_conv1d_kernel_matches_plain(cuda_device, shape, dc_half):
    x, wr, wi, _, _ = _inputs_1d(shape, cuda_device)
    before = spectral_conv1d_cuda.launches
    with torch.inference_mode():
        got = spectral_conv1d_cuda(x, wr, wi, dc_half)
        want = spectral_conv1d(x, wr, wi, dc_half)
    torch.cuda.synchronize()
    assert spectral_conv1d_cuda.launches == before + 1
    torch.testing.assert_close(got, want, rtol=TOL_1D, atol=TOL_1D)


def test_1d_kernel_takes_a_transposed_pointwise_kernel(cuda_device):
    x, wr, wi, pk, pb = _inputs_1d(SHAPES_1D[0], cuda_device)
    pk_t = pk.t().contiguous().t()  # same values, column-major strides
    with torch.inference_mode():
        torch.testing.assert_close(fno1d_layer_cuda(x, wr, wi, pk_t, pb),
                                   fno1d_layer_cuda(x, wr, wi, pk, pb), rtol=0, atol=0)


def test_1d_kernel_wrapper_refuses_what_the_kernel_does_not_take(cuda_device):
    x, wr, wi, pk, pb = _inputs_1d(SHAPES_1D[3], cuda_device)
    with torch.inference_mode():
        with pytest.raises(ValueError, match="contiguous"):
            fno1d_layer_cuda(x.transpose(0, 1), wr, wi, pk, pb)
        with pytest.raises(ValueError, match="float32"):
            fno1d_layer_cuda(x, wr.double(), wi, pk, pb)
        with pytest.raises(ValueError, match="modes"):
            spectral_conv1d_cuda(x[..., :10].contiguous(), wr, wi)  # 7 modes > 10//2+1
        with pytest.raises(ValueError):
            fno1d_layer_cuda(x, wr, wi, pk[:, :-1], pb)
