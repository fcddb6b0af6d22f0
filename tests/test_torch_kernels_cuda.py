"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test asks the ``cuda_device`` fixture, which skips it where no
CUDA device is present (the decision is taken when the test runs, never at import).
"""
import copy

import numpy as np
import pytest
import torch

from blindno_torch.ops.fno_layer import fno1d_layer_plain, fno2d_layer_plain
from blindno_torch.ops.spectral import spectral_conv1d, spectral_conv2d
from blindno_torch.ops.spectral_cuda import (FNO1dLinear, fno1d_layer_cuda, fno2d_layer_cuda,
                                             spectral_conv1d_cuda, spectral_conv2d_cuda)

pytestmark = pytest.mark.cuda

# (B, C, H, W, m1, m2[, Cout], Cout = C unless given): the main serving shape, a ragged
# one, the ncfpe2d heads (an 80x80 grid padded by a quarter), the NIOFNO2D inner branch
# over 4 x 100 snapshots, one smaller than every tile of the kernel, one whose +-H matrix
# must take the x plane's place in shared memory and whose 2*m1 mode rows outnumber the
# first stage's warps, the fpe2d suite's training batch of 16, and two column-parallel
# (tensor-parallel) slices with half and a third of the output channels: the heads' at
# tp=2 and a batch of 4, and the inner branch's at tp=2
SHAPES = [(4, 12, 76, 76, 32, 32), (3, 5, 40, 36, 7, 9), (4, 12, 100, 100, 32, 32),
          (400, 4, 76, 76, 12, 12), (1, 1, 9, 11, 2, 3), (1, 2, 130, 132, 65, 20),
          (16, 12, 76, 76, 32, 32), (4, 12, 76, 76, 32, 32, 6), (2, 4, 76, 76, 12, 12, 2)]
TP_SHAPES = [s for s in SHAPES if len(s) > 6]
# shapes past one block's shared memory or the grid's y and z limits, each in a stage's
# tiled layout: a 200x200 grid at 64x64 modes; the largest grid with every mode kept
# that the two-stage kernel before this design took; a thin grid; 192 input channels at
# B=2 and B=4 (S2's channels split among a cluster's blocks, S3 grouped); the fpe2d
# heads padded by 2x61 to 183; a tall grid (S2 in H chunks); 2*m1 = 300 mode rows (S1
# in two mode tiles); 600 of 601 W-modes (S3 in two passes over Z's columns); 4100 input
# channels (S2 in channel chunks, S3's x chunks); 140000 batch elements (the grids
# folded over y and z); S1's chunks
# split among a cluster's blocks in runs that cross H chunks (3 H chunks of 5 W chunks,
# over 2 or 4 blocks); S3 grouped at an odd W, with 6 output channels in blocks of 4 and
# 2; and S2's input channels split among a cluster's blocks at 192 channels and B = 1
TILED_SHAPES = [(1, 1, 200, 200, 64, 64), (1, 2, 232, 232, 116, 117), (2, 3, 16, 3600, 8, 40),
                (2, 192, 76, 76, 32, 32), (4, 192, 76, 76, 32, 32), (4, 12, 183, 183, 32, 32),
                (1, 2, 1200, 12, 4, 5), (1, 2, 600, 8, 150, 3), (1, 1, 4, 1200, 1, 600),
                (1, 4100, 4, 4, 1, 1, 2), (140000, 1, 2, 1, 1, 1), (2, 6, 150, 300, 32, 40),
                (2, 5, 45, 45, 8, 8, 6), (1, 192, 76, 76, 32, 32, 12)]
# 1-D (B, C, N, modes, dc_half[, Cout], Cout = C unless given): the fpe1d heads, the
# FNO-branch model's inner FNO1d, the GPE width, a ragged shape without the DC halving,
# the gpe1d heads, an even N that keeps its Nyquist mode, one batch row with more output
# than input channels, a long row that the kernel takes in tiles along N, modes so
# many that it reads its twiddles from the table alone, and the ODE-observation NIO's
# head (an odd N, without the vectorized loads, at a width of 30)
SHAPES_1D = [(16, 30, 100, 15, True), (1600, 4, 100, 12, True), (8, 25, 160, 32, True),
             (3, 5, 37, 7, False), (16, 20, 160, 40, True), (4, 6, 64, 33, True),
             (1, 6, 50, 9, True, 11), (2, 8, 4096, 64, False), (2, 1, 2000, 1001, False),
             (16, 30, 125, 15, True)]
TOL_1D = 2e-4  # the 1-D Pallas kernels' tolerance, tests/test_spectral_pallas.py
# 1-D training shapes at the suites' batch of 32: the fpe1d heads, the FNO-branch model's
# inner FNO1d over 32 x 100 snapshots, and the gpe1d heads
TRAIN_SHAPES_1D = [(32, 30, 100, 15, True), (3200, 4, 100, 12, True), (32, 20, 160, 40, True)]
GRAD_RTOL, GRAD_ATOL = 5e-4, 5e-5  # tests/test_fno_layer_fused.py:49,64


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(shape, device):
    b, c, h, w, m1, m2 = shape[:6]
    cout = shape[6] if len(shape) > 6 else c
    rng = np.random.default_rng(0)
    t = lambda *s: torch.tensor(rng.standard_normal(s).astype(np.float32), device=device)
    return t(b, c, h, w), t(c, cout, 2 * m1, m2), t(c, cout, 2 * m1, m2), t(c, cout), t(cout)


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


@pytest.mark.parametrize("shape", TILED_SHAPES)
def test_fno2d_kernel_takes_shapes_beyond_one_block(cuda_device, shape):
    """Shapes whose stages take their tiled layouts (the note of csrc/fno2d_layer.cu):
    fno2d_layer_cuda with and without gelu and spectral_conv2d_cuda against their plain
    versions, one launch each."""
    x, wr, wi, pk, pb = _inputs(shape, cuda_device)
    for wrapper, call, plain in (
            (fno2d_layer_cuda, lambda: fno2d_layer_cuda(x, wr, wi, pk, pb, True),
             lambda: fno2d_layer_plain(x, wr, wi, pk, pb, True)),
            (fno2d_layer_cuda, lambda: fno2d_layer_cuda(x, wr, wi, pk, pb, False),
             lambda: fno2d_layer_plain(x, wr, wi, pk, pb, False)),
            (spectral_conv2d_cuda, lambda: spectral_conv2d_cuda(x, wr, wi),
             lambda: spectral_conv2d(x, wr, wi))):
        before = wrapper.launches
        with torch.inference_mode():
            got = call()
            want = plain()
        torch.cuda.synchronize()
        assert wrapper.launches == before + 1
        torch.testing.assert_close(got, want, rtol=3e-4, atol=3e-4)


def test_kernel_refuses_tensors_beyond_32_bit_indexing(cuda_device):
    """An output of more than 2^31 - 1 elements (2^21 output channels of a 32x32 grid) is
    the one shape the 2-D kernel refuses: the wrapper raises before any launch."""
    x, wr, wi, pk, pb = _inputs((1, 1, 32, 32, 1, 1, 2 ** 21), cuda_device)
    before = fno2d_layer_cuda.launches, spectral_conv2d_cuda.launches
    with torch.inference_mode():
        with pytest.raises(ValueError, match="32-bit"):
            fno2d_layer_cuda(x, wr, wi, pk, pb)
        with pytest.raises(ValueError, match="32-bit"):
            spectral_conv2d_cuda(x, wr, wi)
    assert (fno2d_layer_cuda.launches, spectral_conv2d_cuda.launches) == before


def _inputs_1d(shape, device):
    b, c, n, modes = shape[:4]
    cout = shape[5] if len(shape) > 5 else c
    rng = np.random.default_rng(1)
    t = lambda *s: torch.tensor(rng.standard_normal(s).astype(np.float32), device=device)
    return t(b, c, n), t(c, cout, modes), t(c, cout, modes), t(c, cout), t(cout)


def _replayed(fn):
    """``fn()``'s output after capturing the call in a CUDA graph and replaying it."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    graph.replay()
    torch.cuda.synchronize()
    return out


@pytest.mark.parametrize("apply_act", [True, False])
@pytest.mark.parametrize("shape", SHAPES_1D)
def test_fno1d_layer_kernel_matches_plain(cuda_device, shape, apply_act):
    x, wr, wi, pk, pb = _inputs_1d(shape, cuda_device)
    dc_half = shape[4]
    before = fno1d_layer_cuda.launches
    with torch.inference_mode():
        got = fno1d_layer_cuda(x, wr, wi, pk, pb, dc_half, apply_act)
        want = fno1d_layer_plain(x, wr, wi, pk, pb, dc_half, apply_act)
    torch.cuda.synchronize()
    assert fno1d_layer_cuda.launches == before + 1
    torch.testing.assert_close(got, want, rtol=TOL_1D, atol=TOL_1D)
    with torch.inference_mode():
        replayed = _replayed(lambda: fno1d_layer_cuda(x, wr, wi, pk, pb, dc_half, apply_act))
    torch.testing.assert_close(replayed, want, rtol=TOL_1D, atol=TOL_1D)


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
    with torch.inference_mode():
        replayed = _replayed(lambda: spectral_conv1d_cuda(x, wr, wi, dc_half))
    torch.testing.assert_close(replayed, want, rtol=TOL_1D, atol=TOL_1D)


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


def test_1d_layer_chain_matches_plain_eagerly_and_from_a_graph(cuda_device):
    """Three consecutive layer calls as a head runs them. Each call may start while the
    one before it still runs (programmatic dependent launch), and the intermediates are
    freed between calls, so the allocator hands the third call's output the buffer that
    the second call reads: a call that read its input or wrote its output before waiting
    for the call before it would show here. Eagerly, and replayed from one CUDA graph on
    a new input, against the plain chain."""
    b, c, n, modes, dc_half = SHAPES_1D[0]
    rng = np.random.default_rng(3)
    t = lambda *s, scale=1.0: torch.tensor((scale * rng.standard_normal(s)).astype(np.float32),
                                           device=cuda_device)
    layers = [(t(c, c, modes, scale=c ** -0.5), t(c, c, modes, scale=c ** -0.5),
               t(c, c, scale=c ** -0.5), t(c)) for _ in range(3)]

    def chain(layer, h):
        for i, (wr, wi, pk, pb) in enumerate(layers):
            h = layer(h, wr, wi, pk, pb, dc_half, i < 2)
        return h

    x, x_new = t(b, c, n), t(b, c, n)
    before = fno1d_layer_cuda.launches
    with torch.inference_mode():
        torch.testing.assert_close(chain(fno1d_layer_cuda, x), chain(fno1d_layer_plain, x),
                                   rtol=TOL_1D, atol=TOL_1D)
        static_x = x.clone()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            chain(fno1d_layer_cuda, static_x)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = chain(fno1d_layer_cuda, static_x)
        static_x.copy_(x_new)
        graph.replay()
        torch.cuda.synchronize()
        torch.testing.assert_close(out, chain(fno1d_layer_plain, x_new), rtol=TOL_1D,
                                   atol=TOL_1D)
    assert fno1d_layer_cuda.launches == before + 9  # eager, warm-up and capture


def test_1d_layer_reads_weights_written_just_before_each_call(cuda_device):
    """Weights, pk and pb written by a device kernel right before each layer call, as a
    caller that scales, copies or updates them in place does. Each call may start while
    the kernel before it still runs (programmatic dependent launch): a call that read
    its weights before waiting for that kernel would mix in the weights of the call
    before. In a loop with new weights for every call, made by a kernel into new tensors
    eagerly and copied into the same buffers in a CUDA graph, against the plain
    version."""
    b, c, n, modes, dc_half = SHAPES_1D[0]
    rng = np.random.default_rng(4)
    t = lambda *s: torch.tensor(rng.standard_normal(s).astype(np.float32), device=cuda_device)
    x = t(b, c, n)
    sets = [(t(c, c, modes), t(c, c, modes), t(c, c), t(c)) for _ in range(4)]
    with torch.inference_mode():
        wants = [fno1d_layer_plain(x, *w, dc_half) for w in sets]
        for i in range(12):
            wr, wi, pk, pb = (torch.mul(w, 1.0) for w in sets[i % 4])
            got = fno1d_layer_cuda(x, wr, wi, pk, pb, dc_half)
            torch.testing.assert_close(got, wants[i % 4], rtol=TOL_1D, atol=TOL_1D)
        bufs = [torch.empty_like(w) for w in sets[0]]

        def loop():
            outs = []
            for i in range(8):
                for buf, w in zip(bufs, sets[i % 4]):
                    buf.copy_(w)
                outs.append(fno1d_layer_cuda(x, *bufs, dc_half))
            return outs

        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            loop()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            outs = loop()
        for _ in range(3):
            graph.replay()
        torch.cuda.synchronize()
    for i, got in enumerate(outs):
        torch.testing.assert_close(got, wants[i % 4], rtol=TOL_1D, atol=TOL_1D)


def _train_loop(layer, params, x, target, steps, graph=False):
    """``steps`` steps of forward, backward and ``Adam.step()`` through a chain of three
    FNO layers (gelu between them) whose weights, pk and pb a device kernel writes
    (``torch.mul``) right before each layer call, pk as the transposed view ``FNO1d``
    and ``FNO2d`` pass. With ``graph``, three eager warm-up steps on a side stream, then the rest
    replayed from one captured CUDA graph. Returns the losses of the eager steps and
    the parameters after the last step."""
    params = [[p.clone().requires_grad_() for p in layer_params] for layer_params in params]
    opt = torch.optim.Adam([p for lp in params for p in lp], lr=5e-4, capturable=graph)

    def step():
        opt.zero_grad(set_to_none=True)
        h = x
        for i, (wr, wi, pk_t, pb) in enumerate(params):
            wr_, wi_, pk_, pb_ = (torch.mul(p, 1.0) for p in (wr, wi, pk_t, pb))
            h = layer(h, wr_, wi_, pk_.t(), pb_, i < 2)
        loss = torch.mean((h - target) ** 2)
        loss.backward()
        opt.step()
        return loss

    if not graph:
        return [float(step()) for _ in range(steps)], params
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        losses = [float(step()) for _ in range(3)]
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    opt.zero_grad(set_to_none=True)
    with torch.cuda.graph(g):
        step()
    for _ in range(steps - 3):
        g.replay()
    torch.cuda.synchronize()
    return losses, params


def test_2d_layer_trains_with_weights_written_just_before_each_call(cuda_device):
    """The 2-D counterpart of the test above, in training: Adam's kernels and then a
    ``torch.mul`` write every weight right before each forward layer call, and the
    kernel's later stages may start while the stage before still runs (programmatic
    dependent launch) but its first stage is a plain launch, which waits for them. Eight
    steps of the kernel, eagerly and replayed from a CUDA graph, against eight steps of
    the plain layer (torch autograd) from the same start: losses and parameters."""
    b, c, h, w, m1, m2 = SHAPES[0]
    rng = np.random.default_rng(5)
    t = lambda *s, scale=1.0: torch.tensor((scale * rng.standard_normal(s)).astype(np.float32),
                                           device=cuda_device)
    params = [(t(c, c, 2 * m1, m2, scale=0.1), t(c, c, 2 * m1, m2, scale=0.1),
               t(c, c, scale=c ** -0.5), t(c)) for _ in range(3)]
    x, target = t(b, c, h, w), t(b, c, h, w)
    want_losses, want = _train_loop(fno2d_layer_plain, params, x, target, 8)
    before = fno2d_layer_cuda.launches
    losses, got = _train_loop(fno2d_layer_cuda, params, x, target, 8)
    assert fno2d_layer_cuda.launches == before + 8 * 3
    np.testing.assert_allclose(losses, want_losses, rtol=3e-4)
    _, got_graph = _train_loop(fno2d_layer_cuda, params, x, target, 8, graph=True)
    # relative L2 per tensor: Adam's step is about lr * sign(g), so a gradient within
    # rounding of zero may move its element the other way; weights read before the
    # kernel that wrote them would move whole tensors
    rel = lambda a, b: float((a - b).norm() / b.norm())
    for a, g_, p in zip((p for lp in got for p in lp), (p for lp in got_graph for p in lp),
                        (p for lp in want for p in lp)):
        assert rel(a, p) <= 3e-4 and rel(g_, p) <= 3e-4, (rel(a, p), rel(g_, p))


@pytest.mark.parametrize("shape", [SHAPES[0], *TP_SHAPES])
def test_2d_layer_backward_on_the_card_matches_its_cpu_run(cuda_device, shape):
    """The differentiable layer's ``dx, dwr, dwi, dpk, dpb`` on the card (the kernel
    forward, the transpose chain in cuBLAS backward) against the same call on the CPU,
    at the main shape and the column-parallel slices (Cout < Cin), gelu outside and not,
    at the gradient tolerance of tests/test_fno_layer_fused.py:64. Weights scaled by 0.1
    as that test draws them, and the loss ``sum(out * g)`` with g standard normal, so
    that each gradient is O(1)."""
    b, c, h, w, m1, m2 = shape[:6]
    cout = shape[6] if len(shape) > 6 else c
    rng = np.random.default_rng(6)
    r = lambda *s, scale=1.0: (scale * rng.standard_normal(s)).astype(np.float32)
    args = (r(b, c, h, w), r(c, cout, 2 * m1, m2, scale=0.1),
            r(c, cout, 2 * m1, m2, scale=0.1), r(c, cout, scale=c ** -0.5), r(cout))
    g = r(b, cout, h, w)
    for apply_act in (True, False):
        def grads(device):
            ts = [torch.tensor(a, device=device, requires_grad=True) for a in args]
            torch.sum(fno2d_layer_cuda(*ts, apply_act) * torch.tensor(g, device=device)).backward()
            return [t.grad.cpu() for t in ts]

        before = fno2d_layer_cuda.launches
        got = grads(cuda_device)
        assert fno2d_layer_cuda.launches == before + 1
        for name, a, want in zip(("dx", "dwr", "dwi", "dpk", "dpb"), got, grads("cpu")):
            torch.testing.assert_close(a, want, rtol=5e-4, atol=5e-5, msg=name)


@pytest.mark.parametrize("shape", TRAIN_SHAPES_1D)
def test_fno1d_linear_on_the_card_matches_plain(cuda_device, shape):
    """``FNO1dLinear`` at the 1-D training shapes: its forward (the kernel with the
    epilogue off) against the plain layer without gelu at the kernel's tolerance, and its
    ``dx, dwr, dwi, dpk, dpb`` (through the transposed pk view ``FNO1d`` passes, gelu
    after it) against the same call on the CPU at the CPU test's gradient tolerance.
    Weights scaled by 0.1, and the loss ``sum(out * g)``."""
    b, c, n, modes, dc_half = shape
    rng = np.random.default_rng(7)
    r = lambda *s, scale=1.0: (scale * rng.standard_normal(s)).astype(np.float32)
    args = (r(b, c, n), r(c, c, modes, scale=0.1), r(c, c, modes, scale=0.1),
            r(c, c, scale=c ** -0.5), r(c))
    g = r(b, c, n)
    x, wr, wi, pk_t, pb = (torch.tensor(a, device=cuda_device) for a in args)
    before = fno1d_layer_cuda.launches
    with torch.no_grad():
        got = FNO1dLinear.apply(x, wr, wi, pk_t.t(), pb, dc_half)
        want = fno1d_layer_plain(x, wr, wi, pk_t.t(), pb, dc_half, False)
    assert fno1d_layer_cuda.launches == before + 1
    torch.testing.assert_close(got, want, rtol=TOL_1D, atol=TOL_1D)

    def grads(device):
        ts = [torch.tensor(a, device=device, requires_grad=True) for a in args]
        xx, wr_, wi_, pk_, pb_ = ts
        out = fno1d_layer_cuda(xx, wr_, wi_, pk_.t(), pb_, dc_half, True)
        torch.sum(out * torch.tensor(g, device=device)).backward()
        return [t.grad.cpu() for t in ts]

    before = fno1d_layer_cuda.launches
    got = grads(cuda_device)
    assert fno1d_layer_cuda.launches == before + 1
    for name, a, w in zip(("dx", "dwr", "dwi", "dpk", "dpb"), got, grads("cpu")):
        torch.testing.assert_close(a, w, rtol=GRAD_RTOL, atol=GRAD_ATOL, msg=name)


def test_1d_layer_trains_with_weights_written_just_before_each_call(cuda_device):
    """The 1-D layer in training (``FNO1dLinear``): Adam's kernels and then a
    ``torch.mul`` write every weight right before each forward layer call, and each call
    may start while the kernel before it still runs (programmatic dependent launch), so
    a call that read its weights before waiting would train on stale ones. Eight steps
    of three layers at the fpe1d heads' training shape, eagerly and replayed from a CUDA
    graph, against eight steps of the plain layer from the same start."""
    b, c, n, modes, dc_half = TRAIN_SHAPES_1D[0]
    rng = np.random.default_rng(5)
    t = lambda *s, scale=1.0: torch.tensor((scale * rng.standard_normal(s)).astype(np.float32),
                                           device=cuda_device)
    params = [(t(c, c, modes, scale=0.1), t(c, c, modes, scale=0.1), t(c, c, scale=c ** -0.5),
               t(c)) for _ in range(3)]
    x, target = t(b, c, n), t(b, c, n)
    layer = lambda fn: lambda h, wr, wi, pk, pb, act: fn(h, wr, wi, pk, pb, dc_half, act)
    want_losses, want = _train_loop(layer(fno1d_layer_plain), params, x, target, 8)
    before = fno1d_layer_cuda.launches
    losses, got = _train_loop(layer(fno1d_layer_cuda), params, x, target, 8)
    assert fno1d_layer_cuda.launches == before + 8 * 3
    np.testing.assert_allclose(losses, want_losses, rtol=3e-4)
    _, got_graph = _train_loop(layer(fno1d_layer_cuda), params, x, target, 8, graph=True)
    rel = lambda a, b: float((a - b).norm() / b.norm())
    for a, g_, p in zip((p for lp in got for p in lp), (p for lp in got_graph for p in lp),
                        (p for lp in want for p in lp)):
        assert rel(a, p) <= 3e-4 and rel(g_, p) <= 3e-4, (rel(a, p), rel(g_, p))


# ------------------------------------------------------------------ low-precision operands

LOW = {"bfloat16": (torch.bfloat16, 2.0 ** -8), "float16": (torch.float16, 2.0 ** -11)}


@pytest.mark.parametrize("dtype", LOW)
@pytest.mark.parametrize("dim", [1, 2])
def test_wrappers_take_low_precision_operands(cuda_device, dim, dtype):
    """The four wrappers given bfloat16 or float16 operands (the training step's
    low-precision modes) at the main training shapes (the fpe2d heads', the fpe1d
    heads'): each launches its float32 kernel once on the operands raised to float32 and
    returns the result in their dtype, within the kernel's tolerance plus one rounding of
    the dtype (its unit roundoff, of the output's scale) of the plain version on the same
    raised operands; the differentiable layer's gradients come back each in its input's
    dtype, with the one launch of its forward."""
    low, eps = LOW[dtype]
    if dim == 1:
        args, layer, plain, spec, spec_plain, tol = (
            _inputs_1d(TRAIN_SHAPES_1D[0], cuda_device), fno1d_layer_cuda, fno1d_layer_plain,
            spectral_conv1d_cuda, spectral_conv1d, TOL_1D)
    else:
        args, layer, plain, spec, spec_plain, tol = (
            _inputs(SHAPES[0], cuda_device), fno2d_layer_cuda, fno2d_layer_plain,
            spectral_conv2d_cuda, spectral_conv2d, 3e-4)
    args = [a.to(low) for a in args]
    raised = [a.float() for a in args]

    def close(got, want):
        assert got.dtype == low
        scale = float(want.abs().max())
        torch.testing.assert_close(got.float(), want, rtol=tol + eps, atol=(tol + eps) * scale)

    for wrapper, ref, n_args in ((layer, plain, 5), (spec, spec_plain, 3)):
        before = wrapper.launches
        with torch.inference_mode():
            got = wrapper(*args[:n_args])
            want = ref(*raised[:n_args])
        torch.cuda.synchronize()
        assert wrapper.launches == before + 1
        close(got, want)
    leaves = [a.clone().requires_grad_() for a in args]
    before = layer.launches
    out = layer(*leaves)
    out.float().square().mean().backward()  # a mean: a sum's gradients overflow float16
    assert layer.launches == before + 1 and out.dtype == low
    assert all(t.grad.dtype == low and torch.isfinite(t.grad.float()).all() for t in leaves)


def test_padding_beyond_one_block_runs_on_the_card(cuda_device):
    """An FNO2d whose ``padding_frac`` takes the padded grid past what one block holds
    (61 points padded by 2 x 61 to 183 at 32 x 32 modes: S1 takes its tiled layout) runs
    on the card through the kernel, 3 launches, within 2e-3 of the output's scale (the NIO
    parity bound, tests/test_nio2d_torch_parity.py:190) of its own CPU run."""
    from blindno_torch.nn.fno import FNO2d

    model = FNO2d(32, 12, 3, 12, 1, padding_frac=2.0)
    x = torch.tensor(np.random.default_rng(2).standard_normal((1, 61, 61, 12)),
                     dtype=torch.float32)
    card = copy.deepcopy(model).to(cuda_device)
    assert card.lift(x.to(cuda_device)).shape[2:] == (183, 183)
    before = fno2d_layer_cuda.launches
    with torch.inference_mode():
        got = card(x.to(cuda_device))
        want = model(x)
    torch.cuda.synchronize()
    assert fno2d_layer_cuda.launches == before + 3
    scale = float(want.abs().max())
    torch.testing.assert_close(got.cpu(), want, rtol=2e-3, atol=2e-3 * scale)
