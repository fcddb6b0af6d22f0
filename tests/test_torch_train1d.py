"""The port's 1-D training against the JAX package on the CPU.

The FNO1d layer's gradient (``FNO1dLinear``, the differentiable ``fno1d_layer_cuda``)
is held against ``jax.grad`` through the JAX package's fused Pallas layer in interpret
mode and against torch autograd in float64. Whole float32 steps of the fpe1d suite's
models at small widths (``NIOFP1D``, ``NIOFNO1D``, the bag UNet and the full-set
``unet_nobag`` of depth 6) are held against JAX's step as ``tests/test_torch_train.py``
holds the 2-D NIO's: the subsample indices and mask injected on both sides, flax's
BatchNorm given its two-pass variance, every gradient, updated parameter and running
statistic compared by relative L2.
"""
import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import blindno.models.blindno_unet as jax_unet
import blindno.models.nio1d as jax_nio1d
from blindno.models.blindno_unet import PermInvUNetAttn as JUNet
from blindno.ops.config import set_spectral_impl, spectral_impl
from blindno.ops.fno_layer import fno1d_layer as jax_fno1d_layer
from blindno_torch.convert import from_flax
from blindno_torch.models.blindno_unet import PermInvUNetAttn
from blindno_torch.models.nio1d import NIOFNO1D, NIOFP1D
from blindno_torch.ops.fno_layer import fno1d_layer_backward_plain, fno1d_layer_plain
from blindno_torch.ops.spectral_cuda import FNO1dLinear, fno1d_layer_cuda
from blindno_torch.suites.registry import SUITES
from blindno_torch.train.step import make_optimizer, train_step
from test_torch_train import GRAD_ATOL, GRAD_RTOL, STEP_TOL, _TwoPassBatchNorm
from test_torch_unet import _randomized

N = 80
B, L, L_MIN = 2, 5, 2
ENCODER_GRAD_TOL = 1e-2  # relative L2 in the conv encoders (see _tol)

# ------------------------------------------------------------------ the FNO1d layer's gradient

# (B, C, N, modes): a small shape, and one with modes = N//2 + 1 (the kept Nyquist mode)
LAYER_SHAPES = [(2, 4, 24, 6), (3, 5, 20, 11)]


def _layer_case(shape, seed=4):
    """Layer inputs as ``tests/test_fno_layer_fused.py`` draws them (weights scaled by
    0.1) and an upstream gradient for a loss sum(out * g)."""
    b, c, n, m = shape
    rng = np.random.default_rng(seed)
    r = lambda *s, scale=1.0: (scale * rng.standard_normal(s)).astype(np.float32)
    return (r(b, c, n), r(c, c, m, scale=0.1), r(c, c, m, scale=0.1), r(c, c), r(c)), r(b, c, n)


@pytest.mark.parametrize("dc_half", [True, False])
@pytest.mark.parametrize("apply_act", [True, False])
@pytest.mark.parametrize("shape", LAYER_SHAPES)
def test_fno1d_layer_gradients_match_jax_and_autograd(shape, apply_act, dc_half):
    """``dx, dwr, dwi, dpk, dpb`` of the differentiable ``fno1d_layer_cuda`` (the
    Function, gelu outside when asked) against ``jax.grad`` through the JAX package's
    Pallas layer in interpret mode (its custom VJP), and against torch autograd through
    the plain layer, at rtol 5e-4, atol 5e-5 (``tests/test_fno_layer_fused.py:49``).
    pk goes in as the transposed view ``FNO1d`` passes, and its gradient comes back
    through it."""
    args, g = _layer_case(shape)
    loss = lambda *a: jnp.sum(jax_fno1d_layer(*a, dc_half=dc_half, apply_act=apply_act,
                                              interpret=True) * g)
    want = jax.jit(jax.grad(loss, argnums=(0, 1, 2, 3, 4)))(*map(jnp.asarray, args))

    def grads(layer):
        x, wr, wi, pk, pb = (torch.tensor(a, requires_grad=True) for a in args)
        pk_t = pk.detach().t().contiguous().requires_grad_()  # (Cout, Cin), as PointwiseConv holds it
        torch.sum(layer(x, wr, wi, pk_t.t(), pb, dc_half, apply_act) * torch.tensor(g)).backward()
        return x.grad, wr.grad, wi.grad, pk_t.grad.t(), pb.grad

    before = fno1d_layer_cuda.launches
    got, plain = grads(fno1d_layer_cuda), grads(fno1d_layer_plain)
    assert fno1d_layer_cuda.launches == before  # the plain version ran, on the CPU
    for name, a, p, w in zip(("dx", "dwr", "dwi", "dpk", "dpb"), got, plain, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=name)
        np.testing.assert_allclose(a.numpy(), p.numpy(), rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=name)


@pytest.mark.parametrize("dc_half", [True, False])
def test_fno1d_linear_passes_gradcheck_in_float64(dc_half):
    """``FNO1dLinear`` on float64 CPU tensors (its plain forward) against finite
    differences: the backward is the transpose of the forward, with the forward's halved
    DC column in both the input's and the weights' gradients. pk enters transposed."""
    g = torch.Generator().manual_seed(3)
    t = lambda *s: torch.randn(*s, generator=g, dtype=torch.float64, requires_grad=True)
    x, wr, wi, pk_t, pb = t(2, 3, 14), t(3, 4, 8), t(3, 4, 8), t(4, 3), t(4)
    fn = lambda x, wr, wi, pk_t, pb: FNO1dLinear.apply(x, wr, wi, pk_t.t(), pb, dc_half)
    assert torch.autograd.gradcheck(fn, (x, wr, wi, pk_t, pb))


def test_fno1d_layer_takes_the_function_only_where_autograd_needs_it(monkeypatch):
    args, g = _layer_case(LAYER_SHAPES[0])
    x, wr, wi, pk, pb = map(torch.tensor, args)
    calls = []
    apply = FNO1dLinear.apply
    monkeypatch.setattr(FNO1dLinear, "apply", lambda *a: calls.append(1) or apply(*a))
    with torch.no_grad():
        fno1d_layer_cuda(x, wr, wi, pk, pb.requires_grad_())
    assert not calls
    out = fno1d_layer_cuda(x, wr, wi, pk, pb)
    assert calls and out.requires_grad
    torch.testing.assert_close(out, fno1d_layer_plain(x, wr, wi, pk, pb), rtol=0, atol=0)
    # the Function's backward is the plain backward, dc_half passed on
    du = torch.tensor(g)
    pb.grad = None
    torch.sum(FNO1dLinear.apply(x, wr, wi, pk, pb, False) * du).backward()
    torch.testing.assert_close(pb.grad, fno1d_layer_backward_plain(x, wr, wi, pk, du, False)[4],
                               rtol=0, atol=0)


# ------------------------------------------------------------------ whole steps

SMALL_NIO = dict(width=6, modes=8, n_basis=7, neurons=16, fno_layers=2, l_min=L_MIN)
SMALL_UNET = dict(input_size=(N,), width=6, fno_modes=6, fno_layers=2, head_dims=(1, 1),
                  l_min=L_MIN)
# name -> (JAX model, port factory, the module whose subsample_set is injected): the fpe1d
# suite's four models (blindno/suites/registry.py:84-100) at small widths, the bag UNet
# at depth 3 (the suite's is 5; the full-set UNet keeps its depth of 6)
MODELS = {
    "nio": (lambda: jax_nio1d.NIOFP1D(**SMALL_NIO),
            lambda: NIOFP1D(**SMALL_NIO, device="cpu"), jax_nio1d),
    "fno": (lambda: jax_nio1d.NIOFNO1D(width=6, modes=8, fno_layers=2, l_min=L_MIN),
            lambda: NIOFNO1D(width=6, modes=8, fno_layers=2, l_min=L_MIN, device="cpu"),
            jax_nio1d),
    "unet": (lambda: JUNet(**SMALL_UNET, depth=3, subsample=True),
             lambda: PermInvUNetAttn(**SMALL_UNET, depth=3, subsample=True, device="cpu"),
             jax_unet),
    "unet_nobag": (lambda: JUNet(**SMALL_UNET, depth=6, subsample=False),
                   lambda: PermInvUNetAttn(**SMALL_UNET, depth=6, subsample=False, device="cpu"),
                   jax_unet),
}


def _grid():
    return np.linspace(0.0, 1.0, N, dtype=np.float32).reshape(N, 1)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _seeded_variables(jmodel, x, rng):
    """Variables for ``jmodel`` in flax's tree from a numpy seed, without compiling its
    init (the tree's shapes come from ``jax.eval_shape``): kernels N(0, 1/fan_in),
    biases N(0, 0.1^2), spectral planes U[0, 1)/(Cin Cout) as the layers draw them, the
    DeepONet's b0 N(0, 0.1^2), and every BatchNorm and LayerNorm randomized as the
    serving tests randomize them."""
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), jnp.asarray(x),
                            jnp.asarray(_grid()))

    def draw(path, leaf):
        name, shape = getattr(path[-1], "key", ""), leaf.shape
        if name == "kernel":
            a = rng.standard_normal(shape) / np.sqrt(np.prod(shape[:-1]))
        elif name in ("weights_re", "weights_im"):
            a = rng.random(shape) / (shape[0] * shape[1])
        else:
            a = 0.1 * rng.standard_normal(shape)
        return jnp.asarray(a, leaf.dtype)

    return _randomized(jax.tree_util.tree_map_with_path(draw, shapes), seed=7)


def _jax_step(jmodel, variables, x, y, draw, lr, monkeypatch, module):
    """One step as the JAX training loop takes it (value_and_grad of the MSE with the
    batch statistics mutable, then ``optax.adam(lr)``), the subsample injected and flax's
    BatchNorm given its two-pass variance."""
    monkeypatch.setattr(module, "subsample_set", lambda key, xx, l_min, training: (
        jnp.take(xx, jnp.asarray(draw[0]), axis=1), jnp.asarray(draw[1], xx.dtype)))
    monkeypatch.setattr(flax.linen, "BatchNorm", _TwoPassBatchNorm)
    tx = optax.adam(lr)
    params, stats = variables["params"], variables.get("batch_stats", {})

    def loss_fn(p):
        out, upd = jmodel.apply({"params": p, "batch_stats": stats}, jnp.asarray(x),
                                jnp.asarray(_grid()), training=True,
                                rngs={"sample": jax.random.PRNGKey(0)}, mutable=["batch_stats"])
        return jnp.mean((out - y) ** 2), upd.get("batch_stats", {})

    (loss, new_stats), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    updates, _ = tx.update(grads, tx.init(params), params)
    return float(loss), _np(grads), _np(optax.apply_updates(params, updates)), _np(new_stats)


def _tol(name, key):
    """ENCODER_GRAD_TOL for the gradients and parameters of the conv encoders, STEP_TOL
    for everything else (the heads, the trunk, the loss, the running statistics).

    The NIO's Encoder1D has six leaky-ReLU kinks below its weights, as the 2-D NIO's
    Encoder2D has ten (``tests/test_torch_train.py``). The UNet's conv stack has max
    pools and two-channel LayerNorms, whose float32 gradients are ill-conditioned: on
    this test's draws the depthwise-conv gradients of the two-channel blocks lie
    1.1e-3 (JAX) and 1.5-4.1e-3 (the port) from the port's own float64 step, and
    2.5-3.7e-3 from each other (measured on the CPU); ``chip_smoke.py``
    holds the card's UNet step to the CPU's with the same split (``unet_tol``)."""
    key = key.removeprefix("state ")
    if "running_" in key:
        return STEP_TOL
    if name == "nio":
        return ENCODER_GRAD_TOL if key.startswith("deeponet.branch.") else STEP_TOL
    return ENCODER_GRAD_TOL if "unet" in name and not key.startswith("heads.") else STEP_TOL


@pytest.mark.parametrize("name", MODELS)
def test_small_fpe1d_f32_step_matches_jax(name, monkeypatch):
    """One float32 step at the fpe1d suite's lr (1e-3) from seeded weights, BatchNorm
    statistics and LayerNorms (:func:`_seeded_variables`): the loss, every gradient, every updated parameter and
    every updated running statistic within 2e-3 of each tensor's scale (relative L2),
    the conv encoders' gradients and parameters within 1e-2 (:func:`_tol`). The JAX step runs the fused Pallas layer
    in interpret mode through its custom VJP, the reference of ``FNO1dLinear``.
    Gradients exactly zero in JAX (the frozen fusion; the one-channel ConvNeXt blocks'
    depthwise conv and LayerNorm scale) are exactly zero, or absent, in the port.
    Gradients zero but for rounding (whole tensors below 1e-6 of the largest gradient:
    the conv biases before a BatchNorm) must be so on both sides. After the step, a
    parameter is compared where its gradient is not within rounding of zero (from 1e-6
    of its tensor's largest up): the trunk's biases start at zero and have such entries,
    where a unit's input keeps one sign over the grid, so that its bias only shifts what
    the BatchNorm after it centres, and Adam's first step moves each by about lr with
    the rounding's sign."""
    jcls, factory, module = MODELS[name]
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((B, 1, N)) + 0.5 * rng.standard_normal((B, L, N))).astype(np.float32)
    y = rng.standard_normal((B, N, 2)).astype(np.float32)
    draw = (rng.integers(0, L, L), (np.arange(L) < 3).astype(np.float32))
    jmodel = jcls()
    variables = _np(_seeded_variables(jmodel, x, rng))
    lr = SUITES["fpe1d"].train_cfg.lr
    previous = spectral_impl()
    set_spectral_impl("pallas_fused")
    try:
        jloss, jgrads, jparams, jstats = _jax_step(jmodel, variables, x, y, draw, lr,
                                                   monkeypatch, module)
    finally:
        set_spectral_impl(previous)

    model = factory()
    model.load_state_dict(from_flax(variables["params"], variables.get("batch_stats", {})))
    model.train()
    opt = make_optimizer(model, lr)
    loss = train_step(model, opt, torch.tensor(x), torch.tensor(y), torch.tensor(_grid()),
                      subsample=None if name == "unet_nobag" else draw)
    grads = {k: p.grad for k, p in model.named_parameters() if p.grad is not None}
    want_grads = from_flax(jgrads, None)
    frozen = want_grads.keys() - grads.keys()
    assert frozen == ({"fusion.weight", "fusion.bias"} if "unet" not in name else set())
    zero = {k for k, g in want_grads.items() if not g.any()} - frozen
    assert all(not grads[k].any() for k in zero), zero
    if "unet" in name:  # the one-channel blocks at the top of the down and up paths
        assert zero == {f"blocks.{i}.{p}" for i in (0, 2 * model.depth)
                        for p in ("dwconv.weight", "dwconv.bias", "norm.weight")}
    # gradients zero but for rounding: whole tensors below 1e-6 of the largest gradient
    # (the conv biases before a BatchNorm) must be so on both sides
    top = max(float(g.abs().max()) for g in want_grads.values())
    rounding = {k for k in grads if k not in zero and want_grads[k].abs().max() < 1e-6 * top}
    assert all(g.abs().max() < 1e-6 * top for k in rounding for g in (grads[k], want_grads[k]))
    if name == "nio":  # a BatchNorm follows each encoder conv
        assert {k for k in grads if k.endswith("conv.bias")} <= rounding
    want_state = {k: v for k, v in from_flax(jparams, jstats).items()
                  if not k.endswith("num_batches_tracked")}
    state = {k: v for k, v in model.state_dict().items() if k in want_state}
    assert state.keys() == want_state.keys()
    rel = lambda a, b: float((a - b).norm() / b.norm())
    errs = {"loss": abs(float(loss) - jloss) / abs(jloss)}
    for k in grads.keys() - zero:
        # after the step, entries whose gradient is within rounding of zero (below 1e-6
        # of the tensor's largest) leave the comparison: Adam's first step moves each by
        # about lr with the rounding's sign
        kept = want_grads[k].abs() >= 1e-6 * want_grads[k].abs().max()
        if k in rounding:
            kept = torch.ones_like(kept)
        else:
            errs[k] = rel(grads[k], want_grads[k])
        errs[f"state {k}"] = rel(state[k][kept], want_state[k][kept])
    errs.update({f"state {k}": rel(state[k], want_state[k]) for k in want_state
                 if k not in grads and want_state[k].any()})
    assert any("running_var" in k for k in errs) == (name != "fno")
    bad = {k: e for k, e in errs.items() if not e <= _tol(name, k)}
    assert not bad, bad
