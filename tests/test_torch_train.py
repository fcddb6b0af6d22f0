"""The port's training step against the JAX package on the CPU.

Set subsampling, the flax-faithful train-mode BatchNorm, the FNO2d layer's gradient and
whole ``NIOFP2D`` steps (float32, and bfloat16 under ``encoder_bn32``) are held against
their JAX counterparts. JAX and torch draw from different random streams, so the step
tests hand both the same subsample indices and mask: the JAX model's ``subsample_set``
is replaced through pytest's ``monkeypatch`` for the test, and the port takes them as
``subsample=(indices, mask)``. Weights, gradients, updated parameters and updated batch
statistics move between the two with ``blindno_torch.convert.from_flax``.
"""
import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import blindno.models.nio2d as jax_nio2d
from blindno.models.nio2d import NIOFP2D as JNIOFP2D
from blindno.nn.torch_layers import TorchBatchNorm
from blindno.ops.config import set_spectral_impl, spectral_impl
from blindno.ops.fno_layer import fno2d_layer as jax_fno2d_layer
from blindno.train.loop import amp_cast_fns
from blindno_torch.convert import from_flax
from blindno_torch.models.nio2d import NIOFP2D
from blindno_torch.nn.setops import subsample_set
from blindno_torch.nn.torch_layers import BatchNorm1d, BatchNorm2d
from blindno_torch.ops.fno_layer import fno2d_layer_plain
from blindno_torch.ops.spectral_cuda import FNO2dLinear, fno2d_layer_cuda
from blindno_torch.train.step import AMP_POLICIES, check_compute_dtype, make_optimizer, train_step
from test_nio2d_torch_parity import _randomize_bn

NX = 61
CFG = dict(width=6, modes=8, n_basis=7, neurons=16, fno_layers=2)  # tests/test_torch_nio2d.py:44
B, L, L_MIN = 2, 4, 2
STEP_TOL = 2e-3  # of each tensor's scale: the NIO parity bound, tests/test_nio2d_torch_parity.py:190
ENCODER_GRAD_TOL = 1e-2  # relative L2 (see the float32 step test)
BF16_TOL = 5e-2  # relative L2 (see the bf16 step test)


# ------------------------------------------------------------------ set subsampling


def test_subsample_draws_the_jax_distribution():
    """Shapes, L in [l_min, L_max-1], indices in range, a mask of L ones then zeros."""
    x = torch.arange(3 * 10 * 2, dtype=torch.float32).reshape(3, 10, 2)
    g = torch.Generator().manual_seed(0)
    lengths = set()
    for _ in range(200):
        xs, mask = subsample_set(x, 4, g)
        assert xs.shape == x.shape and mask.shape == (10,) and mask.dtype == torch.float32
        n = int(mask.sum())
        lengths.add(n)
        torch.testing.assert_close(mask, (torch.arange(10) < n).float(), rtol=0, atol=0)
        # each gathered snapshot is one of the set's, in every batch row alike
        idx = (xs[0, :, 0] / 2).long()
        assert ((idx >= 0) & (idx < 10)).all()
        torch.testing.assert_close(xs, x[:, idx], rtol=0, atol=0)
    assert lengths == set(range(4, 10))


def test_subsample_same_generator_state_same_draw():
    x = torch.randn(2, 7, 3, 3)
    a = subsample_set(x, 2, torch.Generator().manual_seed(5))
    b = subsample_set(x, 2, torch.Generator().manual_seed(5))
    c = subsample_set(x, 2, torch.Generator().manual_seed(6))
    for u, v in zip(a, b):
        torch.testing.assert_close(u, v, rtol=0, atol=0)
    assert not all(torch.equal(u, v) for u, v in zip(a, c))


def test_subsample_honours_injected_indices_and_mask():
    x = torch.randn(2, 5, 4)
    idx = np.array([4, 4, 0, 2, 1])
    mask = np.array([1, 1, 1, 0, 0], np.float32)
    xs, m = subsample_set(x, 2, None, idx, mask)
    torch.testing.assert_close(xs, x[:, torch.tensor(idx)], rtol=0, atol=0)
    torch.testing.assert_close(m, torch.tensor(mask), rtol=0, atol=0)
    with pytest.raises(ValueError):
        subsample_set(x, 2, None, idx, None)
    with pytest.raises(ValueError):
        subsample_set(x, 2, None)
    with pytest.raises(ValueError):
        subsample_set(x, 2, None, idx[:3], mask[:3])


def test_subsample_takes_l_min_when_the_set_is_smaller():
    """JAX's randint clamps an empty range to its low end: L = l_min, all ones."""
    _, mask = subsample_set(torch.zeros(1, 3, 2), 50, torch.Generator().manual_seed(0))
    torch.testing.assert_close(mask, torch.ones(3), rtol=0, atol=0)


# ------------------------------------------------------------------ train-mode BatchNorm


def _flax_bn_train(x_nhwc, scale, bias, mean, var):
    bn = TorchBatchNorm(use_running_average=False)
    variables = {"params": {"BatchNorm_0": {"scale": scale, "bias": bias}},
                 "batch_stats": {"BatchNorm_0": {"mean": mean, "var": var}}}
    y, upd = bn.apply(variables, x_nhwc, mutable=["batch_stats"])
    s = upd["batch_stats"]["BatchNorm_0"]
    return np.asarray(y), np.asarray(s["mean"]), np.asarray(s["var"])


def _bn_case(ndim, rng):
    """A batch of n = 8 per channel: (8, 5) in 1-D, (2, 5, 2, 2) in 2-D, with a mean
    and scale per channel; random affine parameters and running statistics."""
    shape = (8, 5) if ndim == 1 else (2, 5, 2, 2)
    x = (rng.normal(0.5, 2.0, shape) * rng.uniform(0.5, 2.0, (1, 5) + (1,) * (len(shape) - 2))
         ).astype(np.float32)
    scale, bias = rng.uniform(0.6, 1.4, 5).astype(np.float32), rng.normal(0, 0.1, 5).astype(np.float32)
    mean, var = rng.normal(0, 0.1, 5).astype(np.float32), rng.uniform(0.7, 1.3, 5).astype(np.float32)
    return x, scale, bias, mean, var


def _port_bn(cls, scale, bias, mean, var):
    bn = cls(5)
    bn.load_state_dict({"weight": torch.tensor(scale), "bias": torch.tensor(bias),
                        "running_mean": torch.tensor(mean), "running_var": torch.tensor(var),
                        "num_batches_tracked": torch.tensor(0)})
    return bn.train()


@pytest.mark.parametrize("ndim", [1, 2])
def test_train_mode_batchnorm_matches_flax(ndim):
    """Output, running_mean and the biased running_var update at n = 8, within 1e-5."""
    x, scale, bias, mean, var = _bn_case(ndim, np.random.default_rng(ndim))
    x_last = x if ndim == 1 else x.transpose(0, 2, 3, 1)
    y_want, mean_want, var_want = _flax_bn_train(jnp.asarray(x_last), scale, bias, mean, var)
    bn = _port_bn(BatchNorm1d if ndim == 1 else BatchNorm2d, scale, bias, mean, var)
    y = bn(torch.tensor(x)).detach().numpy()
    np.testing.assert_allclose(y if ndim == 1 else y.transpose(0, 2, 3, 1), y_want,
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(bn.running_mean.numpy(), mean_want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(bn.running_var.numpy(), var_want, rtol=1e-5, atol=1e-5)
    # eval mode is torch's: the running statistics it now holds, no update
    bn.eval()
    before = bn.running_var.clone()
    torch.testing.assert_close(
        bn(torch.tensor(x)),
        torch.nn.functional.batch_norm(torch.tensor(x), bn.running_mean, before, bn.weight,
                                       bn.bias, False, 0.1, 1e-5), rtol=0, atol=0)
    torch.testing.assert_close(bn.running_var, before, rtol=0, atol=0)


def test_torch_batchnorm_update_misses_flax_by_more_than_the_tolerance():
    """nn.BatchNorm2d's own update takes the unbiased variance, n/(n-1) = 8/7 times the
    biased one at n = 8: the test above would see it."""
    x, scale, bias, mean, var = _bn_case(2, np.random.default_rng(2))
    _, _, var_want = _flax_bn_train(jnp.asarray(x.transpose(0, 2, 3, 1)), scale, bias, mean, var)
    plain = _port_bn(torch.nn.BatchNorm2d, scale, bias, mean, var)
    plain(torch.tensor(x))
    gap = np.abs(plain.running_var.numpy() - var_want).max()
    assert gap > 100 * 1e-5


def test_train_mode_batchnorm_takes_bfloat16_and_keeps_float32_statistics():
    x, scale, bias, mean, var = _bn_case(2, np.random.default_rng(3))
    bn = _port_bn(BatchNorm2d, scale, bias, mean, var)
    ref = _port_bn(BatchNorm2d, scale, bias, mean, var)
    xb = torch.tensor(x).bfloat16()
    y = bn(xb)
    assert y.dtype == torch.bfloat16
    assert all(t.dtype == torch.float32 for t in (bn.weight, bn.running_mean, bn.running_var))
    # the same as normalizing the bfloat16 values in float32 and rounding the result
    y_ref = ref(xb.float())
    torch.testing.assert_close(y.float(), y_ref.bfloat16().float(), rtol=0, atol=0)
    torch.testing.assert_close(bn.running_var, ref.running_var, rtol=1e-6, atol=1e-6)


# ------------------------------------------------------------------ the FNO2d layer's gradient

LAYER_SHAPES = [(2, 4, 24, 20, 6, 5), (3, 5, 40, 36, 7, 9)]
GRAD_RTOL, GRAD_ATOL = 5e-4, 5e-5  # tests/test_fno_layer_fused.py:64


def _layer_case(shape, seed=4):
    """Layer inputs as tests/test_fno_layer_fused.py draws them (weights scaled by 0.1),
    and an upstream gradient for a loss sum(out * g)."""
    b, c, h, w, m1, m2 = shape
    rng = np.random.default_rng(seed)
    r = lambda *s, scale=1.0: (scale * rng.standard_normal(s)).astype(np.float32)
    args = (r(b, c, h, w), r(c, c, 2 * m1, m2, scale=0.1), r(c, c, 2 * m1, m2, scale=0.1),
            r(c, c), r(c))
    return args, r(b, c, h, w)


@pytest.mark.parametrize("apply_act", [True, False])
@pytest.mark.parametrize("shape", LAYER_SHAPES)
def test_fno2d_layer_gradients_match_jax_and_autograd(shape, apply_act):
    """``dx, dwr, dwi, dpk, dpb`` of the differentiable ``fno2d_layer_cuda`` (the
    Function, gelu outside when asked) against ``jax.grad`` through the JAX package's
    Pallas layer in interpret mode, and against torch autograd through the plain layer.
    pk goes in as the transposed view ``FNO2d`` passes."""
    args, g = _layer_case(shape)
    loss = lambda *a: jnp.sum(jax_fno2d_layer(*a, apply_act=apply_act, interpret=True) * g)
    want = jax.jit(jax.grad(loss, argnums=(0, 1, 2, 3, 4)))(*map(jnp.asarray, args))

    def grads(layer):
        x, wr, wi, pk, pb = (torch.tensor(a, requires_grad=True) for a in args)
        pk_t = pk.detach().t().contiguous().requires_grad_()  # (Cout, Cin), as PointwiseConv holds it
        torch.sum(layer(x, wr, wi, pk_t.t(), pb, apply_act) * torch.tensor(g)).backward()
        return x.grad, wr.grad, wi.grad, pk_t.grad.t(), pb.grad

    before = fno2d_layer_cuda.launches
    got, plain = grads(fno2d_layer_cuda), grads(fno2d_layer_plain)
    assert fno2d_layer_cuda.launches == before  # the plain version ran, on the CPU
    for name, a, p, w in zip(("dx", "dwr", "dwi", "dpk", "dpb"), got, plain, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=name)
        np.testing.assert_allclose(a.numpy(), p.numpy(), rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=name)


def test_fno2d_layer_takes_the_function_only_where_autograd_needs_it(monkeypatch):
    args, _ = _layer_case(LAYER_SHAPES[0])
    x, wr, wi, pk, pb = map(torch.tensor, args)
    calls = []
    apply = FNO2dLinear.apply
    monkeypatch.setattr(FNO2dLinear, "apply", lambda *a: calls.append(1) or apply(*a))
    with torch.no_grad():
        fno2d_layer_cuda(x, wr, wi, pk, pb.requires_grad_())
    assert not calls
    out = fno2d_layer_cuda(x, wr, wi, pk, pb)
    assert calls and out.requires_grad
    torch.testing.assert_close(out, fno2d_layer_plain(x, wr, wi, pk, pb), rtol=0, atol=0)


def test_layer_trains_after_serving_under_inference_mode():
    """Serving runs under ``torch.inference_mode``; the DFT matrices it caches must still
    serve autograd afterwards (an inference tensor cannot be saved for backward)."""
    args, g = _layer_case((1, 3, 26, 22, 5, 4))
    x, wr, wi, pk, pb = map(torch.tensor, args)
    with torch.inference_mode():
        fno2d_layer_plain(x, wr, wi, pk, pb)
    xg = x.clone().requires_grad_()
    torch.sum(fno2d_layer_plain(xg, wr, wi, pk, pb) * torch.tensor(g)).backward()
    assert torch.isfinite(xg.grad).all()


# ------------------------------------------------------------------ whole steps


def _grid():
    gx, gy = np.meshgrid(np.linspace(-1, 1, NX), np.linspace(-1, 1, NX), indexing="ij")
    return np.stack([gx, gy], 2).astype(np.float32)  # bench.py:138-139


@pytest.fixture(scope="module")
def small_step():
    """The small NIOFP2D with randomized BatchNorm, a batch, and two steps' draws."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((B, L, NX, NX)).astype(np.float32)
    y = rng.standard_normal((B, NX, NX, 2)).astype(np.float32)
    grid = _grid()
    jmodel = JNIOFP2D(**CFG, l_min=L_MIN)
    variables = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(grid))
    variables = jax.tree.map(np.asarray, _randomize_bn(variables, np.random.default_rng(7)))
    draws = []
    for _ in range(2):
        l_eff = rng.integers(L_MIN, L)
        draws.append((rng.integers(0, L, L), (np.arange(L) < l_eff).astype(np.float32)))
    return jmodel, variables, x, y, grid, draws


class _TwoPassBatchNorm(flax.linen.BatchNorm):
    """flax's BatchNorm with its two-pass variance, mean((x - mean)^2): the default
    ``mean(x^2) - mean^2`` loses digits where a channel's mean is large against its
    spread. Its name keeps flax's parameter paths (``BatchNorm_0``)."""

    use_fast_variance: bool = False


_TwoPassBatchNorm.__name__ = "BatchNorm"


def _jax_stepper(jmodel, x, y, grid, monkeypatch, cdtype=None):
    """``bench.py:172-186`` restated (it lives inside ``main()``): value_and_grad of the
    MSE with ``mutable=["batch_stats"]`` and the cast of ``amp_cast_fns``, then
    ``optax.adam(5e-4)``. The returned step takes ``state = (params, batch_stats,
    opt_state or None)`` and the injected ``draw = (indices, mask)``, and returns the
    loss, the gradients and the state after it. BatchNorm takes flax's two-pass
    variance (:class:`_TwoPassBatchNorm`), the same statistics computed more exactly."""
    tx = optax.adam(5e-4)
    if cdtype is None:
        cast = uncast = lambda t: t
        in_dtype = jnp.float32
    else:
        cast, uncast = amp_cast_fns(cdtype, "encoder_bn32")
        in_dtype = cdtype
    draw = {}
    monkeypatch.setattr(jax_nio2d, "subsample_set", lambda key, xx, l_min, training: (
        jnp.take(xx, draw["idx"], axis=1), draw["mask"].astype(xx.dtype)))
    monkeypatch.setattr(flax.linen, "BatchNorm", _TwoPassBatchNorm)

    @jax.jit
    def step(params, stats, opt_state, idx, mask):
        draw.update(idx=idx, mask=mask)

        def loss_fn(p):
            out, upd = jmodel.apply({"params": cast(p), "batch_stats": cast(stats)},
                                    jnp.asarray(x).astype(in_dtype), jnp.asarray(grid),
                                    training=True, rngs={"sample": jax.random.PRNGKey(0)},
                                    mutable=["batch_stats"])
            return jnp.mean((out.astype(jnp.float32) - y) ** 2), uncast(upd["batch_stats"])

        (loss, new_stats), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        return loss, grads, (optax.apply_updates(params, updates), new_stats, opt_state)

    def run(state, draw_in):
        params, stats, opt_state = state
        opt_state = tx.init(params) if opt_state is None else opt_state
        return jax.tree.map(np.asarray, step(params, stats, opt_state, *map(jnp.asarray, draw_in)))

    return run


def _port_step(state, x, y, grid, draw, compute_dtype=None):
    """The port's ``train_step`` from the same ``state``: params and batch statistics
    through ``from_flax``, and optax's Adam moments and count as torch Adam's state."""
    params, stats, opt_state = state
    model = NIOFP2D(**CFG, l_min=L_MIN, device="cpu")
    model.load_state_dict(from_flax(params, stats))
    model.train()
    opt = make_optimizer(model)
    if opt_state is not None:
        adam = opt_state[0]
        mu, nu = from_flax(adam.mu, None), from_flax(adam.nu, None)
        for k, p in model.named_parameters():
            if p.requires_grad:
                opt.state[p] = {"step": torch.tensor(float(adam.count)),
                                "exp_avg": mu[k].clone(), "exp_avg_sq": nu[k].clone()}
    loss = train_step(model, opt, torch.tensor(x), torch.tensor(y), torch.tensor(grid),
                      subsample=draw, compute_dtype=compute_dtype)
    grads = {k: p.grad for k, p in model.named_parameters() if p.grad is not None}
    state = {k: v for k, v in model.state_dict().items() if not k.endswith("num_batches_tracked")}
    return float(loss), grads, state


def _rel_l2(got, want):
    return float((got - want).norm() / want.norm())


def _step_errors(jax_out, port_out, zero_bound=1e-6):
    """Relative L2 errors ``|got - want| / |want|`` of the loss, each gradient, and each
    parameter and running statistic after the step. The gradients of the conv biases,
    which a BatchNorm follows, are zero but for rounding on both sides: they are held
    below ``zero_bound`` of the largest gradient instead, and left out of the relative
    errors."""
    jloss, jgrads, (jparams, jstats, _) = jax_out
    loss, grads, state = port_out
    want_grads = from_flax(jgrads, None)
    frozen = want_grads.keys() - grads.keys()
    assert frozen == {"fusion.weight", "fusion.bias"}
    assert all(not want_grads.pop(k).any() for k in frozen)  # stop_gradient in JAX
    assert all(g.dtype == torch.float32 and torch.isfinite(g).all() for g in grads.values())
    top = max(float(g.abs().max()) for g in want_grads.values())
    zero = [k for k in grads if k.endswith("conv.bias")]
    assert max(float(g.abs().max()) for k in zero for g in (grads[k], want_grads[k])) < zero_bound * top
    want_state = {k: v for k, v in from_flax(jparams, jstats).items()
                  if not k.endswith("num_batches_tracked")}
    assert all(state[k].dtype == torch.float32 for k in want_state)
    errs = {k: _rel_l2(grads[k], want_grads[k]) for k in grads if k not in zero}
    errs.update({f"state {k}": _rel_l2(state[k], want_state[k]) for k in want_state})
    assert np.isfinite(loss)
    errs["loss"] = abs(loss - float(jloss)) / abs(float(jloss))
    return errs


def _run_steps(small_step, monkeypatch, cdtype=None, compute_dtype=None):
    """Two steps, each from JAX's state before it: the first from the initial weights,
    the second from JAX's params, batch statistics and Adam state after the first, so
    that it checks Adam's bias correction at t=2. (From each side's own first step, the
    second would also measure how far rounding moves the first update: Adam's first
    step is lr * g / (|g| + eps), a sign wherever |g| >> eps, and some gradients are
    within rounding of zero.) Returns, per step, the state it started from, JAX's
    output and the port's."""
    jmodel, variables, x, y, grid, draws = small_step
    jax_step = _jax_stepper(jmodel, x, y, grid, monkeypatch, cdtype)
    state = (variables["params"], variables["batch_stats"], None)
    out = []
    for draw in draws:
        jax_out = jax_step(state, draw)
        out.append((state, jax_out, _port_step(state, x, y, grid, draw, compute_dtype)))
        state = jax_out[2]
    return out


@pytest.mark.parametrize("impl", ["jnp", "pallas_fused"])
def test_small_niofp2d_f32_steps_match_jax(small_step, impl, monkeypatch):
    """Two float32 steps: the loss, every gradient, every updated parameter and every
    updated running statistic within STEP_TOL = 2e-3 of each tensor's scale, its L2
    norm. The JAX step runs under the impl that reaches the fused Pallas layer
    (interpret mode on the CPU, custom VJP) and under the plain one.

    One exception, the gradients of the Encoder2D's parameters, within ENCODER_GRAD_TOL
    = 1e-2: ten leaky ReLUs lie between them and the loss, and where an activation lies
    within rounding of zero, float32 may put it on the other side of the kink than the
    reference does, which changes the gradients below it. The second step's draw holds
    one (block 3, 1.07e-7 from zero in float64, three times through duplicated draws):
    the port's float32 gradients there lie 3.3e-3 from JAX's and 3.0e-3 from the port's
    own float64 step. Measured on the CPU: first step, every error below 5e-4; second
    step, the encoder's gradients up to 3.3e-3 (``jnp``) and 1.2e-3 (``pallas_fused``),
    everything else below 5e-4."""
    previous = spectral_impl()
    set_spectral_impl(impl)
    try:
        steps = _run_steps(small_step, monkeypatch)
    finally:
        set_spectral_impl(previous)
    for _, jax_out, port_out in steps:
        errs = _step_errors(jax_out, port_out)
        bad = {k: e for k, e in errs.items()
               if not e <= (ENCODER_GRAD_TOL if k.startswith("deeponet.branch.") else STEP_TOL)}
        assert not bad, bad


def test_small_niofp2d_bf16_encoder_bn32_steps_match_jax(small_step, monkeypatch):
    """Two bf16 ``encoder_bn32`` steps against JAX's (``amp_cast_fns(jnp.bfloat16,
    "encoder_bn32")``), each from JAX's state as in the float32 test.

    bfloat16 rounding, not the port, sets how close two implementations can come in
    the encoder: JAX's own bf16 gradients of the Encoder2D's weights lie up to 0.26
    (relative L2) from its float32 ones, and the port's up to 0.24, so the two bf16
    gradients differ by up to 0.29 between them, and single gradients within rounding
    of zero flip the sign of Adam's step. The test therefore holds:

    - the loss, the gradients outside the encoder (trunk, b0, heads) and the updated
      running statistics to JAX's bf16 step within BF16_TOL = 5e-2, relative L2. The
      gap measured on this host is at most 2.9e-2 (a trunk bias's gradient, first
      step; 9.5e-3 at the second; the loss 3.5e-7), so the tolerance is under 3x the
      gap and no looser than 5e-2;
    - each encoder gradient to the float32 gradient (the port's float32 step, which the
      float32 test holds to JAX's), no further than 1.5x JAX's own bf16 gradient lies
      from it, or BF16_TOL (measured: at most 1.15x where JAX's lies beyond BF16_TOL):
      the port's bf16 mode is as accurate as JAX's;
    - every gradient and updated tensor finite and float32 (master weights, gradients
      and batch statistics stay float32), and the conv biases' gradients below 1e-3 of
      the largest gradient (measured: 3.3e-4).

    oneDNN is off for the port's step: its bfloat16 convolution on the CPU returned
    NaN from finite inputs (the 512-channel block 8) on its first call after a float32
    run; the plain CPU convolution computes the same function.
    """
    _, _, x, y, grid, draws = small_step
    with torch.backends.mkldnn.flags(enabled=False):
        steps = _run_steps(small_step, monkeypatch, jnp.bfloat16, "bfloat16")
    for (state, jax_out, port_out), draw in zip(steps, draws):
        errs = _step_errors(jax_out, port_out, zero_bound=1e-3)
        f32 = _port_step(state, x, y, grid, draw)[1]  # held to JAX's by the float32 test
        jax_bf16 = from_flax(jax_out[1], None)
        encoder = {k for k in errs if k.startswith("deeponet.branch.")}
        direct = {k: e for k, e in errs.items() if k not in encoder and
                  (k == "loss" or "running_" in k or not k.startswith("state "))}
        bad = {k: e for k, e in direct.items() if not e <= BF16_TOL}
        assert not bad, bad
        dist = {k: (_rel_l2(port_out[1][k], f32[k]), _rel_l2(jax_bf16[k], f32[k])) for k in encoder}
        bad = {k: d for k, d in dist.items() if not d[0] <= max(BF16_TOL, 1.5 * d[1])}
        assert not bad, bad


def test_train_step_refuses_eval_mode_and_unported_policies():
    """Train mode is the caller's to set. The compute dtypes are JAX's float ones:
    float16 and float32 (a no-op cast) were refused until the port took JAX's casts, and
    now run (``tests/test_torch_amp.py``); a name that is no float dtype and an unknown
    amp policy are refused, as JAX's ``jnp.dtype`` and ``amp_cast_fns`` refuse them."""
    model = NIOFP2D(width=4, modes=4, n_basis=3, neurons=8, fno_layers=1, device="cpu")
    opt = make_optimizer(model)
    args = torch.zeros(1, 3, NX, NX), torch.zeros(1, NX, NX, 2), torch.tensor(_grid())
    with pytest.raises(ValueError, match="train"):
        train_step(model, opt, *args, generator=torch.Generator())
    model.train()
    for dtype in ("float16", "float32"):  # the steps themselves: tests/test_torch_amp.py
        for policy in AMP_POLICIES:
            check_compute_dtype(model, dtype, policy)
    with pytest.raises(ValueError, match="compute_dtype"):
        train_step(model, opt, *args, generator=torch.Generator(), compute_dtype="encoder")
    with pytest.raises(ValueError, match="amp_policy"):
        train_step(model, opt, *args, generator=torch.Generator(), compute_dtype="float16",
                   amp_policy="bn32")
