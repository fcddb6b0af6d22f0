"""The port's low-precision training steps against the JAX package's on the CPU.

JAX's loop casts the batch to ``compute_dtype`` for every model, and ``amp_cast_fns``
casts the leaves its policy selects (``blindno/train/loop.py:156-198,369-379``). Each
model family takes one ``train_step`` in bfloat16 and in float16 under ``all`` and
``encoder_bn32`` at small widths, against JAX's step (``jnp`` impl, ``amp_cast_fns``)
from the same seeded weights (``from_flax``) and the same injected set subsample; flax's
BatchNorm takes its two-pass variance (``tests/test_torch_train.py``). The loss, the
gradients and the updated running statistics are held by relative L2, and the output's
dtype must be JAX's. The casting FNO wrappers' plain versions are held against the jnp
chain that JAX runs on bfloat16 and float16 operands.

Where JAX's own float16 step gives NaN (a set attention that masks its keys), the port
refuses the step, and the refusal is tested. Each step runs on one torch thread with
oneDNN off: oneDNN's bfloat16 convolution on the CPU returned NaN from finite inputs
(``tests/test_torch_train.py``).
"""
import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import blindno.models.blindno_unet as jax_unet
import blindno.models.nio1d as jax_nio1d
import blindno.models.nio2d as jax_nio2d
import blindno.models.nio3d as jax_nio3d
from blindno.nn.cnn import Encoder1D as JEncoder1D
from blindno.nn.cnn import Encoder2D as JEncoder2D
from blindno.nn.cnn import Encoder3D as JEncoder3D
from blindno.nn.torch_layers import gelu as jax_gelu
from blindno.ops import spectral as jax_spectral
from blindno.train.loop import amp_cast_fns
from blindno_torch.convert import from_flax
from blindno_torch.models import blindno_unet, nio1d, nio2d, nio3d
from blindno_torch.nn.cnn import Encoder1D, Encoder2D
from blindno_torch.ops.fno_layer import fno1d_layer_plain, fno2d_layer_plain
from blindno_torch.ops.spectral import spectral_conv1d, spectral_conv2d
from blindno_torch.ops.spectral_cuda import (fno1d_layer_cuda, fno2d_layer_cuda,
                                             spectral_conv1d_cuda, spectral_conv2d_cuda)
from blindno_torch.train.step import make_optimizer, train_step
from test_torch_nio3d import seeded_variables
from test_torch_train import BF16_TOL, _rel_l2, _TwoPassBatchNorm

F16_TOL = 2.5e-2  # relative L2 (see the step test)
CHAOS_TOL = 0.75  # mean relative L2 from the float32 step (see the step test)

DTYPES = {"bfloat16": jnp.bfloat16, "float16": jnp.float16}
B, L, L_MIN = 2, 4, 2
DIMS2, DIMS1 = (16, 32, 32, 32, 32), (16, 32, 32)  # the Encoder2D's and Encoder1D's widths, narrowed


@pytest.fixture(autouse=True)
def one_thread_no_onednn():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with torch.backends.mkldnn.flags(enabled=False):
        yield
    torch.set_num_threads(threads)


def _grid(*spatial):
    axes = [np.linspace(-1, 1, n, dtype=np.float32) for n in spatial]
    if len(spatial) == 1:
        return np.linspace(0, 1, spatial[0], dtype=np.float32).reshape(-1, 1)
    return np.stack(np.meshgrid(*axes, indexing="ij"), -1)


def _narrow_encoder(model, factory):
    model.deeponet.branch = factory()
    return model


S2 = dict(width=4, modes=3, fno_layers=2, l_min=L_MIN)
S1 = dict(width=4, modes=4, fno_layers=2, l_min=L_MIN)
UNET = dict(depth=1, width=4, fno_modes=3, fno_layers=2, subsample=True, l_min=L_MIN)
TRANS = dict(trans_layers=1, trans_hidden=8, trans_heads=2, slice_num=4)
FP2 = dict(n_basis=5, neurons=8)
# name -> (JAX module whose subsample_set is injected, JAX model, port model, spatial size)
FAMILIES = {
    "unet2d": (jax_unet, lambda: jax_unet.PermInvUNetAttn(input_size=(12, 12), **UNET),
               lambda: blindno_unet.PermInvUNetAttn(input_size=(12, 12), **UNET, device="cpu"),
               (12, 12)),
    "unet1d": (jax_unet, lambda: jax_unet.PermInvUNetAttn(input_size=(24,), **UNET),
               lambda: blindno_unet.PermInvUNetAttn(input_size=(24,), **UNET, device="cpu"),
               (24,)),
    "fno1d": (jax_nio1d, lambda: jax_nio1d.NIOFNO1D(**S1, inner_modes=4),
              lambda: nio1d.NIOFNO1D(**S1, inner_modes=4, device="cpu"), (24,)),
    "fno2d": (jax_nio2d, lambda: jax_nio2d.NIOFNO2D(**S2, inner_modes=3),
              lambda: nio2d.NIOFNO2D(**S2, inner_modes=3, device="cpu"), (12, 12)),
    "fno_attn2d": (jax_nio2d, lambda: jax_nio2d.NIOFNOAttn2D(**S2, inner_modes=3),
                   lambda: nio2d.NIOFNOAttn2D(**S2, inner_modes=3, device="cpu"), (12, 12)),
    "trans2d": (jax_nio2d, lambda: jax_nio2d.NIOTrans2D(**S2, **TRANS),
                lambda: nio2d.NIOTrans2D(**S2, **TRANS, device="cpu"), (9, 9)),
    "trans_attn2d": (jax_nio2d, lambda: jax_nio2d.NIOTransAttn2D(**S2, **TRANS),
                     lambda: nio2d.NIOTransAttn2D(**S2, **TRANS, device="cpu"), (9, 9)),
    "fp2d": (jax_nio2d, lambda: jax_nio2d.NIOFP2D(**S2, **FP2),
             lambda: _narrow_encoder(nio2d.NIOFP2D(**S2, **FP2, device="cpu"),
                                     lambda: Encoder2D(5, dims=DIMS2)), (61, 61)),
    "attn2d": (jax_nio2d, lambda: jax_nio2d.NIOAttn2D(**S2, **FP2),
               lambda: _narrow_encoder(nio2d.NIOAttn2D(**S2, **FP2, device="cpu"),
                                       lambda: Encoder2D(5, dims=DIMS2)), (61, 61)),
    "fp1d": (jax_nio1d, lambda: jax_nio1d.NIOFP1D(**S1, **FP2),
             lambda: _narrow_encoder(nio1d.NIOFP1D(**S1, **FP2, device="cpu"),
                                     lambda: Encoder1D(5, dims=DIMS1)), (80,)),
    "fp3d": (jax_nio3d, lambda: jax_nio3d.NIOFP3D(width=4, modes=2, n_basis=5, neurons=8,
                                                  l_min=L_MIN),
             lambda: nio3d.NIOFP3D(width=4, modes=2, n_basis=5, neurons=8, l_min=L_MIN,
                                   input_size=(40, 8, 8), encoder_dims=DIMS2, device="cpu"),
             (40, 8, 8)),
}
# the models whose set attention masks its keys: JAX's float16 step gives NaN
F16_NAN = {"unet2d", "unet1d", "fno_attn2d", "trans_attn2d", "attn2d"}


def _narrow_jax_encoders(monkeypatch):
    """JAX's NIOs build their encoders at the default widths; these cases narrow them to
    the port's (flax names the submodule after its class all the same)."""
    monkeypatch.setattr(jax_nio2d, "Encoder2D", lambda n, fk: JEncoder2D(n, fk, *DIMS2))
    monkeypatch.setattr(jax_nio1d, "Encoder1D", lambda n, fc: JEncoder1D(n, fc, *DIMS1))
    monkeypatch.setattr(jax_nio3d, "Encoder3D", lambda n: JEncoder3D(n, *DIMS2))


def _case(name, monkeypatch, seed=0):
    """JAX's model, its seeded variables, a batch and a draw for family ``name``."""
    module, jcls, _, spatial = FAMILIES[name]
    _narrow_jax_encoders(monkeypatch)
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((B, 1, *spatial)) + 0.5 * rng.standard_normal((B, L, *spatial))
         ).astype(np.float32)
    fields = 1 if name == "fp3d" else 2
    y = rng.standard_normal((B, *spatial, fields)).astype(np.float32)
    grid = _grid(*spatial)
    jmodel = jcls()
    variables = seeded_variables(jmodel, rng, x, grid)
    draw = (rng.integers(0, L, L), (np.arange(L) < 3).astype(np.float32))
    return module, jmodel, variables, x, y, grid, draw


def _jax_step(case, cdtype, policy, monkeypatch):
    """JAX's step: value_and_grad of the MSE with ``amp_cast_fns(cdtype, policy)`` inside
    the loss, the batch cast, the batch statistics mutable and cast back. Returns the
    loss, the gradients, the statistics after it and the output's dtype."""
    module, jmodel, variables, x, y, grid, draw = case
    monkeypatch.setattr(module, "subsample_set", lambda key, xx, l_min, training: (
        jnp.take(xx, jnp.asarray(draw[0]), axis=1), jnp.asarray(draw[1], xx.dtype)))
    monkeypatch.setattr(flax.linen, "BatchNorm", _TwoPassBatchNorm)
    cast, uncast = amp_cast_fns(cdtype, policy)
    stats = variables.get("batch_stats", {})

    def loss_fn(p):
        out, upd = jmodel.apply({"params": cast(p), "batch_stats": cast(stats)},
                                jnp.asarray(x).astype(cdtype), jnp.asarray(grid),
                                training=True, rngs={"sample": jax.random.PRNGKey(0)},
                                mutable=["batch_stats"])
        return (jnp.mean((out.astype(jnp.float32) - y) ** 2),
                (uncast(upd.get("batch_stats", {})), out.reshape(-1)[:1]))

    # LLVM's cheapest optimization level: the same arithmetic, compiled in 0.6x the time
    step = jax.jit(jax.value_and_grad(loss_fn, has_aux=True),
                   compiler_options={"xla_backend_optimization_level": 0})
    (loss, (new_stats, corner)), grads = step(variables["params"])
    np_ = lambda t: jax.tree.map(np.asarray, t)
    return float(loss), np_(grads), np_(new_stats), np.dtype(corner.dtype).name


def _port_step(name, case, compute_dtype, policy):
    """The port's ``train_step`` from the same state; the output's dtype read by a hook."""
    _, _, variables, x, y, grid, draw = case
    model = FAMILIES[name][2]()
    model.load_state_dict(from_flax(variables["params"], variables.get("batch_stats", {})))
    seen = []
    model.register_forward_hook(lambda m, a, out: seen.append(str(out.dtype)[6:]))
    loss = train_step(model.train(), make_optimizer(model), torch.tensor(x), torch.tensor(y),
                      torch.tensor(grid), subsample=draw, compute_dtype=compute_dtype,
                      amp_policy=policy)
    grads = {k: p.grad for k, p in model.named_parameters() if p.grad is not None}
    stats = {k: v for k, v in model.state_dict().items() if "running_" in k}
    return float(loss), grads, stats, seen[0]


def _errors(jax_out, port_out):
    """Relative L2 of the loss, of each gradient and of each running statistic after the
    step. Gradients exactly zero in JAX (the frozen fusion; the one-channel ConvNeXt
    blocks' depthwise conv and LayerNorm scale) must be exactly zero, or absent, in the
    port. The gradients of the conv biases before a BatchNorm are zero but for rounding:
    the port's must lie no further from zero than JAX's, or 1e-3 of the largest gradient
    (measured: the port's are 1.1-55x smaller than JAX's, its largest 2.1e-2 of the
    largest gradient against JAX's 3.1e-2 in the narrow Encoder2D in bfloat16). Neither
    joins the relative errors."""
    jloss, jgrads, jstats, _ = jax_out
    loss, grads, stats, _ = port_out
    want = from_flax(jgrads, None)
    exact = {k for k, g in want.items() if not g.any()}
    assert all(k not in grads or not grads[k].any() for k in exact), exact
    assert all(g.dtype == torch.float32 and torch.isfinite(g).all() for g in grads.values())
    top = max(float(g.abs().max()) for g in want.values())
    rounding = {k for k in grads if k.endswith(".conv.bias")}
    worst = [max((float(t[k].abs().max()) for k in rounding), default=0) for t in (grads, want)]
    assert worst[0] <= max(1e-3 * top, worst[1]), (worst, top)
    want_stats = {k: v for k, v in from_flax(jgrads, jstats).items() if "running_" in k}
    assert want_stats.keys() == stats.keys()
    errs = {"loss": abs(loss - jloss) / abs(jloss)}
    errs.update({k: _rel_l2(grads[k], want[k]) for k in grads if k not in exact | rounding})
    errs.update({f"state {k}": _rel_l2(stats[k], want_stats[k]) for k in stats})
    return errs


def _chaotic(name, key):
    """The gradients that bfloat16 or float16 rounding makes chaotic on both sides: the
    conv encoders' (ten leaky-ReLU kinks below them, ``tests/test_torch_train.py``) and
    the UNet's conv stack (max pools and two-channel LayerNorms)."""
    if key == "loss" or key.startswith("state "):
        return False
    return key.startswith("deeponet.branch.") or (name.startswith("unet")
                                                  and not key.startswith("heads."))


def _tol(dtype, policy):
    tol = BF16_TOL if dtype == "bfloat16" else F16_TOL
    return 2 * tol if policy == "all" else tol


def step_cases(names):
    """(family, dtype, policy) of the step tests: every dtype under ``all`` and
    ``encoder_bn32``, but float16 where JAX's step gives NaN (the refusal test)."""
    return [(n, d, p) for n in names for d in DTYPES for p in ("all", "encoder_bn32")
            if not (d == "float16" and n in F16_NAN)]


# the 2-D NIO families here; the UNets, the 1-D and the 3-D NIOs in
# tests/test_torch_amp_unet_1d_3d.py, so that xdist can run the two files side by side
NIO_2D = ("fno2d", "fno_attn2d", "trans2d", "trans_attn2d", "fp2d", "attn2d")


@pytest.mark.parametrize("name,dtype,policy", step_cases(NIO_2D))
def test_low_precision_step_matches_jax(name, dtype, policy, monkeypatch):
    """:func:`check_step` on the 2-D NIO families."""
    check_step(name, dtype, policy, monkeypatch)


def check_step(name, dtype, policy, monkeypatch):
    """One step in ``dtype`` under ``policy`` against JAX's from the same state:

    - the output's dtype is JAX's (bfloat16 for the UNet under ``all``, which ignores its
      grid; float32 wherever a float32 operand promotes the stream);
    - the loss, every updated running statistic and every gradient within BF16_TOL =
      5e-2 (bfloat16) or F16_TOL = 2.5e-2 (float16) of JAX's, relative L2, and twice
      that under ``all``, as ``tests/test_torch_eval_extras.py`` holds NIOFP2D's bf16
      steps. float16 rounds 8x finer than bfloat16, but its gaps come from the same
      amplification and measured 0.1-0.45x the bfloat16 ones, so F16_TOL is half of
      BF16_TOL. Measured on the CPU: the loss within 8.6e-4, the statistics within
      5.6e-2 under ``all`` (the 1-D UNet's skip BatchNorm) and 1.3e-2 under
      ``encoder_bn32``; the gradients held this way within 9.4e-2 under bfloat16 ``all``,
      4.6e-2 under ``encoder_bn32``, and 1.5e-2 in float16;
    - a gradient of small norm (below 1e-3 of the largest in the float32 step: the
      DeepONet's b0, whose gradient cancels through the attention's softmax) within
      that tolerance of the largest gradient's norm instead;
    - a gradient beyond its tolerance passes if it lies no further from the port's own
      float32 step than 3x the larger of JAX's distance from it and the tolerance:
      rounding noise in the encoder's output is amplified in the trunk (one-signed grid
      coordinates through BatchNorms, and the token attention) and in the heads' low
      modes, on both sides alike, and which side lands nearer is chance (measured, in
      bfloat16: the NIOFP2D and NIOAttn2D trunks 0.020-0.122 from float32 in the port
      against 0.047-0.218 in JAX; the 1-D heads' imaginary planes 0.062-0.107 in the
      port against 0.016-0.025 in JAX);
    - the gradients below the leaky-ReLU kinks of a conv encoder and the UNet's conv
      stack (:func:`_chaotic`) are chaotic on both sides: rounding flips an activation
      within its rounding of zero to the other side of a kink, which changes every
      gradient below it (JAX's bfloat16 2-D UNet step lies 8.4x the float32 gradients'
      norm from them on average). Their mean distance from the port's float32 step
      must lie within 1.5x JAX's or CHAOS_TOL = 0.75. Measured: the port's mean is
      0.004-0.61, JAX's 0.004-8.4; even JAX's float16 NIOFP2D step flips a kink from one
      run to the next (its mean distance 0.027 in one run and 0.575 in another, where the
      port's is 0.577). The running statistics of those blocks, forward quantities, are
      held directly.
    """
    case = _case(name, monkeypatch)
    jax_out = _jax_step(case, DTYPES[dtype], policy, monkeypatch)
    port_out = _port_step(name, case, dtype, policy)
    f32 = _port_step(name, case, None, policy)[1]
    assert port_out[3] == jax_out[3]
    hold(_errors(jax_out, port_out), port_out[1], from_flax(jax_out[1], None), f32,
         _tol(dtype, policy), lambda k: _chaotic(name, k))


def hold(errs, got, want, f32, tol, chaotic):
    """:func:`check_step`'s bounds on ``errs`` (relative L2 against JAX by name), given
    the port's gradients ``got``, JAX's ``want``, the port's float32 step's ``f32``, the
    tolerance and the predicate naming the chaotic gradients."""
    top = max(float(g.norm()) for g in f32.values())
    dist = {k: (_rel_l2(got[k], f32[k]), _rel_l2(want[k], f32[k])) for k in errs if k in want}
    for k in dist:
        if float(f32[k].norm()) < 1e-3 * top:
            errs[k] = float((got[k] - want[k]).norm()) / top
    bad = {k: e for k, e in errs.items() if not chaotic(k)
           and not (e <= tol or (k in dist and dist[k][0] <= 3 * max(dist[k][1], tol)))}
    assert not bad, bad
    dists = [dist[k] for k in errs if chaotic(k)]
    if dists:
        port_mean, jax_mean = np.mean(dists, axis=0)
        assert port_mean <= max(1.5 * jax_mean, CHAOS_TOL), (port_mean, jax_mean)


@pytest.mark.parametrize("name", sorted(F16_NAN))
def test_float16_is_refused_where_jax_gives_nan(name, monkeypatch):
    """JAX casts the subsample's mask to the snapshots' dtype and its set attention adds
    ``(1 - mask) * -1e9`` to the scores: -1e9 is -inf in float16, the valid keys' 0 x
    -inf is NaN, and JAX's float16 step gives a NaN loss (shown here under
    ``encoder_bn32`` for the 1-D UNet and ``NIOFNOAttn2D``; the others share the
    mechanism). The port refuses the step under every policy, saying so; bfloat16 runs
    (the step test)."""
    case = _case(name, monkeypatch)
    if name in ("unet1d", "fno_attn2d"):
        assert np.isnan(_jax_step(case, jnp.float16, "encoder_bn32", monkeypatch)[0])
    for policy in ("all", "encoder", "encoder_bn32"):
        with pytest.raises(ValueError, match="NaN"):
            _port_step(name, case, "float16", policy)


# ------------------------------------------------------------------ the casting wrappers

WRAPPER_TOL = {"bfloat16": 2e-2, "float16": 3e-3}  # (see the wrapper test)


def _layer_inputs(dim, rng):
    """x, wr, wi, pk, pb and an upstream gradient at a small 1-D or 2-D layer shape."""
    b, c, m = 2, 3, 4
    spatial = (20,) if dim == 1 else (12, 10)
    wshape = (c, c, m) if dim == 1 else (c, c, 2 * m, m)
    r = lambda *s, scale=1.0: (scale * rng.standard_normal(s)).astype(np.float32)
    return (r(b, c, *spatial), r(*wshape, scale=0.3), r(*wshape, scale=0.3), r(c, c), r(c),
            r(b, c, *spatial))


def _jax_layer(dim, x, wr, wi, pk, pb, spectral_only=False):
    """The jnp chain that JAX's ``FNO1d``/``FNO2d`` run at its default impl, gelu after,
    in the operands' dtypes (``blindno/nn/fno.py:117-124,163-176``)."""
    conv = jax_spectral.spectral_conv1d if dim == 1 else jax_spectral.spectral_conv2d
    y = conv(x, wr, wi)
    if spectral_only:
        return y
    return jax_gelu(y + jnp.einsum("bc...,co->bo...", x, pk) + pb.reshape((1, -1) + (1,) * dim))


@pytest.mark.parametrize("mixed", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("dim", [1, 2])
def test_casting_wrappers_match_the_jnp_chain(dim, dtype, mixed):
    """The wrappers on the CPU (their plain versions) given ``dtype`` operands, or with
    ``mixed`` a float32 x and ``dtype`` weights (a NIO's heads under ``all``), against
    JAX's jnp chain on the same operands: the spectral convolution's and the layer's
    output, and the differentiable layer's five gradients (of sum(out * g)), each in the
    dtype JAX gives it (the output's is jnp's promotion of the operands, a gradient's
    its input's). Each lies within WRAPPER_TOL of JAX's (relative L2; bfloat16 2e-2,
    float16 3e-3), or nearer the float64 result than JAX's does: the wrapper computes in
    float32 and rounds once, the chain rounds each of its einsums. Measured, against
    float64: the port 1.6e-3-4.9e-3 in bfloat16 and 1.6e-4-5.8e-4 in float16, JAX up to
    8.8e-2 (the 2-D bias gradient, a sum over the whole output rounded in bfloat16) and
    1.9e-3; the two apart by up to 8e-3 and 9.7e-4 elsewhere."""
    rng = np.random.default_rng(dim)
    *args, g = _layer_inputs(dim, rng)
    low = DTYPES[dtype]
    jargs = [jnp.asarray(a, jnp.float32 if mixed and i == 0 else low) for i, a in enumerate(args)]
    targs = [torch.tensor(np.asarray(a.astype(jnp.float32))).to(getattr(torch, a.dtype.name))
             for a in jargs]
    exact = [t.double().requires_grad_() for t in targs]
    layer, spectral, layer64, spectral64 = (
        (fno1d_layer_cuda, spectral_conv1d_cuda, fno1d_layer_plain, spectral_conv1d) if dim == 1
        else (fno2d_layer_cuda, spectral_conv2d_cuda, fno2d_layer_plain, spectral_conv2d))
    tol = WRAPPER_TOL[dtype]

    def close(got, want, truth):
        assert str(got.dtype)[6:] == np.dtype(want.dtype).name
        got, want = got.detach().double().numpy(), np.asarray(want.astype(jnp.float32), np.float64)
        truth = truth.detach().numpy()
        err = lambda a, b: np.linalg.norm(a - b) / np.linalg.norm(b)
        assert err(got, want) <= tol or err(got, truth) <= err(want, truth), (
            err(got, want), err(got, truth), err(want, truth))

    jconv, jout, jgrads = jax.jit(lambda *a: (
        _jax_layer(dim, *a, spectral_only=True), _jax_layer(dim, *a),
        jax.grad(lambda *b: jnp.sum(_jax_layer(dim, *b).astype(jnp.float32) * g),
                 argnums=tuple(range(5)))(*a)))(*jargs)
    with torch.no_grad():
        close(spectral(*targs[:3]), jconv, spectral64(*exact[:3]))
    leaves = [t.clone().requires_grad_() for t in targs]
    out = layer(*leaves)
    out64 = layer64(*exact)  # the plain version in float64
    close(out, jout, out64)
    (out.float() * torch.tensor(g)).sum().backward()
    (out64 * torch.tensor(g).double()).sum().backward()
    for t, w, t64 in zip(leaves, jgrads, exact):
        close(t.grad, w, t64.grad)
