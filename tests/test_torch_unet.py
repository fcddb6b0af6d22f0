"""The port's BlinDNO UNet (``PermInvUNetAttn``) and its parts against the JAX package on
the CPU.

Weights move over with ``blindno_torch.convert.from_flax``, and both sides see the same
numpy inputs. Each part is held to its flax module; the whole model in the four
variants of ``tests/test_models_2d.py:55-64`` in eval mode with randomized BatchNorm
statistics and LayerNorm parameters (flax's init, scale 1 and bias 0, would hide a
LayerNorm laid out in the wrong order); the five committed UNet checkpoints against the
JAX ``predict_fields``; and one float32 train step of a small 2-D UNet with the
subsample injected on both sides, as ``tests/test_torch_train.py`` holds the NIO's.
"""
import os
import re

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import blindno.models.blindno_unet as jax_unet
from blindno.eval.field_eval import predict_fields as jax_predict_fields
from blindno.models.blindno_unet import PermInvUNetAttn as JUNet
from blindno.nn.convnext import ConvNeXtBlock as JConvNeXtBlock
from blindno.nn.convnext import PlainConvBlock as JPlainConvBlock
from blindno.nn.setops import TemporalSelfAttention as JTemporalSelfAttention
from blindno.nn.setops import set_self_attention as jax_set_self_attention
from blindno.nn.torch_layers import TorchConvTranspose
from blindno.train.loop import amp_cast_fns
from blindno_torch.convert import from_flax
from blindno_torch.eval.field_eval import predict_fields
from blindno_torch.models.blindno_unet import PermInvUNetAttn
from blindno_torch.nn.convnext import ConvNeXtBlock, PlainConvBlock
from blindno_torch.nn.setops import TemporalSelfAttention, set_self_attention
from blindno_torch.nn.torch_layers import ConvTranspose
from blindno_torch.train.step import make_optimizer, train_step
from test_nio2d_torch_parity import _randomize_bn
from test_torch_nio3d import seeded_variables
from test_torch_train import BF16_TOL, _TwoPassBatchNorm

TOL = 2e-3  # of the output's scale: the NIO parity bound, tests/test_nio2d_torch_parity.py:190
PART_TOL = 1e-5
CKPT = os.path.join(os.path.dirname(__file__), "..", "runs", "ckpt")


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _randomize_ln(variables, rng):
    """Every LayerNorm's scale drawn from U(0.6, 1.4) and its bias from N(0, 0.08)."""

    def visit(path, leaf):
        names = [getattr(p, "key", "") for p in path]
        if "LayerNorm_0" not in names:
            return leaf
        if names[-1] == "scale":
            return jnp.asarray(rng.uniform(0.6, 1.4, leaf.shape), leaf.dtype)
        return jnp.asarray(rng.normal(0.0, 0.08, leaf.shape), leaf.dtype)

    return jax.tree_util.tree_map_with_path(visit, variables)


def _randomized(variables, seed=7):
    rng = np.random.default_rng(seed)
    return _randomize_ln(_randomize_bn(variables, rng), rng)


def _load(module, prefix, params, stats=None):
    """A part's flax tree, under the module path ``prefix`` that ``from_flax`` maps into
    the UNet (``blocks.0``, ``transposes.0``, ...), into ``module``; returns it."""
    state = from_flax({prefix: _np(params)}, {prefix: _np(stats)} if stats is not None else None)
    module.load_state_dict({re.sub(r"^\w+\.\d+\.", "", k): v for k, v in state.items()})
    return module


# ------------------------------------------------------------------ the parts


@pytest.mark.parametrize("ndim", [1, 2])
def test_conv_transpose_flips_its_kernel_and_pads_with_zeros(ndim):
    """Output padding 1 on a 7-wide input (7 -> 15, as 61 -> 30 -> 61 needs): the flax
    kernel moves over flipped, and the padded row and column are zeros, not the bias
    (torch's own ``output_padding`` would fill them with the bias)."""
    rng = np.random.default_rng(ndim)
    x = rng.standard_normal((2,) + (7,) * ndim + (3,)).astype(np.float32)
    jmod = TorchConvTranspose(4, (2,) * ndim, (2,) * ndim, (1,) * ndim)
    variables = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))
    params = _np(variables["params"])
    params["ConvTranspose_0"]["bias"] = rng.normal(0.0, 0.5, 4).astype(np.float32)
    want = np.asarray(jmod.apply({"params": params}, jnp.asarray(x)))
    mod = ConvTranspose(3, 4, (2,) * ndim, (2,) * ndim, (1,) * ndim, torch.Generator())
    _load(mod, "TorchConvTranspose_0/ConvTranspose_0", params["ConvTranspose_0"])
    got = mod(torch.tensor(np.moveaxis(x, -1, 1))).detach().numpy()
    assert want.shape == (2,) + (15,) * ndim + (4,)
    np.testing.assert_allclose(np.moveaxis(got, 1, -1), want, rtol=PART_TOL, atol=PART_TOL)
    assert not got[(..., -1)].any()  # the padded end is zero
    # the init's bound: fan_in = cout * prod(kernel), as torch's ConvTranspose reckons it
    bound = 1 / np.sqrt(4 * 2 ** ndim)
    assert 0.5 * bound < float(mod.weight.detach().abs().max()) <= bound


@pytest.mark.parametrize("dim", [1, 4])
@pytest.mark.parametrize("ndim", [1, 2])
def test_convnext_block_matches_flax(ndim, dim):
    """At dim 1 the LayerNorm returns its bias: the output is the input plus a constant,
    and the depthwise conv's and the LayerNorm scale's gradients are exactly zero, in
    JAX and in the port."""
    rng = np.random.default_rng(dim)
    x = rng.standard_normal((3,) + (9,) * ndim + (dim,)).astype(np.float32)
    g_out = rng.standard_normal(x.shape).astype(np.float32)
    jmod = JConvNeXtBlock(dim)
    params = _randomize_ln(jmod.init(jax.random.PRNGKey(1), jnp.asarray(x)), rng)["params"]
    want, pull = jax.vjp(lambda p: jmod.apply({"params": p}, jnp.asarray(x)), params)
    jgrads = from_flax({"ConvNeXtBlock_0": _np(pull(jnp.asarray(g_out))[0])}, None)
    mod = _load(ConvNeXtBlock(dim, ndim, torch.Generator()), "ConvNeXtBlock_0", params)
    got = mod(torch.tensor(np.moveaxis(x, -1, 1)))
    torch.sum(got * torch.tensor(np.moveaxis(g_out, -1, 1))).backward()
    np.testing.assert_allclose(np.moveaxis(got.detach().numpy(), 1, -1), np.asarray(want),
                               rtol=PART_TOL, atol=PART_TOL)
    for k, p in mod.named_parameters():
        want_g = jgrads[f"blocks.0.{k}"]
        if dim == 1 and k in ("dwconv.weight", "dwconv.bias", "norm.weight"):
            assert not want_g.any() and not p.grad.any(), k
        else:
            assert want_g.abs().max() > 0, k
            np.testing.assert_allclose(p.grad.numpy(), want_g.numpy(), rtol=1e-4, atol=1e-4,
                                       err_msg=k)


@pytest.mark.parametrize("training", [False, True])
def test_plain_conv_block_matches_flax(training, monkeypatch):
    """Eval mode with randomized statistics; train mode with batch statistics and flax's
    running-variance update (flax given its two-pass variance, as in the step tests)."""
    monkeypatch.setattr(flax.linen, "BatchNorm", _TwoPassBatchNorm)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((4, 11, 11, 3)).astype(np.float32)
    jmod = JPlainConvBlock(3)
    variables = _randomize_bn(jmod.init(jax.random.PRNGKey(2), jnp.asarray(x)), rng)
    want, upd = jmod.apply(variables, jnp.asarray(x), training=training, mutable=["batch_stats"])
    mod = _load(PlainConvBlock(3, 2, torch.Generator()), "PlainConvBlock_0",
                variables["params"], variables["batch_stats"]).train(training)
    got = mod(torch.tensor(np.moveaxis(x, -1, 1))).detach().numpy()
    np.testing.assert_allclose(np.moveaxis(got, 1, -1), np.asarray(want), rtol=PART_TOL,
                               atol=PART_TOL)
    stats = upd["batch_stats"]["TorchBatchNorm_0"]["BatchNorm_0"]
    np.testing.assert_allclose(mod.bn.running_mean.numpy(), np.asarray(stats["mean"]), rtol=PART_TOL,
                               atol=PART_TOL)
    np.testing.assert_allclose(mod.bn.running_var.numpy(), np.asarray(stats["var"]), rtol=PART_TOL,
                               atol=PART_TOL)


@pytest.mark.parametrize("mask_rank", [1, 2])
def test_set_self_attention_matches_jax(mask_rank):
    """Scores x xᵀ / sqrt(D), the masked keys given -1e9, over a set of 6 tokens."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 6, 45)).astype(np.float32)
    mask = (np.arange(6) < 4).astype(np.float32)
    if mask_rank == 2:
        mask = np.stack([mask, (np.arange(6) < 5).astype(np.float32)])
    want = np.asarray(jax_set_self_attention(jnp.asarray(x), jnp.asarray(mask)))
    got = set_self_attention(torch.tensor(x), torch.tensor(mask)).numpy()
    np.testing.assert_allclose(got, want, rtol=PART_TOL, atol=PART_TOL)
    # the masked keys take no weight: changing them changes nothing
    x2 = x.copy()
    x2[:, 5] += 1.0
    got2 = set_self_attention(torch.tensor(x2), torch.tensor(mask)).numpy()
    np.testing.assert_allclose(got2[:, :4], got[:, :4], rtol=1e-6, atol=1e-6)


def test_temporal_self_attention_matches_flax():
    """C = 3 channels of a 5x4 grid (D = 60) with a randomized LayerNorm: the port's
    channel-first tokens flatten in JAX's (spatial, channel) order. A LayerNorm taken in
    the channel-first order would miss by the spread of its parameters."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 6, 5, 4, 3)).astype(np.float32)  # (B, T, H, W, C)
    mask = (np.arange(6) < 4).astype(np.float32)
    jmod = JTemporalSelfAttention()
    params = _randomize_ln(jmod.init(jax.random.PRNGKey(3), jnp.asarray(x)), rng)["params"]
    want = np.asarray(jmod.apply({"params": params}, jnp.asarray(x), jnp.asarray(mask)))
    mod = _load(TemporalSelfAttention(3, (5, 4)), "TemporalSelfAttention_0", params)
    got = mod(torch.tensor(np.moveaxis(x, -1, 2)), torch.tensor(mask)).detach().numpy()
    np.testing.assert_allclose(np.moveaxis(got, 2, -1), want, rtol=PART_TOL, atol=PART_TOL)
    # the same parameters laid over a channel-first flatten give another function
    chw = np.moveaxis(x, -1, 2).reshape(2, 6, -1)
    wrong = torch.nn.functional.layer_norm(
        set_self_attention(torch.tensor(chw), torch.tensor(mask)) + torch.tensor(chw), (60,),
        mod.norm.weight, mod.norm.bias, 1e-5).detach().numpy().reshape(2, 6, 3, 5, 4)
    assert np.abs(np.moveaxis(wrong, 2, -1) - want).max() > 100 * PART_TOL


# ------------------------------------------------------------------ the whole model

SMALL = dict(width=6, fno_modes=6, fno_layers=2)
VARIANTS = {  # tests/test_models_2d.py:55-64
    "fpe1d": dict(input_size=(80,), depth=5, block="convnext", head_dims=(1, 1)),
    "gpe1d": dict(input_size=(128,), depth=4, block="convnext", head_dims=(1,)),
    "fpe2d": dict(input_size=(61, 61), depth=4, block="convnext", head_dims=(1, 1)),
    "nc2d": dict(input_size=(61, 61), depth=2, block="plain", head_dims=(1, 1)),
}


def _grid(input_size):
    if len(input_size) == 1:
        return np.linspace(0, 1, input_size[0], dtype=np.float32).reshape(-1, 1)
    gx, gy = np.meshgrid(*(np.linspace(-1, 1, n) for n in input_size), indexing="ij")
    return np.stack([gx, gy], 2).astype(np.float32)


def _port(variables, **cfg):
    model = PermInvUNetAttn(**cfg, device="cpu")
    model.load_state_dict(from_flax(_np(variables["params"]), _np(variables["batch_stats"])))
    return model


@pytest.mark.parametrize("variant", VARIANTS)
def test_unet_variants_match_flax(variant):
    """Eval mode, randomized BatchNorm statistics and LayerNorm parameters, 2 sets of 4
    snapshots: within 2e-3 of the output's scale."""
    cfg = dict(VARIANTS[variant], **SMALL, subsample=True, l_min=2)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 4) + cfg["input_size"]).astype(np.float32)
    jmodel = JUNet(**cfg)
    variables = _randomized(jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.asarray(x)))
    want = np.asarray(jax.jit(jmodel.apply)(variables, jnp.asarray(x)))
    got = predict_fields(_port(variables, **cfg), x, _grid(cfg["input_size"]), batch=2,
                         device="cpu")
    assert got.shape == want.shape == (2,) + cfg["input_size"] + (sum(cfg["head_dims"]),)
    scale = np.abs(want).max()
    assert np.std(want) > 1e-3 * scale
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL * scale)


CHECKPOINTS = {  # blindno/suites/registry.py: the suites' "unet" configs
    "fpe2d_unet": dict(input_size=(61, 61), depth=4, width=12, fno_modes=32, head_dims=(1, 1)),
    "ncfpe2d_unet": dict(input_size=(80, 80), depth=5, width=12, fno_modes=32, head_dims=(1, 1),
                         block="plain"),
    "fpe1d_unet": dict(input_size=(80,), depth=5, width=30, fno_modes=15, head_dims=(1, 1)),
    "schrodinger1d_unet": dict(input_size=(128,), depth=4, width=10, fno_modes=30, head_dims=(1,)),
    "gpe1d_unet": dict(input_size=(128,), depth=4, width=20, fno_modes=40, head_dims=(1,)),
}


@pytest.mark.parametrize("name", CHECKPOINTS)
def test_committed_checkpoint_matches_jax_predict_fields(name):
    """The committed JAX-trained UNet through ``from_flax``, on 2 seeded sets of 6
    snapshots, against the JAX ``predict_fields``."""
    from blindno.train.checkpoint import load_best

    ckpt = load_best(os.path.join(CKPT, name))
    cfg = dict(CHECKPOINTS[name], subsample=True)
    x = np.random.default_rng(5).standard_normal((2, 6) + cfg["input_size"]).astype(np.float32)
    grid = _grid(cfg["input_size"])
    want = jax_predict_fields(JUNet(**cfg), ckpt["params"], ckpt["batch_stats"], x, grid, batch=2)
    got = predict_fields(_port(ckpt, **cfg), x, grid, batch=2, device="cpu")
    assert got.shape == want.shape and np.isfinite(got).all()
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL * scale)


# ------------------------------------------------------------------ one train step

STEP_CFG = dict(input_size=(29, 29), depth=3, **SMALL, head_dims=(1, 1), subsample=True, l_min=2)
B, L = 2, 5
STEP_TOL = 2e-3  # relative L2 per tensor, as tests/test_torch_train.py holds the NIO's step


def _jax_step(jmodel, variables, x, y, draw, monkeypatch):
    """``bench.py:172-186``'s step on the UNet: value_and_grad of the MSE with the
    batch statistics mutable, then ``optax.adam(5e-4)``; the subsample injected and
    flax's BatchNorm given its two-pass variance, as ``tests/test_torch_train.py`` does."""
    monkeypatch.setattr(jax_unet, "subsample_set", lambda key, xx, l_min, training: (
        jnp.take(xx, jnp.asarray(draw[0]), axis=1), jnp.asarray(draw[1], xx.dtype)))
    monkeypatch.setattr(flax.linen, "BatchNorm", _TwoPassBatchNorm)
    tx = optax.adam(5e-4)
    params, stats = variables["params"], variables["batch_stats"]

    def loss_fn(p):
        out, upd = jmodel.apply({"params": p, "batch_stats": stats}, jnp.asarray(x),
                                training=True, rngs={"sample": jax.random.PRNGKey(0)},
                                mutable=["batch_stats"])
        return jnp.mean((out - y) ** 2), upd["batch_stats"]

    (loss, new_stats), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    updates, _ = tx.update(grads, tx.init(params), params)
    return float(loss), _np(grads), _np(optax.apply_updates(params, updates)), _np(new_stats)


def test_unet_f32_train_step_matches_jax(monkeypatch):
    """One float32 step from randomized weights: the loss, every gradient, every updated
    parameter and every updated running statistic of the skip BatchNorms within
    STEP_TOL, relative L2. The gradients that are exactly zero in JAX (the depthwise
    conv and LayerNorm scale of the one-channel blocks) are exactly zero in the port,
    and their parameters do not move."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((B, L) + STEP_CFG["input_size"]).astype(np.float32)
    y = rng.standard_normal((B,) + STEP_CFG["input_size"] + (2,)).astype(np.float32)
    draw = (rng.integers(0, L, L), (np.arange(L) < 3).astype(np.float32))
    jmodel = JUNet(**STEP_CFG)
    variables = _np(_randomized(jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.asarray(x))))
    jloss, jgrads, jparams, jstats = _jax_step(jmodel, variables, x, y, draw, monkeypatch)

    model = _port(variables, **STEP_CFG).train()
    loss = train_step(model, make_optimizer(model), torch.tensor(x), torch.tensor(y),
                      torch.tensor(_grid(STEP_CFG["input_size"])), subsample=draw)
    want_grads = from_flax(jgrads, None)
    grads = {k: p.grad for k, p in model.named_parameters()}
    assert grads.keys() == want_grads.keys()
    zero = {k for k, g in want_grads.items() if not g.any()}
    assert zero == {f"blocks.{i}.{n}" for i in (0, 2 * STEP_CFG["depth"])
                    for n in ("dwconv.weight", "dwconv.bias", "norm.weight")}
    assert all(not grads[k].any() for k in zero)
    want_state = {k: v for k, v in from_flax(jparams, jstats).items()
                  if not k.endswith("num_batches_tracked")}
    state = {k: v for k, v in model.state_dict().items() if k in want_state}
    initial = from_flax(_np(variables["params"]), _np(variables["batch_stats"]))
    assert all(torch.equal(state[k], initial[k]) for k in zero)
    rel = lambda a, b: float((a - b).norm() / b.norm())
    errs = {"loss": abs(float(loss) - jloss) / abs(jloss)}
    errs.update({k: rel(grads[k], want_grads[k]) for k in grads if k not in zero})
    errs.update({f"state {k}": rel(state[k], want_state[k]) for k in want_state if k not in zero})
    assert any(k.startswith("state skip_norms.") and "running_var" in k for k in errs)
    bad = {k: e for k, e in errs.items() if not e <= STEP_TOL}
    assert not bad, bad


def test_unet_train_mode_limits(monkeypatch):
    """The 1-D UNet trains (it refused train mode until 1-D training came; its step is
    held to JAX in ``test_torch_train1d.py``). Low precision, which the port refused on
    the UNet until it took JAX's casts: a bfloat16 step under JAX's default policy
    ``all`` runs in 2-D and in 1-D, in bfloat16 end to end (the UNet ignores its grid),
    with its loss within BF16_TOL = 5e-2 of JAX's bfloat16 step from the same seeded
    weights and draw (measured: 7.4e-5 and 1.8e-3; ``tests/test_torch_amp*.py`` hold
    every gradient). float16 is refused, because JAX's float16 step of a subsampling
    UNet gives NaN (its attention's key mask overflows float16, the message says)."""
    model_1d = PermInvUNetAttn(input_size=(80,), depth=2, **SMALL, subsample=True, l_min=2,
                               device="cpu").train()
    args_1d = (torch.randn(1, 3, 80), torch.zeros(1, 80, 2), torch.zeros(80, 1))
    loss = train_step(model_1d, make_optimizer(model_1d), *args_1d, generator=torch.Generator())
    assert torch.isfinite(loss)
    monkeypatch.setattr(flax.linen, "BatchNorm", _TwoPassBatchNorm)
    rng = np.random.default_rng(3)
    draw = (rng.integers(0, 3, 3), np.array([1.0, 1.0, 0.0], np.float32))
    monkeypatch.setattr(jax_unet, "subsample_set", lambda key, xx, l_min, training: (
        jnp.take(xx, jnp.asarray(draw[0]), axis=1), jnp.asarray(draw[1], xx.dtype)))
    cast, _ = amp_cast_fns(jnp.bfloat16, "all")
    for cfg in (dict(STEP_CFG, depth=1), dict(STEP_CFG, input_size=(80,), depth=2)):
        spatial = cfg["input_size"]
        x = rng.standard_normal((2, 3, *spatial)).astype(np.float32)
        y = rng.standard_normal((2, *spatial, 2)).astype(np.float32)
        grid = np.zeros((*spatial, len(spatial)), np.float32)  # ignored on both sides
        jmodel = JUNet(**cfg)
        variables = seeded_variables(jmodel, rng, x, grid)

        def loss_fn(p):
            out, _ = jmodel.apply({"params": cast(p), "batch_stats": cast(variables["batch_stats"])},
                                  jnp.asarray(x, jnp.bfloat16), training=True,
                                  rngs={"sample": jax.random.PRNGKey(0)}, mutable=["batch_stats"])
            return jnp.mean((out.astype(jnp.float32) - y) ** 2)

        want = float(jax.jit(loss_fn)(variables["params"]))
        model = _port(variables, **cfg).train()
        with torch.backends.mkldnn.flags(enabled=False):  # tests/test_torch_train.py: oneDNN
            got = float(train_step(model, make_optimizer(model), torch.tensor(x), torch.tensor(y),
                                   torch.tensor(grid), subsample=draw,
                                   compute_dtype="bfloat16", amp_policy="all"))
        assert abs(got - want) <= BF16_TOL * abs(want), (got, want)
        with pytest.raises(ValueError, match="NaN"):
            train_step(model, make_optimizer(model), torch.tensor(x), torch.tensor(y),
                       torch.tensor(grid), subsample=draw, compute_dtype="float16")
