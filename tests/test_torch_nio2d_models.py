"""The port's FNO-branch and token-attention NIOs against the flax models on the CPU.

``NIOFNO2D``, ``NIOAttn2D`` and ``NIOFNOAttn2D`` (``blindno_torch/models/nio2d.py``) and
their new parts, ``TokenMeanFusion`` and ``_token_attention_tokens``, each against its
JAX counterpart on the same numpy-seeded inputs, with weights moved by
``blindno_torch.convert.from_flax``: eval-mode forwards at the small sizes of
``tests/test_models_2d.py`` with randomized BatchNorm statistics, the committed
``runs/ckpt/ncfpe2d_fno`` checkpoint against JAX's ``predict_fields``, and one float32
train step of each model against JAX's with an injected set subsample (as
``tests/test_torch_train.py`` does for ``NIOFP2D``). JAX runs its ``jnp`` spectral impl
(``tests/test_torch_nio2d.py`` holds the fused Pallas layer's path).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import blindno.models.nio2d as jax_nio2d
from blindno.eval.field_eval import predict_fields as jax_predict_fields
from blindno.nn import setops as jax_setops
from blindno_torch.convert import from_flax
from blindno_torch.eval.field_eval import predict_fields
from blindno_torch.models import nio2d
from blindno_torch.nn.setops import TokenMeanFusion
from blindno_torch.train.step import make_optimizer, train_step
from test_nio2d_torch_parity import _randomize_bn
from test_torch_amp import hold
from test_torch_train import BF16_TOL, _jax_stepper, _rel_l2

TOL = 2e-3  # the NIO parity bound, tests/test_nio2d_torch_parity.py:190
NX, L = 61, 4
SMALL = dict(width=6, modes=6, fno_layers=2)  # tests/test_models_2d.py:18
DEEPONET = dict(n_basis=5, neurons=16)        # tests/test_models_2d.py:28
MODELS = {  # name -> (JAX class, port class, config)
    "fno": (jax_nio2d.NIOFNO2D, nio2d.NIOFNO2D, SMALL),
    "attn": (jax_nio2d.NIOAttn2D, nio2d.NIOAttn2D, {**SMALL, **DEEPONET}),
    "fno_attn": (jax_nio2d.NIOFNOAttn2D, nio2d.NIOFNOAttn2D, SMALL),
}
CKPT = os.path.join(os.path.dirname(__file__), "..", "runs", "ckpt", "ncfpe2d_fno")


def _grid(n=NX):
    gx, gy = np.meshgrid(np.linspace(-1, 1, n), np.linspace(-1, 1, n), indexing="ij")
    return np.stack([gx, gy], 2).astype(np.float32)


def _sets(rng, b, l, n=NX):
    """Sets whose snapshots share a per-set profile, so that the sets' outputs differ."""
    return (rng.standard_normal((b, 1, n, n)) + 0.5 * rng.standard_normal((b, l, n, n))
            ).astype(np.float32)


def _port(name, variables, **kw):
    _, cls, cfg = MODELS[name]
    model = cls(**cfg, **kw, device="cpu")
    model.load_state_dict(from_flax(jax.tree.map(np.asarray, variables["params"]),
                                    jax.tree.map(np.asarray, variables.get("batch_stats", {}))))
    return model


# ------------------------------------------------------------------ the new set operations


@pytest.mark.parametrize("masked", [False, True])
def test_token_mean_fusion_matches_jax(masked):
    """The mean over all T tokens, the first two always valid and the mask over the rest;
    the weights frozen."""
    rng = np.random.default_rng(1)
    tokens = rng.standard_normal((2, 7, 5, 6)).astype(np.float32)
    mask = np.array([1, 0, 1, 1, 0], np.float32) if masked else None
    jmod = jax_setops.TokenMeanFusion(4, n_always=2)
    variables = jmod.init(jax.random.PRNGKey(0), jnp.asarray(tokens))
    want = np.asarray(jmod.apply(variables, jnp.asarray(tokens),
                                 None if mask is None else jnp.asarray(mask)))
    fusion = TokenMeanFusion(4, 2, torch.Generator())
    state = from_flax({"TokenMeanFusion_0": jax.tree.map(np.asarray, variables["params"])}, None)
    fusion.load_state_dict({k.removeprefix("fusion."): v for k, v in state.items()})
    assert not any(p.requires_grad for p in fusion.parameters())
    got = fusion(torch.tensor(tokens), None if mask is None else torch.tensor(mask))
    assert got.shape == (2, 5, 6, 4)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("masked", [False, True])
def test_token_attention_tokens_match_jax(masked):
    """The grid tokens before the fields, attention over all T = L + 2 tokens with the
    grid tokens' keys always valid. The fields are scaled so that the softmax
    saturates, as it does on raw DeepONet fields."""
    rng = np.random.default_rng(2)
    fields = (3.0 * rng.standard_normal((2, 5, 9, 8))).astype(np.float32)
    grid = _grid(9)[:, :8]
    mask = np.array([1, 1, 0, 1, 0], np.float32) if masked else None
    want, want_mask = jax_nio2d._token_attention_tokens(
        jnp.asarray(fields), jnp.asarray(grid), None if mask is None else jnp.asarray(mask))
    got, got_mask = nio2d._token_attention_tokens(
        torch.tensor(fields), torch.tensor(grid), None if mask is None else torch.tensor(mask))
    assert got.shape == (2, 7, 9, 8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    if masked:
        np.testing.assert_array_equal(got_mask.numpy(), np.asarray(want_mask))
    else:
        assert got_mask is None and want_mask is None


# ------------------------------------------------------------------ eval-mode models


@pytest.fixture(scope="module")
def small_flax():
    """Each small flax model with randomized BatchNorm, and a batch of 2 sets."""
    rng = np.random.default_rng(0)
    x, grid = _sets(rng, 2, L), _grid()
    out = {}
    for name, (jcls, _, cfg) in MODELS.items():
        jmodel = jcls(**cfg)
        variables = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(grid))
        out[name] = jmodel, _randomize_bn(variables, np.random.default_rng(7))
    return out, x, grid


# the module whose output is the per-snapshot fields, and the fusion, in each tree
BRANCH = {"fno": "FNO2d_0", "attn": "DeepOnetNoBias_0", "fno_attn": "FNO2d_0"}
FUSION = {"fno": "MeanFieldFusion_0", "attn": "MeanFieldFusion_0", "fno_attn": "TokenMeanFusion_0"}


@pytest.mark.parametrize("name", MODELS)
def test_small_model_matches_flax_and_is_permutation_invariant(small_flax, name):
    """Eval mode through ``predict_fields`` against the flax model (``jnp`` impl) within
    2e-3 of the output's scale, and invariant to a permutation of the set.

    The untrained models' outputs move little between sets (2.1e-5 at a scale of 0.036
    for ``NIOFNO2D`` on this host), less than that tolerance, so the branch's fields and
    the fusion's output, where the set enters, are each held to flax's within 2e-3 of
    their own scale as well (flax's ``capture_intermediates`` and torch forward hooks)."""
    models, x, grid = small_flax
    jmodel, variables = models[name]
    want, inter = jax.jit(lambda v, a, g: jmodel.apply(
        v, a, g, capture_intermediates=True, mutable=["intermediates"]))(
        variables, jnp.asarray(x), jnp.asarray(grid))
    want = np.asarray(want)
    model = _port(name, variables)
    seen = {}
    branch = model.deeponet if name == "attn" else model.branch
    branch.register_forward_hook(lambda m, a, out: seen.setdefault("fields", out))
    model.fusion.register_forward_hook(lambda m, a, out: seen.setdefault("fused", out))
    got = predict_fields(model, x, grid, batch=2, device="cpu")
    assert got.shape == want.shape == (2, NX, NX, 2)
    scale = np.abs(want).max()
    assert np.abs(want[0] - want[1]).max() > 1e-5 * scale
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL * scale)
    for part, key in (("fields", BRANCH[name]), ("fused", FUSION[name])):
        part_want = np.asarray(inter["intermediates"][key]["__call__"][0])
        part_got = seen[part].numpy().reshape(part_want.shape)
        np.testing.assert_allclose(part_got, part_want, rtol=TOL,
                                   atol=TOL * np.abs(part_want).max(), err_msg=part)
    perm = np.random.default_rng(1).permutation(L)
    permuted = predict_fields(model, x[:, perm], grid, batch=2, device="cpu")
    np.testing.assert_allclose(permuted, got, rtol=TOL, atol=1e-5 * scale)


def test_attention_models_keep_niofp2d_names_and_fno_models_their_own(small_flax):
    """``from_flax`` maps each tree onto its model with no key left over or missing:
    ``NIOAttn2D``'s tree is ``NIOFP2D``'s, the FNO-branch trees name ``FNO2d_0`` the
    branch (``TokenMeanFusion_0`` included); a stray leaf still raises."""
    models, _, _ = small_flax
    for name, (_, variables) in models.items():
        state = from_flax(jax.tree.map(np.asarray, variables["params"]),
                          jax.tree.map(np.asarray, variables.get("batch_stats", {})))
        _, cls, cfg = MODELS[name]
        want = cls(**cfg, device="cpu").state_dict()
        assert state.keys() == want.keys(), name
        assert all(state[k].shape == want[k].shape for k in want), name
    fno_attn = models["fno_attn"][1]["params"]
    assert {"FNO2d_0", "TokenMeanFusion_0"} <= fno_attn.keys()
    stray = jax.tree.map(np.asarray, dict(fno_attn))
    stray["TokenMeanFusion_0"] = {**stray["TokenMeanFusion_0"], "scale": np.ones(3)}
    with pytest.raises(KeyError, match="left over"):
        from_flax(stray, None)


def test_committed_ncfpe2d_fno_checkpoint_matches_jax_predict_fields():
    """The committed JAX-trained ncfpe2d FNO-branch NIO (width 12, 32 modes) through
    ``from_flax``, on 2 seeded 80x80 sets of 6 snapshots, against JAX's
    ``predict_fields``."""
    from blindno.train.checkpoint import load_best

    ckpt = load_best(CKPT)
    x, grid = _sets(np.random.default_rng(5), 2, 6, 80), _grid(80)
    want = jax_predict_fields(jax_nio2d.NIOFNO2D(width=12, modes=32), ckpt["params"],
                              ckpt["batch_stats"], x, grid, batch=2)
    model = nio2d.NIOFNO2D(width=12, modes=32, device="cpu")
    model.load_state_dict(from_flax(ckpt["params"], ckpt["batch_stats"]))
    got = predict_fields(model, x, grid, batch=2, device="cpu")
    assert got.shape == want.shape == (2, 80, 80, 2) and np.isfinite(got).all()
    scale = np.abs(want).max()
    assert np.abs(want[0] - want[1]).max() > 1e-3 * scale
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL * scale)


# ------------------------------------------------------------------ one train step

B, L_STEP, L_MIN = 2, 5, 2
ENCODER_GRAD_TOL = 1e-2  # relative L2, the Encoder2D's gradients (tests/test_torch_train.py)


@pytest.fixture(scope="module")
def step_case():
    """A batch of B sets of L_STEP snapshots, targets, and one injected subsample."""
    rng = np.random.default_rng(3)
    x, grid = _sets(rng, B, L_STEP), _grid()
    y = rng.standard_normal((B, NX, NX, 2)).astype(np.float32)
    draw = (rng.integers(0, L_STEP, L_STEP), (np.arange(L_STEP) < 3).astype(np.float32))
    return x, y, grid, draw


@pytest.mark.parametrize("name", MODELS)
def test_small_f32_step_matches_jax(small_flax, step_case, name, monkeypatch):
    """One float32 ``train_step`` against JAX's (value_and_grad of the MSE, optax Adam),
    the subsample injected on both sides: the loss, every gradient and every parameter
    and running statistic after the step within 2e-3, relative L2 (the Encoder2D's
    gradients within 1e-2, for the leaky-ReLU kinks ``tests/test_torch_train.py``
    describes). The frozen fusion gets no gradient and stays bit for bit what it was, on
    both sides. ``NIOAttn2D``'s encoder gradients pass through the frozen fusion's grid
    features and the attention, so they are held too."""
    x, y, grid, draw = step_case
    jcls, cls, cfg = MODELS[name]
    jmodel = jcls(**cfg, l_min=L_MIN)
    variables = jax.tree.map(np.asarray, small_flax[0][name][1])  # the eval tests' weights
    params, stats = variables["params"], variables.get("batch_stats", {})
    jloss, jgrads, (jparams, jstats, _) = _jax_stepper(jmodel, x, y, grid, monkeypatch)(
        (params, stats, None), draw)

    model = cls(**cfg, l_min=L_MIN, device="cpu")
    model.load_state_dict(from_flax(params, stats))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    loss = train_step(model.train(), make_optimizer(model), torch.tensor(x), torch.tensor(y),
                      torch.tensor(grid), subsample=draw)
    grads = {k: p.grad for k, p in model.named_parameters() if p.grad is not None}
    want_grads = from_flax(jgrads, None)
    frozen = want_grads.keys() - grads.keys()
    assert frozen == {"fusion.weight", "fusion.bias"}
    assert all(not want_grads[k].any() for k in frozen)
    state = {k: v for k, v in model.state_dict().items() if not k.endswith("num_batches_tracked")}
    want_state = from_flax(jparams, jstats)
    for k in frozen:
        assert torch.equal(state[k], before[k]) and torch.equal(want_state[k], before[k]), k
    zero = [k for k in grads if k.endswith("conv.bias")]  # a BatchNorm follows each conv
    errs = {"loss": abs(float(loss) - float(jloss)) / abs(float(jloss))}
    errs.update({k: _rel_l2(grads[k], want_grads[k]) for k in grads if k not in zero})
    errs.update({f"state {k}": _rel_l2(state[k], want_state[k]) for k in state
                 if k not in frozen})
    assert all(torch.isfinite(g).all() for g in grads.values())
    bad = {k: e for k, e in errs.items()
           if not e <= (ENCODER_GRAD_TOL if k.startswith("deeponet.branch.") else TOL)}
    assert not bad, bad
    if name == "attn":
        assert any(k.startswith("deeponet.branch.") for k in grads)


@pytest.mark.parametrize("name", MODELS)
def test_bfloat16_step_runs_only_with_an_encoder(small_flax, step_case, name, monkeypatch):
    """The bfloat16 step (``encoder_bn32``, ``train_step``'s default) of each model
    against JAX's (``amp_cast_fns(jnp.bfloat16, "encoder_bn32")``). It ran only for
    ``NIOAttn2D``, the model with an Encoder, until the port took JAX's casts: JAX casts
    the batch for every model, so the FNO-branch models (no leaf to cast under this
    policy) run on bfloat16-rounded snapshots that their float32 grid promotes. Every
    gradient float32 and finite, and held as ``tests/test_torch_amp.py:check_step``
    holds a step (its ``hold``): the loss and the gradients within BF16_TOL = 5e-2 of
    JAX's, relative L2 (measured: at most 2.2e-5 for the FNO-branch models), or for
    ``NIOAttn2D``'s trunk, whose gradients the token attention makes sensitive to the
    encoder's rounding on both sides, no further from the port's float32 step than 3x
    the larger of JAX's distance and BF16_TOL; the Encoder2D's gradients, chaotic in
    bfloat16 on both sides (``tests/test_torch_train.py``), by their mean distance."""
    x, y, grid, draw = step_case
    jcls, cls, cfg = MODELS[name]
    variables = jax.tree.map(np.asarray, small_flax[0][name][1])
    params, stats = variables["params"], variables.get("batch_stats", {})
    jloss, jgrads, _ = _jax_stepper(jcls(**cfg, l_min=L_MIN), x, y, grid, monkeypatch,
                                    jnp.bfloat16)((params, stats, None), draw)
    steps = []
    for compute_dtype in ("bfloat16", None):
        model = cls(**cfg, l_min=L_MIN, device="cpu")
        model.load_state_dict(from_flax(params, stats))
        with torch.backends.mkldnn.flags(enabled=False):  # tests/test_torch_train.py: oneDNN
            loss = float(train_step(model.train(), make_optimizer(model), torch.tensor(x),
                                    torch.tensor(y), torch.tensor(grid), subsample=draw,
                                    compute_dtype=compute_dtype))
        steps.append((loss, {k: p.grad for k, p in model.named_parameters() if p.grad is not None}))
    (loss, grads), (_, f32) = steps
    assert all(g.dtype == torch.float32 and torch.isfinite(g).all() for g in grads.values())
    want = from_flax(jgrads, None)
    errs = {"loss": abs(loss - float(jloss)) / abs(float(jloss))}
    errs.update({k: _rel_l2(g, want[k]) for k, g in grads.items()
                 if not k.endswith(".conv.bias")})  # zero but for rounding (a BatchNorm follows)
    hold(errs, grads, want, f32, BF16_TOL, lambda k: k.startswith("deeponet.branch."))
