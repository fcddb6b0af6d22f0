"""The port's Transolver and Transolver NIOs against the flax modules on the CPU.

``PhysicsAttention`` (both mesh forms), ``Transolver`` (the NIOs' call and the
placeholder, time and unified-position variants), the embeddings, and small
``NIOTrans2D`` and ``NIOTransAttn2D`` (13x13 grid, hidden 8, 2 layers), each against its
JAX counterpart on the same numpy-seeded inputs with weights moved by
``blindno_torch.convert.from_flax``; the weights are drawn at random (flax's init leaves
the slice attention's output near 1e-4, where a fault would hide). Then one float32
train step of each NIO against JAX's with an injected set subsample (as
``tests/test_torch_train.py`` does), and the CLI's ``--model trans`` and ``trans_attn``
train, eval and time-error stages on a tiny archive. One torch thread, as in
``tests/test_torch_suites1d.py``.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import blindno.models.nio2d as jax_nio2d
import blindno_torch.suites.registry as registry
from blindno.nn import embedding as jax_embedding
from blindno.nn import transolver as jax_transolver
from blindno_torch.convert import from_flax
from blindno_torch.eval.field_eval import predict_fields
from blindno_torch.models import nio2d
from blindno_torch.nn import embedding
from blindno_torch.nn.transolver import PhysicsAttention, Transolver
from blindno_torch.suites.run import main
from blindno_torch.train.step import make_optimizer, train_step
from test_torch_loop import fpe2d_archive
from test_torch_train import _jax_stepper, _rel_l2

ATTN_TOL = 2e-4  # tests/test_transolver_parity.py:52
TOL = 2e-3       # the NIO parity bound, tests/test_nio2d_torch_parity.py:190
NX, L = 13, 3
SMALL = dict(width=6, modes=4, fno_layers=2, trans_layers=2, trans_hidden=8, trans_heads=2,
             slice_num=4)
MODELS = {"trans": (jax_nio2d.NIOTrans2D, nio2d.NIOTrans2D),
          "trans_attn": (jax_nio2d.NIOTransAttn2D, nio2d.NIOTransAttn2D)}


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _grid(n=NX):
    gx, gy = np.meshgrid(np.linspace(-1, 1, n), np.linspace(-1, 1, n), indexing="ij")
    return np.stack([gx, gy], 2).astype(np.float32)


def _randomized(tree, rng):
    """Every leaf of a parameter tree (arrays or ``jax.eval_shape``'s shapes, which spare
    compiling flax's init) drawn anew: kernels ~ N(0, 1/fan_in), LayerNorm scales ~
    U(0.6, 1.4), temperatures ~ U(0.3, 1), every other leaf ~ N(0, 0.1)."""
    def draw(path, leaf):
        name = path[-1].key
        shape = tuple(leaf.shape)
        if name == "temperature":
            return rng.uniform(0.3, 1.0, shape).astype(np.float32)
        if name == "scale":
            return rng.uniform(0.6, 1.4, shape).astype(np.float32)
        if name == "kernel":
            return (rng.standard_normal(shape) / np.sqrt(np.prod(shape[:-1]))).astype(np.float32)
        return (0.1 * rng.standard_normal(shape)).astype(np.float32)
    return jax.tree_util.tree_map_with_path(draw, tree)


def _sub_state(state, prefix):
    return {k[len(prefix):]: v for k, v in state.items() if k.startswith(prefix)}


# ------------------------------------------------------------------ modules


@pytest.mark.parametrize("mesh", [None, (8, 8)], ids=["irregular", "structured"])
def test_physics_attention_matches_flax(mesh):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 64, 16)).astype(np.float32)
    jmod = jax_transolver.PhysicsAttention(dim=16, heads=4, dim_head=4, slice_num=6,
                                           mesh_shape=mesh)
    params = _randomized(jax.eval_shape(jmod.init, jax.random.PRNGKey(0), jnp.asarray(x))["params"],
                         rng)
    want = np.asarray(jmod.apply({"params": params}, jnp.asarray(x)))
    state = from_flax({"Transolver_0": {"TransolverBlock_0": {"PhysicsAttention_0": params}}},
                      None)
    attn = PhysicsAttention(16, 4, 4, 6, None if mesh is None else 2,
                            generator=torch.Generator())
    attn.load_state_dict(_sub_state(state, "trans.blocks.0.attn."))
    got = attn(torch.tensor(x), mesh).detach().numpy()
    assert np.abs(want).max() > 0.1
    np.testing.assert_allclose(got, want, rtol=ATTN_TOL, atol=ATTN_TOL)


# (name, Transolver keywords, widths of x and fx, time given): the NIOs' call (values as
# x, grid as fx, a structured mesh); no fx (the placeholder) with time conditioning;
# unified positions in place of x; an irregular mesh
TRANSOLVERS = [
    ("nio_call", dict(fun_dim=1, mesh=(7, 9)), (1, 2), False),
    ("placeholder_time", dict(fun_dim=0, mesh=(7, 9), time_input=True), (2, 0), True),
    ("unified_pos", dict(fun_dim=1, mesh=(7, 9), unified_pos=True, ref=4), (2, 1), False),
    ("irregular", dict(fun_dim=1, mesh=None), (1, 2), False),
]


@pytest.mark.parametrize("name,kw,widths,with_t", TRANSOLVERS, ids=[t[0] for t in TRANSOLVERS])
def test_transolver_matches_flax(name, kw, widths, with_t):
    rng = np.random.default_rng(1)
    kw = dict(kw)
    mesh = kw.pop("mesh")
    n, with_fx = 63, widths[1] > 0
    x = rng.standard_normal((2, n, widths[0])).astype(np.float32)
    fx = rng.standard_normal((2, n, widths[1])).astype(np.float32) if with_fx else None
    t = np.array([0.3, 2.0], np.float32) if with_t else None
    cfg = dict(n_layers=2, n_hidden=8, n_head=2, slice_num=4, **kw)
    jmod = jax_transolver.Transolver(mesh_shape=mesh, **cfg)
    args = [jnp.asarray(a) if a is not None else None for a in (x, fx, t)]
    params = _randomized(jax.eval_shape(jmod.init, jax.random.PRNGKey(0), *args)["params"], rng)
    want = np.asarray(jmod.apply({"params": params}, *args))
    model = Transolver(mesh_ndim=None if mesh is None else 2, generator=torch.Generator(),
                       **cfg)
    model.load_state_dict(_sub_state(from_flax({"Transolver_0": params}, None), "trans."))
    targs = [torch.tensor(a) if a is not None else None for a in (x, fx, t)]
    got = model(*targs, mesh_shape=mesh).detach().numpy()
    assert got.shape == want.shape == (2, n, 1)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL * scale)
    with pytest.raises(ValueError, match="fx"):
        model(targs[0], None if with_fx else targs[0], mesh_shape=mesh)


def test_embeddings_match_jax():
    t = np.array([0.0, 1.5, 40.0], np.float32)
    for dim in (8, 9):
        np.testing.assert_allclose(embedding.timestep_embedding(torch.tensor(t), dim).numpy(),
                                   np.asarray(jax_embedding.timestep_embedding(jnp.asarray(t), dim)),
                                   rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(embedding.sinusoidal_position_encoding(12, 8).numpy(),
                               np.asarray(jax_embedding.sinusoidal_position_encoding(12, 8)),
                               rtol=1e-5, atol=1e-5)
    x = np.random.default_rng(2).standard_normal((2, 7, 9)).astype(np.float32)
    np.testing.assert_allclose(embedding.rotary_embedding(torch.tensor(x)).numpy(),
                               np.asarray(jax_embedding.rotary_embedding(jnp.asarray(x))),
                               rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------------ the NIOs


def _sets(rng, b, l, n=NX):
    return (rng.standard_normal((b, 1, n, n)) + 0.5 * rng.standard_normal((b, l, n, n))
            ).astype(np.float32)


@pytest.fixture(scope="module")
def small_flax():
    """Each small flax NIO with all its weights drawn at random, and a batch."""
    rng = np.random.default_rng(0)
    x, grid = _sets(rng, 2, L), _grid()
    out = {}
    for name, (jcls, _) in MODELS.items():
        jmodel = jcls(**SMALL)
        shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), jnp.asarray(x),
                                jnp.asarray(grid))["params"]
        out[name] = jmodel, _randomized(shapes, np.random.default_rng(4))
    return out, x, grid


def _port(name, params, **kw):
    model = MODELS[name][1](**SMALL, **kw, device="cpu")
    model.load_state_dict(from_flax(params, {}))
    return model


@pytest.mark.parametrize("name", MODELS)
def test_small_nio_matches_flax(small_flax, name):
    """Eval mode through ``predict_fields`` against flax within 2e-3 of the output's
    scale; the Transolver's per-snapshot fields too, and the set's order does not
    matter."""
    models, x, grid = small_flax
    jmodel, params = models[name]
    want, inter = jmodel.apply({"params": params}, jnp.asarray(x), jnp.asarray(grid),
                               capture_intermediates=True, mutable=["intermediates"])
    want = np.asarray(want)
    model = _port(name, params)
    seen = {}
    model.trans.register_forward_hook(lambda m, a, out: seen.setdefault("fields", out))
    got = predict_fields(model, x, grid, batch=2, device="cpu")
    assert got.shape == want.shape == (2, NX, NX, 2)
    scale = np.abs(want).max()
    assert np.abs(want[0] - want[1]).max() > 1e-3 * scale
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL * scale)
    fields_want = np.asarray(inter["intermediates"]["Transolver_0"]["__call__"][0])
    fields = seen["fields"].numpy().reshape(fields_want.shape)
    np.testing.assert_allclose(fields, fields_want, rtol=TOL,
                               atol=TOL * np.abs(fields_want).max())
    perm = np.random.default_rng(1).permutation(L)
    np.testing.assert_allclose(predict_fields(model, x[:, perm], grid, batch=2, device="cpu"),
                               got, rtol=TOL, atol=1e-5 * scale)


def test_transolver_trees_map_onto_the_models(small_flax):
    """``from_flax`` maps both trees with no key left over or missing: the FNO heads stay
    ``heads.0/1`` beside ``MeanFieldFusion_0`` (no FNO branch), q, k and v have no
    bias."""
    models, _, _ = small_flax
    for name, (_, params) in models.items():
        state = from_flax(params, {})
        want = MODELS[name][1](**SMALL, device="cpu").state_dict()
        assert state.keys() == want.keys(), name
        assert all(state[k].shape == want[k].shape for k in want), name
        assert "trans.blocks.0.attn.dense.1.bias" not in state
        assert {"heads.0.fc0.weight", "heads.1.fc0.weight"} <= state.keys()


B, L_STEP, L_MIN = 2, 5, 2


@pytest.mark.parametrize("name", MODELS)
def test_small_f32_step_matches_jax(small_flax, name, monkeypatch):
    """One float32 ``train_step`` against JAX's (value_and_grad of the MSE, optax Adam)
    with the subsample injected on both sides: the loss, every gradient and every
    parameter after the step within 2e-3, relative L2; the frozen fusion untouched."""
    rng = np.random.default_rng(3)
    x, grid = _sets(rng, B, L_STEP), _grid()
    y = rng.standard_normal((B, NX, NX, 2)).astype(np.float32)
    draw = (rng.integers(0, L_STEP, L_STEP), (np.arange(L_STEP) < 3).astype(np.float32))
    jcls, cls = MODELS[name]
    params = small_flax[0][name][1]
    jloss, jgrads, (jparams, _, _) = _jax_stepper(jcls(**SMALL, l_min=L_MIN), x, y, grid,
                                                  monkeypatch)((params, {}, None), draw)
    model = _port(name, params, l_min=L_MIN)
    loss = train_step(model.train(), make_optimizer(model), torch.tensor(x), torch.tensor(y),
                      torch.tensor(grid), subsample=draw)
    grads = {k: p.grad for k, p in model.named_parameters() if p.grad is not None}
    want_grads = from_flax(jgrads, None)
    assert want_grads.keys() - grads.keys() == {"fusion.weight", "fusion.bias"}
    state = model.state_dict()
    want_state = from_flax(jparams, {})
    errs = {"loss": abs(float(loss) - float(jloss)) / abs(float(jloss))}
    errs.update({k: _rel_l2(grads[k], want_grads[k]) for k in grads})
    errs.update({f"state {k}": _rel_l2(state[k], want_state[k]) for k in state})
    assert all(torch.isfinite(g).all() for g in grads.values())
    assert any(k.startswith("trans.blocks.") for k in grads)
    bad = {k: e for k, e in errs.items() if not e <= TOL}
    assert not bad, bad


# ------------------------------------------------------------------ the CLI

M_TRAIN, M_TEST = 20, 3  # 16 train sets: one batch of the suite's 16


@pytest.mark.parametrize("model", MODELS)
def test_cli_trains_evaluates_and_rolls_out(model, tmp_path, monkeypatch):
    """``--suite fpe2d --model trans|trans_attn``: train an epoch, eval, then the
    time-error stage on one sample, with a small Transolver NIO put in the registry (the
    suite's full config takes minutes on the CPU) and the stage's rollouts on every
    fourth cell of the grid, 16x16, at 20 time points (a 3721-cell propagator takes
    seconds to build on one CPU thread)."""
    from blindno_torch.eval import time_error

    w = str(tmp_path)
    os.makedirs(os.path.join(w, "data"))
    np.savez(os.path.join(w, "data", "fpe2d_train.npz"), **fpe2d_archive(M_TRAIN, 4, 61, 1))
    np.savez(os.path.join(w, "data", "fpe2d_test.npz"), **fpe2d_archive(M_TEST, 4, 61, 2))
    spec = registry.SUITES["fpe2d"]
    small = {k: v for k, v in SMALL.items() if k != "fno_layers"}
    monkeypatch.setitem(registry.SUITES, "fpe2d", dataclasses.replace(spec, models={
        model: lambda **kw: MODELS[model][1](**small, fno_layers=1, l_min=L_MIN, **kw)}))
    rollout = time_error.fpe2d_rollout_error
    monkeypatch.setattr(time_error, "fpe2d_rollout_error", lambda *fields, **kw: rollout(
        *(f[:, ::4, ::4] for f in fields), extent=(155e-9, 155e-9), nsteps=20, **kw))
    argv = ["--suite", "fpe2d", "--model", model, "--workdir", w, "--device", "cpu"]
    res = main(argv + ["--stage", "train", "--epochs", "1"])
    assert res.finished and np.isfinite(res.history[0]["train_loss"])
    report = main(argv + ["--stage", "eval"])
    assert report["n_test"] == M_TEST and np.isfinite(report["mean_rel_l2_sum_tta"])
    preds = np.load(os.path.join(w, "eval", f"fpe2d_{model}", "predictions.npy"))
    assert preds.shape == (M_TEST, 61, 61, 2) and np.isfinite(preds).all()
    terr = main(argv + ["--stage", "time-error", "--m", "1"])
    assert terr["num_samples"] == 1 and terr["model"] == model
    assert np.isfinite(terr["mean_err_l2"]) and terr["mean_err_l2"] > 0
    assert os.path.exists(os.path.join(w, "eval", f"fpe2d_{model}", "time_error.json"))
