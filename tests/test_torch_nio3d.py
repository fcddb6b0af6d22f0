"""The port's 3-D NIO against the JAX package on the CPU.

``spectral_conv3d`` (the truncated-DFT chain and its ``torch.fft`` restatement), the
``FNO3d`` head, the ``Encoder3D`` and ``Encoder3DDown`` branches and the whole
``NIOFP3D`` in eval mode are held against their flax counterparts, and one float32
training step of ``NIOFP3D`` against JAX's, as ``tests/test_torch_train.py`` holds the
2-D NIO's: the subsample injected on both sides, flax's BatchNorm given its two-pass
variance, every gradient, updated parameter and running statistic compared by relative
L2. The grids are 40 x 8 x 8 (``Encoder3D``'s last (2, 1, 1) kernel needs a depth of
33-64), the channels narrow; flax's variables are drawn from a numpy seed over
``jax.eval_shape`` of its init, which compiles nothing.
"""
import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import blindno.models.nio3d as jax_nio3d
from blindno.nn.cnn import Encoder3D as JEncoder3D
from blindno.nn.cnn import Encoder3DDown as JEncoder3DDown
from blindno.nn.fno import FNO3d as JFNO3d
from blindno.ops.spectral import spectral_conv3d as jax_spectral_conv3d
from blindno_torch.convert import from_flax
from blindno_torch.models.nio3d import NIOFP3D
from blindno_torch.nn.cnn import Encoder3D, Encoder3DDown
from blindno_torch.nn.fno import FNO3d
from blindno_torch.ops.spectral import spectral_conv3d, spectral_conv3d_fft
from blindno_torch.train.step import make_optimizer, train_step
from test_nio2d_torch_parity import _randomize_bn
from test_torch_train import ENCODER_GRAD_TOL, STEP_TOL, _TwoPassBatchNorm

SPATIAL = (40, 8, 8)
DIMS = (4, 6, 8, 8, 8)  # the encoders' five channel widths, narrowed
SMALL = dict(width=4, modes=3, n_basis=5, neurons=8, l_min=2)
B, L = 2, 3
TOL = 2e-3  # of the output's scale: the NIO parity bound, tests/test_nio2d_torch_parity.py:190


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def seeded_variables(jmodel, rng, *args):
    """flax variables of ``jmodel`` from a numpy seed, over ``jax.eval_shape`` of its
    init: kernels N(0, 1/fan_in), spectral planes U[0, 1)/(Cin Cout) as the layers draw
    them, other parameters N(0, 0.1^2) (LayerNorm scales 1 + that), and every BatchNorm
    randomized as the serving tests randomize it."""
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), *map(jnp.asarray, args))

    def draw(path, leaf):
        names = [getattr(p, "key", "") for p in path]
        name, shape = names[-1], leaf.shape
        if name == "kernel":
            a = rng.standard_normal(shape) / np.sqrt(np.prod(shape[:-1]))
        elif name in ("weights_re", "weights_im"):
            a = rng.random(shape) / (shape[0] * shape[1])
        else:
            a = 0.1 * rng.standard_normal(shape) + (name == "scale")
        return jnp.asarray(a, leaf.dtype)

    return _np(_randomize_bn(jax.tree_util.tree_map_with_path(draw, shapes),
                             np.random.default_rng(7)))


def sub_state(name, variables, prefix):
    """``from_flax`` of a module's own tree, as the submodule ``name`` of a model whose
    torch prefix for it is ``prefix``: the state dict of the module alone."""
    stats = variables.get("batch_stats")
    state = from_flax({name: variables["params"]}, {name: stats} if stats else {})
    return {k[len(prefix):]: v for k, v in state.items()}


def _scale_err(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _grid3():
    axes = [np.linspace(0.0, 1.0, n, dtype=np.float32) for n in SPATIAL]
    return np.stack(np.meshgrid(*axes, indexing="ij"), -1)


def test_spectral_conv3d_matches_jax_and_fft():
    """At ``tests/test_spectral.py:83``'s shape (2, 3, 20, 18, 16) with modes 5, 4, 4, the
    port's chain against JAX's and against its ``torch.fft`` restatement within 5e-4."""
    rng = np.random.default_rng(0)
    d1, d2, d3, m1, m2, m3 = 20, 18, 16, 5, 4, 4
    r = lambda *s: rng.standard_normal(s).astype(np.float32)
    x, wr, wi = r(2, 3, d1, d2, d3), r(3, 4, 2 * m1, 2 * m2, m3), r(3, 4, 2 * m1, 2 * m2, m3)
    got = spectral_conv3d(*map(torch.tensor, (x, wr, wi)))
    want = np.asarray(jax_spectral_conv3d(*map(jnp.asarray, (x, wr, wi))))
    fft = spectral_conv3d_fft(*map(torch.tensor, (x, wr, wi)))
    np.testing.assert_allclose(got.numpy(), want, rtol=5e-4, atol=5e-4)
    np.testing.assert_allclose(got.numpy(), fft.numpy(), rtol=5e-4, atol=5e-4)


def test_fno3d_matches_jax():
    """Four layers, padding 2 on the far side of each axis, the 128-wide projection."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, *SPATIAL, 4)).astype(np.float32)
    jmodel = JFNO3d(modes=3, width=5, input_dim=4, output_dim=2)
    variables = seeded_variables(jmodel, rng, x)
    model = FNO3d(3, 5, 4, 2)
    model.load_state_dict(sub_state("FNO3d_0", variables, "head."))
    want = jax.jit(jmodel.apply)(variables, jnp.asarray(x))
    with torch.no_grad():
        got = model(torch.tensor(x))
    assert got.shape == (2, *SPATIAL, 2)
    assert _scale_err(got, want) < TOL


@pytest.mark.parametrize("training", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("down", [False, True], ids=["Encoder3D", "Encoder3DDown"])
def test_encoder3d_matches_jax(down, training):
    """The ten blocks at narrow channels on 40 x 8 x 8 volumes, BatchNorm randomized (eval)
    or on batch statistics (train). ``Encoder3D`` collapses the grid to one point,
    ``Encoder3DDown`` leaves a (2, 1, 1) map, whose features ``fc`` takes in flax's
    channel-last order."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((B, L, *SPATIAL)).astype(np.float32)
    jcls, cls = (JEncoder3DDown, Encoder3DDown) if down else (JEncoder3D, Encoder3D)
    jmodel = jcls(7, *DIMS)
    variables = seeded_variables(jmodel, rng, x)
    model = cls(7, SPATIAL, DIMS).train(training)
    assert model.out_features == DIMS[-1] * (2 if down else 1)
    name = "Encoder3DDown_0" if down else "Encoder3D_0"
    model.load_state_dict(sub_state(name, variables, "deeponet.branch."))
    want = jmodel.apply(variables, jnp.asarray(x), training=training,
                        mutable=["batch_stats"] if training else False)
    with torch.no_grad():
        got = model(torch.tensor(x))
    assert _scale_err(got, want[0] if training else want) < TOL


def test_encoder3d_refuses_a_grid_its_schedule_does_not_fit():
    with pytest.raises(ValueError, match="leaves no point"):
        Encoder3D(5, (30, 8, 8), DIMS)  # the (2, 1, 1) kernel meets a depth of 1
    model = Encoder3D(5, SPATIAL, DIMS).eval()
    with pytest.raises(ValueError, match="features"):
        model(torch.zeros(1, 1, 40, 80, 80))  # leaves a (1, 2, 2) map


def _jax_nio3d(monkeypatch):
    """JAX's NIOFP3D with its Encoder3D narrowed to DIMS (the model builds the encoder at
    its default widths; flax names the submodule after its class all the same)."""
    monkeypatch.setattr(jax_nio3d, "Encoder3D", lambda n: JEncoder3D(n, *DIMS))
    return jax_nio3d.NIOFP3D(**SMALL, out_dim=2)


def _port_nio3d():
    return NIOFP3D(**SMALL, out_dim=2, input_size=SPATIAL, encoder_dims=DIMS, device="cpu")


def test_niofp3d_eval_matches_jax(monkeypatch):
    """Eval mode with randomized BatchNorm statistics: the encoder, the trunk over the
    flattened volume, the fusion with 3 grid channels and the FNO3d head, within 2e-3 of
    the output's scale."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((B, L, *SPATIAL)).astype(np.float32)
    grid = _grid3()
    jmodel = _jax_nio3d(monkeypatch)
    variables = seeded_variables(jmodel, rng, x, grid)
    model = _port_nio3d()
    model.load_state_dict(from_flax(variables["params"], variables["batch_stats"]))
    want = jax.jit(jmodel.apply)(variables, jnp.asarray(x), jnp.asarray(grid))
    with torch.no_grad():
        got = model(torch.tensor(x), torch.tensor(grid))
    assert got.shape == (B, *SPATIAL, 2)
    assert _scale_err(got, want) < TOL


def test_niofp3d_f32_step_matches_jax(monkeypatch):
    """One float32 step, the subsample injected on both sides: the loss, every gradient,
    every updated parameter and running statistic within STEP_TOL = 2e-3 (relative L2),
    the encoder's gradients and parameters within ENCODER_GRAD_TOL = 1e-2 (ten leaky
    ReLU kinks lie below them, ``tests/test_torch_train.py``). The frozen fusion has no
    gradient; the conv biases before a BatchNorm have gradients zero but for rounding
    (below 1e-6 of the largest) on both sides."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((B, L, *SPATIAL)).astype(np.float32)
    y = rng.standard_normal((B, *SPATIAL, 2)).astype(np.float32)
    grid = _grid3()
    draw = (rng.integers(0, L, L), (np.arange(L) < 2).astype(np.float32))
    jmodel = _jax_nio3d(monkeypatch)
    variables = seeded_variables(jmodel, rng, x, grid)
    monkeypatch.setattr(jax_nio3d, "subsample_set", lambda key, xx, l_min, training: (
        jnp.take(xx, jnp.asarray(draw[0]), axis=1), jnp.asarray(draw[1], xx.dtype)))
    monkeypatch.setattr(flax.linen, "BatchNorm", _TwoPassBatchNorm)
    tx = optax.adam(5e-4)
    params, stats = variables["params"], variables["batch_stats"]

    def loss_fn(p):
        out, upd = jmodel.apply({"params": p, "batch_stats": stats}, jnp.asarray(x),
                                jnp.asarray(grid), training=True,
                                rngs={"sample": jax.random.PRNGKey(0)}, mutable=["batch_stats"])
        return jnp.mean((out - y) ** 2), upd["batch_stats"]

    (jloss, jstats), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    updates, _ = tx.update(jgrads, tx.init(params), params)
    jparams = optax.apply_updates(params, updates)

    model = _port_nio3d()
    model.load_state_dict(from_flax(params, stats))
    model.train()
    loss = train_step(model, make_optimizer(model), torch.tensor(x), torch.tensor(y),
                      torch.tensor(grid), subsample=draw)
    grads = {k: p.grad for k, p in model.named_parameters() if p.grad is not None}
    want_grads = from_flax(_np(jgrads), None)
    assert want_grads.keys() - grads.keys() == {"fusion.weight", "fusion.bias"}
    top = max(float(g.abs().max()) for g in want_grads.values())
    zero = {k for k in grads if k.endswith("conv.bias")}
    assert all(g.abs().max() < 1e-6 * top for k in zero for g in (grads[k], want_grads[k]))
    want_state = {k: v for k, v in from_flax(_np(jparams), _np(jstats)).items()
                  if not k.endswith("num_batches_tracked")}
    rel = lambda a, b: float((a - b).norm() / b.norm())
    errs = {"loss": abs(float(loss) - float(jloss)) / abs(float(jloss))}
    errs.update({k: rel(grads[k], want_grads[k]) for k in grads.keys() - zero})
    errs.update({f"state {k}": rel(model.state_dict()[k], v) for k, v in want_state.items()
                 if k not in zero})
    assert any("running_var" in k for k in errs) and any(k.startswith("head.") for k in errs)
    tol = lambda k: (ENCODER_GRAD_TOL if k.removeprefix("state ").startswith("deeponet.branch.")
                     and "running_" not in k else STEP_TOL)
    bad = {k: e for k, e in errs.items() if not e <= tol(k)}
    assert not bad, bad
