"""The constructor fields of the JAX modules that the port once hard-coded, each at a
value other than its default against flax on the CPU.

- ``head_dims`` of the six 2-D NIOs, at (2, 1): heads of any output width, concatenated;
- ``input_dimensions_trunk`` and ``n_hidden_layers`` of ``NIOFP2D`` and ``NIOAttn2D``;
- ``padding_frac`` of ``FNO1d`` and ``FNO2d`` and of the models that build them, at 0.5,
  and of ``NIOFP2D`` at 2.0;
- ``trainable`` of ``MeanFieldFusion`` and ``TokenMeanFusion``: the fusion takes
  gradients, joins ``make_optimizer``'s Adam, and a step moves it as JAX's step does;
- ``dims`` of ``Encoder1D`` and ``Encoder2D`` (JAX's ``dim1``-``dim5``), narrowed.

Each model is held in eval mode (randomized BatchNorm statistics) within 2e-3 of the
output's scale, the NIO parity bound (``tests/test_nio2d_torch_parity.py:190``), after
``from_flax`` of flax's tree, and ``to_flax`` of its state dict gives that tree back bit
for bit. Weights are drawn from a numpy seed over ``jax.eval_shape``
(``tests/test_torch_nio3d.py``), so no flax init is compiled. JAX's models build their
FNOs, fusions and encoders with the defaults; a field is set there by handing the model's
module a partial of the class (flax names a submodule after its class all the same).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import blindno.models.nio1d as jax_nio1d
import blindno.models.nio2d as jax_nio2d
from blindno.nn import cnn as jax_cnn
from blindno.nn import fno as jax_fno
from blindno.nn import setops as jax_setops
from blindno_torch.convert import from_flax, to_flax
from blindno_torch.models import nio1d, nio2d
from blindno_torch.nn.cnn import Encoder1D, Encoder2D
from blindno_torch.nn.fno import FNO1d, FNO2d
from blindno_torch.nn.setops import MeanFieldFusion, TokenMeanFusion
from blindno_torch.train.step import make_optimizer, train_step
from test_torch_nio3d import seeded_variables, sub_state
from test_torch_train import STEP_TOL, _jax_stepper, _rel_l2

TOL = 2e-3  # of the output's scale
NX, B, L = 13, 2, 3
S2 = dict(width=4, modes=3, fno_layers=2)
TRANS = dict(trans_layers=1, trans_hidden=8, trans_heads=2, slice_num=4)
FP2 = dict(n_basis=5, neurons=8)
DIMS2, DIMS1 = (8, 12, 16, 16, 16), (8, 12, 16)  # the narrowed encoders' widths


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _grid(*spatial):
    if len(spatial) == 1:
        return np.linspace(0, 1, spatial[0], dtype=np.float32).reshape(-1, 1)
    axes = [np.linspace(-1, 1, n, dtype=np.float32) for n in spatial]
    return np.stack(np.meshgrid(*axes, indexing="ij"), -1)


def _sets(rng, *spatial):
    return (rng.standard_normal((B, 1, *spatial)) + 0.5 * rng.standard_normal((B, L, *spatial))
            ).astype(np.float32)


def _scale_err(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _round_trip(model, variables):
    """``to_flax`` of the model's state dict is flax's tree, bit for bit."""
    params, stats = to_flax(model.state_dict())
    want = (variables["params"], variables.get("batch_stats", {}))
    assert jax.tree.structure((params, stats)) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves((params, stats)), jax.tree.leaves(want)):
        assert a.shape == b.shape and np.array_equal(a, np.asarray(b))


def _held(jmodel, model, x, grid, seed=0):
    """Seeded flax variables through ``from_flax`` into ``model``; eval mode against
    flax, then the round trip. Returns the variables."""
    variables = seeded_variables(jmodel, np.random.default_rng(seed), x, grid)
    model.load_state_dict(from_flax(variables["params"], variables.get("batch_stats", {})))
    want = jax.jit(jmodel.apply)(variables, jnp.asarray(x), jnp.asarray(grid))
    with torch.no_grad():
        got = model.eval()(torch.tensor(x), torch.tensor(grid))
    assert got.shape == want.shape
    assert _scale_err(got, want) < TOL
    _round_trip(model, variables)
    return variables


def _narrow_encoder2d(monkeypatch):
    monkeypatch.setattr(jax_nio2d, "Encoder2D", lambda n, fk: jax_cnn.Encoder2D(n, fk, *DIMS2))
    return lambda model: setattr(model.deeponet, "branch", Encoder2D(FP2["n_basis"], dims=DIMS2))


# name -> (JAX class, port class, config, spatial size)
HEAD_MODELS = {
    "nio": (jax_nio2d.NIOFP2D, nio2d.NIOFP2D, {**S2, **FP2}, (61, 61)),
    "attn": (jax_nio2d.NIOAttn2D, nio2d.NIOAttn2D, {**S2, **FP2}, (61, 61)),
    "fno": (jax_nio2d.NIOFNO2D, nio2d.NIOFNO2D, dict(S2, inner_modes=3), (NX, NX)),
    "fno_attn": (jax_nio2d.NIOFNOAttn2D, nio2d.NIOFNOAttn2D, dict(S2, inner_modes=3), (NX, NX)),
    "trans": (jax_nio2d.NIOTrans2D, nio2d.NIOTrans2D, {**S2, **TRANS}, (9, 9)),
    "trans_attn": (jax_nio2d.NIOTransAttn2D, nio2d.NIOTransAttn2D, {**S2, **TRANS}, (9, 9)),
}


@pytest.mark.parametrize("name", HEAD_MODELS)
def test_head_dims_of_the_2d_nios(name, monkeypatch):
    """``head_dims=(2, 1)``: a two-channel head and a one-channel one, concatenated as
    JAX's ``_heads`` does, output (B, Nx, Ny, 3). The DeepONet models take the narrowed
    Encoder2D on both sides (their 61x61 grid collapses only under its schedule)."""
    jcls, cls, cfg, spatial = HEAD_MODELS[name]
    rng = np.random.default_rng(1)
    x, grid = _sets(rng, *spatial), _grid(*spatial)
    model = cls(**cfg, head_dims=(2, 1), device="cpu")
    if name in ("nio", "attn"):
        _narrow_encoder2d(monkeypatch)(model)
    assert [h.fc2.out_features for h in model.heads] == [2, 1]
    _held(jcls(**cfg, head_dims=(2, 1)), model, x, grid)


@pytest.mark.parametrize("name", ["nio", "attn"])
def test_trunk_fields_and_narrowed_encoder2d(name, monkeypatch):
    """``NIOFP2D`` and ``NIOAttn2D`` with ``n_hidden_layers=2`` (one hidden BatchNorm)
    and ``input_dimensions_trunk=3``, which JAX's ``FFN`` takes and does not use (its
    Dense layers take the grid's two coordinates), and the Encoder2D at ``dims`` DIMS2
    (JAX's ``dim1``-``dim5``), whose ``fc`` then takes DIMS2[4] in-features."""
    jcls, cls, cfg, spatial = HEAD_MODELS[name]
    fields = dict(input_dimensions_trunk=3, n_hidden_layers=2)
    rng = np.random.default_rng(2)
    x, grid = _sets(rng, *spatial), _grid(*spatial)
    model = cls(**cfg, **fields, device="cpu")
    _narrow_encoder2d(monkeypatch)(model)
    assert len(model.deeponet.trunk.layers) == 3 and len(model.deeponet.trunk.norms) == 1
    assert model.deeponet.branch.fc.in_features == DIMS2[4]
    _held(jcls(**cfg, **fields), model, x, grid)


def test_narrowed_encoder1d(monkeypatch):
    """``NIOFP1D`` with its Encoder1D at ``dims`` DIMS1 (JAX's ``dim1``-``dim3``) on 80
    points, which the FPE schedule collapses to DIMS1[2] features."""
    monkeypatch.setattr(jax_nio1d, "Encoder1D", lambda n, fc: jax_cnn.Encoder1D(n, fc, *DIMS1))
    cfg = dict(width=4, modes=4, fno_layers=2, **FP2)
    rng = np.random.default_rng(3)
    x, grid = _sets(rng, 80), _grid(80)
    model = nio1d.NIOFP1D(**cfg, device="cpu")
    model.deeponet.branch = Encoder1D(FP2["n_basis"], dims=DIMS1)
    assert model.deeponet.branch.fc.in_features == DIMS1[2]
    _held(jax_nio1d.NIOFP1D(**cfg), model, x, grid)


@pytest.mark.parametrize("dim", [1, 2])
def test_padding_frac_of_the_fnos(dim):
    """``FNO1d`` and ``FNO2d`` at ``padding_frac=0.5``: the lifted field is padded by
    round(n / 2) (Python's rounding, as JAX's) at the far end of each axis, 7 -> 11 and
    9 -> 13 points here."""
    rng = np.random.default_rng(4)
    spatial = (7,) if dim == 1 else (7, 9)
    x = rng.standard_normal((2, *spatial, 3)).astype(np.float32)
    jcls, cls = (jax_fno.FNO1d, FNO1d) if dim == 1 else (jax_fno.FNO2d, FNO2d)
    jmodel = jcls(modes=3, width=4, n_layers=2, input_dim=3, output_dim=2, padding_frac=0.5)
    variables = seeded_variables(jmodel, rng, x)
    model = cls(3, 4, 2, 3, 2, padding_frac=0.5)
    model.load_state_dict(sub_state(f"FNO{dim}d_0", variables, "heads.0."))
    assert model.lift(torch.tensor(x)).shape[2:] == ((11,) if dim == 1 else (11, 13))
    want = jax.jit(jmodel.apply)(variables, jnp.asarray(x))
    with torch.no_grad():
        got = model(torch.tensor(x))
    assert _scale_err(got, want) < TOL


@pytest.mark.parametrize("name,frac", [("fno", 0.5), ("trans", 0.5), ("nio", 2.0)],
                         ids=["fno", "trans", "nio-2.0"])
def test_padding_frac_of_the_models(name, frac, monkeypatch):
    """A model at ``padding_frac`` ``frac`` against JAX's with its FNO2d given the same
    (``NIOFNO2D``: the branch and the heads; ``NIOTrans2D`` and ``NIOFP2D``: the heads).
    ``NIOFP2D`` at 2.0, with the narrowed Encoder2D, pads its 61x61 grid to 183x183: a
    grid that the CUDA kernel takes in its tiled layout."""
    monkeypatch.setattr(jax_nio2d, "FNO2d", functools.partial(jax_fno.FNO2d, padding_frac=frac))
    jcls, cls, cfg, spatial = HEAD_MODELS[name]
    rng = np.random.default_rng(5)
    x, grid = _sets(rng, *spatial), _grid(*spatial)
    model = cls(**cfg, padding_frac=frac, device="cpu")
    if name == "nio":
        _narrow_encoder2d(monkeypatch)(model)
    assert {m.padding_frac for m in model.modules() if isinstance(m, FNO2d)} == {frac}
    _held(jcls(**cfg), model, x, grid)


@pytest.mark.parametrize("name", ["fno", "fno_attn"])
def test_trainable_fusions(name, monkeypatch):
    """``trainable=True`` in ``MeanFieldFusion`` (``NIOFNO2D``) and ``TokenMeanFusion``
    (``NIOFNOAttn2D``): the fusion's weight and bias take gradients and join
    ``make_optimizer``'s Adam; one float32 step from the same weights and draw gives the
    fusion's gradients within STEP_TOL = 2e-3 of JAX's (relative L2, as
    ``tests/test_torch_nio2d_models.py`` holds these models' steps), and moves it."""
    jfusion = "MeanFieldFusion" if name == "fno" else "TokenMeanFusion"
    monkeypatch.setattr(jax_nio2d, jfusion,
                        functools.partial(getattr(jax_setops, jfusion), trainable=True))
    jcls, cls, cfg, spatial = HEAD_MODELS[name]
    rng = np.random.default_rng(6)
    x, grid = _sets(rng, *spatial), _grid(*spatial)
    y = rng.standard_normal((B, *spatial, 2)).astype(np.float32)
    draw = (rng.integers(0, L, L), (np.arange(L) < 2).astype(np.float32))
    model = cls(**cfg, l_min=2, device="cpu")
    model.fusion = (MeanFieldFusion(cfg["width"], 2, torch.Generator(), trainable=True)
                    if name == "fno" else TokenMeanFusion(cfg["width"], 2, torch.Generator(),
                                                          trainable=True))
    jmodel = jcls(**cfg, l_min=2)
    variables = _held(jmodel, model, x, grid)
    opt = make_optimizer(model)
    assert {id(model.fusion.weight), id(model.fusion.bias)} <= {
        id(p) for group in opt.param_groups for p in group["params"]}
    before = model.fusion.weight.detach().clone()
    params, stats = variables["params"], variables.get("batch_stats", {})
    jloss, jgrads, _ = _jax_stepper(jmodel, x, y, grid, monkeypatch)((params, stats, None), draw)
    loss = train_step(model.train(), opt, torch.tensor(x), torch.tensor(y), torch.tensor(grid),
                      subsample=draw)
    want = from_flax(jgrads, None)
    assert abs(float(loss) - float(jloss)) <= STEP_TOL * abs(float(jloss))
    for k in ("fusion.weight", "fusion.bias"):
        assert want[k].any() and _rel_l2(dict(model.named_parameters())[k].grad, want[k]) <= STEP_TOL
    assert not torch.equal(model.fusion.weight, before)
