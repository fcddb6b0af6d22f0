"""The port's data- and tensor-parallel training (``blindno_torch.parallel``) against the
JAX package on the CPU, over gloo ranks.

JAX runs one program on a ``(data, model)`` mesh and its DP x TP step equals its
single-device step (``tests/test_parallel.py``, ``tests/test_multichip_entry.py``), so
each JAX reference here runs on one device. The port's ranks are spawned worker
processes (``RankPool``; each on one torch thread, a ``file://`` store, every run joined
with a timeout) whose functions live in ``blindno_torch.parallel.dryrun``: a spawned
rank imports the module of its function again, and this module imports JAX. Inputs are
numpy arrays from a seed.
"""
import dataclasses
import os
import subprocess
import sys

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blindno.nn.fno import FNO1d as JFNO1d
from blindno.nn.fno import FNO2d as JFNO2d
from blindno.nn.torch_layers import TorchBatchNorm
from blindno.models.blindno_unet import PermInvUNetAttn as JUNet
from blindno.models.nio2d import NIOFP2D as JNIOFP2D
from blindno.ops.config import set_spectral_impl, spectral_impl
from blindno.parallel.mesh import data_mesh as jax_data_mesh
from blindno.parallel.mesh import data_model_mesh as jax_data_model_mesh
from blindno_torch.convert import from_flax
from blindno_torch.data.datasets import load_fpe1d
from blindno_torch.models.blindno_unet import PermInvUNetAttn
from blindno_torch.models.nio1d import NIOFP1D
from blindno_torch.models.nio2d import NIOFNO2D, NIOFP2D
from blindno_torch.nn.fno import FNO1d, FNO2d
from blindno_torch.nn.torch_layers import BatchNorm1d, BatchNorm2d
from blindno_torch.parallel import dryrun
from blindno_torch.parallel.mesh import RankPool, data_parallel_size, mesh_layout
from blindno_torch.train.checkpoint import RESUME, load_best, load_resume
from blindno_torch.train.loop import TrainConfig, train_model
from test_nio2d_torch_parity import _randomize_bn
from test_torch_suites1d import _fpe1d_archive
from test_torch_train import (CFG, ENCODER_GRAD_TOL, L_MIN, NX, STEP_TOL, _grid, _jax_stepper,
                              _port_step, _rel_l2, _step_errors, _TwoPassBatchNorm)
from test_torch_unet import STEP_CFG
from test_torch_unet import STEP_TOL as UNET_STEP_TOL
from test_torch_unet import _grid as _unet_grid
from test_torch_unet import _jax_step as _unet_jax_step
from test_torch_unet import _port as _unet_port
from test_torch_unet import _randomized

RUN_TIMEOUT = 120.0  # seconds for one group of ranks; a hung collective fails the test
BN_TOL = 1e-5  # tests/test_torch_train.py:test_train_mode_batchnorm_matches_flax
FNO_TOL = {1: 2e-4, 2: 3e-4}  # tests/test_torch_fno1d.py, tests/test_torch_fno2d.py
GRAD_RTOL, GRAD_ATOL = 5e-4, 5e-5  # tests/test_fno_layer_fused.py:49,64
PORT_TOL = 1e-5  # the distributed step against the port's own single-process step


@pytest.fixture(scope="module")
def ranks():
    """Four spawned ranks for the whole file; each run takes the first ``world``."""
    with RankPool(4) as pool:
        yield lambda fn, world, *args: pool.run(fn, world, *args, timeout=RUN_TIMEOUT)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The single-process references on one torch thread, as the ranks run."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np(state):
    return {k: v.detach().numpy() for k, v in state.items()}


def _seeded(jmodel, *inputs, seed=0):
    """``jmodel``'s variables drawn from a numpy seed as ``tests/test_torch_train1d.py``
    draws them, over ``jax.eval_shape`` (compiling a model's init costs seconds):
    kernels N(0, 1/fan_in), spectral planes U[0, 1)/(Cin Cout), the rest N(0, 0.1^2),
    then every BatchNorm and LayerNorm randomized as the serving tests do."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), *map(jnp.asarray, inputs))

    def draw(path, leaf):
        name, shape = getattr(path[-1], "key", ""), leaf.shape
        if name == "kernel":
            a = rng.standard_normal(shape) / np.sqrt(np.prod(shape[:-1]))
        elif name in ("weights_re", "weights_im"):
            a = rng.random(shape) / (shape[0] * shape[1])
        else:
            a = 0.1 * rng.standard_normal(shape)
        return jnp.asarray(a, leaf.dtype)

    variables = _randomized(jax.tree_util.tree_map_with_path(draw, shapes), seed=7)
    return jax.tree.map(np.asarray, variables)


def _by_data(results, key):
    """``key`` of the ranks at model index 0, joined along the batch in data order."""
    rows = sorted((r["place"][0], r[key]) for r in results if r["place"][1] == 0)
    return torch.cat([v for _, v in rows])


# ------------------------------------------------------------------ the mesh


def test_data_axis_rule_and_rank_layout_are_jax_meshes():
    """``data_mesh(batch_size=b)`` on JAX's 8 virtual devices for b in 5-9, and
    ``data_model_mesh(n)``'s device ids for every model axis of 8 (a 3 fails as JAX's
    assert does)."""
    for b in range(5, 10):
        assert data_parallel_size(8, b) == jax_data_mesh(batch_size=b).shape["data"]
    for n in (1, 2, 4, 8):
        ids = np.vectorize(lambda d: d.id)(jax_data_model_mesh(n).devices)
        np.testing.assert_array_equal(mesh_layout(8, n), ids)
    with pytest.raises(ValueError, match="not divisible"):
        mesh_layout(8, 3)


def test_tp_shards_gather_back_and_an_odd_width_stays_replicated(ranks):
    """A small NIOFNO2D on a (1, 2) mesh: its two width-4 heads' layers (and their Adam
    moments) hold half their out-channels per rank and gather back to the original
    values; its width-5 inner FNO and every other parameter stay whole."""
    kwargs = dict(fno_layers=2, width=4, modes=4, inner_modes=4, inner_width=5, device="cpu")
    state = _np(NIOFNO2D(**kwargs).state_dict())
    out = ranks(dryrun.shard_roundtrip, 2, (NIOFNO2D, kwargs), state, 2)
    for r, res in enumerate(out):
        assert res["place"] == (0, r) and res["sharded"] == 2
        shapes = res["shapes"]
        assert shapes["heads.1.spectral.1.weights_re"] == (4, 2, 8, 4)
        assert shapes["heads.0.pointwise.0.weight"] == (2, 4)
        assert shapes["heads.0.pointwise.1.bias"] == (2,)
        assert shapes["heads.0.fc0.weight"] == (4, 4)  # not a layer: replicated
        assert shapes["branch.spectral.0.weights_re"] == (5, 5, 8, 4)
        assert shapes["branch.pointwise.0.weight"] == (5, 5)
        assert res["state"].keys() == state.keys()
        for k, v in state.items():
            np.testing.assert_array_equal(res["state"][k].numpy(), v)
        for k, v in res["exp_avg"].items():
            np.testing.assert_array_equal(v.numpy(), 2 * state[k])


def test_a_large_array_reaches_the_ranks_through_a_file(ranks, monkeypatch):
    """An argument array of ``FILE_ARRAY_BYTES`` or more reaches each rank as a file that
    the rank maps, with the same values; a smaller one comes through the pipe."""
    from blindno_torch.parallel import mesh

    monkeypatch.setattr(mesh, "FILE_ARRAY_BYTES", 4096)
    big, small = np.arange(1024, dtype=np.float64).reshape(32, 32), np.arange(4.0)
    assert ranks(type, 2, big) == [np.memmap] * 2
    assert ranks(np.sum, 2, big) == [big.sum()] * 2
    assert ranks(type, 1, small) == [np.ndarray]


# ------------------------------------------------------------------ the synced BatchNorm


def _bn_case(kind, rng):
    """A batch of 8 rows (4 per rank) with a mean and scale per channel; with
    ``large_mean``, means of 20-40 against a spread of about 1."""
    shape = (8, 5) if kind == "1d" else (8, 5, 3, 2)
    lead = (1, 5) + (1,) * (len(shape) - 2)
    loc = rng.uniform(20, 40, lead) if kind == "large_mean" else 0.5
    x = (rng.normal(0, 2.0, shape) * rng.uniform(0.5, 2.0, lead) + loc).astype(np.float32)
    g = rng.standard_normal(shape).astype(np.float32)
    params = [rng.uniform(0.6, 1.4, 5), rng.normal(0, 0.1, 5), rng.normal(0, 0.1, 5),
              rng.uniform(0.7, 1.3, 5)]
    return x, g, [p.astype(np.float32) for p in params]


def _flax_bn(x, g, scale, bias, mean, var):
    """flax's train-mode BatchNorm (two-pass variance) on the whole batch: the output,
    the running statistics and the gradients of ``sum(y * g)`` by x, scale and bias."""
    last = lambda a: np.moveaxis(a, 1, -1)
    bn = TorchBatchNorm(use_running_average=False)

    def run(xx, sc, bi):
        variables = {"params": {"BatchNorm_0": {"scale": sc, "bias": bi}},
                     "batch_stats": {"BatchNorm_0": {"mean": mean, "var": var}}}
        y, upd = bn.apply(variables, xx, mutable=["batch_stats"])
        return jnp.sum(y * last(g)), (y, upd["batch_stats"]["BatchNorm_0"])

    (_, (y, stats)), (dx, dscale, dbias) = jax.value_and_grad(run, (0, 1, 2), has_aux=True)(
        jnp.asarray(last(x)), jnp.asarray(scale), jnp.asarray(bias))
    back = lambda a: np.moveaxis(np.asarray(a), -1, 1)
    return back(y), np.asarray(stats["mean"]), np.asarray(stats["var"]), back(dx), dscale, dbias


@pytest.mark.parametrize("kind", ["1d", "2d", "large_mean"])
def test_synced_batchnorm_matches_flax_on_the_whole_batch(ranks, kind, monkeypatch):
    """Two ranks of 4 rows each against flax on all 8: output, running mean and
    variance, and the input's, weight's and bias's gradients (each rank's own sums,
    added) within 1e-5."""
    monkeypatch.setattr(flax.linen, "BatchNorm", _TwoPassBatchNorm)
    x, g, (scale, bias, mean, var) = _bn_case(kind, np.random.default_rng(len(kind)))
    y, mean_want, var_want, dx, dscale, dbias = _flax_bn(x, g, scale, bias, mean, var)
    cls = BatchNorm1d if x.ndim == 2 else BatchNorm2d
    state = {"weight": scale, "bias": bias, "running_mean": mean, "running_var": var,
             "num_batches_tracked": np.array(0)}
    out = ranks(dryrun.module_grads, 2, (cls, dict(num_features=5)), state, x, g, 1)
    tol = dict(rtol=BN_TOL, atol=BN_TOL)
    np.testing.assert_allclose(_by_data(out, "out").numpy(), y, **tol)
    np.testing.assert_allclose(_by_data(out, "dx").numpy(), dx, **tol)
    np.testing.assert_allclose(sum(r["grads"]["weight"] for r in out).numpy(), dscale, **tol)
    np.testing.assert_allclose(sum(r["grads"]["bias"] for r in out).numpy(), dbias, **tol)
    for r in out:
        np.testing.assert_allclose(r["buffers"]["running_mean"].numpy(), mean_want, **tol)
        np.testing.assert_allclose(r["buffers"]["running_var"].numpy(), var_want, **tol)


def test_batchnorm_of_a_one_rank_data_axis_is_the_local_one_bit_for_bit(ranks):
    """One rank (a data axis of 1): the BatchNorm is not synced, and its output, running
    statistics and gradients equal an unprepared module's in this process exactly."""
    x, g, (scale, bias, mean, var) = _bn_case("2d", np.random.default_rng(5))
    state = {"weight": scale, "bias": bias, "running_mean": mean, "running_var": var,
             "num_batches_tracked": np.array(0)}
    (out,) = ranks(dryrun.module_grads, 1, (BatchNorm2d, dict(num_features=5)), state, x, g, 1)
    bn = BatchNorm2d(5)
    bn.load_state_dict({k: torch.from_numpy(np.asarray(v)) for k, v in state.items()})
    xs = torch.from_numpy(x).requires_grad_()
    y = bn.train()(xs)
    (y * torch.from_numpy(g)).sum().backward()
    assert bn.sync_group is None
    for got, want in ((out["out"], y), (out["dx"], xs.grad), (out["grads"]["weight"], bn.weight.grad),
                      (out["buffers"]["running_var"], bn.running_var)):
        assert torch.equal(got, want.detach())


# ------------------------------------------------------------------ column-parallel FNOs


@pytest.mark.parametrize("dim", [1, 2])
def test_column_parallel_fno_matches_flax(ranks, dim):
    """FNO1d and FNO2d (width 6, 3 layers) with their layers cut over two ranks against
    flax's ``jnp`` FNO with the same weights: the output, and the gradients of
    ``sum(out * g)`` by the input and every parameter (the sharded ones gathered)."""
    modes, width, layers, cin, cout = (7, 6, 3, 3, 2) if dim == 1 else (5, 6, 3, 3, 2)
    spatial = (37,) if dim == 1 else (21, 19)
    rng = np.random.default_rng(dim)
    x = rng.standard_normal((2, *spatial, cin)).astype(np.float32)
    g = rng.standard_normal((2, *spatial, cout)).astype(np.float32)
    jmodel = (JFNO1d if dim == 1 else JFNO2d)(modes, width, layers, cin, cout)
    previous = spectral_impl()
    set_spectral_impl("jnp")
    try:
        params = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.asarray(x))["params"]

        def loss(p, xx):
            out = jmodel.apply({"params": p}, xx)
            return jnp.sum(out * g), out

        (_, want), (dparams, dx) = jax.jit(jax.value_and_grad(loss, (0, 1), has_aux=True))(
            params, jnp.asarray(x))
        want = np.asarray(want)
    finally:
        set_spectral_impl(previous)
    name = f"FNO{dim}d_0"
    as_port = lambda tree: {k.removeprefix("heads.0."): v for k, v in
                            from_flax({name: jax.tree.map(np.asarray, tree)}, {}).items()}
    cls = FNO1d if dim == 1 else FNO2d
    out = ranks(dryrun.module_grads, 2, (cls, dict(modes=modes, width=width, n_layers=layers,
                                                   input_dim=cin, output_dim=cout)),
                _np(as_port(params)), x, g, 2)
    want_grads = as_port(dparams)
    for r in out:
        np.testing.assert_allclose(r["out"].numpy(), want, rtol=FNO_TOL[dim], atol=FNO_TOL[dim])
        np.testing.assert_allclose(r["dx"].numpy(), np.asarray(dx), rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL)
        assert r["grads"].keys() == want_grads.keys()
        for k, w in want_grads.items():
            np.testing.assert_allclose(r["grads"][k].numpy(), w.numpy(), rtol=GRAD_RTOL,
                                       atol=GRAD_ATOL, err_msg=k)


# ------------------------------------------------------------------ whole steps


def test_dp2_niofp2d_step_matches_jax_and_the_single_process(ranks, monkeypatch):
    """One float32 step of the small NIOFP2D of ``tests/test_torch_train.py`` on a batch
    of 2 split over two ranks (synced BatchNorm, DDP's gradient average): within that
    file's tolerances of JAX's step on the whole batch, and within 1e-5 (relative L2
    per tensor) of the port's own single-process step."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 4, NX, NX)).astype(np.float32)
    y = rng.standard_normal((2, NX, NX, 2)).astype(np.float32)
    grid = _grid()
    draw = (rng.integers(0, 4, 4), (np.arange(4) < 3).astype(np.float32))
    jmodel = JNIOFP2D(**CFG, l_min=L_MIN)
    # flax's own init, as tests/test_torch_train.py takes it: the encoder's conv biases,
    # which Adam moves by rounding (a BatchNorm follows each conv), then lie far above
    # that rounding
    variables = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(grid))
    variables = jax.tree.map(np.asarray, _randomize_bn(variables, np.random.default_rng(7)))
    start = (variables["params"], variables["batch_stats"], None)
    jax_out = _jax_stepper(jmodel, x, y, grid, monkeypatch)(start, draw)
    single = _port_step(start, x, y, grid, draw)
    state = _np(from_flax(variables["params"], variables["batch_stats"]))
    out = ranks(dryrun.train_step_ranks, 2, (NIOFP2D, dict(**CFG, l_min=L_MIN, device="cpu")),
                state, x, y, grid, draw, 1)
    for r in out:
        got = (r["loss"], r["grads"], {k: v for k, v in r["state"].items()
                                       if not k.endswith("num_batches_tracked")})
        errs = _step_errors(jax_out, got)
        bad = {k: e for k, e in errs.items()
               if not e <= (ENCODER_GRAD_TOL if k.startswith("deeponet.branch.") else STEP_TOL)}
        assert not bad, bad
        assert abs(r["loss"] - single[0]) <= PORT_TOL * abs(single[0])
        # the conv biases' gradients are zero but for rounding (``_step_errors`` holds
        # them near 0) and left out; Adam's first step, lr * g / (|g| + eps), magnifies
        # the rounding of a gradient within a few eps = 1e-8 of zero (a trunk bias's
        # 3.2e-9, 0.16% apart, moves its parameter 2e-5 of the tensor's norm), so each
        # parameter is compared where its gradient exceeds 10 eps
        noise = lambda k: k.endswith("conv.bias")
        errs = {k: _rel_l2(r["grads"][k], single[1][k]) for k in single[1] if not noise(k)}
        for k, v in single[2].items():
            keep = single[1][k].abs() > 1e-7 if k in single[1] else torch.ones_like(v, dtype=bool)
            if not noise(k):
                errs[k] = _rel_l2(r["state"][k][keep], v[keep])
        bad = {k: e for k, e in errs.items() if not e <= PORT_TOL}
        assert not bad, bad


def test_dp_tp_unet_step_matches_jax(ranks, monkeypatch):
    """One float32 step of ``tests/test_torch_unet.py``'s UNet on a 2 x 2 mesh (a row
    per data rank, the heads' FNO layers cut over two model ranks) within that file's
    STEP_TOL of JAX's step on the whole batch; JAX's exact zero gradients stay exact."""
    rng = np.random.default_rng(0)
    b, l = 2, 5
    x = rng.standard_normal((b, l) + STEP_CFG["input_size"]).astype(np.float32)
    y = rng.standard_normal((b,) + STEP_CFG["input_size"] + (2,)).astype(np.float32)
    draw = (rng.integers(0, l, l), (np.arange(l) < 3).astype(np.float32))
    jmodel = JUNet(**STEP_CFG)
    variables = _seeded(jmodel, x)
    jloss, jgrads, jparams, jstats = _unet_jax_step(jmodel, variables, x, y, draw, monkeypatch)
    state = _np(_unet_port(variables, **STEP_CFG).state_dict())
    out = ranks(dryrun.train_step_ranks, 4, (PermInvUNetAttn, dict(**STEP_CFG, device="cpu")),
                state, x, y, _unet_grid(STEP_CFG["input_size"]), draw, 2)
    want_grads = from_flax(jgrads, None)
    zero = {k for k, g in want_grads.items() if not g.any()}
    want_state = {k: v for k, v in from_flax(jparams, jstats).items()
                  if not k.endswith("num_batches_tracked")}
    for r in out:
        assert r["grads"].keys() == want_grads.keys()
        assert all(not r["grads"][k].any() for k in zero)
        errs = {"loss": abs(r["loss"] - jloss) / abs(jloss)}
        errs.update({k: _rel_l2(r["grads"][k], want_grads[k]) for k in want_grads
                     if k not in zero})
        errs.update({f"state {k}": _rel_l2(r["state"][k], v) for k, v in want_state.items()
                     if k not in zero})
        bad = {k: e for k, e in errs.items() if not e <= UNET_STEP_TOL}
        assert not bad, bad


@pytest.mark.parametrize("n_ranks", [4, 2])
def test_dryrun_multigpu(n_ranks):
    """``__graft_entry__.py:dryrun_multichip``'s check in the port: a (2, 2) and a (2, 1)
    mesh's step against one process's, within 1e-5 on the loss."""
    out = dryrun.dryrun_multigpu(n_ranks, timeout=RUN_TIMEOUT)
    assert out["mesh"] == ((2, 2) if n_ranks == 4 else (2, 1))
    assert abs(out["loss"] - out["loss_single"]) <= 1e-5 * max(1.0, abs(out["loss_single"]))


# ------------------------------------------------------------------ the training loop


def _fpe1d_data(m=20):
    return load_fpe1d(_fpe1d_archive(m, np.random.default_rng(0), l=8))


GRID_1D = np.linspace(0.0, 1.0, 80, dtype=np.float32).reshape(80, 1)
SMALL_1D = dict(width=8, modes=8, n_basis=5, neurons=16, l_min=4, device="cpu")


def test_train_model_dp_tp_reproduces_the_single_process_run(ranks, tmp_path):
    """``train_model`` on four ranks at tp=2 (a 2 x 2 mesh; 2 epochs of 2 steps of
    batch 8) against one process: every epoch's losses within rtol 2e-4. Rank 0 alone
    writes the log (one record an epoch) and the checkpoints, unsharded: ``best_*``
    loads into a single-process model, and ``resume.msgpack`` holds whole Adam moments."""
    data = _fpe1d_data()
    state = _np(NIOFP1D(**SMALL_1D).state_dict())
    cfg = TrainConfig(epochs=2, batch_size=8, save_interval=1, lr=1e-3)
    model = NIOFP1D(**SMALL_1D)
    single = train_model(model, data, GRID_1D, cfg, device="cpu")
    dist_cfg = TrainConfig(epochs=2, batch_size=8, save_interval=1, lr=1e-3, tp=2,
                           ckpt_dir=str(tmp_path / "ck"), log_path=str(tmp_path / "log.jsonl"))
    out = ranks(dryrun.train_model_ranks, 4, (NIOFP1D, SMALL_1D), state, data, GRID_1D,
                dist_cfg)
    for res in out:
        assert res.finished and [h["epoch"] for h in res.history] == [1, 2]
        for a, b in zip(single.history, res.history):
            np.testing.assert_allclose(b["train_loss"], a["train_loss"], rtol=2e-4)
            np.testing.assert_allclose(b["test_loss"], a["test_loss"], rtol=2e-4)
        assert {k: tuple(v.shape) for k, v in res.params.items()} == {
            k: tuple(v.shape) for k, v in single.params.items()}
    assert len(open(tmp_path / "log.jsonl").read().splitlines()) == 2
    ckpt = os.listdir(tmp_path / "ck")
    assert sorted(f for f in ckpt if not f.startswith("best_")) == [RESUME]
    assert sum(f.startswith("best_") for f in ckpt) == 1
    best = load_best(tmp_path / "ck")
    NIOFP1D(**SMALL_1D).load_state_dict({**best["params"], **best["batch_stats"]})
    adam = load_resume(tmp_path / "ck")["opt_state"]["0"]
    mu, nu = from_flax(adam["mu"], None), from_flax(adam["nu"], None)
    for name, p in model.named_parameters():
        assert mu[name].shape == nu[name].shape == p.shape


def test_train_model_low_precision_across_ranks_matches_one_process(ranks):
    """``train_model`` in bfloat16 under ``all`` on a 2 x 2 mesh at tp=2 (DDP over
    ``data``, the FNO layers column-parallel over ``model``, each layer's kernel inside
    the cast): two epochs whose losses equal the single-process bfloat16 run's within
    rtol 2e-4, as the float32 run is held above (measured: 1.2e-6). oneDNN is off in the
    reference, as in the other bfloat16 CPU tests; the ranks convolve nothing."""
    from blindno_torch.models.nio1d import NIOFNO1D

    kw = dict(width=8, modes=8, l_min=4, device="cpu")
    model, data = NIOFNO1D(**kw), _fpe1d_data()
    cfg = TrainConfig(epochs=2, batch_size=8, save_interval=1, lr=1e-3,
                      compute_dtype="bfloat16", amp_policy="all")
    # the ranks first: the state's arrays share the model's storage, which training moves
    out = ranks(dryrun.train_model_ranks, 4, (NIOFNO1D, kw), _np(model.state_dict()), data,
                GRID_1D, dataclasses.replace(cfg, tp=2))
    with torch.backends.mkldnn.flags(enabled=False):
        single = train_model(model, data, GRID_1D, cfg, device="cpu")
    for res in out:
        assert res.finished and [h["epoch"] for h in res.history] == [1, 2]
        for a, b in zip(single.history, res.history):
            np.testing.assert_allclose(b["train_loss"], a["train_loss"], rtol=2e-4)
            np.testing.assert_allclose(b["test_loss"], a["test_loss"], rtol=2e-4)


def test_stop_file_stops_every_rank(ranks, tmp_path):
    """A stop file that rank 0 finds ends the run on all four ranks after the first
    epoch, with resume state written and nothing left waiting."""
    stop = tmp_path / "STOP"
    stop.write_text("")
    cfg = TrainConfig(epochs=3, batch_size=8, save_interval=2, lr=1e-3, tp=2,
                      ckpt_dir=str(tmp_path / "ck"), stop_file=str(stop))
    out = ranks(dryrun.train_model_ranks, 4, (NIOFP1D, SMALL_1D),
                _np(NIOFP1D(**SMALL_1D).state_dict()), _fpe1d_data(), GRID_1D, cfg)
    assert all(not r.finished and r.history == [] for r in out)
    assert load_resume(tmp_path / "ck")["epoch"] == 1


def test_torchrun_trains_through_the_cli(tmp_path):
    """``python -m torch.distributed.run --standalone --nproc-per-node 2 -m
    blindno_torch.suites.run --suite fpe1d --model nio --stage train --tp 2 --device cpu``
    on a tiny archive: one epoch, the checkpoints and the summary written."""
    _torchrun_train(tmp_path, 2, 2)


def test_torchrun_trains_on_three_ranks_at_a_batch_that_two_divide(tmp_path):
    """The same at ``--nproc-per-node 3`` and ``--tp 1``: the fpe1d suite's batch of 32
    leaves a data axis of 2, as JAX's ``data_mesh`` leaves it on three devices. Rank 2
    idles and exits 0 with the others; the checkpoints are written once, and rank 0 alone
    prints the result."""
    out = _torchrun_train(tmp_path, 3, 1)
    assert out.count("best test rel-L2") == 1, out[-3000:]


def _torchrun_train(tmp_path, nproc, tp):
    """The train stage through torchrun on ``nproc`` CPU ranks at ``--tp tp``, one epoch on
    a tiny fpe1d archive (40 sets: one step of 32): rc 0, one ``best_*``, the resume state
    and the summary written. Returns the run's standard output."""
    rng = np.random.default_rng(0)
    os.makedirs(tmp_path / "data")
    np.savez(tmp_path / "data" / "fpe1d_train.npz", **_fpe1d_archive(40, rng))
    np.savez(tmp_path / "data" / "fpe1d_test.npz", **_fpe1d_archive(5, rng))
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {**os.environ, "PYTHONPATH": root, "OMP_NUM_THREADS": "1"}
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
           str(nproc), "-m", "blindno_torch.suites.run", "--suite", "fpe1d", "--model", "nio",
           "--stage", "train", "--tp", str(tp), "--device", "cpu", "--workdir", str(tmp_path),
           "--epochs", "1"]
    proc = subprocess.run(cmd, cwd=root, env=env, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    ckpt = os.listdir(tmp_path / "ckpt" / "fpe1d_nio")
    assert RESUME in ckpt and sum(f.startswith("best_") for f in ckpt) == 1
    assert os.path.exists(tmp_path / "logs" / "fpe1d_nio_summary.json")
    return proc.stdout
