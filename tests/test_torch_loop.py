"""The port's ``train_model`` against a JAX reference loop, and its behaviour.

Loop parity: the small ``NIOFP2D`` of ``tests/test_torch_train.py`` trains 2 epochs on
a synthetic fpe2d archive (m=12: 9 train samples, 4 steps an epoch at batch 2, and 3
test samples in 2 padded eval batches), with ``d4_scalar`` augmentation, bfloat16
input storage, StepLR decaying after epoch 1 and an eval after each epoch. The JAX
reference is built from the package's own pieces (``make_augment``, ``step_lr``,
``optax.adam``, ``relative_l2_per_field``, ``train_test_split``, ``eval_batches``),
with the subsample and two-pass BatchNorm patched in as ``_jax_stepper`` does. Both
sides take the same draws (each epoch's batches, each step's group element and set
subsample) and start from the same weights.

Behaviour, as ``tests/test_train_smoke.py`` checks the JAX loop: resume, warm restart,
preemption, early stop, the divergence guard, the profile hook, reproducible seeded
draws, and the refusals of what JAX refuses too.
"""
import dataclasses
import glob
import os

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import blindno.models.nio2d as jax_nio2d
import blindno_torch.train.loop as loop
from blindno.data.datasets import eval_batches as jax_eval_batches
from blindno.data.datasets import load_fpe2d as jax_load_fpe2d
from blindno.data.datasets import train_test_split as jax_train_test_split
from blindno.eval.metrics import relative_l2_per_field as jax_rel_l2
from blindno.models.nio2d import NIOFP2D as JNIOFP2D
from blindno.nn.cnn import Encoder2D as JEncoder2D
from blindno.train.loop import amp_cast_fns
from blindno.train.loop import make_augment as jax_make_augment
from blindno.train.loop import step_lr as jax_step_lr
from blindno_torch.convert import from_flax
from blindno_torch.data.datasets import FPE2D_SCALES, load_fpe2d
from blindno_torch.models.nio2d import NIOFP2D
from blindno_torch.nn.cnn import Encoder2D
from blindno_torch.train.checkpoint import RESUME, load_best, load_resume
from blindno_torch.train.loop import TrainConfig, train_model
from test_nio2d_torch_parity import _randomize_bn
from test_torch_nio3d import seeded_variables
from test_torch_train import CFG, ENCODER_GRAD_TOL, NX, STEP_TOL, _grid, _TwoPassBatchNorm

M, L, L_MIN = 12, 4, 2
SMALL = dict(width=4, modes=4, n_basis=3, neurons=8, fno_layers=1)
PARITY_CFG = TrainConfig(epochs=2, batch_size=2, lr=1e-4, lr_step_epochs=1, save_interval=1,
                         augment="d4_scalar", compress_inputs=True)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One torch thread for the file: its many small steps ran 30-80x slower with
    oversubscribed threads under the Tier-1 command's six workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def fpe2d_archive(m=M, l=L, n=NX, seed=0):
    """A synthetic fpe2d archive in the JAX datagen's keys and raw magnitudes: smooth
    random fields, so that the model has something to learn, plus noise."""
    rng = np.random.default_rng(seed)
    gx, gy = np.meshgrid(np.linspace(-1, 1, n), np.linspace(-1, 1, n), indexing="ij")
    c = rng.uniform(-0.5, 0.5, (m, 2, 1, 1))
    well = np.exp(-((gx - c[:, 0]) ** 2 + (gy - c[:, 1]) ** 2) / 0.2)  # (m, n, n)
    t = rng.uniform(0.2, 1.0, (m, l, 1, 1))
    traj = well[:, None] ** t + 0.05 * rng.random((m, l, n, n))
    s = FPE2D_SCALES
    return {"trajectories": (traj / s["trajectories"]).astype(np.float32),
            "potential": (-well / s["potential"]).astype(np.float32),
            "drag": ((1 + 0.3 * well + 0.05 * rng.random((m, n, n))) / s["drag"]).astype(np.float32)}


def tiny_data(m=M, seed=0):
    return load_fpe2d(fpe2d_archive(m, seed=seed)), _grid()


def small_model(**kw):
    return NIOFP2D(**{**SMALL, **kw}, l_min=L_MIN, device="cpu")


# ------------------------------------------------------------------ loop parity with JAX


def _draw_source(seed=3):
    """Each epoch's batches (steps, 2) of train positions, group elements covering all
    8 of D4 over the 8 steps, and set subsamples (indices, mask)."""
    rng = np.random.default_rng(seed)
    elements = rng.permutation(8)
    table = {}

    def draw(epoch, steps):
        if epoch not in table:
            perm = rng.permutation(9)[: 2 * steps].reshape(steps, 2)
            subs = [(rng.integers(0, L, L), (np.arange(L) < rng.integers(L_MIN, L)).astype(np.float32))
                    for _ in range(steps)]
            table[epoch] = (perm, elements[(epoch - 1) * steps: epoch * steps].tolist(), subs)
        return table[epoch]

    return draw


def _jax_loop(jmodel, variables, data, grid, cfg, draws, monkeypatch, scan=False):
    """train_model's per-step path (``blindno/train/loop.py:288-500``) restated from the
    package's pieces, on one device, with the draws injected; with ``scan``, its
    ``epoch_scan`` path (``:396-415,464-468``): each epoch one jitted ``lax.scan`` of the
    same step over the epoch's draws."""
    train_idx, test_idx = jax_train_test_split(data.inputs.shape[0], cfg.train_frac, cfg.split_seed)
    in_dtype = jnp.bfloat16 if cfg.compress_inputs else jnp.float32
    x_train = jnp.asarray(data.inputs[train_idx], dtype=in_dtype)
    y_train = jnp.asarray(data.targets[train_idx])
    x_test = jnp.asarray(data.inputs[test_idx], dtype=in_dtype)
    y_test = jnp.asarray(data.targets[test_idx])
    grid = jnp.asarray(grid)
    spe = train_idx.shape[0] // cfg.batch_size
    tx = optax.adam(jax_step_lr(cfg.lr, cfg.lr_gamma, cfg.lr_step_epochs, spe))
    # the loop's casts (blindno/train/loop.py:369-379); identities in float32
    cdtype = jnp.dtype(cfg.compute_dtype) if cfg.compute_dtype else jnp.float32
    cast, uncast = (amp_cast_fns(cdtype, cfg.amp_policy) if cfg.compute_dtype
                    else (lambda t: t, lambda t: t))
    aug_fns = jax_make_augment(cfg.augment)
    draw = {}
    monkeypatch.setattr(jax_nio2d, "subsample_set", lambda key, xx, l_min, training: (
        jnp.take(xx, draw["idx"], axis=1), draw["mask"].astype(xx.dtype)))
    monkeypatch.setattr(flax.linen, "BatchNorm", _TwoPassBatchNorm)

    def step_fn(params, stats, opt_state, idx, element, sidx, smask):
        draw.update(idx=sidx, mask=smask)
        xb = jnp.take(x_train, idx, axis=0).astype(jnp.float32)
        yb = jnp.take(y_train, idx, axis=0)
        xb, yb = jax.lax.switch(element, aug_fns, xb, yb)

        def loss_fn(p):
            out, upd = jmodel.apply({"params": cast(p), "batch_stats": cast(stats)},
                                    xb.astype(cdtype), grid, training=True,
                                    rngs={"sample": jax.random.PRNGKey(0)}, mutable=["batch_stats"])
            return jnp.mean((out.astype(jnp.float32) - yb) ** 2), uncast(upd["batch_stats"])

        (loss, new_stats), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), new_stats, opt_state, loss

    step = jax.jit(step_fn)

    @jax.jit
    def train_epoch(params, stats, opt_state, batch_idx, elements, sidx, smask):
        def body(carry, xs):
            *carry, loss = step_fn(*carry, *xs)
            return tuple(carry), loss

        carry, losses = jax.lax.scan(body, (params, stats, opt_state),
                                     (batch_idx, elements, sidx, smask))
        return (*carry, losses.mean())

    @jax.jit
    def eval_step(params, stats, idx, mask):
        xb = jnp.take(x_test, idx, axis=0).astype(jnp.float32)
        out = jmodel.apply({"params": params, "batch_stats": stats}, xb, grid, training=False)
        errs = jax_rel_l2(out, jnp.take(y_test, idx, axis=0), cfg.reference_denominator)
        return (errs * mask[:, None]).sum(axis=0)

    params, stats = variables["params"], variables["batch_stats"]
    opt_state = tx.init(params)
    history = []
    for epoch in range(1, cfg.epochs + 1):
        batch_idx, elements, subs = draws(epoch, spe)
        if scan:
            params, stats, opt_state, train_loss = train_epoch(
                params, stats, opt_state, np.asarray(batch_idx), np.asarray(elements),
                *(np.stack(a) for a in zip(*subs)))
        else:
            losses = []
            for i in range(spe):
                params, stats, opt_state, loss = step(params, stats, opt_state, batch_idx[i],
                                                      elements[i], *subs[i])
                losses.append(loss)
            train_loss = jnp.stack(losses).mean()
        sums = sum(eval_step(params, stats, i, m) for i, m in jax_eval_batches(test_idx.shape[0],
                                                                                cfg.batch_size))
        means = np.asarray(sums) / test_idx.shape[0]
        history.append({"epoch": epoch, "train_loss": float(train_loss),
                        "test_loss": float(means.sum()), "field_rel_l2": means.tolist()})
    return history, jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, stats)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _trained_like(variables, rng):
    """The flax init with every tensor away from zero, as after training: BatchNorm as
    ``_randomize_bn`` draws it, and the trunk's biases (zeros at init) from N(0, 0.05).
    A relative error of a tensor that starts at zero measures only the rounding noise
    that Adam's normalized steps turn into parameter moves."""
    variables = jax.tree.map(np.asarray, _randomize_bn(variables, rng))
    for name, dense in variables["params"]["FFN_0"].items():
        if name.startswith("Dense"):
            dense["bias"] = rng.normal(0.0, 0.05, dense["bias"].shape).astype(np.float32)
    return variables


def test_train_model_matches_a_jax_reference_loop(monkeypatch):
    """After 2 epochs (8 steps) from the same weights and draws:

    - the history (train and test loss, per-field rel-L2) within STEP_TOL = 2e-3;
    - every final parameter and running variance within STEP_TOL relative L2 outside
      the Encoder2D and ENCODER_GRAD_TOL = 1e-2 in it, the tolerances with which
      ``tests/test_torch_train.py`` holds single steps;
    - the final eval-mode outputs on the test split within STEP_TOL of their scale.

    The Encoder2D's running means are held through those outputs and not one by one:
    they are batch means of the deep blocks' conv outputs, small against the spread
    they come from. Measured on the CPU: the history within 3.6e-5, the encoder's
    tensors within 5.1e-3 (block 9's running variance) and the rest within 1.3e-4,
    the outputs within 4.7e-4 of their scale, and block 9's running mean 2.0e-2 away.

    The gaps are float32 rounding, amplified by leaky-ReLU kinks and Adam's normalized
    steps: in float64 the first step agrees to 4e-8 (the test below). For the same
    reason the learning rate is 1e-4, not the suite's 5e-4: over eight steps at 5e-4,
    JAX's own two implementations (the ``jnp`` and the fused Pallas layer) end 1.6e-2
    apart in the encoder's conv weights, beyond the tolerance; at 1e-4, 1.5e-3 apart.
    """
    data = load_fpe2d(fpe2d_archive())
    jdata = jax_load_fpe2d(fpe2d_archive())
    np.testing.assert_array_equal(data.inputs, jdata.inputs)
    grid = _grid()
    jmodel = JNIOFP2D(**CFG, l_min=L_MIN)
    variables = _trained_like(jax.jit(jmodel.init)(jax.random.PRNGKey(0),
                                                   jnp.asarray(data.inputs[:2]),
                                                   jnp.asarray(grid)), np.random.default_rng(7))
    want_hist, jparams, jstats = _jax_loop(jmodel, variables, jdata, grid, PARITY_CFG,
                                           _draw_source(), monkeypatch)

    model = NIOFP2D(**CFG, l_min=L_MIN, device="cpu")
    model.load_state_dict(from_flax(variables["params"], variables["batch_stats"]))
    res = train_model(model, data, grid, PARITY_CFG, device="cpu", draws=_draw_source())

    assert [h["epoch"] for h in res.history] == [1, 2] and res.finished
    for got, want in zip(res.history, want_hist):
        assert set(got) == set(want) | {"steps_per_sec"}
        for k in ("train_loss", "test_loss"):
            assert abs(got[k] - want[k]) <= STEP_TOL * abs(want[k]), (got, want)
        assert _rel(got["field_rel_l2"], want["field_rel_l2"]) <= STEP_TOL, (got, want)
    assert want_hist[0]["train_loss"] != want_hist[1]["train_loss"]

    initial = from_flax(variables["params"], variables["batch_stats"])
    want_state = from_flax(jparams, jstats)
    got_state = {**res.params, **res.batch_stats}
    errs = {k: _rel(got_state[k], v) for k, v in want_state.items()
            if not k.endswith("num_batches_tracked")
            and not (k.startswith("deeponet.branch.") and k.endswith("running_mean"))}
    bad = {k: e for k, e in errs.items()
           if not e <= (ENCODER_GRAD_TOL if k.startswith("deeponet.branch.") else STEP_TOL)}
    assert not bad, bad
    # the comparison sees the training: the heads moved far more than the gap
    moved = _rel(got_state["heads.0.fc0.weight"], initial["heads.0.fc0.weight"])
    assert moved > 10 * errs["heads.0.fc0.weight"]

    _, test_idx = jax_train_test_split(M, 0.8, 0)
    x_test = np.array(jnp.asarray(data.inputs[test_idx], jnp.bfloat16).astype(jnp.float32))
    want_out = np.asarray(jmodel.apply({"params": jparams, "batch_stats": jstats},
                                       jnp.asarray(x_test), jnp.asarray(grid)))
    with torch.no_grad():
        got_out = model(torch.from_numpy(x_test), torch.from_numpy(grid)).numpy()
    scale = np.abs(want_out).max()
    np.testing.assert_allclose(got_out, want_out, rtol=STEP_TOL, atol=STEP_TOL * scale)


class _Float64BatchNorm(_TwoPassBatchNorm):
    """flax's two-pass BatchNorm computing in float64 (``TorchBatchNorm`` asks it for
    float32, ``blindno/nn/torch_layers.py:101``)."""

    def __post_init__(self):
        object.__setattr__(self, "dtype", jnp.float64)
        super().__post_init__()


_Float64BatchNorm.__name__ = "BatchNorm"


def test_first_step_on_the_parity_data_matches_jax_in_float64(x64, monkeypatch):
    """The float32 gaps of the loop test are rounding, amplified, and not a difference
    in what is computed: on its first batch and draw, from the same weights, the
    port's step in float64 and JAX's (its BatchNorm in float64 too) give the same loss
    and gradients within 1e-6 relative L2 (measured: 3.9e-8, JAX's DFT matrices being
    float32), where in float32 the first encoder block's gradients lie 2.8e-3 apart.
    The conv biases' gradients, zero but for rounding (a BatchNorm follows), are held
    below 1e-9 of the largest gradient instead."""
    data = load_fpe2d(fpe2d_archive())
    grid = _grid()
    train_idx, _ = jax_train_test_split(M, 0.8, 0)
    batch_idx, _, subs = _draw_source()(1, 4)
    x, y = data.inputs[train_idx][batch_idx[0]], data.targets[train_idx][batch_idx[0]]
    jmodel = JNIOFP2D(**CFG, l_min=L_MIN)
    variables = _trained_like(jmodel.init(jax.random.PRNGKey(0), jnp.asarray(x, jnp.float32),
                                          jnp.asarray(grid)), np.random.default_rng(7))
    f64 = jax.tree.map(lambda a: np.asarray(a, np.float64), variables)
    idx, mask = subs[0]
    monkeypatch.setattr(jax_nio2d, "subsample_set", lambda key, xx, l_min, training: (
        jnp.take(xx, jnp.asarray(idx), axis=1), jnp.asarray(mask, xx.dtype)))
    monkeypatch.setattr(flax.linen, "BatchNorm", _Float64BatchNorm)

    def loss_fn(p):
        out, _ = jmodel.apply({"params": p, "batch_stats": f64["batch_stats"]},
                              jnp.asarray(x, jnp.float64), jnp.asarray(grid, jnp.float64),
                              training=True, rngs={"sample": jax.random.PRNGKey(0)},
                              mutable=["batch_stats"])
        return jnp.mean((out - y) ** 2)

    jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(f64["params"])
    want = from_flax(jax.tree.map(np.asarray, jgrads), None)

    model = NIOFP2D(**CFG, l_min=L_MIN, device="cpu")
    model.load_state_dict(from_flax(variables["params"], variables["batch_stats"]))
    model.double().train()
    out = model(torch.from_numpy(x).double(), torch.from_numpy(grid).double(), subsample=subs[0])
    loss = torch.mean((out - torch.from_numpy(y).double()) ** 2)
    loss.backward()
    got = {k: p.grad for k, p in model.named_parameters() if p.grad is not None}
    assert abs(loss.detach().item() - float(jloss)) <= 1e-9 * abs(float(jloss))
    top = max(float(g.abs().max()) for g in got.values())
    zero = {k for k in got if k.endswith("conv.bias")}
    assert max(float(got[k].abs().max()) for k in zero) < 1e-9 * top
    errs = {k: _rel(got[k].numpy(), want[k].numpy()) for k in got if k not in zero}
    bad = {k: e for k, e in errs.items() if not e <= 1e-6}
    assert not bad, bad


# ------------------------------------------------------------------ behaviour


def _cfg(tmp_path=None, **kw):
    base = dict(epochs=2, batch_size=4, save_interval=1, lr=1e-3,
                ckpt_dir=str(tmp_path / "ck") if tmp_path else None)
    return TrainConfig(**{**base, **kw})


def test_train_loop_resumes_where_it_stopped(tmp_path):
    data, grid = tiny_data()
    cfg = _cfg(tmp_path)
    res1 = train_model(small_model(), data, grid, cfg, device="cpu")
    assert [h["epoch"] for h in res1.history] == [1, 2]
    saved = load_resume(cfg.ckpt_dir)
    # the resumed run starts from exactly the saved state
    restored = {}
    original = loop.checkpoint.load_resume

    def spy(*a, **k):
        state = original(*a, **k)
        restored.update(state["params"])
        return state

    model = small_model()
    loop.checkpoint.load_resume = spy
    try:
        res2 = train_model(model, data, grid, dataclasses.replace(cfg, epochs=4), device="cpu")
    finally:
        loop.checkpoint.load_resume = original
    assert all(torch.equal(restored[k], saved["params"][k]) for k in saved["params"])
    assert [h["epoch"] for h in res2.history] == [3, 4]
    assert res2.best_test_loss <= res1.best_test_loss + 1e-9
    assert load_best(cfg.ckpt_dir)["test_loss"] == res2.best_test_loss


def test_train_loop_warm_restarts_without_resume_file(tmp_path):
    data, grid = tiny_data()
    cfg = _cfg(tmp_path)
    res1 = train_model(small_model(), data, grid, cfg, device="cpu")
    os.remove(os.path.join(cfg.ckpt_dir, RESUME))
    best_epoch = load_best(cfg.ckpt_dir)["epoch"]
    res2 = train_model(small_model(), data, grid, dataclasses.replace(cfg, epochs=4), device="cpu")
    assert res2.history[0]["epoch"] == best_epoch + 1 and res2.history[-1]["epoch"] == 4
    assert res2.best_test_loss <= res1.best_test_loss + 1e-9
    # a mismatched model starts fresh
    os.remove(os.path.join(cfg.ckpt_dir, RESUME))
    res3 = train_model(small_model(width=6), data, grid, dataclasses.replace(cfg, epochs=1),
                       device="cpu")
    assert res3.history[0]["epoch"] == 1


def test_train_loop_stop_file_preempts_with_resume_state(tmp_path):
    data, grid = tiny_data()
    stop = tmp_path / "STOP"
    stop.write_text("")
    cfg = _cfg(tmp_path, epochs=4, save_interval=3, stop_file=str(stop))
    res = train_model(small_model(), data, grid, cfg, device="cpu")
    assert not res.finished and res.history == []
    assert load_resume(cfg.ckpt_dir)["epoch"] == 1
    stop.unlink()
    res = train_model(small_model(), data, grid, cfg, device="cpu")
    assert res.finished and [h["epoch"] for h in res.history] == [3, 4]


def test_train_loop_early_stop_counts_as_finished(monkeypatch):
    """A constant metric never improves after the first eval: patience 3 ends the run
    at epoch 4."""
    monkeypatch.setattr(loop, "relative_l2_per_field",
                        lambda out, yb, ref: torch.ones(yb.shape[0], 1))
    data, grid = tiny_data()
    res = train_model(small_model(), data, grid, _cfg(epochs=50, early_stop_patience=3),
                      device="cpu")
    assert res.finished and res.history[-1]["epoch"] == 4


def test_train_loop_divergence_guard_stops(tmp_path):
    data, grid = tiny_data()
    res = train_model(small_model(), data, grid, _cfg(tmp_path, epochs=50, lr=1e12), device="cpu")
    assert not res.finished and len(res.history) < 10
    for name in glob.glob(os.path.join(tmp_path, "ck", "best_*")):  # nothing poisoned kept
        assert all(torch.isfinite(v).all() for v in torch.load(name, weights_only=True)["params"].values())


def test_train_loop_profile_dir_traces_one_epoch(tmp_path):
    data, grid = tiny_data()
    res = train_model(small_model(), data, grid, _cfg(epochs=3, save_interval=3,
                                                      profile_dir=str(tmp_path / "prof")),
                      device="cpu")
    assert res.finished
    assert len(glob.glob(str(tmp_path / "prof" / "*.json"))) == 1


def test_train_loop_seeded_draws_are_reproducible():
    """Same weights and seed: the same history; another seed: another one."""
    data, grid = tiny_data()
    cfg = _cfg(epochs=1, augment="d4_scalar")
    runs = [train_model(small_model(), data, grid, dataclasses.replace(cfg, seed=s), device="cpu")
            for s in (0, 0, 1)]
    a, b, c = (r.history[0] for r in runs)
    assert (a["train_loss"], a["test_loss"]) == (b["train_loss"], b["test_loss"])
    assert a["train_loss"] != c["train_loss"]


@pytest.mark.parametrize("fields", [dict(tp=2),
                                    dict(compute_dtype="bfloat16", amp_policy="bn32"),
                                    dict(compute_dtype="float16", amp_policy="all"),
                                    dict(compute_dtype="float16", amp_policy="encoder_bn32"),
                                    dict(augment="d8")])
def test_train_loop_refuses_what_is_not_ported(fields, monkeypatch):
    """What JAX refuses too (an unknown amp policy or augment kind), and ``tp=2`` in one
    process: tensor parallelism
    is ported (``tests/test_torch_parallel.py``), but one rank is not divisible by a
    model axis of 2, as JAX's ``data_model_mesh`` asserts on one device.

    The two float16 cases were refused until the port took JAX's low-precision steps;
    they now run (:func:`_float16_loop_matches_jax`). Every amp policy with bfloat16 and
    float16 is held step by step in ``tests/test_torch_amp*.py``. ``epoch_scan`` was
    refused until the port took it; ``tests/test_torch_epoch_scan.py`` holds it, and its
    refusal across ranks."""
    if fields.get("compute_dtype") == "float16":
        _float16_loop_matches_jax(fields, monkeypatch)
        return
    data, grid = tiny_data()
    with pytest.raises(ValueError, match="not divisible by tp" if "tp" in fields else None):
        train_model(small_model(), data, grid, _cfg(**fields), device="cpu")


ENC_DIMS = (16, 32, 32, 32, 32)  # the Encoder2D's five widths, narrowed


def _float16_loop_matches_jax(fields, monkeypatch):
    """One epoch of the loop-parity run (4 steps, d4 augmentation, bfloat16 input
    storage) in float16 under ``fields``' policy, from the same seeded weights and draws
    as JAX's loop in float16 (its casts, ``_jax_loop``): the train and test losses and
    the per-field errors within STEP_TOL, relative, as the float32 loop holds them. The
    losses are means, over which float16's rounding averages out: measured on the CPU,
    at most 1.2e-5 apart. The Encoder2D is narrowed to ``ENC_DIMS`` on both sides: at
    full width, a float16 convolution runs 0.1 steps/s on one CPU thread without
    oneDNN."""
    cfg = dataclasses.replace(PARITY_CFG, epochs=1, **fields)
    data, jdata, grid = load_fpe2d(fpe2d_archive()), jax_load_fpe2d(fpe2d_archive()), _grid()
    monkeypatch.setattr(jax_nio2d, "Encoder2D", lambda n, fk: JEncoder2D(n, fk, *ENC_DIMS))
    jmodel = JNIOFP2D(**CFG, l_min=L_MIN)
    variables = seeded_variables(jmodel, np.random.default_rng(7), data.inputs[:2], grid)
    want, _, _ = _jax_loop(jmodel, variables, jdata, grid, cfg, _draw_source(), monkeypatch)
    model = NIOFP2D(**CFG, l_min=L_MIN, device="cpu")
    model.deeponet.branch = Encoder2D(CFG["n_basis"], dims=ENC_DIMS)
    model.load_state_dict(from_flax(variables["params"], variables["batch_stats"]))
    with torch.backends.mkldnn.flags(enabled=False):  # tests/test_torch_train.py: oneDNN
        got = train_model(model, data, grid, cfg, device="cpu", draws=_draw_source()).history
    for g, w in zip(got, want, strict=True):
        for k in ("train_loss", "test_loss"):
            assert abs(g[k] - w[k]) <= STEP_TOL * abs(w[k]), (g, w)
        assert _rel(g["field_rel_l2"], w["field_rel_l2"]) <= STEP_TOL, (g, w)


def test_train_loop_refuses_an_empty_epoch():
    data, grid = tiny_data()
    with pytest.raises(ValueError, match="batch_size"):
        train_model(small_model(), data, grid, _cfg(batch_size=16), device="cpu")
