"""The port reads the JAX package's checkpoints itself (``blindno_torch/train/
jax_checkpoint.py``), and its stages take over a JAX workdir as JAX's stages do.

(a) every committed ``runs/ckpt/*/best_*`` read by the reader equals orbax's
``StandardCheckpointer().restore`` bit for bit; (b) ``load_best`` picks the smaller loss
among the port's files and JAX's directories and refuses a foreign directory by name;
(c) the port's ``--stage eval`` and ``--stage time-error`` on the committed fpe1d NIO
directory against JAX's CLI, the directory unchanged; (d) the port's ``save_best`` leaves
the names JAX's leaves; (e) the warm restart from a JAX directory sets what JAX's loop
sets, and one CLI epoch from it keeps ``save_best``'s rule; (f) ``resume.msgpack``, as
JAX's ``save_resume`` writes it, restores bit for bit, and one Adam step from it matches
optax's. JAX runs here only as the oracle, on the CPU.
"""
import glob
import hashlib
import json
import logging
import os
import re
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import optax
import orbax.checkpoint as ocp
import pytest
import torch

import blindno.models.nio1d as jax_nio1d
import blindno.suites.registry as jax_registry
import blindno.train.checkpoint as jax_ck
import blindno.train.loop as jax_loop
import blindno_torch.train.loop as loop
from blindno_torch.convert import adam_from_optax, from_flax, from_flax_checkpoint
from blindno_torch.data.datasets import SetToFieldData
from blindno_torch.models.nio1d import NIOFNO1D
from blindno_torch.suites import registry
from blindno_torch.suites.run import main
from blindno_torch.train import checkpoint as ck
from blindno_torch.train import jax_checkpoint as jc
from blindno_torch.train.step import make_optimizer
from test_torch_datagen import METRIC_TOL, _run_jax_cli
from test_torch_suites import _assert_eval_matches_jax
from test_torch_train import STEP_TOL

CKPT = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "runs", "ckpt"))
# the committed directories, each holding one JAX best_*: the registry's {suite}_{model}
# ones, and the fpe1d NIO and fpe2d UNet variants at the registry's widths
COMMITTED = ("fpe1d_fno", "fpe1d_nio", "fpe1d_nio_bf16val", "fpe1d_nio_bf16val_bn32",
             "fpe1d_nio_bf16val_enc", "fpe1d_unet", "fpe2d_nio", "fpe2d_unet",
             "fpe2d_unet_leakdemo", "gpe1d_fno", "gpe1d_nio", "gpe1d_unet", "gpe1d_vgk_nio",
             "ncfpe2d_fno", "ncfpe2d_unet", "schrodinger1d_fno", "schrodinger1d_nio",
             "schrodinger1d_unet")
M, M_TEST = 48, 6  # the JAX datagen archive of (c) and (e)


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    logging.disable(logging.WARNING)  # orbax warns that no restore target is given
    yield
    logging.disable(logging.NOTSET)
    torch.set_num_threads(threads)


def _committed_best(name):
    """The one entry of ``runs/ckpt/{name}``, a JAX ``best_*`` directory."""
    d = os.path.join(CKPT, name)
    entries = sorted(os.listdir(d)) if os.path.isdir(d) else []
    assert len(entries) == 1 and entries[0].startswith("best_") \
        and os.path.isdir(os.path.join(d, entries[0])), \
        f"committed checkpoint {d}: want one best_* directory, found {entries or 'nothing'}"
    return os.path.join(d, entries[0])


def _copy_committed(name, target):
    """A copy of committed checkpoint ``name``'s ``best_*`` directory in ``target``."""
    src = _committed_best(name)
    shutil.copytree(src, os.path.join(target, os.path.basename(src)))


def _orbax(path):
    return ocp.StandardCheckpointer().restore(os.path.abspath(path))


def _assert_same_tree(got, want, path=""):
    """Keys, types, dtypes and bytes equal (jax arrays read to numpy)."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and got.keys() == want.keys(), path
        for k in want:
            _assert_same_tree(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, (int, float)):
        assert type(got) is type(want) and got == want, path
    else:
        want = np.asarray(want)
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype, path
        assert got.shape == want.shape and got.tobytes() == want.tobytes(), path


def _assert_same_state(got, want):
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k


def _digest(directory):
    """Every file under ``directory`` with its SHA-256."""
    out = {}
    for root, _, files in os.walk(directory):
        for f in files:
            with open(os.path.join(root, f), "rb") as fh:
                out[os.path.relpath(os.path.join(root, f), directory)] = \
                    hashlib.sha256(fh.read()).hexdigest()
    return out


# ------------------------------------------------------------------ (a) the reader


@pytest.mark.parametrize("name", COMMITTED, ids=COMMITTED)
def test_reader_equals_orbax_restore_bit_for_bit(name):
    path = _committed_best(name)
    _assert_same_tree(jc.read_orbax(path), _orbax(path))


def test_reader_refuses_what_it_does_not_read(tmp_path):
    """A flipped byte fails the node's CRC-32C; a zarr3 tree and a missing chunk are
    named."""
    d = str(tmp_path / "best_0.243984_e380")
    shutil.copytree(_committed_best("fpe1d_fno"), d)
    node = glob.glob(os.path.join(d, "d", "*"))[0]
    raw = bytearray(open(node, "rb").read())
    raw[40] ^= 1
    open(node, "wb").write(raw)
    with pytest.raises(jc.JaxCheckpointError, match="CRC-32C"):
        jc.read_orbax(d)
    with pytest.raises(jc.JaxCheckpointError, match="no array 'nope'"):
        jc._zarr_array({}, "nope", d)
    meta = json.load(open(os.path.join(d, "_METADATA")))
    json.dump({**meta, "use_zarr3": True}, open(os.path.join(d, "_METADATA"), "w"))
    with pytest.raises(jc.JaxCheckpointError, match="use_zarr3=True"):
        jc.read_orbax(d)


# ------------------------------------------------------------------ (b) load_best


@pytest.mark.parametrize("port_loss", [0.1, 0.5])
def test_load_best_takes_the_smaller_loss_of_either_format(port_loss, tmp_path):
    d = str(tmp_path / "fpe1d_fno")
    _copy_committed("fpe1d_fno", d)
    jax_state = from_flax_checkpoint(_orbax(glob.glob(os.path.join(d, "best_*"))[0]))
    doubled = {k: 2 * v for k, v in jax_state["params"].items()}
    # written beside the JAX directory by hand: the port's save_best would remove it
    torch.save({"params": doubled, "batch_stats": {}, "epoch": 7, "test_loss": port_loss},
               os.path.join(d, f"best_{port_loss:.6f}_e7"))
    got = ck.load_best(d)
    want = (dict(jax_state, params=doubled, epoch=7, test_loss=port_loss) if port_loss < 0.243984
            else jax_state)
    _assert_same_state(got["params"], want["params"])
    assert (got["epoch"], got["test_loss"]) == (want["epoch"], want["test_loss"])
    foreign = os.path.join(d, "best_0.010000_e1")
    os.makedirs(foreign)
    open(os.path.join(foreign, "weights.bin"), "wb").close()
    with pytest.raises(jc.JaxCheckpointError, match=re.escape(foreign)):
        ck.load_best(d)


# ------------------------------------------------------------------ (c) eval, time-error


@pytest.fixture(scope="module")
def jax_archives(tmp_path_factory):
    """JAX's CLI datagen of fpe1d, ``--m 48 --m-test 6``."""
    w = str(tmp_path_factory.mktemp("jax_datagen"))
    _run_jax_cli(["--suite", "fpe1d", "--stage", "datagen", "--workdir", w, "--m", str(M),
                  "--m-test", str(M_TEST)])
    return os.path.join(w, "data")


def _workdir(root, archives, name="fpe1d_nio"):
    """A workdir with the archives and a copy of the committed ``runs/ckpt/{name}``."""
    shutil.copytree(archives, os.path.join(root, "data"))
    _copy_committed(name, os.path.join(root, "ckpt", name))
    return str(root)


def _printed_report(out):
    """The JSON report JAX's CLI prints last."""
    lines = out.splitlines()
    return json.loads("\n".join(lines[max(i for i, ln in enumerate(lines) if ln == "{"):]))


def test_eval_and_time_error_stages_read_the_jax_directory(jax_archives, tmp_path, capsys):
    """On the committed fpe1d NIO directory: metrics and predictions within 2e-3 of JAX's
    CLI, time errors within METRIC_TOL, and the directory byte for byte unchanged."""
    jw = _workdir(tmp_path / "jax", jax_archives)
    w = _workdir(tmp_path / "port", jax_archives)
    before = _digest(os.path.join(w, "ckpt"))
    argv = ["--suite", "fpe1d", "--model", "nio"]
    _run_jax_cli(argv + ["--stage", "eval", "--workdir", jw])
    jreport = _printed_report(capsys.readouterr().out)
    report = main(argv + ["--stage", "eval", "--workdir", w, "--device", "cpu"])
    _assert_eval_matches_jax(report, jreport, w, jw, "fpe1d", "nio", M_TEST)
    assert report["ckpt_epoch"] == 400
    _run_jax_cli(argv + ["--stage", "time-error", "--workdir", jw, "--m", "4"])
    jte = _printed_report(capsys.readouterr().out)
    te = main(argv + ["--stage", "time-error", "--workdir", w, "--m", "4", "--device", "cpu"])
    assert te.keys() == jte.keys() and jte["mean_err_l2"] > 0.01
    for k in ("mean_err_l2", "std_err_l2"):
        np.testing.assert_allclose(te[k], jte[k], rtol=METRIC_TOL, err_msg=k)
    assert _digest(os.path.join(w, "ckpt")) == before


# ------------------------------------------------------------------ (d) save_best


@pytest.mark.parametrize("loss,epoch", [(0.1, 381), (0.9, 381), (0.180609, 400)],
                         ids=["better", "worse", "replayed-name"])
def test_save_best_leaves_the_names_jax_leaves(loss, epoch, tmp_path):
    """Two mirror workdirs, each with a copy of the committed fpe1d NIO directory: JAX's
    ``save_best`` in one, the port's in the other, neither raising."""
    jd, d = (str(tmp_path / s / "fpe1d_nio") for s in ("jax", "port"))
    for target in (jd, d):
        _copy_committed("fpe1d_nio", target)
    raw = _orbax(glob.glob(os.path.join(jd, "best_*"))[0])
    jax_ck.save_best(jd, raw["params"], raw["batch_stats"], epoch, loss)
    state = from_flax_checkpoint(raw)
    path = ck.save_best(d, state["params"], state["batch_stats"], epoch, loss)
    assert sorted(os.listdir(d)) == sorted(os.listdir(jd)) == [os.path.basename(path)]
    assert jc.is_orbax(path)
    _assert_same_state(ck.load_best(d)["params"], state["params"])


# ------------------------------------------------------------------ (e) the warm restart


def _captured_optimizers(monkeypatch):
    made = []

    def capture(*args, **kwargs):
        made.append(make_optimizer(*args, **kwargs))
        return made[-1]

    monkeypatch.setattr(loop, "make_optimizer", capture)
    return made


WARM = re.compile(r"warm restart from best_\* at epoch (\d+) \(best ([0-9.]+); Adam moments "
                  r"reset, lr schedule advanced to step (\d+)\)")


def test_warm_restart_from_a_jax_directory(jax_archives, tmp_path, monkeypatch, capsys):
    """With the committed fpe1d NIO directory and no resume file, the port's loop and
    JAX's set the same params (from_flax of orbax's restore, bit for bit), start epoch,
    best loss and Adam step (0 epochs run). Then one epoch through the CLI (``--epochs
    401``): it starts at 401 with JAX's best loss, Adam's step advanced, and the JAX
    directory is kept or removed by ``save_best``'s rule."""
    from blindno.data.datasets import load_fpe1d as jax_load_fpe1d
    from blindno_torch.data.datasets import load_fpe1d

    jw = _workdir(tmp_path / "jax", jax_archives)
    w = _workdir(tmp_path / "port", jax_archives)
    name = "fpe1d_nio"
    with np.load(os.path.join(jax_archives, "fpe1d_train.npz")) as z:
        archive = {k: z[k] for k in z.files}
    spec, jspec = registry.SUITES["fpe1d"], jax_registry.SUITES["fpe1d"]
    jcfg = jax_loop.TrainConfig(**{**vars(jspec.train_cfg), "epochs": 400,
                                   "ckpt_dir": os.path.join(jw, "ckpt", name), "log_path": None})
    jres = jax_loop.train_model(jspec.models["nio"](), jax_load_fpe1d(archive), jspec.grid, jcfg)
    jwarm = WARM.search(capsys.readouterr().out).groups()
    made = _captured_optimizers(monkeypatch)
    cfg = loop.TrainConfig(**{**vars(spec.train_cfg), "epochs": 400,
                              "ckpt_dir": os.path.join(w, "ckpt", name), "log_path": None})
    model = spec.models["nio"](device="cpu")
    res = loop.train_model(model, load_fpe1d(archive), spec.grid, cfg, device="cpu")
    assert WARM.search(capsys.readouterr().out).groups() == jwarm
    want = from_flax_checkpoint(_orbax(_committed_best(name)))
    _assert_same_state(res.params, want["params"])
    _assert_same_state(from_flax(*map(jax.device_get, (jres.params, jres.batch_stats))),
                       {**res.params, **want["batch_stats"]})
    assert res.best_test_loss == jres.best_test_loss == want["test_loss"]
    steps = int(jwarm[2])
    assert steps > 0 and all(s["step"] == steps and not s["exp_avg"].any()
                             for s in made[0].state.values())

    # one epoch through the CLI from the JAX directory
    main(["--suite", "fpe1d", "--model", "nio", "--stage", "train", "--workdir", w,
          "--epochs", "401", "--device", "cpu"])
    out = capsys.readouterr().out
    assert WARM.search(out).groups() == jwarm
    with open(os.path.join(w, "logs", f"{name}_summary.json")) as fh:
        (record,) = json.load(fh)["history"]
    assert record["epoch"] == 401
    resume = ck.load_resume(os.path.join(w, "ckpt", name))
    assert resume["epoch"] == 401
    assert all(int(resume["opt_state"][i]["count"]) == steps + 1 for i in ("0", "1"))
    jax_dir = os.path.basename(_committed_best(name))
    bests = sorted(f for f in os.listdir(os.path.join(w, "ckpt", name)) if f.startswith("best_"))
    if record["test_loss"] < want["test_loss"]:  # a new best: the JAX directory goes
        assert bests == [f"best_{record['test_loss']:.6f}_e401"]
        assert resume["best_loss"] == record["test_loss"]
    else:
        assert bests == [jax_dir] and resume["best_loss"] == want["test_loss"]


# ------------------------------------------------------------------ (f) resume.msgpack


SMALL_FNO = dict(width=6, modes=8, fno_layers=2, l_min=2)


def _jax_resume(d, rng):
    """A small fpe1d ``NIOFNO1D``, one optax Adam update of a seeded gradient, and JAX's
    ``save_resume`` of the state: the flax tree, the optimizer, the state, the gradient
    of the next update and the schedule."""
    jmodel = jax_nio1d.NIOFNO1D(**SMALL_FNO)
    x = jnp.asarray(rng.standard_normal((2, 5, 80)), jnp.float32)
    grid = jnp.linspace(0, 1, 80)[:, None]
    variables = jax.jit(jmodel.init)({"params": jax.random.PRNGKey(0),
                                      "sample": jax.random.PRNGKey(1)}, x, grid)
    params, stats = variables["params"], variables.get("batch_stats", {})
    schedule = jax_loop.step_lr(1e-3, 0.5, 100, 3)
    tx = optax.adam(schedule)
    draw = lambda: jax.tree.map(
        lambda a: jnp.asarray(rng.standard_normal(a.shape), a.dtype), params)
    opt_state = tx.init(params)
    updates, opt_state = tx.update(draw(), opt_state, params)
    params = optax.apply_updates(params, updates)
    jax_ck.save_resume(d, params, stats, opt_state, epoch=3, best_loss=0.4375)
    return params, stats, tx, opt_state, draw(), schedule


def test_resume_msgpack_restores_bit_for_bit_and_steps_as_optax(tmp_path, monkeypatch, capsys):
    d = str(tmp_path / "ckpt")
    rng = np.random.default_rng(0)
    params, stats, tx, opt_state, grad, schedule = _jax_resume(d, rng)
    state = from_flax(*map(jax.device_get, (params, stats)))
    adam = jax.device_get(opt_state[0])
    restored = ck.load_resume(d)
    assert restored["path"] == os.path.join(d, ck.RESUME)
    _assert_same_state({**restored["params"], **restored["batch_stats"]}, state)
    assert (restored["epoch"], restored["best_loss"]) == (3, 0.4375)

    # the loop restores it (epochs=3: nothing is trained)
    made = _captured_optimizers(monkeypatch)
    model = NIOFNO1D(**SMALL_FNO, device="cpu")
    data = SetToFieldData(rng.standard_normal((8, 5, 80)).astype(np.float32),
                          rng.standard_normal((8, 80, 2)).astype(np.float32))
    grid = np.linspace(0, 1, 80, dtype=np.float32)[:, None]
    cfg = loop.TrainConfig(epochs=3, batch_size=2, ckpt_dir=d, log_path=None)
    res = loop.train_model(model, data, grid, cfg, device="cpu")
    assert f"resumed from {os.path.join(d, ck.RESUME)} at epoch 4" in capsys.readouterr().out
    assert res.best_test_loss == 0.4375
    _assert_same_state({**res.params, **res.batch_stats}, state)
    opt = made[0]
    names = [k for k, p in model.named_parameters() if p.requires_grad]
    mu, nu = from_flax(adam.mu, None), from_flax(adam.nu, None)
    for name, s in zip(names, opt.state_dict()["state"].values()):
        assert s["step"] == int(adam.count) == 1
        assert torch.equal(s["exp_avg"], mu[name]) and torch.equal(s["exp_avg_sq"], nu[name])

    # one more Adam update with the same gradient, against optax's
    updates, _ = tx.update(grad, opt_state, params)
    want = from_flax(jax.device_get(optax.apply_updates(params, updates)), None)
    g = from_flax(jax.device_get(grad), None)
    trained = dict(model.named_parameters())
    for name in names:
        trained[name].grad = g[name].clone()
    for group in opt.param_groups:
        group["lr"] = schedule(int(adam.count))
    opt.step()
    for name in names:
        err = torch.linalg.norm(trained[name].detach() - want[name])
        assert err <= STEP_TOL * torch.linalg.norm(want[name]), name

    # an earlier port version's resume.pt of a later epoch wins, one of an earlier or the
    # same epoch does not
    for epoch, wins in ((2, ck.RESUME), (3, ck.RESUME), (4, ck.OLD_RESUME)):
        torch.save({"params": dict(model.named_parameters()), "batch_stats": {},
                    "opt_state": opt.state_dict(), "epoch": epoch, "best_loss": 0.5},
                   os.path.join(d, ck.OLD_RESUME))
        assert ck.load_resume(d)["path"] == os.path.join(d, wins)


def test_adam_from_optax_checks_the_counts():
    with pytest.raises(ValueError, match="differs from the schedule"):
        adam_from_optax({"0": {"count": np.int32(2), "mu": {}, "nu": {}},
                         "1": {"count": np.int32(3)}}, [], [])
