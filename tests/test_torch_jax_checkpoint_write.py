"""The port writes the JAX package's checkpoint formats itself (``blindno_torch/train/
jax_checkpoint.py``: ``write_orbax``, ``write_msgpack``), and JAX's own code reads what it
wrote.

(a) every committed ``runs/ckpt/*/best_*``, read by the port's reader and written by its
writer, restores through JAX's ``load_best`` (orbax) bit for bit as orbax restores the
original, and the port's reader reads it the same; its metadata and zarr headers are
those of orbax's own save of the tree; (b) after two CPU steps of the port, JAX's
``load_resume``, with the target that JAX's loop builds, restores the port's
``resume.msgpack`` bit for bit (its bytes are flax's ``to_bytes`` of what it restores),
and JAX's ``train_model(resume=True)`` continues one epoch that agrees with the port's
own; (c) JAX's eval and time-error stages on a workdir that the port's CLI trained in;
(d) port, JAX and port training in turn in one workdir leave the ``best_*`` names that
JAX's ``save_best`` alone leaves. JAX runs here only as the oracle, on the CPU, and only
on copies: ``runs/`` is read, never written.
"""
import copy
import json
import logging
import os
import shutil
from collections.abc import Mapping

import flax.serialization as fser
import jax
import jax.numpy as jnp
import numpy as np
import optax
import orbax.checkpoint as ocp
import pytest
import torch
from flax.core import freeze
from jax.sharding import Mesh, NamedSharding, PartitionSpec

import blindno.data.datasets as jax_datasets
import blindno.models.nio1d as jax_nio1d
import blindno.train.checkpoint as jax_ck
import blindno.train.loop as jax_loop
import blindno_torch.train.loop as loop
from blindno_torch.convert import adam_to_optax, from_flax, to_flax
from blindno_torch.data.datasets import SetToFieldData
from blindno_torch.models.nio1d import NIOFNO1D
from blindno_torch.suites.run import main
from blindno_torch.train import checkpoint as ck
from blindno_torch.train import jax_checkpoint as jc
from test_torch_datagen import _run_jax_cli
from test_torch_jax_checkpoint import (COMMITTED, SMALL_FNO, _assert_same_tree,
                                       _captured_optimizers, _committed_best, _digest,
                                       _printed_report)
from test_torch_suites import EVAL_TOL, _assert_eval_matches_jax
from test_torch_train import STEP_TOL

M, L, N = 20, 5, 80  # (b) and (d): sets, snapshots and points of the 1-D data
BATCH = 16  # the whole train split of M: one step an epoch, whatever order it is drawn in
M_CLI, M_CLI_TEST = 40, 4  # (c): the port's fpe1d datagen


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    logging.disable(logging.WARNING)  # orbax warns that no restore target is given
    yield
    logging.disable(logging.NOTSET)
    torch.set_num_threads(threads)


def _host(tree):
    """``tree`` with JAX's arrays read to numpy and flax's frozen dicts to dicts."""
    if isinstance(tree, Mapping):
        return {k: _host(v) for k, v in tree.items()}
    return tree if isinstance(tree, (int, float)) else np.asarray(tree)


def _json(path):
    with open(path) as fh:
        return json.load(fh)


# ------------------------------------------------------------------ (a) best_* directories


@pytest.mark.parametrize("name", COMMITTED, ids=COMMITTED)
def test_written_directory_restores_through_jax_as_the_committed_one(name, tmp_path):
    src = _committed_best(name)
    before = _digest(os.path.dirname(src))
    d = str(tmp_path / name)
    dst = os.path.join(d, os.path.basename(src))
    jc.write_orbax(dst, jc.read_orbax(src))
    want = _host(ocp.StandardCheckpointer().restore(src))
    _assert_same_tree(_host(jax_ck.load_best(d)), want)
    _assert_same_tree(jc.read_orbax(dst), want)
    assert _digest(os.path.dirname(src)) == before


@pytest.mark.parametrize("name", ["fpe1d_fno", "gpe1d_nio"])
def test_written_metadata_is_orbaxs_own(name, tmp_path):
    """orbax here saves the committed tree, its arrays on a one-device ``data`` mesh as
    JAX's loop places them: ``_METADATA``, ``_sharding``, ``array_metadatas`` and every
    key and ``.zarray`` of the store are the port's writer's, and each chunk decodes to
    the same bytes (fpe1d_fno's tree has an empty ``batch_stats``)."""
    tree = jc.read_orbax(_committed_best(name))
    mesh = Mesh(np.asarray(jax.devices()[:1]), ("data",))
    placed = jax.tree.map(lambda a: jax.device_put(a, NamedSharding(mesh, PartitionSpec()))
                          if isinstance(a, np.ndarray) else a, tree)
    theirs, ours = str(tmp_path / "orbax"), str(tmp_path / "port")
    checkpointer = ocp.StandardCheckpointer()
    checkpointer.save(theirs, placed)
    checkpointer.wait_until_finished()
    jc.write_orbax(ours, tree)
    for f in ("_METADATA", "_sharding", os.path.join("array_metadatas", "process_0")):
        assert _json(os.path.join(ours, f)) == _json(os.path.join(theirs, f)), f
    assert _json(os.path.join(ours, "_CHECKPOINT_METADATA")).keys() == \
        _json(os.path.join(theirs, "_CHECKPOINT_METADATA")).keys()
    got, want = jc.read_ocdbt(ours), jc.read_ocdbt(theirs)
    assert got.keys() == want.keys()
    for key in want:
        if key.endswith(".zarray"):
            assert got[key] == want[key], key
        else:
            meta = json.loads(want[os.path.dirname(key) + "/.zarray"])
            size = int(np.prod(meta["shape"], dtype=np.int64)) * np.dtype(meta["dtype"]).itemsize
            assert (jc.zstd_decompress(got[key], size, key).tobytes()
                    == jc.zstd_decompress(want[key], size, key).tobytes()), key


# ------------------------------------------------------------------ (b) resume.msgpack


def test_msgpack_is_flaxs_byte_for_byte(tmp_path):
    """``write_msgpack`` against flax's ``msgpack_serialize`` (what ``to_bytes`` calls) on
    what a resume state holds, at each size boundary of msgpack's forms: maps of 15, 16 and
    70000 keys, keys of 31, 32 and 300 bytes, integers of every width and sign, doubles,
    arrays of every rank up to 2 and payloads of the fixext and ext forms."""
    rng = np.random.default_rng(0)
    numbers = [0, 127, 128, 255, 256, 65535, 65536, 2 ** 32, -1, -32, -33, -128, -129,
               -2 ** 15 - 1, -2 ** 31 - 1, 0.4375, float("inf")]
    state = {"params": {"a": rng.standard_normal((3, 4)).astype(np.float32),
                        "b" * 31: {"c": np.zeros((), np.float32)}, "b" * 32: np.arange(2.0),
                        "e" * 300: np.arange(5, dtype=np.int64),
                        "d": rng.standard_normal(70000).astype(np.float32)},
             "batch_stats": {}, "count": np.asarray(7, np.int32),
             "numbers": {f"n{i:02d}": v for i, v in enumerate(numbers)},
             "fifteen": {f"k{i}": i for i in range(15)}, "sixteen": {f"k{i}": i for i in range(16)},
             "wide": {f"k{i:05d}": i for i in range(70000)}}
    path = str(tmp_path / "state.msgpack")
    jc.write_msgpack(path, state)
    with open(path, "rb") as fh:
        assert fh.read() == fser.msgpack_serialize(copy.deepcopy(state), in_place=True)
    got = jc.read_msgpack(path)
    assert got["numbers"] == state["numbers"] and got["wide"] == state["wide"]
    _assert_same_tree(got["params"], state["params"])
    with pytest.raises(jc.JaxCheckpointError, match="type bool"):
        jc.write_msgpack(path, {"flag": True})


def _data(seed=0):
    """Smooth random snapshots (three sine modes) and two fields of their mean, which
    the model learns from the first epochs on: x (M, L, N), y (M, N, 2), the grid."""
    rng = np.random.default_rng(seed)
    t = np.linspace(0, 1, N)
    x = np.einsum("mlk,kn->mln", rng.standard_normal((M, L, 3)),
                  np.sin(np.pi * np.arange(1, 4)[:, None] * t))
    mean = x.mean(1)
    y = np.stack([mean, 0.5 * mean + 0.2], -1)
    return x.astype(np.float32), y.astype(np.float32), t.astype(np.float32)[:, None]


def _whole_sets(monkeypatch):
    """Every set whole in training, on both sides: JAX's ``subsample_set`` patched to
    the identity, and the port's draws (the whole train split, in order) injected."""
    monkeypatch.setattr(jax_nio1d, "subsample_set",
                        lambda key, x, l_min, training: (x, jnp.ones((x.shape[1],), x.dtype)))
    whole = (np.arange(L), np.ones(L, np.float32))
    return lambda epoch, steps: (torch.arange(BATCH).reshape(1, BATCH), None, [whole])


def _cfg(ckpt_dir, epochs, package=loop):
    return package.TrainConfig(epochs=epochs, batch_size=BATCH, lr=1e-3, save_interval=1,
                               ckpt_dir=ckpt_dir, log_path=None)


def _jax_target(jmodel, x, grid, cfg):
    """The target JAX's loop restores ``resume.msgpack`` into
    (``blindno/train/loop.py:309-326``)."""
    variables = jax.jit(jmodel.init)({"params": jax.random.PRNGKey(0),
                                      "sample": jax.random.PRNGKey(0)}, jnp.asarray(x[:2]),
                                     jnp.asarray(grid))
    params = variables["params"]
    spe = int(cfg.train_frac * M) // cfg.batch_size
    tx = optax.adam(jax_loop.step_lr(cfg.lr, cfg.lr_gamma, cfg.lr_step_epochs, spe))
    return {"params": jax.device_get(params),
            "batch_stats": jax.device_get(variables.get("batch_stats", freeze({}))),
            "opt_state": jax.device_get(tx.init(params)), "epoch": 0, "best_loss": 0.0}


def test_jax_resumes_from_the_ports_resume_msgpack(tmp_path, monkeypatch):
    x, y, grid = _data()
    draws = _whole_sets(monkeypatch)
    made = _captured_optimizers(monkeypatch)
    d, jd = str(tmp_path / "port"), str(tmp_path / "jax")
    model = NIOFNO1D(**SMALL_FNO, device="cpu")
    loop.train_model(model, SetToFieldData(x, y), grid, _cfg(d, 2), device="cpu", draws=draws)
    shutil.copytree(d, jd)
    path = os.path.join(jd, ck.RESUME)

    jmodel = jax_nio1d.NIOFNO1D(**SMALL_FNO)
    jcfg = _cfg(jd, 3, jax_loop)
    restored = jax_ck.load_resume(jd, _jax_target(jmodel, x, grid, jcfg))
    with open(path, "rb") as fh:
        assert fser.to_bytes(restored) == fh.read()  # flax writes what the port wrote
    params, stats = to_flax(model.state_dict())
    _assert_same_tree(_host(restored["params"]), params)
    _assert_same_tree(_host(restored["batch_stats"]), stats)
    adam, schedule = restored["opt_state"]
    want = adam_to_optax(made[0].state_dict(), dict(model.named_parameters()),
                         [k for k, p in model.named_parameters() if p.requires_grad])
    assert adam.count.dtype == schedule.count.dtype == np.int32
    assert int(adam.count) == int(schedule.count) == 2 == int(made[0].state_dict()["state"][0]["step"])
    _assert_same_tree(_host(adam.mu), want["0"]["mu"])
    _assert_same_tree(_host(adam.nu), want["0"]["nu"])
    assert restored["epoch"] == 2 and restored["best_loss"] == ck.load_resume(d)["best_loss"]

    # one more epoch each: JAX's loop from the port's files, the port's from its own
    jres = jax_loop.train_model(jmodel, jax_datasets.SetToFieldData(x, y), grid, jcfg)
    res = loop.train_model(NIOFNO1D(**SMALL_FNO, device="cpu"), SetToFieldData(x, y), grid,
                           _cfg(d, 3), device="cpu", draws=draws)
    (got,), (jgot,) = res.history, jres.history
    assert got["epoch"] == jgot["epoch"] == 3
    for k in ("train_loss", "test_loss"):
        assert abs(got[k] - jgot[k]) <= STEP_TOL * abs(jgot[k]), (k, got, jgot)
    jstate = from_flax(*map(jax.device_get, (jres.params, jres.batch_stats)))
    moved = 0
    for name, p in res.params.items():
        err = torch.linalg.norm(p - jstate[name])
        assert err <= STEP_TOL * torch.linalg.norm(jstate[name]), name
        moved += not torch.equal(p, from_flax(params, stats)[name])
    assert moved  # the epoch trained
    # each names its epoch-3 best by its own loss: the two agree within STEP_TOL (above)
    # and may round apart in the sixth decimal that the name keeps
    assert res.best_test_loss == got["test_loss"] and jres.best_test_loss == jgot["test_loss"]
    assert sorted(os.listdir(d)) == [f"best_{res.best_test_loss:.6f}_e3", ck.RESUME]
    assert sorted(os.listdir(jd)) == [f"best_{jres.best_test_loss:.6f}_e3", ck.RESUME]


# ------------------------------------------------------------------ (c) the CLI


def test_jax_stages_read_a_workdir_the_ports_cli_trained(tmp_path, capsys):
    """The port's fpe1d datagen and one epoch of ``--stage train`` of the NIO: JAX's eval
    and time-error stages on a copy of that workdir agree with the port's within
    EVAL_TOL, and the workdir holds no ``.pt``."""
    w, jw = str(tmp_path / "port"), str(tmp_path / "jax")
    argv = ["--suite", "fpe1d", "--model", "nio"]
    main(["--suite", "fpe1d", "--stage", "datagen", "--workdir", w, "--m", str(M_CLI),
          "--m-test", str(M_CLI_TEST), "--device", "cpu"])
    main(argv + ["--stage", "train", "--workdir", w, "--epochs", "1", "--device", "cpu"])
    shutil.copytree(w, jw)
    capsys.readouterr()
    report = main(argv + ["--stage", "eval", "--workdir", w, "--device", "cpu"])
    te = main(argv + ["--stage", "time-error", "--workdir", w, "--m", "2", "--device", "cpu"])
    capsys.readouterr()
    _run_jax_cli(argv + ["--stage", "eval", "--workdir", jw])
    jreport = _printed_report(capsys.readouterr().out)
    _run_jax_cli(argv + ["--stage", "time-error", "--workdir", jw, "--m", "2"])
    jte = _printed_report(capsys.readouterr().out)
    _assert_eval_matches_jax(report, jreport, w, jw, "fpe1d", "nio", M_CLI_TEST)
    assert report["ckpt_epoch"] == jreport["ckpt_epoch"] == 1
    assert te.keys() == jte.keys() and jte["mean_err_l2"] > 0.05
    for k in ("mean_err_l2", "std_err_l2"):
        np.testing.assert_allclose(te[k], jte[k], rtol=EVAL_TOL, err_msg=k)
    files = [f for _, _, fs in os.walk(w) for f in fs]
    assert files and not [f for f in files if f.endswith(".pt")]
    assert sorted(os.listdir(os.path.join(w, "ckpt", "fpe1d_nio"))) == \
        [f"best_{report['ckpt_test_loss']:.6f}_e1", ck.RESUME]


# ------------------------------------------------------------------ (d) mixed workdirs


def test_port_jax_port_training_leaves_jaxs_best_names(tmp_path, monkeypatch):
    """Epochs 1-2 by the port, 3-4 by JAX resuming from them, 5-6 by the port resuming
    from JAX's files, all in one workdir. A mirror workdir where JAX's ``save_best`` takes
    the same saves in the same order holds the same ``best_*`` names after each run,
    and the workdir holds nothing else but ``resume.msgpack``."""
    x, y, grid = _data(1)
    draws = _whole_sets(monkeypatch)
    d, mirror = str(tmp_path / "ck"), str(tmp_path / "mirror")
    saves = []

    def recorded(who, save):
        def record(ckpt_dir, params, stats, epoch, loss, **kw):  # the port's group=
            saves.append((who, epoch, loss))
            return save(ckpt_dir, params, stats, epoch, loss, **kw)

        return record

    monkeypatch.setattr(ck, "save_best", recorded("port", ck.save_best))
    monkeypatch.setattr(jax_ck, "save_best", recorded("jax", jax_ck.save_best))
    replayed = 0

    def check(epochs):
        nonlocal replayed
        for _, epoch, loss in saves[replayed:]:
            _JAX_SAVE_BEST(mirror, {"w": np.zeros(1, np.float32)}, {}, epoch, loss)
        replayed = len(saves)
        assert sorted(os.listdir(d)) == sorted(os.listdir(mirror)) + [ck.RESUME], epochs
        assert ck.load_resume(d)["epoch"] == epochs[-1]

    loop.train_model(NIOFNO1D(**SMALL_FNO, device="cpu"), SetToFieldData(x, y), grid,
                     _cfg(d, 2), device="cpu", draws=draws)
    check((1, 2))
    jax_loop.train_model(jax_nio1d.NIOFNO1D(**SMALL_FNO), jax_datasets.SetToFieldData(x, y),
                         grid, _cfg(d, 4, jax_loop))
    check((3, 4))
    loop.train_model(NIOFNO1D(**SMALL_FNO, device="cpu"), SetToFieldData(x, y), grid,
                     _cfg(d, 6), device="cpu", draws=draws)
    check((5, 6))
    # each run improved on the one before: JAX removed the port's directory and the
    # port JAX's
    assert [who for who, epoch, _ in saves if epoch in (2, 4, 6)] == ["port", "jax", "port"]


_JAX_SAVE_BEST = jax_ck.save_best  # before the test records its calls
