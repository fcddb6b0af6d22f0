"""``train_model`` on a rank count whose data axis does not divide the batch, as JAX's
``data_mesh`` trains on fewer devices (``blindno/parallel/mesh.py:19-28``): at tp=1 the
most ranks that divide the batch train, and the ranks past them idle until the run ends
(``blindno_torch.parallel.mesh.TrainingRanks``).

The ranks are spawned workers of one ``RankPool`` running
``blindno_torch.parallel.dryrun.train_model_ranks`` on a small ``NIOFP1D`` and numpy data
from a seed, each on one torch thread, as in ``tests/test_torch_parallel.py``. Every
rank's result is held bit for bit against the same run on exactly the ranks that train;
JAX's own run on its reduced mesh is held in ``tests/test_torch_epoch_scan_parallel.py``
(mesh ``dp2_idle1``). This module imports no JAX at its top: a spawned rank imports it
to unpickle :class:`SlowDraws`.
"""
import time

import numpy as np
import pytest
import torch

from blindno_torch.data.datasets import SetToFieldData
from blindno_torch.models.nio1d import NIOFP1D
from blindno_torch.parallel import dryrun
from blindno_torch.parallel.mesh import RankPool
from blindno_torch.train.checkpoint import load_best, load_resume
from blindno_torch.train.loop import TrainConfig, train_model

RUN_TIMEOUT = 120.0  # seconds for one group of ranks; a hung rank fails the test
SMALL = dict(width=8, modes=8, n_basis=5, neurons=16, l_min=4, device="cpu")
FACTORY = (NIOFP1D, SMALL)
GRID = np.linspace(0.0, 1.0, 80, dtype=np.float32).reshape(80, 1)
M = 40  # sets: 32 train, 8 test
KEYS = ("epoch", "train_loss", "test_loss", "field_rel_l2")


@pytest.fixture(scope="module")
def ranks():
    """Four spawned ranks for the whole file; each run takes the first ``world``."""
    with RankPool(4) as pool:
        yield lambda fn, world, *args, **kw: pool.run(fn, world, *args, timeout=RUN_TIMEOUT,
                                                      **kw)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The single-process runs on one torch thread, as the ranks run."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _data():
    rng = np.random.default_rng(0)
    return SetToFieldData(rng.standard_normal((M, 8, 80)).astype(np.float32),
                          rng.standard_normal((M, 80, 2)).astype(np.float32))


def _state():
    return {k: v.numpy() for k, v in NIOFP1D(**SMALL).state_dict().items()}


def _table(epochs, batch, n_train=int(0.8 * M)):
    """Draws for ``epochs`` epochs as the loop's ``draws`` hook returns them: each epoch a
    permutation of the train split cut into batches; no group element, the model drawing
    its subsamples."""
    rng = np.random.default_rng(3)
    steps = n_train // batch
    return {e: (rng.permutation(n_train)[:steps * batch].reshape(steps, batch), None, None)
            for e in range(1, epochs + 1)}


class SlowDraws(dict):
    """A draws table each of whose epochs waits ``seconds`` first, on every training rank
    alike, so that the run outlasts a short process-group timeout while no collective
    waits long."""

    def __init__(self, table, seconds):
        super().__init__(table)
        self.seconds = seconds

    def __getitem__(self, epoch):
        time.sleep(self.seconds)
        return super().__getitem__(epoch)


def _same(got, want):
    """Equal bit for bit: tensors, arrays and numbers, in nested dicts."""
    if isinstance(want, dict):
        return got.keys() == want.keys() and all(_same(got[k], want[k]) for k in want)
    if isinstance(want, torch.Tensor):
        return isinstance(got, torch.Tensor) and got.dtype == want.dtype and torch.equal(got, want)
    if isinstance(want, np.ndarray):
        return got.dtype == want.dtype and got.shape == want.shape and \
            got.tobytes() == want.tobytes()
    return got == want


def _same_result(got, want):
    """Two ``TrainResult`` equal bit for bit: history (its numbers), final and best state,
    best loss and how the run ended."""
    numbers = lambda res: [{k: h[k] for k in KEYS} for h in res.history]
    return (numbers(got) == numbers(want) and got.finished == want.finished
            and got.best_test_loss == want.best_test_loss
            and all(_same(getattr(got, k), getattr(want, k))
                    for k in ("params", "batch_stats", "best_params", "best_batch_stats")))


def test_four_ranks_at_batch_6_train_on_three_and_the_idle_rank_returns_the_result(
        ranks, tmp_path):
    """Four ranks at batch 6: the data axis is 3 (JAX's ``data_mesh`` rule), rank 3 is
    idle. Two epochs, each evaluated and checkpointed: every rank's ``TrainResult``,
    rank 3's included, is bit for bit rank 0's of the same run on three ranks; both runs'
    ``best_*`` and ``resume.msgpack`` restore equal trees, and rank 0 alone logged one
    record an epoch."""
    data, state = _data(), _state()
    runs = {}
    for world in (4, 3):
        ck, log = tmp_path / f"ck{world}", tmp_path / f"log{world}.jsonl"
        cfg = TrainConfig(epochs=2, batch_size=6, save_interval=1, ckpt_dir=str(ck),
                          log_path=str(log))
        runs[world] = ranks(dryrun.train_model_ranks, world, FACTORY, state, data, GRID, cfg)
        assert len(log.read_text().splitlines()) == 2
    want = runs[3][0]
    assert want.finished and [h["epoch"] for h in want.history] == [1, 2]
    assert want.history[0]["train_loss"] != want.history[1]["train_loss"]
    for rank, res in enumerate(runs[4]):
        assert _same_result(res, want), rank
    for load in (load_best, load_resume):
        got, ref = load(tmp_path / "ck4"), load(tmp_path / "ck3")
        got.pop("path", None), ref.pop("path", None)
        assert _same(got, ref), load.__name__


def test_a_data_axis_of_one_is_the_one_process_run(ranks):
    """Two ranks at batch 5: the data axis is 1, so rank 0 trains alone through DDP over a
    group of one and rank 1 idles. Both return the one-process run's result bit for
    bit."""
    data, state = _data(), _state()
    cfg = TrainConfig(epochs=2, batch_size=5, save_interval=1)
    out = ranks(dryrun.train_model_ranks, 2, FACTORY, state, data, GRID, cfg)
    one = train_model(dryrun.built(FACTORY, state, "cpu"), data, GRID, cfg, device="cpu")
    assert one.finished and len(one.history) == 2
    for rank, res in enumerate(out):
        assert _same_result(res, one), rank


def test_an_idle_rank_outlives_a_short_group_timeout(ranks):
    """In a process group whose timeout is 3 s, four ranks at batch 6 train for three
    epochs that each first wait 2 s: the idle rank waits out the whole run (no collective
    of its own until the end) and returns the result, equal to the training ranks'."""
    data, state = _data(), _state()
    cfg = TrainConfig(epochs=3, batch_size=6, save_interval=3)
    t0 = time.perf_counter()
    out = ranks(dryrun.train_model_ranks, 4, FACTORY, state, data, GRID, cfg, "cpu",
                SlowDraws(_table(3, 6), 2.0), group_timeout=3.0)
    assert time.perf_counter() - t0 > 6.0
    assert out[3].finished and [h["epoch"] for h in out[3].history] == [3]
    for rank, res in enumerate(out[1:], 1):
        assert _same_result(res, out[0]), rank


def test_a_training_rank_that_raises_makes_the_idle_rank_raise(ranks):
    """Four ranks at batch 6, the draws table lacking epoch 2: the three training ranks
    raise ``KeyError`` there, and the idle rank, waiting for the run's end, raises a
    ``RuntimeError`` that names the failure, within the run's timeout."""
    out = ranks(dryrun.raised, 4, dryrun.train_model_ranks, FACTORY, _state(), _data(), GRID,
                TrainConfig(epochs=2, batch_size=6, save_interval=1), "cpu", _table(1, 6))
    assert all(isinstance(e, KeyError) for e in out[:3]), out
    assert isinstance(out[3], RuntimeError) and "KeyError" in str(out[3]), out[3]


def test_tp2_at_a_batch_the_data_axis_does_not_divide_is_refused_as_jax_refuses_it(ranks):
    """tp=2 on four ranks at batch 5: the data axis, 2, does not divide the batch. JAX
    refuses it on its 8 virtual devices (data axis 4) with a ``ValueError``; so does every
    rank here, before any of them trains."""
    import blindno.train.loop as jax_loop

    with pytest.raises(ValueError, match="not divisible by the data axis"):
        jax_loop.train_model(None, _data(), GRID, jax_loop.TrainConfig(batch_size=5, tp=2))
    out = ranks(dryrun.raised, 4, dryrun.train_model_ranks, FACTORY, _state(), _data(), GRID,
                TrainConfig(epochs=1, batch_size=5, tp=2))
    for e in out:
        assert isinstance(e, ValueError) and "not divisible by the data axis (2" in str(e), e
