"""``TrainConfig(epoch_scan=True)`` on the card: the epoch program's CUDA graph
(``blindno_torch/train/scan.py``) against the per-step loop.

Marked ``cuda``: each test asks the ``cuda_device`` fixture, which skips it where no
CUDA device is present (the decision is taken when the test runs, never at import). The
file imports nothing of JAX, so on the card host it runs with ``--noconftest``.

The two Adams round differently (the captured one's bias corrections are float32
products on the card, the host's float64 ones), so a scanned run is held to its
per-step twin within bounds, not bit for bit: the history within HIST_TOL relative, each
final tensor within STATE_TOL relative L2 (CONV_TOL in the conv stack, where the
ConvNeXt blocks' max pools pass a gradient to either of two entries within rounding of
each other, as ``chip_smoke.py``'s ``unet_tol`` holds the UNet).

Across ranks (over NCCL, one card a rank): a one-rank group runs the DDP step captured
with its all-reduce and equals the one-process program bit for bit (the same Adam,
deterministic cuDNN, TF32 off); two ranks on two cards, where the host has them, land
within the bounds of the one-process program.
"""
import dataclasses

import numpy as np
import pytest
import torch

from blindno_torch.data.datasets import SetToFieldData
from blindno_torch.models.blindno_unet import PermInvUNetAttn
from blindno_torch.nn.setops import subsample_set
from blindno_torch.ops.spectral_cuda import fno1d_layer_cuda
from blindno_torch.parallel import dryrun
from blindno_torch.parallel.mesh import RankPool
from blindno_torch.suites.registry import SUITES
from blindno_torch.train import loop, scan
from blindno_torch.train.checkpoint import RESUME
from blindno_torch.train.jax_checkpoint import read_msgpack
from blindno_torch.train.loop import TrainConfig, train_model

pytestmark = pytest.mark.cuda

HIST_TOL, STATE_TOL, CONV_TOL = 1e-4, 2e-3, 1e-2


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _data_1d(m, l=100, n=80, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, 1, n)) + 0.5 * rng.standard_normal((m, l, n))
    y = rng.standard_normal((m, n, 2))
    grid = np.linspace(0, 1, n, dtype=np.float32).reshape(-1, 1)
    return SetToFieldData(x.astype(np.float32), y.astype(np.float32)), grid


def _rel(a, b):
    a = a.to(b.device)  # a rank's result lies on that rank's card
    if torch.equal(a, b):
        return 0.0
    return float((a.double() - b.double()).norm() / b.double().norm())


def _assert_close_runs(scanned, eager, conv=lambda k: False):
    a = [v for h in scanned.history for v in (h["train_loss"], h["test_loss"], *h["field_rel_l2"])]
    b = [v for h in eager.history for v in (h["train_loss"], h["test_loss"], *h["field_rel_l2"])]
    assert len(a) == len(b) and np.isfinite(a).all()
    np.testing.assert_allclose(a, b, rtol=HIST_TOL, atol=0)
    state = {**{k: _rel(scanned.params[k], v) for k, v in eager.params.items()},
             **{k: _rel(scanned.batch_stats[k], v) for k, v in eager.batch_stats.items()
                if v.is_floating_point()}}
    bad = {k: e for k, e in state.items() if not e <= (CONV_TOL if conv(k) else STATE_TOL)}
    assert not bad, bad


def test_replays_draw_what_eager_steps_draw(cuda_device):
    """A captured set subsample (``subsample_set`` from a generator registered with the
    graph) replayed 5 times draws what 5 eager calls from the same generator state draw,
    and leaves the generator where they leave it."""
    x = torch.arange(100, dtype=torch.float32, device=cuda_device).view(1, 100, 1).expand(2, 100, 3)
    eager_gen = torch.Generator(device=cuda_device).manual_seed(11)
    want = [torch.cat([m.view(-1), s[0, :, 0]]) for s, m in
            (subsample_set(x, 50, eager_gen) for _ in range(5))]
    gen = torch.Generator(device=cuda_device).manual_seed(11)
    out = torch.empty(200, device=cuda_device)
    graph = torch.cuda.CUDAGraph()
    graph.register_generator_state(gen)
    stream = torch.cuda.Stream()
    with torch.cuda.graph(graph, stream=stream):
        s, m = subsample_set(x, 50, gen)
        out.copy_(torch.cat([m.view(-1), s[0, :, 0]]))
    got = []
    for _ in range(5):
        graph.replay()
        got.append(out.clone())
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert len({tuple(g.tolist()) for g in got}) == 5
    assert torch.equal(torch.randint(0, 2**30, (4,), generator=gen, device=cuda_device),
                       torch.randint(0, 2**30, (4,), generator=eager_gen, device=cuda_device))


def _small_unet1d(device):
    return PermInvUNetAttn(input_size=(80,), depth=3, width=8, fno_modes=8, fno_layers=2,
                           head_dims=(1, 1), subsample=True, l_min=50, device=device)


@pytest.mark.parametrize("first,then", [(True, False), (False, True)])
def test_checkpoint_state_round_trips_between_modes(first, then, cuda_device, tmp_path):
    """A narrow 1-D UNet, epoch 1 under ``epoch_scan=first`` with a resume checkpoint,
    epochs 2-3 resumed under ``epoch_scan=then``: the file holds optax's Adam state
    either way (both counts 0-d int32 arrays at Adam's step), and the resumed run lands within the bounds of an unbroken per-step run's (the draws depend
    on the epoch alone and inject the subsamples, so both runs see the same batches)."""
    data, grid = _data_1d(40)
    n_train = 32

    def draws(epoch, steps):
        rng = np.random.default_rng([3, epoch])
        subs = [(rng.integers(0, 100, 100), (np.arange(100) < rng.integers(50, 100)).astype(np.float32))
                for _ in range(steps)]
        return (rng.permutation(n_train)[: 8 * steps].reshape(steps, 8),
                rng.integers(0, 2, steps).tolist(), subs)

    cfg = TrainConfig(epochs=3, batch_size=8, lr=1e-3, save_interval=1, augment="flip1d")
    ck = dict(ckpt_dir=str(tmp_path / "ck"))
    init = _small_unet1d("cpu").state_dict()

    def run(c):
        model = _small_unet1d(cuda_device)
        model.load_state_dict(init)
        return train_model(model, data, grid, c, draws=draws)

    whole = run(cfg)
    part = run(dataclasses.replace(cfg, epochs=1, epoch_scan=first, **ck))
    adam = read_msgpack(str(tmp_path / "ck" / RESUME))["opt_state"]
    counts = [adam["0"]["count"], adam["1"]["count"]]
    assert all(c.dtype == np.int32 and c.shape == () and int(c) == 4 for c in counts)
    rest = run(dataclasses.replace(cfg, epoch_scan=then, **ck))
    assert [h["epoch"] for h in part.history + rest.history] == [1, 2, 3]
    _assert_close_runs(dataclasses.replace(rest, history=part.history + rest.history), whole,
                       conv=lambda k: not k.startswith("heads."))


def test_fpe1d_unet_epoch_scan_matches_its_per_step_loop(cuda_device, monkeypatch):
    """The fpe1d suite's UNet (``flip1d``, its FNO1d heads' ``fno1d_layer`` kernel inside
    the graph) at the suite's config for 2 epochs of 2 steps of 32 sets, from the same
    weights and seed: the scanned run within the bounds of the per-step one; 2 x 2 - 1
    replays of one graph holding the step's 6 kernel calls, so the run executes as many
    as the per-step loop's."""
    spec = SUITES["fpe1d"]
    data, grid = _data_1d(80)
    cfg = dataclasses.replace(spec.train_cfg, epochs=2, save_interval=1)
    programs = []

    class Kept(scan.EpochProgram):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            programs.append(self)

        def _capture(self):
            before = fno1d_layer_cuda.launches
            super()._capture()
            self.captured = fno1d_layer_cuda.launches - before

    monkeypatch.setattr(loop, "EpochProgram", Kept)
    runs = {}
    for scanned in (False, True):
        model = spec.models["unet"](generator=torch.Generator().manual_seed(0), device=cuda_device)
        fno1d_layer_cuda.launches = 0
        runs[scanned] = train_model(model, data, grid, dataclasses.replace(cfg, epoch_scan=scanned))
        runs[scanned, "calls"] = fno1d_layer_cuda.launches
    program, = programs
    assert program.replays == 3 and program.captured == 6
    executed = runs[True, "calls"] - program.captured + program.captured * program.replays
    assert executed == runs[False, "calls"] == 6 * (2 + 1) * 2
    _assert_close_runs(runs[True], runs[False], conv=lambda k: not k.startswith("heads."))


# epochs of 4 steps: DDP's 11 eager steps end in epoch 3, whose last step is captured, so
# epoch 4 replays whole
RANKS_EPOCHS = 4
RANKS_CFG = TrainConfig(epochs=RANKS_EPOCHS, batch_size=8, lr=1e-3, save_interval=1,
                        augment="flip1d", seed=4)


@pytest.fixture
def deterministic_card(cuda_device):
    torch.backends.cudnn.deterministic = True
    yield cuda_device
    torch.backends.cudnn.deterministic = False


def _one_process_program(device, init, data, grid):
    """``train_model(epoch_scan=True)`` of the narrow 1-D UNet from ``init`` in this
    process (a rank, where a process group is up), its program recorded."""
    model = _small_unet1d(device)
    model.load_state_dict(init)
    with dryrun.recorded_programs() as programs:
        result = train_model(model, data, grid, dataclasses.replace(RANKS_CFG, epoch_scan=True))
    return result, programs


def _same_run(a, b):
    keys = ("epoch", "train_loss", "test_loss", "field_rel_l2")
    return ([{k: h[k] for k in keys} for h in a.history] == [{k: h[k] for k in keys}
                                                            for h in b.history]
            and all(torch.equal(a.params[k], v) for k, v in b.params.items())
            and all(torch.equal(a.batch_stats[k], v) for k, v in b.batch_stats.items()))


def test_one_nccl_rank_captures_the_ddp_step_bit_for_bit(deterministic_card, tmp_path):
    """A one-rank NCCL group (a file store) trains the narrow 1-D UNet through
    ``train_model(epoch_scan=True)``: DDP's 11 eager steps, then its step captured with
    the all-reduce inside (the profiler sees it issued during the capture) and replayed;
    epoch 4 replays whole under sync debug mode "error". The history and final state
    equal the one-process program's (1 eager step, then replays) bit for bit: the same
    capturable Adam in both, and an all-reduce of one rank is the identity."""
    data, grid = _data_1d(40)
    init = _small_unet1d("cpu").state_dict()
    single, (one,) = _one_process_program(deterministic_card, init, data, grid)
    torch.distributed.init_process_group("nccl", init_method=f"file://{tmp_path}/store",
                                         rank=0, world_size=1)
    try:
        ranked, (program,) = _one_process_program(deterministic_card, init, data, grid)
    finally:
        torch.distributed.destroy_process_group()
    steps = RANKS_EPOCHS * 4
    assert (one["eager_steps"], one["replays"]) == (1, steps - 1)
    assert (program["eager_steps"], program["replays"]) == (11, steps - 11)
    assert len(program["replayed"]) == 1 and program["captured"]["fno1d_layer"] == 4
    assert any("allreduce" in k for k in program["collectives_captured"]), program
    assert one["collectives_captured"] is None
    assert ranked.finished and _same_run(ranked, single)


@pytest.mark.skipif(not torch.cuda.is_available() or torch.cuda.device_count() < 2,
                    reason="needs two CUDA devices: NCCL takes one card a rank")
def test_two_nccl_ranks_capture_the_dp2_step(deterministic_card):
    """Two NCCL ranks on two cards (DP 2: the batch's rows split, BatchNorm synced over
    both, DDP's all-reduce) run the program, each rank's step captured with its
    collectives; every rank's history and final state lie within the bounds of the
    one-process program's (the synced statistics and the all-reduce sum in another
    order)."""
    data, grid = _data_1d(40)
    factory = (PermInvUNetAttn, dict(input_size=(80,), depth=3, width=8, fno_modes=8,
                                     fno_layers=2, head_dims=(1, 1), subsample=True, l_min=50,
                                     device="cpu"))
    init = _small_unet1d("cpu").state_dict()
    single, _ = _one_process_program(deterministic_card, init, data, grid)
    state = {k: v.numpy() for k, v in init.items()}
    with RankPool(2, dryrun.full_precision) as pool:
        out = pool.run(dryrun.train_model_ranks, 2, factory, state, data, grid,
                       dataclasses.replace(RANKS_CFG, epoch_scan=True), "cuda", None, True,
                       device="cuda", backend="nccl", timeout=600)
    for r in out:
        (program,) = r["programs"]
        assert program["eager_steps"] == 11 and len(program["replayed"]) == 1
        assert any("allreduce" in k for k in program["collectives_captured"]), program
        _assert_close_runs(r["result"], single, conv=lambda k: not k.startswith("heads."))
