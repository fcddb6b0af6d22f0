"""The port's figures, debug helpers, ``mse``, ``epoch_batch_indices``, the converter's
way back and the ``all`` and ``encoder`` AMP policies, against the JAX package on the
CPU.

- Every plot of ``blindno_torch.eval.plots`` renders to a PNG of more than 1000 bytes, as
  ``tests/test_plots.py`` holds JAX's, and the suite eval's ``_figures`` draws a 1-D and
  a 2-D report.
- ``format_tensor_size`` equals JAX's; ``param_count`` of every registry model (and the
  vestigial and 3-D NIOs) equals the count of its flax tree.
- ``to_flax(from_flax(tree))`` is the tree bit for bit for every model, and JAX's
  ``predict_fields`` on ``to_flax`` of the port's weights agrees with the port's
  ``predict_fields`` within 2e-3 of the output's scale.
- The two policies are held to JAX's bf16 step as ``tests/test_torch_train.py`` holds
  ``encoder_bn32``.
"""
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_train
from blindno.eval.field_eval import predict_fields as jax_predict_fields
from blindno.eval.metrics import mse as jax_mse
from blindno.models.blindno_unet import PermInvUNetAttn as JUNet
from blindno.models.nio1d import NIOFNO1D as JNIOFNO1D
from blindno.models.nio1d import NIOFPOde as JNIOFPOde
from blindno.suites.registry import SUITES as JSUITES
from blindno.suites.registry import VESTIGIAL_MODELS as JVESTIGIAL
from blindno.train.loop import amp_cast_fns
from blindno.utils.debug import format_tensor_size as jax_format_tensor_size
from blindno.utils.debug import param_count as jax_param_count
from blindno_torch.convert import from_flax, to_flax
from blindno_torch.data.datasets import epoch_batch_indices
from blindno_torch.eval import plots
from blindno_torch.eval.field_eval import _figures, predict_fields
from blindno_torch.eval.metrics import mse
from blindno_torch.models.blindno_unet import PermInvUNetAttn
from blindno_torch.models.nio1d import NIOFNO1D, NIOFPOde
from blindno_torch.models.nio3d import NIOFP3D
from blindno_torch.suites.registry import SUITES, VESTIGIAL_MODELS
from blindno_torch.train.step import train_step
from blindno_torch.utils.debug import DeviceMemoryDebugger, format_tensor_size, param_count
from test_torch_nio3d import TOL, _scale_err
from test_torch_train import BF16_TOL, _rel_l2, _run_steps, _step_errors, small_step  # noqa: F401

# ------------------------------------------------------------------ figures


def test_all_plots_render(tmp_path):
    """``tests/test_plots.py`` on the port's plots."""
    rng = np.random.default_rng(0)
    x = np.linspace(0, 1, 80)
    u_gt = -np.exp(-(((x - 0.5) / 0.1) ** 2))
    models = {"blindno": u_gt * 1.02, "nio": u_gt * 0.9, "fno": u_gt * 1.1}
    plots.plot_drift_comparison(x, u_gt, models, str(tmp_path / "drift.png"))
    t = np.linspace(0, 1, 50)
    ref = np.abs(rng.standard_normal((50, 80))) + 1.0
    trajs = {k: ref + 0.01 * rng.standard_normal((50, 80)) for k in models}
    plots.plot_error_over_time(t, trajs, ref, str(tmp_path / "eot.png"))
    plots.plot_final_density(x, trajs, ref, str(tmp_path / "final.png"))
    plots.plot_spacetime_density(ref, str(tmp_path / "st.png"), title="|psi|")
    plots.plot_field_2d(rng.standard_normal((61, 61)), str(tmp_path / "f2d.png"),
                        clamp_nonpositive=True)
    for f in ("drift.png", "eot.png", "final.png", "st.png", "f2d.png"):
        assert os.path.getsize(tmp_path / f) > 1000
    np.testing.assert_allclose(plots.normalize_potential(u_gt, u_gt).max(), 0.0, atol=1e-12)
    np.testing.assert_allclose(plots.relative_l2_over_time(ref, ref), 0.0)


@pytest.mark.parametrize("dim", [1, 2])
def test_figures_draw_the_first_samples(tmp_path, dim):
    """The suite eval's figures: one PNG per sample for the first three, their paths
    returned; 1-D line plots (truth of field 0 beside each field), 2-D imshow pairs."""
    rng = np.random.default_rng(1)
    if dim == 1:
        preds, test = rng.standard_normal((5, 80, 2)), {"potential": rng.standard_normal((5, 80))}
    else:
        preds = rng.standard_normal((4, 20, 20, 2))
        test = {"F": rng.standard_normal((4, 2, 20, 20))}
    paths = _figures(str(tmp_path), preds, test)
    assert paths == [str(tmp_path / f"pred_sample_{i}.png") for i in range(3)]
    assert all(os.path.getsize(p) > 1000 for p in paths)


def test_figures_say_so_without_matplotlib(tmp_path, monkeypatch):
    import builtins

    real_import = builtins.__import__

    def no_matplotlib(name, *args, **kwargs):
        if name.startswith("matplotlib"):
            raise ImportError("No module named 'matplotlib'")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_matplotlib)
    out = _figures(str(tmp_path), np.zeros((2, 8, 1)), {"V": np.zeros((2, 8))})
    assert out.startswith("not made: matplotlib cannot be imported")
    assert not os.listdir(tmp_path)


# ------------------------------------------------------------------ debug helpers, metrics


def test_format_tensor_size_matches_jax():
    for n in (0, 1, 1023, 1024, 1536, 2 ** 20 - 1, 3 * 2 ** 30, 2 ** 40 + 5, 2 ** 52, -4096, 12.5):
        assert format_tensor_size(n) == jax_format_tensor_size(n), n


def test_print_size_and_memory_debugger(capsys):
    model = NIOFPOde(width=4, modes=3, n_basis=3, neurons=8, device="cpu")
    from blindno_torch.utils.debug import print_size

    n = print_size(model, "ode")
    assert n == param_count(model) == param_count(model.state_dict()) - sum(
        b.numel() for b in model.buffers())
    assert f"Total number of ode parameters: {n} (~" in capsys.readouterr().out
    debugger = DeviceMemoryDebugger(device="cpu")  # no CUDA allocator: 0, as JAX reads it
    assert debugger.print("here") == 0
    assert "[mem] here: 0.00 B (delta 0.00 B)" in capsys.readouterr().out


def test_mse_matches_jax():
    rng = np.random.default_rng(2)
    a, b = rng.standard_normal((2, 3, 5, 4)).astype(np.float32)
    got = mse(torch.tensor(a), torch.tensor(b))
    assert got.shape == ()
    np.testing.assert_allclose(float(got), float(jax_mse(jnp.asarray(a), jnp.asarray(b))), rtol=1e-6)


@pytest.mark.parametrize("n,batch", [(10, 3), (12, 4), (5, 8)])
def test_epoch_batch_indices_shape_and_coverage(n, batch):
    """JAX's rules: (n // batch, batch) distinct indices of range(n), the tail past the
    last full batch dropped; the same generator state gives the same epoch."""
    got = epoch_batch_indices(torch.Generator().manual_seed(0), n, batch)
    want = jax.eval_shape(lambda k: __import__("blindno.data.datasets", fromlist=["x"])
                          .epoch_batch_indices(k, n, batch), jax.random.PRNGKey(0))
    assert tuple(got.shape) == want.shape == (n // batch, batch)
    flat = got.flatten().tolist()
    assert len(set(flat)) == len(flat) and set(flat) <= set(range(n))
    assert torch.equal(got, epoch_batch_indices(torch.Generator().manual_seed(0), n, batch))
    if n // batch >= 2:
        assert not torch.equal(got, epoch_batch_indices(torch.Generator().manual_seed(1), n, batch))


# ------------------------------------------------------------------ the converter's way back

SPATIAL_3D = (40, 40, 40)
# name -> (JAX model, port factory, JAX input x, grid): every registry model, the
# vestigial NIO and the 3-D NIO at their own configurations
MODELS = {f"{s}-{m}": (functools.partial(JSUITES[s].models[m]),
                       functools.partial(SUITES[s].models[m], device="cpu"), s)
          for s in SUITES for m in SUITES[s].models}
MODELS["vestigial-nio_ode"] = (JVESTIGIAL["nio_ode"],
                               functools.partial(VESTIGIAL_MODELS["nio_ode"], device="cpu"), "ode")
MODELS["nio3d"] = (lambda: __import__("blindno.models.nio3d", fromlist=["x"]).NIOFP3D(),
                   functools.partial(NIOFP3D, device="cpu"), "3d")


def _inputs(kind):
    """A batch of one set and the grid for a model of the suite ``kind`` (or "ode", "3d")."""
    if kind == "ode":
        return np.zeros((1, 5, 11), np.float32), np.zeros((100, 1), np.float32)
    if kind == "3d":
        return np.zeros((1, 2, *SPATIAL_3D), np.float32), np.zeros((*SPATIAL_3D, 3), np.float32)
    grid = JSUITES[kind].grid
    return np.zeros((1, 4, *grid.shape[:-1]), np.float32), grid


@functools.lru_cache(maxsize=None)
def _case(name):
    """The port's model, and a flax tree of its JAX counterpart's shapes filled with seeded
    normal draws (``jax.eval_shape`` of the init: nothing compiles)."""
    jfactory, factory, kind = MODELS[name]
    x, grid = _inputs(kind)
    shapes = jax.eval_shape(jfactory().init, {"params": jax.random.PRNGKey(0),
                                              "sample": jax.random.PRNGKey(1)},
                            jnp.asarray(x), jnp.asarray(grid))
    rng = np.random.default_rng(sum(map(ord, name)))
    tree = jax.tree.map(lambda s: rng.standard_normal(s.shape).astype(np.float32), shapes)
    return factory(), tree["params"], tree.get("batch_stats", {})


@pytest.mark.parametrize("name", MODELS)
def test_param_count_matches_the_flax_tree(name):
    model, params, _ = _case(name)
    assert param_count(model) == jax_param_count(params)


@pytest.mark.parametrize("name", MODELS)
def test_to_flax_inverts_from_flax(name):
    """The port's model takes ``from_flax`` of the tree (strictly), and ``to_flax`` of its
    state dict gives the tree back bit for bit: kernels, the transposed convs' flip, the
    frozen fusion maps, the spectral planes, the BatchNorm statistics."""
    model, params, stats = _case(name)
    model.load_state_dict(from_flax(params, stats))
    back_params, back_stats = to_flax(model.state_dict())
    assert jax.tree.structure(back_params) == jax.tree.structure(params)
    assert jax.tree.structure(back_stats) == jax.tree.structure(stats)
    for a, b in zip(jax.tree.leaves((back_params, back_stats)), jax.tree.leaves((params, stats))):
        assert a.dtype == np.float32 and a.shape == b.shape and np.array_equal(a, b)


def test_to_flax_refuses_an_unknown_module():
    model, params, stats = _case("fpe1d-nio")
    state = dict(from_flax(params, stats), **{"extra.weight": torch.zeros(2)})
    with pytest.raises(KeyError, match="extra"):
        to_flax(state)


def _randomize_buffers(model, seed):
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, buf in model.named_buffers():
            if name.endswith("running_mean"):
                buf.copy_(0.05 * torch.randn(buf.shape, generator=g))
            elif name.endswith("running_var"):
                buf.copy_(0.7 + 0.6 * torch.rand(buf.shape, generator=g))
    return model


SERVE = {  # name -> (JAX model, port model, inputs (M, L, *spatial), grid)
    "nio_ode": (lambda: JNIOFPOde(width=8, modes=8, n_basis=5, neurons=16),
                lambda: NIOFPOde(width=8, modes=8, n_basis=5, neurons=16, device="cpu"),
                (3, 20, 11), np.linspace(0, 1, 100, dtype=np.float32).reshape(100, 1)),
    "fno1d": (lambda: JNIOFNO1D(width=6, modes=8, fno_layers=2),
              lambda: NIOFNO1D(width=6, modes=8, fno_layers=2, device="cpu"),
              (3, 4, 80), np.linspace(0, 1, 80, dtype=np.float32).reshape(80, 1)),
    "unet1d": (lambda: JUNet(input_size=(80,), depth=3, width=6, fno_modes=6, fno_layers=2,
                             head_dims=(1, 1), subsample=True),
               lambda: PermInvUNetAttn(input_size=(80,), depth=3, width=6, fno_modes=6,
                                       fno_layers=2, head_dims=(1, 1), subsample=True,
                                       device="cpu"),
               (3, 4, 80), np.linspace(0, 1, 80, dtype=np.float32).reshape(80, 1)),
}


@pytest.mark.parametrize("name", SERVE)
def test_jax_serves_the_port_s_weights(name):
    """The port's own seeded weights (its BatchNorm statistics randomized) through
    ``to_flax`` into JAX's ``predict_fields``: the same fields as the port's within 2e-3
    of their scale. The FNO-branch NIO checks the branch's renaming, the UNet the
    transposed convs' flip."""
    jfactory, factory, shape, grid = SERVE[name]
    model = _randomize_buffers(factory(), 5)
    x = np.random.default_rng(6).standard_normal(shape).astype(np.float32)
    params, stats = to_flax(model.state_dict())
    want = jax_predict_fields(jfactory(), params, stats, x, jnp.asarray(grid), batch=2)
    got = predict_fields(model, x, grid, batch=2, device="cpu")
    assert got.shape == want.shape
    assert _scale_err(got, want) < TOL


# ------------------------------------------------------------------ the amp policies


@pytest.mark.parametrize("policy", ["all", "encoder"])
def test_small_niofp2d_bf16_policy_steps_match_jax(small_step, policy, monkeypatch):
    """Two bfloat16 steps of the small NIOFP2D under ``all`` and ``encoder`` against JAX's
    (``amp_cast_fns(jnp.bfloat16, policy)``), each from JAX's state, as
    ``test_small_niofp2d_bf16_encoder_bn32_steps_match_jax`` holds ``encoder_bn32``:

    - the loss, the gradients outside the encoder and the running statistics within
      BF16_TOL = 5e-2 (relative L2) of JAX's bf16 step under ``encoder`` (measured: at
      most 2.8e-2), and within 2 x BF16_TOL under ``all`` (see below);
    - the encoder's gradients against the port's float32 ones, no less accurate than
      JAX's bf16 gradients are: their mean distance over the encoder's tensors within
      1.5x JAX's, and each tensor's within 1.5x the largest of JAX's at that step. bf16
      rounding makes single tensors chaotic at the 0.2 level on both sides (the
      ``encoder_bn32`` test's note): the last block's gradients lie 0.09-0.18 from the
      float32 ones in the port and 0.03-0.12 in JAX, the other blocks' 0.12-0.24 on both
      sides (measured on the CPU), so a tensor-by-tensor ratio to JAX's would measure
      that chaos, not the port;
    - every gradient and updated tensor finite and float32, the conv biases' gradients
      below 1e-3 of the largest gradient.

    Under ``all`` every parameter outside the encoder takes bfloat16 values too, and its
    gradient is rounded to bfloat16 on both sides. At the second step (from JAX's state
    after its first) the policy moves the heads' gradients far from ``encoder_bn32``'s
    (``heads.0.fc0.weight`` by 0.75 relative L2 in JAX, 0.79 in the port) and the port
    lands 6.9e-2 from JAX there, 2.9e-2 or less elsewhere (measured on the CPU); the
    first step's gap is at most 2.9e-2. oneDNN is off, as there (its bfloat16
    convolution on the CPU)."""
    monkeypatch.setattr(test_torch_train, "amp_cast_fns", lambda c, _: amp_cast_fns(c, policy))
    monkeypatch.setattr(test_torch_train, "train_step",
                        functools.partial(train_step, amp_policy=policy))
    _, _, x, y, grid, draws = small_step
    with torch.backends.mkldnn.flags(enabled=False):
        steps = _run_steps(small_step, monkeypatch, jnp.bfloat16, "bfloat16")
    monkeypatch.setattr(test_torch_train, "train_step", train_step)
    direct_tol = BF16_TOL if policy == "encoder" else 2 * BF16_TOL
    for (state, jax_out, port_out), draw in zip(steps, draws):
        errs = _step_errors(jax_out, port_out, zero_bound=1e-3)
        f32 = test_torch_train._port_step(state, x, y, grid, draw)[1]
        jax_bf16 = from_flax(jax_out[1], None)
        encoder = {k for k in errs if k.startswith("deeponet.branch.")}
        direct = {k: e for k, e in errs.items() if k not in encoder and
                  (k == "loss" or "running_" in k or not k.startswith("state "))}
        bad = {k: e for k, e in direct.items() if not e <= direct_tol}
        assert not bad, bad
        dist = {k: (_rel_l2(port_out[1][k], f32[k]), _rel_l2(jax_bf16[k], f32[k])) for k in encoder}
        port_mean, jax_mean = np.mean(list(dist.values()), axis=0)
        assert port_mean <= 1.5 * jax_mean, (port_mean, jax_mean)
        worst = max(d[1] for d in dist.values())
        bad = {k: d for k, d in dist.items() if not d[0] <= 1.5 * worst}
        assert not bad, bad
