"""Flax parameter trees to PyTorch state dicts for the port's models, and back.

``from_flax(params, batch_stats)`` takes the nested dicts of numpy arrays that the JAX
package's checkpoints hold and returns the state dict of the port's model whose tree it
is: :class:`blindno_torch.models.nio2d.NIOFP2D` (and ``NIOAttn2D``, whose tree is the
same), ``NIOFNO2D``, ``NIOFNOAttn2D``, ``NIOTrans2D`` (and ``NIOTransAttn2D``),
:class:`blindno_torch.models.nio1d.NIOFP1D`, ``NIOFNO1D``, ``NIOFPOde``,
:class:`blindno_torch.models.nio3d.NIOFP3D` or
:class:`blindno_torch.models.blindno_unet.PermInvUNetAttn`. ``to_flax(state_dict)`` is
its exact inverse: ``to_flax(from_flax(p, s)) == (p, s)`` bit for bit.

- conv kernels go from (*window, cin, cout) to (cout, cin, *window), for 1-, 2- and
  3-D windows;
- transposed-conv kernels go from (*window, cin, cout) to (cin, cout, *window) and are
  flipped in space (flax's transposed convolution does not flip its kernel, torch's
  does);
- LayerNorm scale/bias become weight/bias as they stand (the port's set attention
  flattens its tokens in JAX's order);
- dense kernels (also the 1x1 ``PointwiseConv`` and either fusion map) from (in, out)
  to (out, in), with their bias (the slice attention's q, k and v have none);
- BatchNorm scale/bias/mean/var become weight/bias/running_mean/running_var;
- spectral ``weights_re`` / ``weights_im`` stay (Cin, Cout, modes), (Cin, Cout, 2*m1, m2)
  or (Cin, Cout, 2*m1, 2*m2, m3) planes;
- the Transolver NIOs' ``Transolver_0`` becomes ``trans``, with its ``temperature``
  and ``placeholder`` parameters as they stand;
- ``FNO1d_k`` / ``FNO2d_k`` become ``heads.k``, except in the FNO-branch models, whose
  tree has a fusion map (``MeanFieldFusion_0`` or ``TokenMeanFusion_0``) but neither a
  DeepONet nor a Transolver: there ``FNO1d_0`` / ``FNO2d_0`` is the ``branch`` and
  ``FNO*d_k`` becomes ``heads.{k-1}``; ``NIOFP3D``'s ``FNO3d_0`` becomes ``head``.

Every flax leaf must map to one torch key and every torch module must receive all of
its tensors: a left-over or missing key raises ``KeyError``. A tree with no statistics at
all, such as a gradient tree, goes in with ``batch_stats=None``: its BatchNorm modules
then give weight and bias only.

:func:`from_flax_checkpoint` turns a whole restored ``best_*`` tree into the port's
checkpoint dict, and :func:`adam_from_optax` JAX's Adam state (``resume.msgpack``'s
``opt_state``) into torch's ``Adam.state_dict()``; :func:`adam_to_optax` is its inverse.

The way back reads the names torch does not keep from the tensors: the encoder's class
from its first conv's window rank and its number of blocks (``EncoderODE`` has 5, an
``Encoder1D`` 6 or 7), each FNO head's rank from its spectral planes, and the fusion's
class from its in-features (one for ``TokenMeanFusion``).
"""
from __future__ import annotations

import re

import numpy as np
import torch

# (flax module path, torch module prefix, kind). In the paths, {0} and {1} are indices
# that both sides share; {enc}, {fusion} and {dim} are names that only flax has (see
# _RANKS). First full match wins.
_RULES = [
    ("{enc}_0/ConvBlock_{0}/TorchConv_0/Conv_0", "deeponet.branch.blocks.{0}.conv", "conv"),
    ("{enc}_0/ConvBlock_{0}/TorchBatchNorm_0/BatchNorm_0", "deeponet.branch.blocks.{0}.bn", "bn"),
    ("{enc}_0/ConvBlock_{0}/LayerNorm_0", "deeponet.branch.blocks.{0}.ln", "ln"),
    ("{enc}_0/TorchDense_0/Dense_0", "deeponet.branch.fc", "dense"),
    ("FFN_0/Dense_{0}", "deeponet.trunk.layers.{0}", "dense"),
    ("FFN_0/TorchBatchNorm_{0}/BatchNorm_0", "deeponet.trunk.norms.{0}", "bn"),
    ("DeepOnetNoBias_0", "deeponet", "scalar"),
    ("{fusion}_0", "fusion", "dense"),
    ("FNO{dim}d_{0}/TorchDense_{1}/Dense_0", "heads.{0}.fc{1}", "dense"),
    ("FNO{dim}d_{0}/SpectralConv{dim}d_{1}", "heads.{0}.spectral.{1}", "spectral"),
    ("FNO{dim}d_{0}/PointwiseConv_{1}", "heads.{0}.pointwise.{1}", "dense"),
    ("FNO3d_0/TorchDense_{0}/Dense_0", "head.fc{0}", "dense"),
    ("FNO3d_0/SpectralConv3d_{0}", "head.spectral.{0}", "spectral"),
    ("FNO3d_0/PointwiseConv_{0}", "head.pointwise.{0}", "dense"),
    # the UNet: flax numbers each kind of module in its order of creation, and the port
    # keeps its lists in that order (blindno_torch/models/blindno_unet.py)
    ("TorchConv_{0}/Conv_0", "convs.{0}", "conv"),
    ("ConvNeXtBlock_{0}/TorchConv_0/Conv_0", "blocks.{0}.dwconv", "conv"),
    ("ConvNeXtBlock_{0}/LayerNorm_0", "blocks.{0}.norm", "ln"),
    ("ConvNeXtBlock_{0}/TorchDense_0/Dense_0", "blocks.{0}.pwconv1", "dense"),
    ("ConvNeXtBlock_{0}/TorchDense_1/Dense_0", "blocks.{0}.pwconv2", "dense"),
    ("PlainConvBlock_{0}/TorchConv_0/Conv_0", "blocks.{0}.conv", "conv"),
    ("PlainConvBlock_{0}/TorchBatchNorm_0/BatchNorm_0", "blocks.{0}.bn", "bn"),
    ("TemporalSelfAttention_{0}/LayerNorm_0", "attention.{0}.norm", "ln"),
    ("TorchConvTranspose_{0}/ConvTranspose_0", "transposes.{0}", "conv_transpose"),
    ("TorchBatchNorm_{0}/BatchNorm_0", "skip_norms.{0}", "bn"),
    # the Transolver NIOs: each Transolver module keeps flax's Dense_k, LayerNorm_k and
    # TorchConv_k as entry k of a list (blindno_torch/nn/transolver.py)
    ("Transolver_0", "trans", "placeholder"),
    ("Transolver_0/TransolverMLP_0/Dense_{0}", "trans.preprocess.layers.{0}", "dense"),
    ("Transolver_0/Dense_{0}", "trans.time_fc.{0}", "dense"),
    ("Transolver_0/TransolverBlock_{0}/PhysicsAttention_0", "trans.blocks.{0}.attn",
     "temperature"),
    ("Transolver_0/TransolverBlock_{0}/PhysicsAttention_0/TorchConv_{1}/Conv_0",
     "trans.blocks.{0}.attn.convs.{1}", "conv"),
    ("Transolver_0/TransolverBlock_{0}/PhysicsAttention_0/Dense_{1}",
     "trans.blocks.{0}.attn.dense.{1}", "attention_dense"),
    ("Transolver_0/TransolverBlock_{0}/LayerNorm_{1}", "trans.blocks.{0}.norms.{1}", "ln"),
    ("Transolver_0/TransolverBlock_{0}/TransolverMLP_0/Dense_{1}",
     "trans.blocks.{0}.mlp.layers.{1}", "dense"),
    ("Transolver_0/TransolverBlock_{0}/Dense_0", "trans.blocks.{0}.out", "dense"),
]

_NAMES = {"enc": r"Encoder(?:[123]D|3DDown|Helm2|ODE)", "fusion": r"(?:MeanField|TokenMean)Fusion",
          "dim": r"[12]"}


def _regex(template):
    """A template of _RULES as a regex: {0} and {1} capture indices, a flax-only name
    matches any of its values."""
    out = re.escape(template).replace(r"\{", "{").replace(r"\}", "}")
    out = re.sub(r"\{(\d)\}|\{(\w+)\}", lambda m: r"(\d+)" if m[1] else "(?:%s)" % _NAMES[m[2]], out)
    return re.compile(out)


_COMPILED = [(_regex(f), _regex(t), f, t, kind) for f, t, kind in _RULES]


def _conv_back(a):
    return a.transpose(*range(2, a.ndim), 1, 0)


def _conv_transpose_back(a):
    return np.ascontiguousarray(np.flip(a.transpose(*range(2, a.ndim), 0, 1), tuple(range(a.ndim - 2))))


# kind -> {flax leaf (in params, or in batch_stats for "stats:"):
#          (torch name, flax -> torch, torch -> flax)}
_KINDS = {
    "conv": {"kernel": ("weight", lambda a: a.transpose(a.ndim - 1, a.ndim - 2, *range(a.ndim - 2)),
                        _conv_back),
             "bias": ("bias", None, None)},
    "conv_transpose": {
        "kernel": ("weight", lambda a: np.ascontiguousarray(np.flip(
            a, tuple(range(a.ndim - 2))).transpose(a.ndim - 2, a.ndim - 1, *range(a.ndim - 2))),
            _conv_transpose_back),
        "bias": ("bias", None, None)},
    "dense": {"kernel": ("weight", lambda a: a.T, lambda a: a.T), "bias": ("bias", None, None)},
    # the slice attention's Dense_k: q, k and v have no bias, the others have one
    "attention_dense": {"kernel": ("weight", lambda a: a.T, lambda a: a.T),
                        "bias?": ("bias", None, None)},
    "ln": {"scale": ("weight", None, None), "bias": ("bias", None, None)},
    "bn": {"scale": ("weight", None, None), "bias": ("bias", None, None),
           "stats:mean": ("running_mean", None, None), "stats:var": ("running_var", None, None)},
    "spectral": {"weights_re": ("weights_re", None, None), "weights_im": ("weights_im", None, None)},
    "scalar": {"b0": ("b0", None, None)},
    "temperature": {"temperature": ("temperature", None, None)},
    "placeholder": {"placeholder": ("placeholder", None, None)},
}


def _groups(tree, tag, out, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            _groups(v, tag, out, path + (k,))
        else:
            out.setdefault("/".join(path), {})[tag + k] = v
    return out


def _match(module_path):
    for flax_re, _, _, prefix, kind in _COMPILED:
        m = flax_re.fullmatch(module_path)
        if m:
            return prefix.format(*m.groups()), kind
    raise KeyError(f"flax module {module_path!r} has no torch counterpart")


def _fno_branch_names(key):
    """The FNO-branch model's names: heads.0 is its branch, heads.k its head k-1."""
    m = re.match(r"heads\.(\d+)\.", key)
    if not m:
        return key
    k = int(m[1])
    return ("branch." if k == 0 else f"heads.{k - 1}.") + key[m.end():]


def from_flax(params, batch_stats) -> dict:
    """Nested dicts of numpy arrays -> a state dict of float32 tensors for the model whose
    flax tree this is (see the module note); ``batch_stats=None`` for a tree without
    statistics."""
    groups = _groups(params, "", {})
    _groups(batch_stats or {}, "stats:", groups)
    state = {}
    for module_path, leaves in groups.items():
        prefix, kind = _match(module_path)
        table = _KINDS[kind]
        if batch_stats is None:
            table = {k: v for k, v in table.items() if not k.startswith("stats:")}
        # a leaf marked "?" (an attention Dense's bias) is there or not, as the module has it
        table = {k.rstrip("?"): v for k, v in table.items()
                 if not k.endswith("?") or k.rstrip("?") in leaves}
        missing, extra = table.keys() - leaves.keys(), leaves.keys() - table.keys()
        if missing or extra:
            raise KeyError(f"flax module {module_path!r}: missing {sorted(missing)}, "
                           f"left over {sorted(extra)}")
        for leaf, (name, fn, _) in table.items():
            a = np.asarray(leaves[leaf], np.float32)
            state[f"{prefix}.{name}"] = torch.tensor(fn(a) if fn else a)
        if kind == "bn" and batch_stats is not None:
            state[f"{prefix}.num_batches_tracked"] = torch.tensor(0)
    if ({"MeanFieldFusion_0", "TokenMeanFusion_0"} & params.keys()
            and not {"DeepOnetNoBias_0", "Transolver_0"} & params.keys()):
        state = {_fno_branch_names(k): v for k, v in state.items()}
    return state


def _fno_branch_names_back(key):
    """:func:`_fno_branch_names` undone: ``branch`` is heads.0, heads.k is heads.{k+1}."""
    if key.startswith("branch."):
        return "heads.0." + key[len("branch."):]
    m = re.match(r"heads\.(\d+)\.", key)
    return f"heads.{int(m[1]) + 1}." + key[m.end():] if m else key


def _flax_names(state):
    """The names of the flax tree that the state dict does not carry (see the module
    note): {"enc": ..., "fusion": ..., "dim": {head index: "1" or "2"}}."""
    names = {"dim": {}}
    first = state.get("deeponet.branch.blocks.0.conv.weight")
    if first is not None:
        n_blocks = len({k.split(".")[3] for k in state if k.startswith("deeponet.branch.blocks.")})
        rank = first.dim() - 2
        names["enc"] = "EncoderODE" if (rank, n_blocks) == (1, 5) else f"Encoder{rank}D"
    if "fusion.weight" in state:
        names["fusion"] = ("TokenMeanFusion" if state["fusion.weight"].shape[1] == 1
                           else "MeanFieldFusion")
    for k, v in state.items():
        m = re.fullmatch(r"heads\.(\d+)\.spectral\.0\.weights_re", k)
        if m:
            names["dim"][m[1]] = str(v.dim() - 2)
    return names


def _set(tree, path, value):
    *parents, leaf = path
    for p in parents:
        tree = tree.setdefault(p, {})
    tree[leaf] = value


def to_flax(state_dict) -> tuple[dict, dict]:
    """A state dict of one of the models :func:`from_flax` takes -> ``(params,
    batch_stats)``, nested dicts of float32 numpy arrays in the JAX package's layout;
    ``batch_stats`` is empty for a state without running statistics (a gradient tree).
    ``num_batches_tracked``, which flax does not keep, is dropped."""
    state = {k: v for k, v in state_dict.items() if not k.endswith("num_batches_tracked")}
    if any(k.startswith("branch.") for k in state):  # the FNO-branch models
        state = {_fno_branch_names_back(k): v for k, v in state.items()}
    names = _flax_names(state)
    modules = {}
    for key, value in state.items():
        prefix, leaf = key.rsplit(".", 1)
        modules.setdefault(prefix, {})[leaf] = value
    params, batch_stats = {}, {}
    for prefix, leaves in modules.items():
        for _, torch_re, flax_t, _, kind in _COMPILED:
            m = torch_re.fullmatch(prefix)
            if m:
                break
        else:
            raise KeyError(f"torch module {prefix!r} has no flax counterpart")
        groups = m.groups()
        path = flax_t.format(*groups, enc=names.get("enc"), fusion=names.get("fusion"),
                             dim=names["dim"].get(groups[0] if groups else None)).split("/")
        spec = _KINDS[kind]
        table = {name: (leaf.rstrip("?"), back) for leaf, (name, _, back) in spec.items()}
        required = {name for leaf, (name, _, _) in spec.items()
                    if not leaf.endswith("?") and not leaf.startswith("stats:")}
        extra, missing = leaves.keys() - table.keys(), required - leaves.keys()
        if extra or missing:
            raise KeyError(f"torch module {prefix!r}: missing {sorted(missing)}, "
                           f"left over {sorted(extra)}")
        for name, value in leaves.items():
            leaf, back = table[name]
            a = value.detach().cpu().numpy().astype(np.float32, copy=False)
            a = back(a) if back else a
            if leaf.startswith("stats:"):
                _set(batch_stats, path + [leaf[len("stats:"):]], a)
            else:
                _set(params, path + [leaf], a)
    return params, batch_stats


_BUFFERS = ("running_mean", "running_var", "num_batches_tracked")


def from_flax_checkpoint(raw: dict) -> dict:
    """A restored ``best_*`` tree of the JAX package (``{"params", "batch_stats",
    "epoch", "test_loss"}``, as orbax restores it or
    :func:`blindno_torch.train.jax_checkpoint.read_orbax` reads it) -> the port's
    checkpoint: ``params`` the model's named parameters, ``batch_stats`` its named buffers
    (the BatchNorm running statistics), as the port's own ``best_*`` files hold them."""
    state = from_flax(raw["params"], raw.get("batch_stats") or {})
    params = {k: v for k, v in state.items() if not k.endswith(_BUFFERS)}
    stats = {k: v for k, v in state.items() if k.endswith(_BUFFERS)}
    return {"params": params, "batch_stats": stats, "epoch": int(raw["epoch"]),
            "test_loss": float(raw["test_loss"])}


def adam_from_optax(opt_state: dict, names: list[str], param_groups: list[dict]) -> dict:
    """JAX's ``optax.adam(schedule)`` state, as ``resume.msgpack`` holds it (``{"0":
    {"count", "mu", "nu"}, "1": {"count"}}``: Adam's, then the schedule's) -> torch's
    ``Adam.state_dict()`` over the parameters ``names``, in the optimizer's order, with
    its ``param_groups``. ``mu`` and ``nu`` take the parameters' layouts
    (:func:`from_flax` with ``batch_stats=None``); ``step`` is Adam's ``count``, which
    must equal the schedule's."""
    adam, schedule = opt_state["0"], opt_state["1"]
    count = int(np.asarray(adam["count"]))
    if count != int(np.asarray(schedule["count"])):
        raise ValueError(f"optax state: Adam's count {count} differs from the schedule's "
                         f"{int(np.asarray(schedule['count']))}")
    mu, nu = from_flax(adam["mu"], None), from_flax(adam["nu"], None)
    missing = set(names) - mu.keys()
    if missing:
        raise KeyError(f"optax state: no moments for {sorted(missing)[:4]}")
    state = {i: {"step": torch.tensor(float(count)), "exp_avg": mu[name],
                 "exp_avg_sq": nu[name]} for i, name in enumerate(names)}
    groups = [dict(g) for g in param_groups]
    if sum(len(g["params"]) for g in groups) != len(names):
        raise ValueError(f"optax state: {len(names)} parameters for param groups of "
                         f"{sum(len(g['params']) for g in groups)}")
    return {"state": state, "param_groups": groups}


def adam_to_optax(opt_state: dict, params: dict, names: list[str]) -> dict:
    """torch's ``Adam.state_dict()`` over the parameters ``names``, in the optimizer's
    order -> JAX's ``optax.adam(schedule)`` state as ``resume.msgpack`` holds it,
    :func:`adam_from_optax` undone: ``{"0": {"count", "mu", "nu"}, "1": {"count"}}``.
    Both counts are Adam's ``step`` as 0-d int32 arrays (the schedule counts the same
    updates); ``mu`` and ``nu`` take flax's layout (:func:`to_flax`). ``params`` holds
    every named parameter of the model: one outside ``names`` (a frozen fusion) gets
    zero moments, as optax's are behind JAX's ``stop_gradient``, and so does one that
    Adam has not stepped yet."""
    state, groups = opt_state["state"], opt_state["param_groups"]
    if sum(len(g["params"]) for g in groups) != len(names):
        raise ValueError(f"Adam state: param groups of {sum(len(g['params']) for g in groups)} "
                         f"parameters for {len(names)} names")
    steps = {float(s["step"]) for s in state.values()}
    if len(steps) > 1:
        raise ValueError(f"Adam state: parameters at different steps {sorted(steps)}")
    count = np.asarray(int(steps.pop()) if steps else 0, np.int32)
    index = {name: i for i, name in enumerate(names)}
    moments = {}
    for key in ("exp_avg", "exp_avg_sq"):
        tree = {name: state[index[name]][key] if index.get(name) in state
                else torch.zeros(p.shape) for name, p in params.items()}
        moments[key] = to_flax(tree)[0]
    return {"0": {"count": count, "mu": moments["exp_avg"], "nu": moments["exp_avg_sq"]},
            "1": {"count": count.copy()}}
