"""Flax parameter trees to PyTorch state dicts for the port's NIO models.

``from_flax(params, batch_stats)`` takes the nested dicts of numpy arrays that the JAX
package's checkpoints hold and returns the state dict of
:class:`blindno_torch.models.nio2d.NIOFP2D` (and ``NIOAttn2D``, whose tree is the same),
``NIOFNO2D``, ``NIOFNOAttn2D``, ``NIOTrans2D`` (and ``NIOTransAttn2D``),
:class:`blindno_torch.models.nio1d.NIOFP1D`,
:class:`blindno_torch.models.nio1d.NIOFNO1D` or
:class:`blindno_torch.models.blindno_unet.PermInvUNetAttn`:

- conv kernels go from (*window, cin, cout) to (cout, cin, *window);
- transposed-conv kernels go from (*window, cin, cout) to (cin, cout, *window) and are
  flipped in space (flax's transposed convolution does not flip its kernel, torch's
  does);
- LayerNorm scale/bias become weight/bias as they stand (the port's set attention
  flattens its tokens in JAX's order);
- dense kernels (also the 1x1 ``PointwiseConv`` and either fusion map) from (in, out)
  to (out, in), with their bias (the slice attention's q, k and v have none);
- BatchNorm scale/bias/mean/var become weight/bias/running_mean/running_var;
- spectral ``weights_re`` / ``weights_im`` stay (Cin, Cout, modes) or
  (Cin, Cout, 2*m1, m2) planes;
- the Transolver NIOs' ``Transolver_0`` becomes ``trans``, with its ``temperature``
  and ``placeholder`` parameters as they stand;
- ``FNO1d_k`` / ``FNO2d_k`` become ``heads.k``, except in the FNO-branch models, whose
  tree has a fusion map (``MeanFieldFusion_0`` or ``TokenMeanFusion_0``) but neither a
  DeepONet nor a Transolver: there ``FNO1d_0`` / ``FNO2d_0`` is the ``branch`` and
  ``FNO*d_k`` becomes ``heads.{k-1}``.

Every flax leaf must map to one torch key and every torch module must receive all of
its tensors: a left-over or missing key raises ``KeyError``. A tree with no statistics at
all, such as a gradient tree, goes in with ``batch_stats=None``: its BatchNorm modules
then give weight and bias only.
"""
from __future__ import annotations

import re

import numpy as np
import torch

# flax module path -> (torch module prefix, kind); first full match wins
_RULES = [
    (r"Encoder[12]D_0/ConvBlock_(\d+)/TorchConv_0/Conv_0", "deeponet.branch.blocks.{0}.conv", "conv"),
    (r"Encoder[12]D_0/ConvBlock_(\d+)/TorchBatchNorm_0/BatchNorm_0", "deeponet.branch.blocks.{0}.bn", "bn"),
    (r"Encoder[12]D_0/TorchDense_0/Dense_0", "deeponet.branch.fc", "dense"),
    (r"FFN_0/Dense_(\d+)", "deeponet.trunk.layers.{0}", "dense"),
    (r"FFN_0/TorchBatchNorm_(\d+)/BatchNorm_0", "deeponet.trunk.norms.{0}", "bn"),
    (r"DeepOnetNoBias_0", "deeponet", "scalar"),
    (r"MeanFieldFusion_0", "fusion", "dense"),
    (r"TokenMeanFusion_0", "fusion", "dense"),
    (r"FNO[12]d_(\d+)/TorchDense_([012])/Dense_0", "heads.{0}.fc{1}", "dense"),
    (r"FNO[12]d_(\d+)/SpectralConv[12]d_(\d+)", "heads.{0}.spectral.{1}", "spectral"),
    (r"FNO[12]d_(\d+)/PointwiseConv_(\d+)", "heads.{0}.pointwise.{1}", "dense"),
    # the UNet: flax numbers each kind of module in its order of creation, and the port
    # keeps its lists in that order (blindno_torch/models/blindno_unet.py)
    (r"TorchConv_(\d+)/Conv_0", "convs.{0}", "conv"),
    (r"ConvNeXtBlock_(\d+)/TorchConv_0/Conv_0", "blocks.{0}.dwconv", "conv"),
    (r"ConvNeXtBlock_(\d+)/LayerNorm_0", "blocks.{0}.norm", "ln"),
    (r"ConvNeXtBlock_(\d+)/TorchDense_0/Dense_0", "blocks.{0}.pwconv1", "dense"),
    (r"ConvNeXtBlock_(\d+)/TorchDense_1/Dense_0", "blocks.{0}.pwconv2", "dense"),
    (r"PlainConvBlock_(\d+)/TorchConv_0/Conv_0", "blocks.{0}.conv", "conv"),
    (r"PlainConvBlock_(\d+)/TorchBatchNorm_0/BatchNorm_0", "blocks.{0}.bn", "bn"),
    (r"TemporalSelfAttention_(\d+)/LayerNorm_0", "attention.{0}.norm", "ln"),
    (r"TorchConvTranspose_(\d+)/ConvTranspose_0", "transposes.{0}", "conv_transpose"),
    (r"TorchBatchNorm_(\d+)/BatchNorm_0", "skip_norms.{0}", "bn"),
    # the Transolver NIOs: each Transolver module keeps flax's Dense_k, LayerNorm_k and
    # TorchConv_k as entry k of a list (blindno_torch/nn/transolver.py)
    (r"Transolver_0", "trans", "placeholder"),
    (r"Transolver_0/TransolverMLP_0/Dense_(\d+)", "trans.preprocess.layers.{0}", "dense"),
    (r"Transolver_0/Dense_(\d+)", "trans.time_fc.{0}", "dense"),
    (r"Transolver_0/TransolverBlock_(\d+)/PhysicsAttention_0", "trans.blocks.{0}.attn",
     "temperature"),
    (r"Transolver_0/TransolverBlock_(\d+)/PhysicsAttention_0/TorchConv_(\d+)/Conv_0",
     "trans.blocks.{0}.attn.convs.{1}", "conv"),
    (r"Transolver_0/TransolverBlock_(\d+)/PhysicsAttention_0/Dense_(\d+)",
     "trans.blocks.{0}.attn.dense.{1}", "attention_dense"),
    (r"Transolver_0/TransolverBlock_(\d+)/LayerNorm_(\d+)", "trans.blocks.{0}.norms.{1}", "ln"),
    (r"Transolver_0/TransolverBlock_(\d+)/TransolverMLP_0/Dense_(\d+)",
     "trans.blocks.{0}.mlp.layers.{1}", "dense"),
    (r"Transolver_0/TransolverBlock_(\d+)/Dense_0", "trans.blocks.{0}.out", "dense"),
]

# kind -> {flax leaf (in params, or in batch_stats for "stats:"): (torch name, transform)}
_KINDS = {
    "conv": {"kernel": ("weight", lambda a: a.transpose(a.ndim - 1, a.ndim - 2, *range(a.ndim - 2))),
             "bias": ("bias", None)},
    "conv_transpose": {
        "kernel": ("weight", lambda a: np.ascontiguousarray(np.flip(
            a, tuple(range(a.ndim - 2))).transpose(a.ndim - 2, a.ndim - 1, *range(a.ndim - 2)))),
        "bias": ("bias", None)},
    "dense": {"kernel": ("weight", lambda a: a.T), "bias": ("bias", None)},
    # the slice attention's Dense_k: q, k and v have no bias, the others have one
    "attention_dense": {"kernel": ("weight", lambda a: a.T), "bias?": ("bias", None)},
    "ln": {"scale": ("weight", None), "bias": ("bias", None)},
    "bn": {"scale": ("weight", None), "bias": ("bias", None),
           "stats:mean": ("running_mean", None), "stats:var": ("running_var", None)},
    "spectral": {"weights_re": ("weights_re", None), "weights_im": ("weights_im", None)},
    "scalar": {"b0": ("b0", None)},
    "temperature": {"temperature": ("temperature", None)},
    "placeholder": {"placeholder": ("placeholder", None)},
}


def _groups(tree, tag, out, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            _groups(v, tag, out, path + (k,))
        else:
            out.setdefault("/".join(path), {})[tag + k] = v
    return out


def _match(module_path):
    for pattern, prefix, kind in _RULES:
        m = re.fullmatch(pattern, module_path)
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
        for leaf, (name, fn) in table.items():
            a = np.asarray(leaves[leaf], np.float32)
            state[f"{prefix}.{name}"] = torch.tensor(fn(a) if fn else a)
        if kind == "bn" and batch_stats is not None:
            state[f"{prefix}.num_batches_tracked"] = torch.tensor(0)
    if ({"MeanFieldFusion_0", "TokenMeanFusion_0"} & params.keys()
            and not {"DeepOnetNoBias_0", "Transolver_0"} & params.keys()):
        state = {_fno_branch_names(k): v for k, v in state.items()}
    return state
