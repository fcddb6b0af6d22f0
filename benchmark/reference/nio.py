"""The plain reference of the NIO (``NIOFP2D``): its leaves and its forward (the
reference repository's ``2d_FPE/NIOModules.py`` as the JAX package restates it in
``blindno/models/nio2d.py``)."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from benchmark.reference.layers import (batch_norm, conv_leaves, fno_head_leaves, heads,
                                        leaky_relu, linear, masked_mean, norm_leaves,
                                        prefixed)


def _encoder_schedule(dims, final_kernel):
    d1, d2, d3, d4, d5 = dims
    return [(1, d1, (1, 7), (1, 2), (0, 3)),
            (d1, d2, (3, 3), (2, 2), (1, 1)), (d2, d2, (3, 3), (1, 1), (1, 1)),
            (d2, d3, (3, 3), (2, 2), (1, 1)), (d3, d3, (3, 3), (1, 1), (1, 1)),
            (d3, d4, (3, 3), (2, 2), (1, 1)), (d4, d4, (3, 3), (1, 1), (1, 1)),
            (d4, d5, (3, 3), (2, 2), (1, 1)), (d5, d5, (3, 3), (2, 2), (1, 1)),
            (d5, d5, tuple(final_kernel), (1, 1), (0, 0))]


def leaves(config):
    """{name: (shape, kind)} of the model's state, in a fixed order."""
    kw, dims = config["model"]["kwargs"], config["encoder_dims"]
    out = {}
    for i, (cin, cout, k, _, _) in enumerate(_encoder_schedule(dims, kw["encoder_final_kernel"])):
        out.update(prefixed(f"deeponet.branch.blocks.{i}.conv", conv_leaves(cout, cin, k)))
        out.update(prefixed(f"deeponet.branch.blocks.{i}.bn", norm_leaves(cout, running=True)))
    out.update(prefixed("deeponet.branch.fc", conv_leaves(kw["n_basis"], dims[-1], ())))
    trunk = [2] + [kw["neurons"]] * kw["n_hidden_layers"] + [kw["n_basis"]]
    for i, (a, b) in enumerate(zip(trunk, trunk[1:])):
        out.update(prefixed(f"deeponet.trunk.layers.{i}", conv_leaves(b, a, ())))
    for i in range(kw["n_hidden_layers"] - 1):
        out.update(prefixed(f"deeponet.trunk.norms.{i}", norm_leaves(kw["neurons"], running=True)))
    out["deeponet.b0"] = ((), "scalar")
    out["fusion.weight"] = ((kw["width"], 3), "frozen_weight")
    out["fusion.bias"] = ((kw["width"],), "frozen_bias")
    for k, d in enumerate(kw["head_dims"]):
        out.update(fno_head_leaves(f"heads.{k}", kw["width"], kw["modes"], kw["fno_layers"], d))
    return out


def forward(config, p, x, grid, train, mask):
    kw, dims = config["model"]["kwargs"], config["encoder_dims"]
    b, l, nx, ny = x.shape
    h = x.reshape(b * l, 1, nx, ny)
    for i, (_, _, _, s, pad) in enumerate(_encoder_schedule(dims, kw["encoder_final_kernel"])):
        pre = f"deeponet.branch.blocks.{i}"
        h = F.conv2d(h, p[f"{pre}.conv.weight"], p[f"{pre}.conv.bias"], stride=s, padding=pad)
        h = leaky_relu(batch_norm(h, p, f"{pre}.bn", train), 0.2)
    branch = linear(h.movedim(1, -1).reshape(b, l, -1), p, "deeponet.branch.fc")
    t = leaky_relu(linear(grid.reshape(-1, 2), p, "deeponet.trunk.layers.0"), 0.01)
    for i in range(1, kw["n_hidden_layers"]):
        t = leaky_relu(linear(t, p, f"deeponet.trunk.layers.{i}"), 0.01)
        t = batch_norm(t, p, f"deeponet.trunk.norms.{i - 1}", train)
    basis = linear(t, p, f"deeponet.trunk.layers.{kw['n_hidden_layers']}")
    fields = ((torch.einsum("blp,np->bln", branch, basis) + p["deeponet.b0"])
              / math.sqrt(basis.shape[-1])).reshape(b, l, nx, ny)
    wf = p["fusion.weight"]
    grid_feats = grid.unsqueeze(0).expand(b, *grid.shape)
    feats = grid_feats @ wf[:, :2].T + masked_mean(fields, mask)[..., None] * wf[:, 2]
    return heads(feats + p["fusion.bias"], p, kw)


