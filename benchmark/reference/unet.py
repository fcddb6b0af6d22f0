"""The plain reference of the BlinDNO UNet (``PermInvUNetAttn``): its leaves and its
forward (the reference repository's ``2d_FPE`` model as the JAX package restates it in
``blindno/models/blindno_unet.py``)."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from benchmark.reference.layers import (batch_norm, conv_leaves, fno_head_leaves, heads,
                                        layer_norm, linear, masked_mean, norm_leaves,
                                        prefixed)


def _unet_sizes(size, depth):
    sizes = [tuple(size)]
    for _ in range(depth):
        sizes.append(tuple(s // 2 for s in sizes[-1]))
    return sizes


def leaves(config):
    """{name: (shape, kind)} of the model's state, in a fixed order."""
    kw = config["model"]["kwargs"]
    depth, width = kw["depth"], kw["width"]
    chs = [kw["base_ch"] * 2 ** i for i in range(depth + 1)]
    sizes = _unet_sizes(kw["input_size"], depth)
    up = [depth - 1 - i for i in range(depth)]
    out = {}
    convs = ([(chs[i - 1] if i else 1, chs[i], (3, 3)) for i in range(depth + 1)]
             + [(2 * chs[lv], chs[lv], (3, 3)) for lv in up] + [(chs[0], width, (1, 1))])
    for k, (cin, cout, kernel) in enumerate(convs):
        out.update(prefixed(f"convs.{k}", conv_leaves(cout, cin, kernel)))
    for k, lv in enumerate([*range(depth + 1), *up]):
        d = chs[lv]
        out.update(prefixed(f"blocks.{k}.dwconv", conv_leaves(d, 1, (7, 7))))
        out.update(prefixed(f"blocks.{k}.norm", norm_leaves(d)))
        out.update(prefixed(f"blocks.{k}.pwconv1", conv_leaves(4 * d, d, ())))
        out.update(prefixed(f"blocks.{k}.pwconv2", conv_leaves(d, 4 * d, ())))
    for k, lv in enumerate([depth, *up]):
        out.update(prefixed(f"attention.{k}.norm", norm_leaves(chs[lv] * math.prod(sizes[lv]))))
    for i, lv in enumerate(up):
        out[f"transposes.{i}.weight"] = ((chs[lv + 1], chs[lv], 2, 2), "weight_transposed")
        out[f"transposes.{i}.bias"] = ((chs[lv],), "bias")
    for i, lv in enumerate(up):
        out.update(prefixed(f"skip_norms.{i}", norm_leaves(chs[lv], running=True)))
    for k, d in enumerate(kw["head_dims"]):
        out.update(fno_head_leaves(f"heads.{k}", width, kw["fno_modes"], kw["fno_layers"], d))
    return out


def _convnext(h, p, prefix):
    dim = h.shape[1]
    y = F.conv2d(h, p[f"{prefix}.dwconv.weight"], p[f"{prefix}.dwconv.bias"], padding=3,
                 groups=dim)
    y = layer_norm(y.movedim(1, -1), p[f"{prefix}.norm.weight"], p[f"{prefix}.norm.bias"], 1e-6)
    y = linear(F.gelu(linear(y, p, f"{prefix}.pwconv1")), p, f"{prefix}.pwconv2")
    return y.movedim(-1, 1) + h


def _set_attention(seq, p, prefix, mask):
    """Q = K = V self-attention over the set axis of (B, T, C, *spatial), tokens
    flattened channel-last, masked keys at -1e9, the residual and a LayerNorm (eps
    1e-5) over the token."""
    b, t, c = seq.shape[:3]
    flat = seq.movedim(2, -1).reshape(b, t, -1)
    scores = flat @ flat.transpose(1, 2) / math.sqrt(flat.shape[-1])
    if mask is not None:
        scores = scores + (1.0 - mask.reshape(1, 1, -1)) * -1e9
    out = layer_norm(torch.softmax(scores, dim=-1) @ flat + flat, p[f"{prefix}.norm.weight"],
                     p[f"{prefix}.norm.bias"], 1e-5)
    return out.reshape(b, t, *seq.shape[3:], c).movedim(-1, 2)


def forward(config, p, x, grid, train, mask):
    kw = config["model"]["kwargs"]
    depth = kw["depth"]
    b, l, hh, ww = x.shape
    sizes = _unet_sizes((hh, ww), depth)
    h = x.reshape(b * l, 1, hh, ww)
    feats = []
    for i in range(depth + 1):
        h = F.conv2d(h, p[f"convs.{i}.weight"], p[f"convs.{i}.bias"], padding=1)
        h = _convnext(h, p, f"blocks.{i}")
        feats.append(h)
        if i < depth:
            h = F.max_pool2d(h, 2)

    def pool(feat, k):
        seq = feat.reshape(b, l, *feat.shape[1:])
        if kw["use_attention"]:
            seq = _set_attention(seq, p, f"attention.{k}", mask)
        return masked_mean(seq, mask)

    h = pool(h, 0)
    for i in range(depth):
        lv = depth - 1 - i
        skip = batch_norm(pool(feats[lv], i + 1), p, f"skip_norms.{i}", train)
        up = F.conv_transpose2d(h, p[f"transposes.{i}.weight"], p[f"transposes.{i}.bias"],
                                stride=2)
        up = F.pad(up, (0, sizes[lv][1] - up.shape[-1], 0, sizes[lv][0] - up.shape[-2]))
        h = torch.cat([up, skip], dim=1)
        h = F.conv2d(h, p[f"convs.{depth + 1 + i}.weight"], p[f"convs.{depth + 1 + i}.bias"],
                     padding=1)
        h = _convnext(h, p, f"blocks.{depth + 1 + i}")
    k = 2 * depth + 1
    feats = F.conv2d(h, p[f"convs.{k}.weight"], p[f"convs.{k}.bias"]).movedim(1, -1)
    return heads(feats, p, kw)


