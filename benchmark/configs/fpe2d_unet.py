"""Analytic operations of the fpe2d BlinDNO UNet (``fpe2d_unet.json``): the set encoder
over all B·L snapshots (a 3x3 conv and a ConvNeXt block a level, channels base_ch·2^i
on 61 -> 30 -> 15 -> 7 -> 3), the set attention over the L snapshots at each level, the
up path on the pooled set, the 1x1 fuse and two FNO2d heads."""
from __future__ import annotations

from benchmark.flops import bmm, conv, dense, fno2d_head


def _block(name, n, dim, size):
    pts = n * size[0] * size[1]
    return [conv(f"{name}.dwconv", n, dim, dim, (7, 7), size, groups=dim),
            dense(f"{name}.pwconv1", pts, dim, 4 * dim), dense(f"{name}.pwconv2", pts, 4 * dim, dim)]


def model_ops(config, batch, snapshots):
    """(ops, fno2d layer shapes) of one forward over ``batch`` sets of ``snapshots``."""
    kw = config["model"]["kwargs"]
    depth, width = kw["depth"], kw["width"]
    chs = [kw["base_ch"] * 2 ** i for i in range(depth + 1)]
    sizes = [tuple(kw["input_size"])]
    for _ in range(depth):
        sizes.append(tuple(s // 2 for s in sizes[-1]))
    n = batch * snapshots
    ops = []
    for i in range(depth + 1):
        ops.append(conv(f"down{i}.conv", n, chs[i - 1] if i else 1, chs[i], (3, 3), sizes[i],
                        bwd=2 if i else 1))
        ops += _block(f"down{i}.block", n, chs[i], sizes[i])

    def attention(name, lv):
        d = chs[lv] * sizes[lv][0] * sizes[lv][1]
        return [bmm(f"{name}.scores", batch, snapshots, d, snapshots),
                bmm(f"{name}.values", batch, snapshots, snapshots, d)]

    ops += attention("attn.bottleneck", depth)
    for i in range(depth):
        lv = depth - 1 - i
        ops += attention(f"attn.skip{lv}", lv)
        ops.append(conv(f"up{lv}.transpose", batch, chs[lv + 1], chs[lv], (2, 2), sizes[lv + 1]))
        ops.append(conv(f"up{lv}.conv", batch, 2 * chs[lv], chs[lv], (3, 3), sizes[lv]))
        ops += _block(f"up{lv}.block", batch, chs[lv], sizes[lv])
    ops.append(conv("fuse", batch, chs[0], width, (1, 1), sizes[0]))
    shapes = []
    h, w = sizes[0]
    for k, out_dim in enumerate(kw["head_dims"]):
        head, calls = fno2d_head(f"head{k}", batch, h, w, width, kw["fno_modes"],
                                 kw["fno_layers"], width, out_dim, kw["padding_frac"])
        ops += head
        shapes += calls
    return ops, shapes
