"""Analytic operations of the fpe2d NIO (``fpe2d_nio.json``): the Encoder2D branch's ten
conv blocks over all B·L snapshots and its dense layer, the FFN trunk on the grid's
points, the DeepONet contraction, the frozen mean-field fusion and two FNO2d heads."""
from __future__ import annotations

from benchmark.flops import bmm, conv, dense, fno2d_head


def _encoder_schedule(dims, final_kernel):
    """(in, out, kernel, stride, padding) of the ten blocks, as the published Encoder2D."""
    d1, d2, d3, d4, d5 = dims
    return [(1, d1, (1, 7), (1, 2), (0, 3)),
            (d1, d2, (3, 3), (2, 2), (1, 1)), (d2, d2, (3, 3), (1, 1), (1, 1)),
            (d2, d3, (3, 3), (2, 2), (1, 1)), (d3, d3, (3, 3), (1, 1), (1, 1)),
            (d3, d4, (3, 3), (2, 2), (1, 1)), (d4, d4, (3, 3), (1, 1), (1, 1)),
            (d4, d5, (3, 3), (2, 2), (1, 1)), (d5, d5, (3, 3), (2, 2), (1, 1)),
            (d5, d5, tuple(final_kernel), (1, 1), (0, 0))]


def model_ops(config, batch, snapshots):
    """(ops, fno2d layer shapes) of one forward over ``batch`` sets of ``snapshots``."""
    kw = config["model"]["kwargs"]
    h, w = config["grid"]["shape"]
    n = batch * snapshots
    ops, size = [], (h, w)
    for i, (cin, cout, k, s, p) in enumerate(_encoder_schedule(config["encoder_dims"],
                                                              kw["encoder_final_kernel"])):
        size = tuple((a + 2 * pp - kk) // ss + 1 for a, kk, ss, pp in zip(size, k, s, p))
        ops.append(conv(f"encoder.block{i}", n, cin, cout, k, size, bwd=2 if i else 1))
    if size != (1, 1):
        raise ValueError(f"the encoder leaves {size} on a {h}x{w} grid")
    basis, neurons = kw["n_basis"], kw["neurons"]
    ops.append(dense("encoder.fc", n, config["encoder_dims"][-1], basis))
    points = h * w
    dims = [2] + [neurons] * kw["n_hidden_layers"] + [basis]
    for i, (a, b) in enumerate(zip(dims, dims[1:])):
        ops.append(dense(f"trunk.{i}", points, a, b, bwd=2 if i else 1))
    ops.append(bmm("deeponet", 1, n, basis, points))
    ops.append(dense("fusion.grid", batch * points, 2, kw["width"], bwd=0))
    shapes = []
    for k, out_dim in enumerate(kw["head_dims"]):
        head, calls = fno2d_head(f"head{k}", batch, h, w, kw["width"], kw["modes"],
                                 kw["fno_layers"], kw["width"], out_dim, kw["padding_frac"])
        ops += head
        shapes += calls
    return ops, shapes
