"""``fno2d_layer_roofline.eval``: the traced ``fno2d_layer`` calls' least time (the frozen
``layer_bound`` at each call's shape) over the device time of the ``fno2d_*`` kernels."""
from benchmark.readers import fno2d_roofline_pct


def read(r):
    return fno2d_roofline_pct(r, r.facts["batch"]) if r.facts.get("kind") == "eval" else None
