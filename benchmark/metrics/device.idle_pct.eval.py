"""``device.idle_pct.eval``: the share of the traced window in which no kernel, copy or
set ran on the device, 1 - (union of their intervals) / (the window's span)."""
from benchmark.readers import idle_pct


def read(r):
    return idle_pct(r) if r.facts.get("kind") == "eval" else None
