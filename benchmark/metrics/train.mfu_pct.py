"""``train.mfu_pct``: the configuration's analytic operations of the window's work over its
time, as a share of the H100's float32 peak (67 TFLOP/s, TF32 off)."""
from benchmark.readers import train_mfu_pct


def read(r):
    return train_mfu_pct(r) if r.facts.get("kind") == "train" else None
